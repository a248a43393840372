"""The port's C++ prefetch loader (`data/native_loader.py`,
`csrc/loader.cpp`) on the CPU, after tests/test_native_loader.py.

Against the JAX package's `NativeLoader` on the same manifest, bit for
bit: one thread with seed=None (manifest order) and with an int seed
(the same std::mt19937_64 shuffle), in one pass and in loop mode across
epochs; against the port's python loader (`bucket_stream` over
`manifest_examples`, and `manifest_batches` with a held-out first batch
and CMVN) with seed=None; {"audio"} records, featurized by the port's
`log_mel` after the pipeline, against JAX's native FBANK within
FEATS_ATOL (tests/test_torch_recognize.py's bound) and against the
python loader's per-utterance `log_mel` within AUDIO_ATOL. Also: four
threads give the same multiset; loop mode reshuffles every epoch and
never runs dry; the refusals; the library is built by g++ from the
port's tree at first use only, and a failed build raises; the training
and decode CLIs with --loader native.
"""

import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from rnn_transducer_tpu.data import native_loader as jnative
from rnn_transducer_tpu.models.config import TransducerConfig as JaxConfig
from rnn_transducer_tpu_torch import recognize as rec
from rnn_transducer_tpu_torch.data import native_loader as native
from rnn_transducer_tpu_torch.data.bucketing import (BucketBatcher,
                                                     bucket_stream)
from rnn_transducer_tpu_torch.data.cmvn import apply_cmvn_batch
from rnn_transducer_tpu_torch.data.manifest import (manifest_batches,
                                                    manifest_examples)
from rnn_transducer_tpu_torch.models.config import (TrainConfig,
                                                    TransducerConfig)
from rnn_transducer_tpu_torch.train.__main__ import main as train_main
from rnn_transducer_tpu_torch.utils import build

pytestmark = pytest.mark.quick

CFG = TransducerConfig(input_dim=8, vocab_size=16)
JCFG = JaxConfig(input_dim=8, vocab_size=16)
BUCKETS = ((6, 3), (12, 5))
FEATS_ATOL = 1e-3  # the port's log_mel against JAX's native FBANK
# batched log_mel against one utterance's: the same f32 arithmetic a
# frame, the filterbank product blocked differently; log-mels of ~10
AUDIO_ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_manifest(tmp_path, n=13, seed=0, audio=None, dim=8, t_max=14,
                    samples=(800, 2000)):
    """n records: .npy features of 2..t_max-1 frames, or audio (audio=
    "npy" or "raw" f32) of `samples` samples, with 1-5 labels."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        labels = rng.integers(1, CFG.vocab_size,
                              size=int(rng.integers(1, 6))).tolist()
        if audio:
            wav = rng.normal(size=int(rng.integers(*samples))).astype(
                np.float32)
            p = os.path.join(tmp_path, f"a{i}.{audio}")
            if audio == "npy":
                np.save(p, wav)
            else:
                wav.tofile(p)
            recs.append({"audio": p, "labels": labels})
        else:
            feats = rng.normal(size=(int(rng.integers(2, t_max)),
                                     dim)).astype(np.float32)
            p = os.path.join(tmp_path, f"f{i}.npy")
            np.save(p, feats)
            recs.append({"feats": p, "labels": labels})
    mpath = os.path.join(tmp_path, "manifest.jsonl")
    with open(mpath, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    return mpath, recs


def _assert_batches_equal(got, want):
    assert len(got) == len(want) and len(want) >= 1
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _python_batches(mpath, cfg=CFG, buckets=BUCKETS, batch_size=4):
    return list(bucket_stream(manifest_examples(mpath, cfg, device="cpu"),
                              buckets, batch_size, blank=cfg.blank,
                              with_valid=True))


@pytest.mark.parametrize("seed, loop", [(None, False), (7, False),
                                        (7, True)])
def test_matches_the_jax_native_loader_bit_for_bit(tmp_path, seed, loop):
    """One thread: the same batches as JAX's loader, in the same order;
    with an int seed the same shuffle, in loop mode over four epochs. The
    end-of-pass flush (partial batches, n_valid < 4) is equal batch for
    batch too, but its order is bucket_stream's (each bucket's first
    example) in the port and the bucket index in JAX's: the manifest
    makes them differ, and they are compared by bucket."""
    mpath, _ = _write_manifest(str(tmp_path), n=13, t_max=16)
    n = 12 if loop else None
    with native.NativeLoader(mpath, CFG, BUCKETS, 4, loop=loop, seed=seed,
                             n_threads=1, device="cpu") as a, \
            jnative.NativeLoader(mpath, JCFG, BUCKETS, 4, loop=loop,
                                 seed=seed, n_threads=1) as b:
        got = list(itertools.islice(a, n))
        want = list(itertools.islice(b, n))
        if not loop:
            assert a.dropped == b.dropped > 0
    full = [[x for x in bs if x[4] == 4] for bs in (got, want)]
    _assert_batches_equal(*full)
    flush = [sorted((x for x in bs if x[4] < 4), key=lambda x: x[0].shape)
             for bs in (got, want)]
    assert len(flush[0]) == (0 if loop else len(BUCKETS))
    for g, w in zip(*flush):
        _assert_batches_equal([g], [w])
    if seed is None:
        assert [x[0].shape for x in got] != [x[0].shape for x in want]


@pytest.mark.parametrize("cmvn", [False, True])
def test_matches_the_port_python_loader(tmp_path, cmvn):
    """seed=None, one thread: bucket_stream's batches and drop count; with
    the first batch held out and CMVN in place on the padded batch, the
    first epoch of manifest_batches (CMVN a record before padding) and
    apply_cmvn_batch's arithmetic. The manifest is the one whose flush
    order the JAX loader changes."""
    mpath, _ = _write_manifest(str(tmp_path), n=13, t_max=16)
    if not cmvn:
        with native.NativeLoader(mpath, CFG, BUCKETS, 4, seed=None,
                                 n_threads=1, device="cpu") as ld:
            got = list(ld)
            dropped = ld.dropped
        _assert_batches_equal(got, _python_batches(mpath))
        bb = BucketBatcher(BUCKETS, 4, blank=CFG.blank)
        for f, l in manifest_examples(mpath, CFG, device="cpu"):
            bb.add(f, l)
        assert dropped == bb.n_dropped
        return
    rng = np.random.default_rng(2)
    stats = {"mean": rng.normal(size=8).tolist(),
             "std": rng.uniform(0.5, 2.0, size=8).tolist()}
    tcfg = TrainConfig(batch_size=4, buckets=BUCKETS)
    with native.NativeLoader(mpath, CFG, BUCKETS, 4, seed=None, n_threads=1,
                             skip_first=4, cmvn=stats, device="cpu") as ld:
        got = [b[:4] for b in ld]
    with native.NativeLoader(mpath, CFG, BUCKETS, 4, seed=None, n_threads=1,
                             skip_first=4, device="cpu") as ld:
        _assert_batches_equal(got, [
            (apply_cmvn_batch(b[0], b[1], stats),) + tuple(b[1:4])
            for b in ld])
    want = list(itertools.islice(manifest_batches(
        mpath, CFG, tcfg, skip_first=4, cmvn=stats, device="cpu"),
        len(got)))
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("audio", ["npy", "raw"])
def test_audio_records_match_jax_native_fbank(tmp_path, audio):
    """{"audio"} records: the threads publish PCM, the port's log_mel
    featurizes it; JAX's threads run its C++ FBANK. The frame counts and
    labels equal, the features within FEATS_ATOL, padding frames zero;
    with CMVN, within AUDIO_ATOL of the port's python loader's."""
    mpath, recs = _write_manifest(str(tmp_path), n=9, audio=audio)
    buckets = ((6, 3), (12, 5))
    with native.NativeLoader(mpath, CFG, buckets, 4, seed=None, n_threads=1,
                             device="cpu") as a, \
            jnative.NativeLoader(mpath, JCFG, buckets, 4, seed=None,
                                 n_threads=1) as b:
        got, want = list(a), list(b)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g[0].shape == w[0].shape and g[0].dtype == np.float32
        for i in (1, 2, 3):
            np.testing.assert_array_equal(g[i], w[i])
        assert g[4] == w[4]
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=FEATS_ATOL)
        for row, n in zip(g[0], g[1]):
            assert not row[n:].any()
    rng = np.random.default_rng(3)
    stats = {"mean": (rng.normal(size=8) - 10).tolist(),
             "std": rng.uniform(1.0, 3.0, size=8).tolist()}
    with native.NativeLoader(mpath, CFG, buckets, 4, seed=None, n_threads=1,
                             cmvn=stats, device="cpu") as a:
        got = list(a)
    want = list(bucket_stream(manifest_examples(mpath, CFG, cmvn=stats,
                                                device="cpu"),
                              buckets, 4, blank=CFG.blank, with_valid=True))
    for g, w in zip(got, want):
        for i in (1, 2, 3, 4):
            np.testing.assert_array_equal(np.asarray(g[i]),
                                          np.asarray(w[i]))
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=AUDIO_ATOL)
        for row, n in zip(g[0], g[1]):
            assert not row[n:].any()


def test_multithreaded_same_multiset(tmp_path):
    """Four threads produce the same examples (in any batch order)."""
    mpath, _ = _write_manifest(str(tmp_path), n=23, seed=3)

    def key_set(batches):
        keys = []
        for feats, fl, labels, ll, n_valid in batches:
            for i in range(n_valid):
                keys.append((feats[i, : fl[i]].tobytes(),
                             tuple(labels[i, : ll[i]].tolist())))
        return sorted(keys)

    with native.NativeLoader(mpath, CFG, BUCKETS, 4, seed=None, n_threads=4,
                             device="cpu") as ld:
        got = list(ld)
    assert key_set(got) == key_set(_python_batches(mpath))


def test_loop_mode_reshuffles_and_keeps_feeding(tmp_path):
    """Loop mode never flushes a partial batch and never runs dry; with an
    int seed each epoch takes another order."""
    mpath, _ = _write_manifest(str(tmp_path), n=16, seed=5, t_max=6)
    with native.NativeLoader(mpath, CFG, ((6, 5),), 4, loop=True, seed=7,
                             n_threads=2, device="cpu") as ld:
        batches = list(itertools.islice(iter(ld), 10))
    assert len(batches) == 10
    for feats, fl, labels, ll, n_valid in batches:
        assert n_valid == 4 and np.all(fl > 0)
    with native.NativeLoader(mpath, CFG, ((6, 5),), 4, loop=True, seed=7,
                             n_threads=1, device="cpu") as ld:
        epochs = list(itertools.islice(iter(ld), 8))
    firsts = [b[0][0, 0].tobytes() for b in epochs]
    assert firsts[:4] != firsts[4:]  # 4 batches an epoch, reordered


def test_refusals(tmp_path):
    mpath, recs = _write_manifest(str(tmp_path), n=4)
    audio = os.path.join(str(tmp_path), "a.npy")
    np.save(audio, np.zeros(800, np.float32))
    mixed = os.path.join(str(tmp_path), "mixed.jsonl")
    with open(mixed, "w") as f:
        f.write(json.dumps(recs[0]) + "\n")
        f.write(json.dumps({"audio": audio, "labels": [1]}) + "\n")
    with pytest.raises(ValueError, match="mixes feats and audio"):
        native.NativeLoader(mixed, CFG, BUCKETS, 2, device="cpu")
    with pytest.raises(ValueError, match="empty manifest"):
        native.NativeLoader(mpath, CFG, BUCKETS, 2, skip_first=4,
                            device="cpu")
    bad = os.path.join(str(tmp_path), "bad.jsonl")
    with open(bad, "w") as f:
        f.write(json.dumps({"labels": [1]}) + "\n")
    with pytest.raises(ValueError, match="bad manifest record"):
        native.NativeLoader(bad, CFG, BUCKETS, 2, device="cpu")


def test_library_is_the_ports_and_built_at_first_use_only():
    """The source lies in the port's csrc/ and includes only the standard
    library (no path into the JAX package's cpp/); the library goes to
    csrc/build/; importing the loader builds and loads nothing."""
    csrc = os.path.join(REPO, "rnn_transducer_tpu_torch", "csrc")
    assert build.LOADER_SOURCE == os.path.join(csrc, "loader.cpp")
    assert os.path.dirname(build.loader_library_path()) == os.path.join(
        csrc, "build")
    with open(build.LOADER_SOURCE) as f:
        includes = [ln for ln in f if ln.startswith("#include")]
    assert includes and all("<" in ln and '"' not in ln for ln in includes)
    code = ("import rnn_transducer_tpu_torch.data.native_loader, "
            "rnn_transducer_tpu_torch.train.__main__, "
            "rnn_transducer_tpu_torch.recognize as r; "
            "from rnn_transducer_tpu_torch.utils import build as b; "
            "print(b._loader_lib is None and b._lib is None)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "True"
    assert native.available()


def test_a_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "loader.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(build, "LOADER_SOURCE", str(src))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(build, "_loader_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build.load_loader_library()
    assert not native.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.NativeLoader("unused.jsonl", CFG, BUCKETS, 2, device="cpu")


def _cli_manifest(tmp_path, audio=False):
    """8 utterances of 20-40 frames at the smoke config's 80 features
    (or their PCM), 2-4 labels."""
    rng = np.random.default_rng(0)
    recs = []
    for i in range(8):
        t = int(rng.integers(20, 40))
        labels = rng.integers(1, 30, size=int(rng.integers(2, 5))).tolist()
        if audio:
            p = tmp_path / f"a{i}.npy"
            np.save(p, (0.1 * rng.normal(size=400 + 160 * (t - 1))).astype(
                np.float32))
            recs.append({"audio": str(p), "labels": labels})
        else:
            p = tmp_path / f"f{i}.npy"
            np.save(p, rng.normal(size=(t, 80)).astype(np.float32))
            recs.append({"feats": str(p), "labels": labels})
    man = tmp_path / "train.jsonl"
    man.write_text("\n".join(json.dumps(r) for r in recs))
    return str(man)


@pytest.mark.parametrize("audio", [False, True])
def test_train_cli_with_native_loader(tmp_path, capsys, audio):
    """--loader native runs the C++ pipeline end to end: three finite
    steps, each record with the batch's wait and step times."""
    man = _cli_manifest(tmp_path, audio)
    log = tmp_path / "log.jsonl"
    train_main(["--config", "smoke", "--steps", "3", "--batch-size", "2",
                "--data", f"manifest:{man}", "--loader", "native",
                "--log-every", "1", "--eval-every", "0", "--log-file",
                str(log), "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["steps"] == 3 and np.isfinite(res["final_loss"])
    recs = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(r["load_ms"] >= 0 and r["step_ms"] > 0 for r in recs)


def test_train_cli_native_refusals(tmp_path):
    man = _cli_manifest(tmp_path)
    base = ["--config", "smoke", "--batch-size", "2", "--device", "cpu",
            "--loader", "native", "--eval-every", "0"]
    with pytest.raises(SystemExit, match="--sortagrad"):
        train_main(base + ["--data", f"manifest:{man}", "--sortagrad"])
    with pytest.raises(SystemExit, match="manifest data"):
        train_main(base)
    d = str(tmp_path / "ck")
    train_main(base + ["--data", f"manifest:{man}", "--steps", "1",
                       "--ckpt-dir", d])
    with pytest.raises(SystemExit, match="--resume-data exact"):
        train_main(base + ["--data", f"manifest:{man}", "--steps", "2",
                           "--ckpt-dir", d, "--resume", "--resume-data",
                           "exact"])
    # a plain --resume restarts the native stream from epoch 0
    train_main(base + ["--data", f"manifest:{man}", "--steps", "2",
                       "--ckpt-dir", d, "--resume"])


def test_decode_cli_with_native_loader(tmp_path, capsys):
    """The decode CLI's --loader native decodes the manifest's utterances
    as the python loader does (WER and count; the batch order is the
    threads')."""
    man = _cli_manifest(tmp_path)
    argv = ["--config", "smoke", "--mode", "greedy", "--data",
            f"manifest:{man}", "--batch-size", "4", "--max-symbols", "8",
            "--device", "cpu"]
    want = rec.main(argv)
    got = rec.main(argv + ["--loader", "native"])
    capsys.readouterr()
    assert got["n"] == want["n"] == 8 and got["wer"] == want["wer"]
    assert got["rtf"] > 0
    with pytest.raises(SystemExit, match="manifest data"):
        rec.main(["--config", "smoke", "--loader", "native", "--device",
                  "cpu"])
