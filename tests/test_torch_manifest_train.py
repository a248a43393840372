"""The port's training data (data/manifest.py's training half, its
prepare tool) and the training CLI on manifest data, on the CPU.

`manifest_batches`, `fast_forward_state` and `manifest_dev_batch` against
the JAX package's on the same manifests, bit for bit (SortaGrad on and
off, a shuffle seed, a held-out first batch, every cut of a resumed
stream); `python -m rnn_transducer_tpu_torch.tools.prepare_manifest`
against JAX's tools/prepare_manifest.py on one tiny corpus per layout
(records and labels equal, features within 1e-3: JAX computes them in
its native frontend, the port in `log_mel`); the CLI's exact resume with
augmentation, dropout, weight noise and EMA on, bit-equal to an
uninterrupted run; SIGTERM to a CLI process (one rank, and two gloo
ranks stopping after one step); and the CLI's refusals.
"""

import itertools
import json
import os
import signal
import subprocess
import sys
import threading
import wave

import numpy as np
import pytest
import torch

from rnn_transducer_tpu_torch.data import manifest as pm
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.train import checkpoint as ckpt
from rnn_transducer_tpu_torch.train.__main__ import main as train_main

pytestmark = pytest.mark.quick

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LENGTHS = [5, 12, 7, 15, 4, 9, 14, 6, 11, 3, 13, 8, 20]
LABEL_LENS = [2, 4, 3, 5, 1, 2, 4, 3, 5, 1, 2, 3, 2]
BUCKETS = ((8, 3), (16, 5))


def _manifest(tmp_path, lengths=LENGTHS, label_lens=LABEL_LENS, dim=8,
              vocab=16, name="m.jsonl"):
    rng = np.random.default_rng(0)
    recs = []
    for i, t in enumerate(lengths):
        p = tmp_path / f"{name}.f{i}.npy"
        np.save(p, rng.normal(size=(t, dim)).astype(np.float32))
        recs.append({"feats": str(p), "labels": rng.integers(
            1, vocab, size=label_lens[i]).tolist()})
    m = tmp_path / name
    m.write_text("\n".join(json.dumps(r) for r in recs))
    return str(m)


def _cfgs(batch_size=2):
    from rnn_transducer_tpu.models import config as jc
    kw = dict(input_dim=8, vocab_size=16)
    tkw = dict(batch_size=batch_size, buckets=BUCKETS)
    return (port_config.TransducerConfig(**kw),
            port_config.TrainConfig(**tkw), jc.TransducerConfig(**kw),
            jc.TrainConfig(**tkw))


def _take(stream, n):
    return [tuple(np.asarray(a) for a in b)
            for b in itertools.islice(stream, n)]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)


STREAMS = {
    "manifest_order": dict(),
    "shuffled": dict(shuffle_seed=3),
    "sortagrad": dict(sortagrad=True),
    "sortagrad_shuffled_skip": dict(sortagrad=True, shuffle_seed=11,
                                    skip_first=2),
    "skip_first": dict(skip_first=1, shuffle_seed=5),
}


@pytest.mark.parametrize("kind", sorted(STREAMS))
def test_manifest_batches_equal_jax(kind, tmp_path):
    from rnn_transducer_tpu.data import manifest as jm
    m = _manifest(tmp_path)
    cfg, tcfg, jcfg, jtcfg = _cfgs()
    kw = STREAMS[kind]
    n = 20  # about three epochs
    want = _take(jm.manifest_batches(m, jcfg, jtcfg, **kw), n)
    got = _take(pm.manifest_batches(m, cfg, tcfg, device="cpu", **kw), n)
    _assert_equal(got, want)


@pytest.mark.parametrize("kind", ["shuffled", "sortagrad_shuffled_skip"])
def test_resumed_stream_equals_uninterrupted_at_every_cut(kind, tmp_path):
    """Every cut over about three epochs (mid-epoch, inside the flush, on
    an epoch's edge): the resumed stream goes on with the uninterrupted
    one's batches, and JAX's fast-forward state is the port's."""
    from rnn_transducer_tpu.data import manifest as jm
    m = _manifest(tmp_path)
    cfg, tcfg, jcfg, jtcfg = _cfgs()
    kw = STREAMS[kind]
    total = 18
    want = _take(pm.manifest_batches(m, cfg, tcfg, device="cpu", **kw),
                 total + 3)
    ff = {k: v for k, v in kw.items()}
    for cut in range(1, total):
        got = _take(pm.manifest_batches(m, cfg, tcfg, resume_batches=cut,
                                        device="cpu", **kw), 3)
        _assert_equal(got, want[cut:cut + 3])
        assert pm.fast_forward_state(m, tcfg, cut, **ff) == \
            jm.fast_forward_state(m, jtcfg, cut, **ff)


def test_fast_forward_is_metadata_only(tmp_path, monkeypatch):
    m = _manifest(tmp_path)
    _, tcfg, _, _ = _cfgs()

    def boom(*a, **k):
        raise AssertionError("fast_forward_state loaded a payload")

    monkeypatch.setattr(pm, "load_example", boom)
    epoch, pos, pending, in_flush = pm.fast_forward_state(
        m, tcfg, 9, sortagrad=True, shuffle_seed=2)
    assert epoch >= 1 and isinstance(in_flush, bool)
    assert all(0 <= i < len(LENGTHS) for i in pending)
    assert pm.fast_forward_state(m, tcfg, 0) == (0, 0, [], False)


def test_no_batch_raises_and_dev_batch_equals_jax(tmp_path):
    from rnn_transducer_tpu.data import manifest as jm
    cfg, tcfg, jcfg, jtcfg = _cfgs()
    tiny = _manifest(tmp_path, [5, 6], [1, 1], name="tiny.jsonl")
    with pytest.raises(ValueError, match="produced no training batches"):
        next(pm.manifest_batches(tiny, cfg, tcfg, skip_first=2,
                                 device="cpu"))
    too_long = _manifest(tmp_path, [40, 50], [1, 1], name="long.jsonl")
    with pytest.raises(ValueError, match="produced no training batches"):
        next(pm.manifest_batches(too_long, cfg, tcfg, device="cpu"))
    assert pm.manifest_dev_batch(too_long, cfg, tcfg, device="cpu") is None
    m = _manifest(tmp_path)
    for bs in (2, 5):
        cfg, tcfg, jcfg, jtcfg = _cfgs(bs)
        got = pm.manifest_dev_batch(m, cfg, tcfg, device="cpu")
        want = jm.manifest_dev_batch(m, jcfg, jtcfg)
        assert len(got) == 5 and got[4] == want[4]
        _assert_equal([got[:4]], [want[:4]])


# ----------------------------- prepare tool -------------------------------

TEXTS = ["hello world", "the quick brown fox", "jumps over the dog",
         "a lazy afternoon"]
PHONES = ["h# sh iy hh ae d h#", "h# dh ax k w ih k h#", "h# b r aw n h#",
          "h# f aa k s h#"]


def _pcm(n, seed):
    return (np.random.default_rng(seed).normal(size=n) * 3000).astype(
        np.int16)


def _write_wav(path, n, seed):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(_pcm(n, seed).tobytes())


def _write_sphere(path, n, seed):
    lines = ["NIST_1A", "   1024", "sample_rate -i 16000",
             "sample_coding -s3 pcm", "sample_byte_format -s2 01",
             "end_head"]
    head = ("\n".join(lines) + "\n").encode().ljust(1024, b" ")
    path.write_bytes(head + _pcm(n, seed).tobytes())


def _corpus(root, layout):
    root.mkdir()
    if layout == "paired":
        for i, text in enumerate(TEXTS):
            _write_wav(root / f"utt{i}.wav", 6000 + 800 * i, i)
            (root / f"utt{i}.txt").write_text(text)
        return ["--tokenizer", "char"]
    if layout == "librispeech":
        d = root / "19" / "198"
        d.mkdir(parents=True)
        lines = []
        for i, text in enumerate(TEXTS):
            _write_wav(d / f"19-198-{i:04d}.wav", 5000 + 700 * i, 10 + i)
            lines.append(f"19-198-{i:04d} {text.upper()}")
        (d / "19-198.trans.txt").write_text("\n".join(lines) + "\n")
        return ["--tokenizer", "bpe", "--vocab-size", "40"]
    for i, phones in enumerate(PHONES):  # timit: SPHERE .wav + .phn
        _write_sphere(root / f"si{i}.wav", 4000 + 900 * i, 20 + i)
        (root / f"si{i}.phn").write_text("\n".join(
            f"{k * 100} {(k + 1) * 100} {p}"
            for k, p in enumerate(phones.split())) + "\n")
    return ["--tokenizer", "phone"]


@pytest.mark.parametrize("layout", ["paired", "librispeech", "timit"])
def test_prepare_tool_equals_jax(layout, tmp_path, capsys):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import prepare_manifest as jax_tool

    from rnn_transducer_tpu_torch.tools import prepare_manifest as tool

    corpus = tmp_path / "corpus"
    extra = ["--in-dir", str(corpus), "--layout", layout] + _corpus(
        corpus, layout)
    jax_tool.main(extra + ["--out-dir", str(tmp_path / "jax")])
    want_sum = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got_sum = tool.main(extra + ["--out-dir", str(tmp_path / "port"),
                                 "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got_sum
    assert got_sum["utts"] == want_sum["utts"] == 4
    assert (got_sum["skipped"], got_sum["vocab_size"]) == \
        (want_sum["skipped"], want_sum["vocab_size"])
    if layout == "librispeech":
        assert json.load(open(got_sum["bpe_model"])) == \
            json.load(open(want_sum["bpe_model"]))
    got = list(pm.read_manifest(got_sum["manifest"]))
    want = list(pm.read_manifest(want_sum["manifest"]))
    assert [(r["labels"], r["text"]) for r in got] == \
        [(r["labels"], r["text"]) for r in want]
    for g, w in zip(got, want):
        a, b = np.load(g["feats"]), np.load(w["feats"])
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)


def test_prepare_tool_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    from rnn_transducer_tpu_torch.tools import prepare_manifest as tool
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main(["--in-dir", str(tmp_path), "--out-dir",
                   str(tmp_path / "o")])


# --------------------------------- CLI ------------------------------------

REGULARIZED = ["--sortagrad", "--spec-augment", "--spec-augment-warp", "4",
               "--speed-perturb", "0.9,1.0,1.1", "--dropout", "0.2",
               "--embed-dropout", "0.1", "--weight-noise", "0.01",
               "--ema-decay", "0.9"]


def _cli_corpus(tmp_path, n=12):
    rng = np.random.default_rng(0)
    recs = []
    for i in range(n):
        t = int(rng.integers(20, 60))
        p = tmp_path / f"u{i}.npy"
        np.save(p, rng.normal(size=(t, 80)).astype(np.float32))
        recs.append({"feats": str(p), "labels": rng.integers(
            1, 32, size=int(rng.integers(2, 6))).tolist()})
    man = tmp_path / "m.jsonl"
    man.write_text("\n".join(json.dumps(r) for r in recs))
    return str(man)


def _argv(man, steps, ck, *extra):
    return ["--config", "smoke", "--data", f"manifest:{man}", "--steps",
            str(steps), "--batch-size", "2", "--ckpt-dir", ck,
            "--log-every", "1", "--seed", "5", "--device", "cpu",
            "--eval-every", "2", *extra]


def _leaves_equal(a, b):
    la, lb = (torch.utils._pytree.tree_leaves(x) for x in (a, b))
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def test_cli_resume_exact_equals_uninterrupted(tmp_path, capsys):
    """Run A trains 6 steps straight; run B trains 3, checkpoints, and
    resumes (--resume-data exact, the default) to 6. With augmentation,
    dropout, weight noise and EMA on, B's params, Adam state and EMA
    equal A's bit for bit, and so do its logged losses at steps 4-6."""
    man = _cli_corpus(tmp_path)

    def run(steps, ck, log, resume=False):
        train_main(_argv(man, steps, ck, *REGULARIZED, "--log-file", log,
                         *(["--resume"] if resume else [])))
        capsys.readouterr()
        return {r["step"]: r["loss"] for r in map(json.loads, open(log))
                if "loss" in r}

    la = run(6, str(tmp_path / "A"), str(tmp_path / "a.jsonl"))
    run(3, str(tmp_path / "B"), str(tmp_path / "b1.jsonl"))
    assert ckpt.latest_step(str(tmp_path / "B")) == 3
    lb = run(6, str(tmp_path / "B"), str(tmp_path / "b2.jsonl"),
             resume=True)
    assert [la[s] for s in (4, 5, 6)] == [lb[s] for s in (4, 5, 6)]
    a, _ = ckpt.restore_checkpoint(str(tmp_path / "A"))
    b, _ = ckpt.restore_checkpoint(str(tmp_path / "B"))
    assert a.step == b.step == 6
    assert _leaves_equal(a.params, b.params)
    assert _leaves_equal(a.opt_state, b.opt_state)
    assert a.ema is not None and _leaves_equal(a.ema, b.ema)
    dev = [r for r in map(json.loads, open(tmp_path / "a.jsonl"))
           if "dev_loss" in r]
    assert [r["step"] for r in dev] == [2, 4, 6]
    assert all(np.isfinite(r["dev_loss"]) and r["dev_per"] >= 0
               for r in dev)
    meta = ckpt.load_meta(str(tmp_path / "A"))
    assert meta["train_config"]["ema_decay"] == 0.9
    assert meta["train_config"]["dropout"] == 0.2


def test_cli_resume_fresh_restarts_the_stream(tmp_path, capsys):
    man = _cli_corpus(tmp_path)
    ck = str(tmp_path / "ck")
    log = str(tmp_path / "l.jsonl")
    train_main(_argv(man, 2, ck, "--log-file", log))
    train_main(_argv(man, 4, ck, "--resume", "--resume-data", "fresh",
                     "--log-file", log))
    capsys.readouterr()
    losses = {r["step"]: r["loss"] for r in map(json.loads, open(log))
              if "loss" in r}
    assert sorted(losses) == [1, 2, 3, 4]
    assert ckpt.latest_step(ck) == 4


def _popen(argv, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "rnn_transducer_tpu_torch.train", *argv],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _term_after_step(proc, step: int) -> str:
    """Read the CLI's stderr until its log shows `step`, send SIGTERM,
    and return all of its stderr and its stdout (the process is killed
    if it logs nothing for 120 s)."""
    seen = []
    watchdog = threading.Timer(120, proc.kill)
    watchdog.start()
    try:
        for line in proc.stderr:
            seen.append(line)
            if (line.startswith("{")
                    and json.loads(line).get("step", 0) >= step):
                proc.send_signal(signal.SIGTERM)
                break
        rest = proc.communicate(timeout=120)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return "".join(seen) + rest[1], rest[0]


def test_sigterm_checkpoints_and_resumes(tmp_path):
    """SIGTERM after step 2 of 100: the CLI finishes its step, writes a
    checkpoint there, exits 0; --resume goes on from that step."""
    man = _cli_corpus(tmp_path)
    ck = str(tmp_path / "ck")
    proc = _popen(_argv(man, 100, ck, "--eval-every", "0"), tmp_path)
    err, out = _term_after_step(proc, 2)
    assert proc.returncode == 0, err
    final = json.loads(out.strip().splitlines()[-1])
    stopped = final["steps"]
    assert 2 <= stopped < 100 and ckpt.latest_step(ck) == stopped
    assert f"SIGTERM: rank 0 stops after step {stopped}" in err
    state = train_main(_argv(man, stopped + 2, ck, "--resume"))
    assert state.step == stopped + 2 and ckpt.latest_step(ck) == stopped + 2


def test_sigterm_stops_two_ranks_after_one_step(tmp_path):
    """Two gloo ranks: SIGTERM to rank 0 alone stops both after the same
    step (agreed by an all-reduce), so neither waits for the other."""
    man = _cli_corpus(tmp_path)
    ck = str(tmp_path / "ck")
    proc = _popen(_argv(man, 100, ck, "--data-parallel", "2",
                        "--eval-every", "0", "--dropout", "0.1"), tmp_path)
    err, out = _term_after_step(proc, 2)
    assert proc.returncode == 0, err
    stopped = json.loads(out.strip().splitlines()[-1])["steps"]
    assert ckpt.latest_step(ck) == stopped
    for r in (0, 1):
        assert f"SIGTERM: rank {r} stops after step {stopped}" in err, err


@pytest.mark.parametrize("argv, words", [
    (["--cmvn", "stats.json"], "--cmvn requires manifest data"),
    (["--resume-data", "exact"], "--resume-data exact requires manifest"),
    (["--data", "tfrecord:x"], "'synthetic' or 'manifest:<path>'"),
])
def test_cli_refusals_on_synthetic_data(argv, words):
    with pytest.raises(SystemExit, match=words):
        train_main(["--config", "smoke", "--device", "cpu", "--steps", "1",
                    *argv])


def test_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    man = _cli_corpus(tmp_path, 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_main(["--config", "smoke", "--data", f"manifest:{man}"])
