"""PyTorch port of the manifest loader and the decode CLI
(`python -m rnn_transducer_tpu_torch.recognize`) on the CPU.

The manifest's examples against the JAX package's (`load_example`: .npy
feats equal; .npy and raw f32 audio within 1e-3, JAX's native FBANK
bound); the CLI's hypotheses, frames and confidences on a test-written
manifest against the JAX decoders (`recognize_greedy`, `recognize_beam`,
`stream_transcribe`, `stream_transcribe_beam`) run on the JAX package's
own batches of the same manifest, the same params at f32 (tokens and
frames equal, confidences and scores within 2e-4: the 4-place rounding);
its JSON keys against the JAX CLI's; its refusals.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.data import manifest as jman
from rnn_transducer_tpu.data.bucketing import bucket_stream as jax_buckets
from rnn_transducer_tpu.decode import beam as jbeam
from rnn_transducer_tpu.decode import greedy as jgreedy
from rnn_transducer_tpu.decode import streaming as jstream
from rnn_transducer_tpu.models.config import TrainConfig as JaxTrainConfig
from rnn_transducer_tpu_torch import recognize as rec
from rnn_transducer_tpu_torch.data import manifest as tman
from rnn_transducer_tpu_torch.train import checkpoint as ckpt
from rnn_transducer_tpu_torch.train.loop import TrainState
from rnn_transducer_tpu_torch.weights import params_from_numpy
from test_torch_beam import beam_params
from test_torch_greedy import JCFG, TCFG, walking_params

pytestmark = pytest.mark.quick

FEATS_ATOL = 1e-3  # the port's log_mel against JAX's native FBANK
ROUND_ATOL = 2e-4  # both sides' confidences and scores at 4 places
LENGTHS = (40, 33, 21, 7, 45, 16)


# -------------------------------- manifests --------------------------------

def _write_manifest(tmp_path, kinds=("feats",)):
    """A manifest of the LENGTHS utterances: .npy feats of scale 3, or
    audio (.npy or raw f32) of 0.1 noise whose frames are those lengths."""
    rng = np.random.default_rng(7)
    recs = []
    for i, T in enumerate(LENGTHS):
        kind = kinds[i % len(kinds)]
        labels = rng.integers(1, TCFG.vocab_size, size=3 + i % 4).tolist()
        if kind == "feats":
            p = tmp_path / f"f{i}.npy"
            np.save(p, (3 * rng.normal(size=(T, TCFG.input_dim))).astype(
                np.float32))
            recs.append({"feats": str(p), "labels": labels})
            continue
        audio = (0.1 * rng.normal(size=400 + 160 * (T - 1) + 37)).astype(
            np.float32)
        if kind == "npy_audio":
            p = tmp_path / f"a{i}.npy"
            np.save(p, audio)
        else:
            p = tmp_path / f"a{i}.f32"
            audio.tofile(p)
        recs.append({"audio": str(p), "labels": labels})
    man = tmp_path / "m.jsonl"
    man.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    return str(man)


def test_load_example_matches_jax(tmp_path):
    man = _write_manifest(tmp_path, ("feats", "npy_audio", "raw_audio"))
    stats = {"mean": [0.5] * TCFG.input_dim, "std": [2.0] * TCFG.input_dim}
    for r in tman.read_manifest(man):
        for cmvn in (None, stats):
            got, lab = tman.load_example(r, TCFG.input_dim, cmvn=cmvn,
                                         device="cpu")
            want, jlab = jman.load_example(r, TCFG.input_dim, cmvn=cmvn)
            assert got.shape == want.shape and got.dtype == np.float32
            np.testing.assert_array_equal(lab, jlab)
            if "feats" in r:
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, atol=FEATS_ATOL,
                                           rtol=FEATS_ATOL)
        assert tman.example_length(r) == jman.example_length(r) == \
            got.shape[0]
    with pytest.raises(ValueError, match="'feats' or 'audio'"):
        tman.load_example({"labels": [1]}, 8, device="cpu")
    with pytest.raises(ValueError, match="input_dim"):
        tman.load_example(next(tman.read_manifest(man)), 5, device="cpu")


def test_manifest_examples_follow_order_and_cmvn(tmp_path):
    man = _write_manifest(tmp_path)
    stats = {"mean": [1.0] * TCFG.input_dim, "std": [3.0] * TCFG.input_dim}
    got = list(tman.manifest_examples(man, TCFG, order=[4, 0, 2],
                                      cmvn=stats, device="cpu"))
    want = list(jman.manifest_examples(man, JCFG, order=[4, 0, 2],
                                       cmvn=stats))
    assert [g[0].shape[0] for g in got] == [LENGTHS[i] for i in (4, 0, 2)]
    for (f, l), (jf, jl) in zip(got, want):
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(l, jl)


# ------------------------------ the decode CLI ------------------------------

def _ckpt(tmp_path, p, name="ck"):
    """A port checkpoint directory of the numpy params `p` at TCFG."""
    d = str(tmp_path / name)
    ckpt.save_checkpoint(d, 0, TrainState(params=params_from_numpy(p),
                                          opt_state={}, step=0),
                         model_cfg=TCFG)
    return d


def _jax_batches(man):
    """The JAX CLI's batches of the manifest (recognize.py's python
    loader), with the count of real rows."""
    return list(jax_buckets(jman.manifest_examples(man, JCFG),
                            JaxTrainConfig().buckets, 8, blank=JCFG.blank,
                            with_valid=True))


def _jax_hyps(p, man, mode):
    """Per utterance (tokens, input frames, confidences or None, n-best
    [(tokens, score)] or None) from the JAX decoders."""
    jp = jax.tree.map(jnp.asarray, p)
    out = []
    for feats, fl, _, _, n_valid in _jax_batches(man):
        f, l = jnp.asarray(feats), jnp.asarray(fl)
        conf = nb = None
        if mode == "greedy":
            tok, n, conf, fr = jgreedy.recognize_greedy(
                jp, JCFG, f, l, max_symbols=30, with_confidence=True,
                with_timestamps=True)
        elif mode == "beam":
            tok, n, sc, conf, fr = jbeam.recognize_beam(
                jp, JCFG, f, l, beam=4, max_symbols=30, expansions=2,
                with_confidence=True, with_timestamps=True)
        elif mode == "streaming":
            tok, n, fr = jstream.stream_transcribe(
                jp, JCFG, f, l, 16, max_symbols=30, with_timestamps=True)
        else:
            tok, n, sc, fr = jstream.stream_transcribe_beam(
                jp, JCFG, f, l, 16, beam=4, max_symbols=30, expansions=2,
                with_timestamps=True)
        tok, n, fr = (np.asarray(a) for a in (tok, n, fr))
        if tok.ndim == 3:  # beam: the top beam, and the n-best
            sc = np.asarray(sc)
            nb = [[(tok[i, k, :n[i, k]].tolist(), float(sc[i, k]))
                   for k in range(3) if sc[i, k] > -1e29]
                  for i in range(n_valid)]
            tok, n, fr = tok[:, 0], n[:, 0], fr[:, 0]
            conf = None if conf is None else np.asarray(conf)[:, 0]
        for i in range(n_valid):
            out.append((tok[i, :n[i]].tolist(),
                        (fr[i, :n[i]] * JCFG.time_reduction).tolist(),
                        None if conf is None else
                        np.asarray(conf)[i, :n[i]].tolist(),
                        None if nb is None else nb[i]))
    return out


def _port_cli(tmp_path, d, man, mode, extra=()):
    hyps = tmp_path / f"hyps_{mode}.jsonl"
    argv = ["--ckpt-dir", d, "--data", f"manifest:{man}", "--mode", mode,
            "--device", "cpu", "--max-symbols", "30", "--beam", "4",
            "--expansions", "2", "--chunk-frames", "16", "--timestamps",
            "--hyps-file", str(hyps), *extra]
    if mode in ("greedy", "beam"):
        argv.append("--confidence")
    if "beam" in mode:
        argv += ["--nbest", "3"]
    out = rec.main(argv)
    return out, [json.loads(ln) for ln in hyps.read_text().splitlines()]


@pytest.mark.parametrize("mode", ["greedy", "beam", "streaming",
                                  "streaming_beam"])
def test_cli_hyps_match_the_jax_decoders(tmp_path, mode, capsys):
    p = beam_params() if "beam" in mode else walking_params()
    man = _write_manifest(tmp_path)
    out, records = _port_cli(tmp_path, _ckpt(tmp_path, p), man, mode)
    want = _jax_hyps(p, man, mode)
    assert len(records) == len(want) == len(LENGTHS)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out
    refs = [r["labels"] for r in tman.read_manifest(man)]
    for r, (tok, frames, conf, nb), ref in zip(records, want, refs):
        assert r["hyp"] == tok and r["ref"] == ref
        assert r["frames"] == frames
        assert r["times_s"] == [round(f * 0.01, 3) for f in frames]
        if conf is not None:
            np.testing.assert_allclose(r["confs"], conf, atol=ROUND_ATOL)
        if nb is not None:
            assert [h["hyp"] for h in r["nbest"]] == [t for t, _ in nb]
            np.testing.assert_allclose([h["score"] for h in r["nbest"]],
                                       [s for _, s in nb], atol=ROUND_ATOL)
    assert sum(len(w[0]) for w in want) >= len(LENGTHS)
    from rnn_transducer_tpu.decode.metrics import error_rate
    assert out["wer"] == round(error_rate(refs, [w[0] for w in want]), 4)
    assert out["n"] == len(LENGTHS)


def test_cli_word_segments_and_audio_manifest(tmp_path):
    """--tokenizer char: text hyps, words and the word WER; an audio
    manifest is featurized by log_mel on the CLI's device."""
    p = walking_params()
    man = _write_manifest(tmp_path, ("feats", "raw_audio"))
    out, records = _port_cli(tmp_path, _ckpt(tmp_path, p), man, "greedy",
                             ["--tokenizer", "char"])
    assert "word_wer" in out
    for r in records:
        assert isinstance(r["hyp"], str) and isinstance(r["ref"], str)
        assert all(w["end_s"] > w["start_s"] for w in r["words"])


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_cli_prints_the_jax_clis_keys(mode, capsys):
    import recognize as jax_cli

    argv = ["--config", "smoke", "--mode", mode, "--batches", "1",
            "--batch-size", "2", "--beam", "2", "--max-symbols", "20",
            "--tokenizer", "char"]
    jax_cli.main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = rec.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == got
    assert list(got) == list(want)
    assert got["mode"] == mode and got["n"] == want["n"] == 2


@pytest.mark.parametrize("argv, item", [  # explicit ids: stable names
    pytest.param(["--lm-ckpt", "lm"], "item 18", id="argv5-item 18"),
    pytest.param(["--lm-rescore"], "item 18", id="argv6-item 18"),
])
def test_cli_refuses_unported_options_with_their_item(argv, item):
    with pytest.raises(SystemExit, match=item):
        rec.main(argv + ["--device", "cpu"])


def test_cli_refusals(tmp_path, monkeypatch):
    d = _ckpt(tmp_path, walking_params())
    with pytest.raises(SystemExit, match="does not match the checkpoint"):
        rec.main(["--ckpt-dir", d, "--config", "smoke", "--device", "cpu"])
    phrases = tmp_path / "p.txt"
    phrases.write_text("ab\n")
    with pytest.raises(SystemExit, match="requires --mode"):
        rec.main(["--ckpt-dir", d, "--boost-file", str(phrases),
                  "--tokenizer", "char", "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs a tokenizer"):
        rec.main(["--ckpt-dir", d, "--boost-file", str(phrases),
                  "--mode", "beam", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--confidence supports"):
        rec.main(["--ckpt-dir", d, "--mode", "streaming", "--confidence",
                  "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        rec.main(["--ckpt-dir", d])


def test_cli_boost_file_biases_the_beam(tmp_path):
    """--boost-file with the checkpoint's tokenizer: the phrases' trie
    reaches the beam decode (the top beam's score moves)."""
    from rnn_transducer_tpu_torch.data.tokenizer import (CharTokenizer,
                                                         tokenizer_to_meta)

    d = _ckpt(tmp_path, beam_params())
    meta = ckpt.load_meta(d)
    ckpt.save_meta(d, TCFG, tokenizer=tokenizer_to_meta(
        CharTokenizer("abcdefghij")), **{k: v for k, v in meta.items()
                                         if k != "model_config"})
    man = _write_manifest(tmp_path)
    outs = {}
    for boost in ("0.0", "5.0"):
        phrases = tmp_path / f"p{boost}.txt"
        phrases.write_text(f"ab\t{boost}\ncd\t{boost}\n")
        _, outs[boost] = _port_cli(tmp_path, d, man, "beam",
                                   ["--boost-file", str(phrases)])
    assert outs["0.0"] != outs["5.0"]


def test_cli_int8_and_ngram_run(tmp_path):
    from rnn_transducer_tpu_torch.models.ngram import save_ngram, train_ngram

    d = _ckpt(tmp_path, beam_params())
    man = _write_manifest(tmp_path)
    lm = str(tmp_path / "lm3")
    rng = np.random.default_rng(0)
    save_ngram(train_ngram([rng.integers(1, 11, size=6).tolist()
                            for _ in range(20)], 3, 11), lm)
    out, records = _port_cli(tmp_path, d, man, "beam",
                             ["--ngram", lm, "--quantize", "int8"])
    assert out["beam"] == 4 and len(records) == len(LENGTHS)
    with pytest.raises(SystemExit, match="--ngram requires"):
        rec.main(["--ckpt-dir", d, "--ngram", lm, "--device", "cpu"])


def test_tokenizer_recorded_by_the_train_cli(tmp_path, capsys):
    """train --tokenizer writes the JAX package's tokenizer meta; one
    bigger than the model's vocabulary is refused."""
    from rnn_transducer_tpu_torch.data.tokenizer import CharTokenizer
    from rnn_transducer_tpu_torch.train.__main__ import main as train_main

    d = str(tmp_path / "ck")
    args = ["--device", "cpu", "--steps", "1", "--batch-size", "2",
            "--max-frames", "20", "--max-labels", "4", "--ckpt-dir", d]
    train_main(["--tokenizer", "char"] + args)
    assert ckpt.load_meta(d)["tokenizer"] == {
        "kind": "char", "alphabet": CharTokenizer.DEFAULT_ALPHABET}
    with pytest.raises(SystemExit, match="model vocab_size"):
        train_main(["--tokenizer", "phone"] + args)
    capsys.readouterr()
    assert dataclasses.asdict(ckpt.load_model_config(d))["vocab_size"] == 32
