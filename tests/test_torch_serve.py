"""PyTorch port serving: BatchingEngine and http_server on the CPU.

Concurrent requests are batched by the engine and must come back as a
direct `recognize_greedy` (beam mode: `recognize_beam`) of each utterance
alone gives them; the beam engine answers what the JAX package's beam
engine answers; the HTTP front end answers /recognize, /stats and
/healthz and rejects bad bodies.
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from rnn_transducer_tpu_torch.decode.beam import recognize_beam
from rnn_transducer_tpu_torch.decode.greedy import recognize_greedy
from rnn_transducer_tpu_torch import serve as port_serve
from rnn_transducer_tpu_torch.serve import BatchingEngine, http_server
from rnn_transducer_tpu_torch.weights import params_from_numpy
from test_torch_beam import beam_params
from test_torch_greedy import JCFG, TCFG, walking_params

pytestmark = pytest.mark.quick

BUCKETS = (16, 32, 48)
LENGTHS = (40, 7, 33, 21, 48, 12, 3, 29, 16, 45)


@pytest.fixture(scope="module")
def params():
    return params_from_numpy(walking_params())


@pytest.fixture(scope="module")
def engine(params):
    eng = BatchingEngine(params, TCFG, max_symbols=30, frame_buckets=BUCKETS,
                         max_batch=4, window_ms=20.0, device="cpu")
    eng.warmup()
    yield eng
    eng.close()


@pytest.fixture(scope="module")
def server(engine):
    srv = http_server("127.0.0.1", 0, engine, max_body_bytes=1 << 16)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    th.join(timeout=10)
    assert not th.is_alive()


def _utterances():
    rng = np.random.default_rng(5)
    return [(3 * rng.normal(size=(T, TCFG.input_dim))).astype(np.float32)
            for T in LENGTHS]


def _direct(params, feats):
    tok, n, conf, fr = recognize_greedy(
        params, TCFG, torch.from_numpy(feats)[None],
        torch.tensor([feats.shape[0]], dtype=torch.int32), max_symbols=30,
        with_confidence=True, with_timestamps=True)
    n = int(n[0])
    return {"tokens": tok[0, :n].tolist(),
            "confidence": conf[0, :n].tolist(),
            "frames": (fr[0, :n] * TCFG.time_reduction).tolist()}


def _assert_result(got, want):
    assert got["tokens"] == want["tokens"]
    assert got["frames"] == want["frames"]
    np.testing.assert_allclose(got["confidence"], want["confidence"],
                               atol=2e-4)  # the engine rounds to 4 places


def test_concurrent_submits_match_direct_decode(engine, params):
    utts = _utterances()
    results = [None] * len(utts)
    batches_before = engine.stats.summary()["batches"]

    def call(i):
        results[i] = engine.submit_full(utts[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(utts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    for got, feats in zip(results, utts):
        _assert_result(got, _direct(params, feats))
    assert any(r["tokens"] for r in results)
    stats = engine.stats.summary()
    assert stats["max_batch"] > 1  # requests shared a decode
    assert stats["batches"] - batches_before < len(utts)


@pytest.mark.parametrize("feats, match", [
    (np.zeros((5, 3), np.float32), "feats must be"),
    (np.zeros((0, 8), np.float32), "feats must be|empty"),
    (np.zeros((49, 8), np.float32), "largest serving bucket"),
])
def test_submit_rejects_bad_feats(engine, feats, match):
    with pytest.raises(ValueError, match=match):
        engine.submit_full(feats)


def test_closed_engine_rejects_submits(params):
    eng = BatchingEngine(params, TCFG, frame_buckets=BUCKETS, device="cpu")
    eng.close()
    assert not eng._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(np.zeros((4, TCFG.input_dim), np.float32))


# ------------------------------- beam mode -------------------------------

BEAM = dict(mode="beam", beam=4, expansions=3, max_symbols=30,
            frame_buckets=BUCKETS, max_batch=4, window_ms=20.0)


def _direct_beam(params, feats, **fusion):
    """recognize_beam of one utterance, zero-padded to its bucket as the
    engine pads it: an odd length's last frame then stacks with a zero
    frame into one more encoder frame (at every bucket, all even)."""
    T = feats.shape[0]
    padded = np.zeros((min(b for b in BUCKETS if b >= T), feats.shape[1]),
                      np.float32)
    padded[:T] = feats
    tok, n, sc, conf, fr = recognize_beam(
        params, TCFG, torch.from_numpy(padded)[None],
        torch.tensor([T], dtype=torch.int32), beam=4,
        max_symbols=30, expansions=3, with_confidence=True,
        with_timestamps=True, **fusion)
    n0 = int(n[0, 0])
    return {"tokens": tok[0, 0, :n0].tolist(), "score": float(sc[0, 0]),
            "confidence": conf[0, 0, :n0].tolist(),
            "frames": (fr[0, 0, :n0] * TCFG.time_reduction).tolist(),
            "nbest": [{"tokens": tok[0, k, :int(n[0, k])].tolist(),
                       "score": float(sc[0, k])}
                      for k in range(4) if float(sc[0, k]) > -5e29]}


def _assert_beam_result(got, want, atol=2e-4):
    _assert_result(got, want)
    assert abs(got["score"] - want["score"]) <= atol
    assert [b["tokens"] for b in got["nbest"]] == [
        b["tokens"] for b in want["nbest"]]
    np.testing.assert_allclose([b["score"] for b in got["nbest"]],
                               [b["score"] for b in want["nbest"]],
                               atol=atol)


def _concurrent(engine, utts):
    results = [None] * len(utts)

    def call(i):
        results[i] = engine.submit_full(utts[i])

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(utts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    return results


def test_concurrent_beam_submits_match_direct_decode():
    params = params_from_numpy(beam_params())
    eng = BatchingEngine(params, TCFG, device="cpu", **BEAM)
    try:
        utts = _utterances()
        results = _concurrent(eng, utts)
        stats = eng.stats.summary()
    finally:
        eng.close()
    for got, feats in zip(results, utts):
        _assert_beam_result(got, _direct_beam(params, feats))
    assert sum(len(r["tokens"]) for r in results) > len(utts)
    assert max(len(r["nbest"]) for r in results) > 1
    assert stats["max_batch"] > 1  # requests shared a decode


def test_beam_engine_answers_as_the_jax_engine():
    """The same params and requests through the JAX package's
    BatchingEngine(mode="beam") and the port's: tokens, frames and the
    n-best's tokens identical, scores within 1e-4 (plus the 4-place
    rounding both engines apply)."""
    import jax
    import jax.numpy as jnp

    from rnn_transducer_tpu.serve import BatchingEngine as JaxEngine

    p = beam_params()
    jeng = JaxEngine(jax.tree.map(jnp.asarray, p), JCFG, **BEAM)
    teng = BatchingEngine(params_from_numpy(p), TCFG, device="cpu", **BEAM)
    try:
        for feats in _utterances()[:5]:
            want, got = jeng.submit_full(feats), teng.submit_full(feats)
            _assert_beam_result(got, want, atol=1e-4 + 1e-4)
    finally:
        jeng.close()
        teng.close()


def test_beam_engine_serves_context_and_ngram():
    from rnn_transducer_tpu_torch.decode.context import build_context_bias
    from rnn_transducer_tpu_torch.models.ngram import train_ngram

    params = params_from_numpy(beam_params())
    rng = np.random.default_rng(9)
    seqs = [rng.integers(1, TCFG.vocab_size, size=6).tolist()
            for _ in range(30)]
    fusion = {"context": build_context_bias([[3, 4], [7]],
                                            TCFG.vocab_size, boost=1.5),
              "ngram": (train_ngram(seqs, 3, TCFG.vocab_size), 0.5)}
    eng = BatchingEngine(params, TCFG, device="cpu", **BEAM, **fusion)
    try:
        feats = _utterances()[0]
        _assert_beam_result(eng.submit_full(feats),
                            _direct_beam(params, feats, **fusion))
    finally:
        eng.close()


@pytest.mark.parametrize("fusion", ["context", "ngram"])
def test_greedy_engine_refuses_context_and_ngram(params, fusion):
    with pytest.raises(ValueError, match="mode='beam'"):
        BatchingEngine(params, TCFG, device="cpu", **{fusion: object()})


def test_unknown_mode_is_refused(params):
    with pytest.raises(ValueError, match="unknown mode"):
        BatchingEngine(params, TCFG, mode="sample", device="cpu")


def test_cli_ngram_needs_beam_mode_and_the_model_vocab(tmp_path):
    from rnn_transducer_tpu_torch.models.ngram import save_ngram, train_ngram

    with pytest.raises(SystemExit, match="--ngram requires --mode beam"):
        port_serve.main(["--ngram", str(tmp_path / "none")])
    path = str(tmp_path / "lm3")
    save_ngram(train_ngram([[1, 2, 3]], 3, 11), path)
    with pytest.raises(SystemExit, match="n-gram vocab 11 != model vocab"):
        port_serve.main(["--mode", "beam", "--ngram", path])


def _request(url, method="GET", body=None):
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_recognize_stats_healthz(server, params):
    feats = _utterances()[2]
    code, out = _request(f"{server}/recognize", "POST",
                         {"feats": feats.tolist()})
    assert code == 200
    _assert_result(out, _direct(params, feats))
    assert _request(f"{server}/healthz") == (200, {"ok": True})
    code, stats = _request(f"{server}/stats")
    assert code == 200 and stats["offline"]["requests"] >= 1


@pytest.mark.parametrize("body, code, match", [
    (b"{not json", 400, "JSON|Expecting"),
    ({"feats": [[1.0, 2.0]]}, 400, "feats must be"),
    ({"audio": [0.0] * 160}, 400, "not yet ported"),
    ({"nothing": 1}, 400, "needs 'feats'"),
    ({"feats": [[0.0] * 8] * 2000}, 413, "exceeds cap"),
])
def test_http_rejects_bad_bodies(server, body, code, match):
    got, out = _request(f"{server}/recognize", "POST", body)
    assert got == code
    assert any(m in out["error"] for m in match.split("|"))


@pytest.mark.parametrize("method, path", [
    ("POST", "/session"), ("POST", "/session/abc"), ("DELETE", "/session/abc"),
    ("GET", "/nope"),
])
def test_http_session_routes_are_not_found(server, method, path):
    assert _request(f"{server}{path}", method,
                    {} if method == "POST" else None)[0] == 404


def test_cli_flags_keep_the_jax_names_and_defaults():
    import serve as jax_serve_cli

    port = vars(port_serve.parse_args([]))
    jax_args = vars(jax_serve_cli.parse_args([]))
    assert port.pop("state_dict") is None  # replaces --ckpt-dir
    for name, value in port.items():
        assert jax_args[name] == value, name


def test_cli_refuses_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        port_serve.main(["--config", "libri100"])


@pytest.mark.parametrize("name", [None, "smoke", "libri100"])
def test_cli_config_names(name):
    import train

    want = train.get_model_config(name or "smoke")
    got = port_serve.get_model_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
