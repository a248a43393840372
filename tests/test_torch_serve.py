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
    # shorter than one 400-sample window: no frame, as the JAX server's
    # native frontend gives it
    ({"audio": [0.0] * 160}, 400, "empty utterance"),
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
    assert port.pop("state_dict") is None  # the port's own, beside --ckpt-dir
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


# ------------------------------ streaming --------------------------------

STREAM = dict(slots=4, chunk_frames=8, max_symbols=30, window_ms=20.0)


def _stream_utts():
    """Utterances of 16-40 frames: whole 8-frame chunks and short last
    chunks (odd lengths too: the last chunk's stacked pair then holds one
    zero frame, as the offline engine's bucket padding gives it)."""
    rng = np.random.default_rng(11)
    return [(3 * rng.normal(size=(T, TCFG.input_dim))).astype(np.float32)
            for T in (16, 21, 40, 13, 32, 27)]


def _feed_all(engine, feats, chunk=8, full=True):
    """Every chunk of one utterance to a new session -> (the last
    feed_full result, close_session's tokens)."""
    sid = engine.open_session()
    for t0 in range(0, feats.shape[0], chunk):
        out = engine.feed_full(sid, feats[t0:t0 + chunk])
    return out, engine.close_session(sid)


@pytest.fixture(scope="module")
def streaming(params):
    eng = port_serve.StreamingEngine(params, TCFG, device="cpu", **STREAM)
    eng.warmup()
    yield eng
    eng.close()


def test_streaming_sessions_match_the_offline_engine(streaming, engine):
    """Concurrent sessions on the slots give each utterance the offline
    engine's tokens, confidences and frames; a freed slot starts clean."""
    utts = _stream_utts()
    results = [None] * len(utts)

    def call(i):
        results[i] = _feed_all(streaming, utts[i])

    for wave in (range(4), range(4, 6)):  # as many sessions as slots
        threads = [threading.Thread(target=call, args=(i,)) for i in wave]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    for (out, final), feats in zip(results, utts):
        want = engine.submit_full(feats)
        assert out["tokens"] == final == want["tokens"]
        assert out["frames"] == want["frames"]
        assert out["stable_len"] == len(out["tokens"])
        np.testing.assert_allclose(out["confidence"], want["confidence"],
                                   atol=2e-4)
    assert sum(len(r[1]) for r in results) > len(utts)
    assert streaming.stats.summary()["max_batch"] > 1
    # 6 sessions went through 4 slots: freed slots were reset
    out, _ = _feed_all(streaming, utts[0])
    assert out["tokens"] == results[0][1]


def _jax_stream_engine(p, **kw):
    import jax
    import jax.numpy as jnp

    from rnn_transducer_tpu.serve import StreamingEngine as JaxStreaming

    return JaxStreaming(jax.tree.map(jnp.asarray, p), JCFG, **kw)


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_streaming_engine_answers_as_the_jax_engine(mode):
    """The same params and chunks through the JAX package's
    StreamingEngine and the port's: every feed_full dict (tokens, frames,
    stable_len, endpointing; beam: the n-best) and close_session's tokens
    equal, confidences and scores within 1e-4 plus the 4-place rounding
    both engines apply."""
    p = beam_params() if mode == "beam" else walking_params()
    kw = dict(STREAM, endpoint_frames=6, mode=mode,
              **({"beam": 4, "expansions": 3} if mode == "beam" else {}))
    jeng = _jax_stream_engine(p, **kw)
    teng = port_serve.StreamingEngine(params_from_numpy(p), TCFG,
                                      device="cpu", **kw)
    try:
        for feats in _stream_utts()[:4]:
            sids = jeng.open_session(), teng.open_session()
            for t0 in range(0, feats.shape[0], 8):
                want, got = (e.feed_full(s, feats[t0:t0 + 8])
                             for e, s in zip((jeng, teng), sids))
                assert set(got) == set(want)
                for key in ("tokens", "frames", "stable_len",
                            "trailing_frames", "endpoint"):
                    assert got[key] == want[key], key
                np.testing.assert_allclose(got["confidence"],
                                           want["confidence"], atol=2e-4)
                if mode == "beam":
                    assert abs(got["score"] - want["score"]) <= 2e-4
                    assert [h["tokens"] for h in got["nbest"]] == [
                        h["tokens"] for h in want["nbest"]]
                    np.testing.assert_allclose(
                        [h["score"] for h in got["nbest"]],
                        [h["score"] for h in want["nbest"]], atol=2e-4)
            assert teng.close_session(sids[1]) == \
                jeng.close_session(sids[0])
    finally:
        jeng.close()
        teng.close()


def test_streaming_short_chunk_ends_session(params, streaming):
    feats = _stream_utts()[1]  # 21 frames: 8 + 8 + 5
    sid = streaming.open_session()
    streaming.feed(sid, feats[:8])
    streaming.feed(sid, feats[8:13])  # short -> the last chunk
    with pytest.raises(ValueError, match="last chunk"):
        streaming.feed(sid, feats[13:21])
    final = streaming.close_session(sid)
    with pytest.raises(KeyError):
        streaming.feed(sid, feats[:8])
    with pytest.raises(KeyError):
        streaming.close_session(sid)
    sid = streaming.open_session()
    streaming.feed(sid, feats[:8])
    assert streaming.feed(sid, feats[8:13], last=False) == final
    for bad, match in ((np.zeros((9, 8), np.float32), "outside"),
                       (np.zeros((8, 3), np.float32), "chunk must be")):
        with pytest.raises(ValueError, match=match):
            streaming.feed(sid, bad)
    streaming.close_session(sid)


def test_streaming_ttl_reaps_abandoned_sessions(params):
    import time as _time

    eng = port_serve.StreamingEngine(params, TCFG, slots=2, chunk_frames=8,
                                     max_symbols=30, window_ms=1.0,
                                     session_ttl_s=0.05, device="cpu")
    try:
        eng.open_session()
        eng.open_session()  # both slots taken, the clients vanish
        with pytest.raises(RuntimeError, match="slots busy"):
            eng.session_ttl_s = 60.0
            eng.open_session()
        eng.session_ttl_s = 0.05
        _time.sleep(0.1)
        sid = eng.open_session()  # reaps an expired session
        assert sid in eng._live and len(eng._live) == 1
    finally:
        eng.close()


def test_streaming_closed_engine_rejects_feed_and_open(params):
    eng = port_serve.StreamingEngine(params, TCFG, slots=2, chunk_frames=8,
                                     device="cpu")
    sid = eng.open_session()
    eng.close()
    assert not eng._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        eng.feed(sid, np.zeros((8, TCFG.input_dim), np.float32))
    with pytest.raises(RuntimeError, match="closed"):
        eng.open_session()


def test_streaming_endpointing():
    """With endpoint_frames set, partial results carry trailing_frames
    (input frames since the last emission) and the endpoint flag; without
    it, neither key."""
    silent = walking_params()
    silent["joint"]["out"]["b"][JCFG.blank] += 50.0  # nothing is emitted
    eng = port_serve.StreamingEngine(params_from_numpy(silent), TCFG,
                                     slots=1, chunk_frames=8, window_ms=1.0,
                                     endpoint_frames=12, device="cpu")
    try:
        feats = _stream_utts()[2]
        sid = eng.open_session()
        out = eng.feed_full(sid, feats[:8])
        assert out["tokens"] == [] and out["trailing_frames"] == 8
        assert out["endpoint"] is False
        out = eng.feed_full(sid, feats[8:16])
        assert out["trailing_frames"] == 16 and out["endpoint"] is True
    finally:
        eng.close()
    eng = port_serve.StreamingEngine(params_from_numpy(walking_params()),
                                     TCFG, slots=1, chunk_frames=8,
                                     window_ms=1.0, device="cpu")
    try:
        out, _ = _feed_all(eng, _stream_utts()[0])
        assert "endpoint" not in out and "trailing_frames" not in out
    finally:
        eng.close()


@pytest.mark.parametrize("fusion", ["context", "ngram", "lm"])
def test_streaming_greedy_engine_refuses_fusion(params, fusion):
    lm = (None, object(), 0.3)
    with pytest.raises(ValueError, match="mode='beam'"):
        port_serve.StreamingEngine(params, TCFG, device="cpu",
                                   **{fusion: lm if fusion == "lm"
                                      else object()})


def test_streaming_beam_engine_serves_context_and_ngram():
    """The fusion tables ride through the beam slots: a session's answer
    is the direct stream_transcribe_beam of its utterance."""
    from rnn_transducer_tpu_torch.decode.context import build_context_bias
    from rnn_transducer_tpu_torch.decode.streaming import \
        stream_transcribe_beam
    from rnn_transducer_tpu_torch.models.ngram import train_ngram

    params = params_from_numpy(beam_params())
    rng = np.random.default_rng(9)
    seqs = [rng.integers(1, TCFG.vocab_size, size=6).tolist()
            for _ in range(30)]
    fusion = {"context": build_context_bias([[3, 4], [7]],
                                            TCFG.vocab_size, boost=1.5),
              "ngram": (train_ngram(seqs, 3, TCFG.vocab_size), 0.5)}
    eng = port_serve.StreamingEngine(params, TCFG, mode="beam", beam=4,
                                     device="cpu", **STREAM, **fusion)
    try:
        for feats in _stream_utts()[:2]:
            out, final = _feed_all(eng, feats)
            tok, n, sc = stream_transcribe_beam(
                params, TCFG, torch.from_numpy(feats)[None],
                torch.tensor([feats.shape[0]]), 8, beam=4, max_symbols=30,
                device="cpu", **fusion)
            assert final == out["tokens"] == tok[0, 0, :n[0, 0]].tolist()
            assert abs(out["score"] - float(sc[0, 0])) <= 2e-4
            assert len(out["nbest"]) > 1
    finally:
        eng.close()


def test_int8_ragged_streaming_matches_direct_stream_chunk(monkeypatch):
    """int8 params on the W8A8 route (8 slots, H=128) and sessions of
    different lengths: a batch tile's rows share one requantisation scale,
    so idle and short rows move the others' bits (ROADMAP §3). Each
    session's answer is that of the direct stream_chunk of the same slot
    layout, tick by tick, with the idle rows re-selected."""
    from rnn_transducer_tpu_torch.decode import streaming as ts
    from rnn_transducer_tpu_torch.ops import lstm_int8_cuda
    from rnn_transducer_tpu_torch.ops.quant import quantize_params
    from rnn_transducer_tpu_torch.models import transducer as tm

    cfg = dataclasses.replace(TCFG, enc_hidden=128)
    rng = np.random.default_rng(7)
    p = tm.init_params(cfg, rng, "cpu")
    p["joint"]["out"]["b"][cfg.blank] += 0.11  # rows emit at several frames
    qp = quantize_params(p)
    calls = []
    real = lstm_int8_cuda.lstm_recurrence_int8

    def spy(*a):
        calls.append(a[0].shape[0])
        return real(*a)

    monkeypatch.setattr(lstm_int8_cuda, "lstm_recurrence_int8", spy)
    lengths = (32, 21, 8, 27, 16, 32, 13)  # 7 sessions, one idle slot
    utts = [(3 * rng.normal(size=(T, 8))).astype(np.float32)
            for T in lengths]
    eng = port_serve.StreamingEngine(qp, cfg, slots=8, chunk_frames=8,
                                     max_symbols=30, window_ms=500.0,
                                     device="cpu")
    try:
        sids = [eng.open_session() for _ in utts]
        slots = [eng._live[s] for s in sids]
        results = {}
        for r in range(4):  # one tick a round: the sessions with a chunk
            def call(i):
                results[i] = eng.feed_full(sids[i], utts[i][8 * r:8 * r + 8])

            threads = [threading.Thread(target=call, args=(i,))
                       for i, u in enumerate(utts) if len(u) > 8 * r]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
        ticks = eng.stats.summary()["batches"]
    finally:
        eng.close()
    assert ticks == 4 and calls and set(calls) == {8}
    # the direct reference on the same slot layout
    state = ts.init_stream(qp, cfg, 8, 30, device="cpu")
    for r in range(4):
        chunks = torch.zeros((8, 8, 8))
        lens = torch.zeros((8,), dtype=torch.int32)
        for u, s in zip(utts, slots):
            c = torch.from_numpy(u[8 * r:8 * r + 8])
            chunks[s, :len(c)] = c
            lens[s] = len(c)
        new, tok, n = ts.stream_chunk(qp, cfg, state, chunks, lens, 30)
        state = ts.select_rows(lens > 0, new, state)
    for i, s in enumerate(slots):
        assert results[i]["tokens"] == tok[s, :n[s]].tolist()
    assert sum(len(r["tokens"]) for r in results.values()) > 0


def test_http_session_routes(params, engine, streaming):
    """/session over HTTP: open, feed (the last chunk short), close; the
    answer is the offline engine's; /stats gains "streaming"; an 'audio'
    body shorter than a window completes no frame and answers pending
    frames; an unknown session answers 400."""
    srv = http_server("127.0.0.1", 0, engine, streaming,
                      max_body_bytes=1 << 20)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        feats = _stream_utts()[1]
        code, out = _request(f"{url}/session", "POST", {})
        assert code == 200
        sid = out["sid"]
        for t0 in range(0, 21, 8):
            code, out = _request(f"{url}/session/{sid}", "POST",
                                 {"feats": feats[t0:t0 + 8].tolist(),
                                  "last": t0 + 8 >= 21})
            assert code == 200
        code, final = _request(f"{url}/session/{sid}", "DELETE")
        want = engine.submit_full(feats)
        assert code == 200 and final == {"tokens": want["tokens"]}
        assert out["tokens"] == want["tokens"]
        assert out["frames"] == want["frames"]
        code, stats = _request(f"{url}/stats")
        assert code == 200 and stats["streaming"]["requests"] >= 3
        # a body on POST /session is read before the reply
        code, out = _request(f"{url}/session", "POST",
                             {"pad": "x" * (1 << 19)})
        assert code == 200
        sid = out["sid"]
        code, out = _request(f"{url}/session/{sid}", "POST",
                             {"audio": [0.0] * 160})
        assert code == 200 and out["pending_frames"] == 0
        assert out["tokens"] == []
        assert _request(f"{url}/session/{sid}", "DELETE")[0] == 200
        for method in ("POST", "DELETE"):
            code, out = _request(f"{url}/session/nope", method,
                                 {"feats": feats[:8].tolist()}
                                 if method == "POST" else None)
            assert code == 400 and "unknown session" in out["error"]
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)


def test_cli_refuses_chunks_off_the_attention_grid():
    """libri100_conformer_chunked attends in 32-frame chunks of encoded
    frames: --chunk-frames must give a multiple of 32 (4x stacking: 128)."""
    with pytest.raises(SystemExit, match="not a multiple of enc_chunk_att"):
        port_serve.main(["--config", "libri100_conformer_chunked"])


def test_streaming_engine_under_thread_stress(params, engine):
    """More clients than slots and cores, the interpreter switching threads
    every microsecond: each client retries a busy engine, streams its
    utterance and closes; every answer is the offline engine's, and every
    slot ends free."""
    import sys
    import time as _time

    utts = _stream_utts()[:4]
    want = [engine.submit(u) for u in utts]
    eng = port_serve.StreamingEngine(params, TCFG, slots=3, chunk_frames=8,
                                     max_symbols=30, window_ms=1.0,
                                     device="cpu")
    got = {}

    def client(i):
        deadline = _time.monotonic() + 60
        while True:
            try:
                sid = eng.open_session()
                break
            except RuntimeError:
                assert _time.monotonic() < deadline
                _time.sleep(0.001)
        u = utts[i % len(utts)]
        for t0 in range(0, u.shape[0], 8):
            eng.feed(sid, u[t0:t0 + 8])
        got[i] = eng.close_session(sid)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
        eng.close()
    assert {i: got.get(i) for i in range(12)} == {
        i: want[i % len(utts)] for i in range(12)}
    assert eng._free == {0, 1, 2} and not eng._live


# ------------------------- audio bodies and text --------------------------

ALPHABET = "ab cdefgh"  # 9 characters + blank: 10 ids of the model's 11


def _audio_utts():
    """Raw 16 kHz PCM of 12-47 frames (the buckets hold 48), each with a
    partial window at its end that featurization drops."""
    rng = np.random.default_rng(21)
    return [(0.1 * rng.normal(size=400 + 160 * (F - 1) + extra)).astype(
        np.float32) for F, extra in ((12, 7), (47, 159), (20, 80),
                                     (33, 0), (28, 101))]


def _logmel(audio):
    from rnn_transducer_tpu_torch.ops.logmel import featurize

    return featurize(audio, device="cpu", n_mels=TCFG.input_dim)


@pytest.fixture(scope="module")
def audio_cmvn():
    """Global stats that put the utterances' log-mel features at mean 0
    and scale 3, the walking model's input scale."""
    f = np.concatenate([_logmel(a) for a in _audio_utts()])
    return {"mean": f.mean(0).tolist(), "std": (f.std(0) / 3).tolist()}


def _serve(srv):
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    return th, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv, th):
    srv.shutdown()
    srv.server_close()
    th.join(timeout=10)


def test_http_audio_answers_as_the_jax_server(engine, audio_cmvn):
    """{"audio"} bodies to the JAX http_server (its native FBANK) and to
    the port's (`log_mel` on the engine's device, here the CPU), on the
    same weights, char tokenizer and global CMVN at f32: tokens, frames,
    text and word segments equal; confidences within 2e-4 (4-place
    rounding)."""
    import jax
    import jax.numpy as jnp

    from rnn_transducer_tpu.data.tokenizer import CharTokenizer as JaxChar
    from rnn_transducer_tpu.serve import BatchingEngine as JaxEngine
    from rnn_transducer_tpu.serve import http_server as jax_http_server
    from rnn_transducer_tpu_torch.data.tokenizer import CharTokenizer

    jeng = JaxEngine(jax.tree.map(jnp.asarray, walking_params()), JCFG,
                     max_symbols=30, frame_buckets=BUCKETS, max_batch=4,
                     window_ms=20.0)
    jsrv = jax_http_server("127.0.0.1", 0, jeng, tok=JaxChar(ALPHABET),
                           cmvn=audio_cmvn, frame_hop_s=0.02)
    tsrv = http_server("127.0.0.1", 0, engine, tok=CharTokenizer(ALPHABET),
                       cmvn=audio_cmvn, frame_hop_s=0.02)
    jth, jurl = _serve(jsrv)
    tth, turl = _serve(tsrv)
    try:
        n_words = 0
        for audio in _audio_utts():
            body = {"audio": audio.tolist()}
            (jc, want), (tc, got) = (_request(f"{u}/recognize", "POST", body)
                                     for u in (jurl, turl))
            assert jc == tc == 200
            assert set(got) == set(want)
            for key in ("tokens", "frames", "text"):
                assert got[key] == want[key], key
            np.testing.assert_allclose(got["confidence"], want["confidence"],
                                       atol=2e-4)
            assert [(w["word"], w["start_s"], w["end_s"])
                    for w in got["words"]] == [
                (w["word"], w["start_s"], w["end_s"]) for w in want["words"]]
            np.testing.assert_allclose([w["conf"] for w in got["words"]],
                                       [w["conf"] for w in want["words"]],
                                       atol=2e-4)
            n_words += len(got["words"])
        assert n_words > 0
    finally:
        _stop(jsrv, jth)
        _stop(tsrv, tth)
        jeng.close()


def test_http_cmvn_applies_to_both_body_forms(engine, audio_cmvn):
    """With global CMVN the server normalizes an audio body's features and
    a feats body alike: both answer the engine's decode of the normalized
    log-mel features."""
    from rnn_transducer_tpu_torch.data.cmvn import apply_cmvn

    srv = http_server("127.0.0.1", 0, engine, cmvn=audio_cmvn)
    th, url = _serve(srv)
    try:
        for audio in _audio_utts()[:3]:
            feats = _logmel(audio)
            want = engine.submit_full(apply_cmvn(feats, audio_cmvn))
            for body in ({"audio": audio.tolist()},
                         {"feats": feats.tolist()}):
                code, out = _request(f"{url}/recognize", "POST", body)
                assert code == 200
                _assert_result(out, want)
    finally:
        _stop(srv, th)


def test_http_pcm_sessions_match_recognize(engine, streaming, audio_cmvn):
    """Raw-PCM sessions split at uneven points, aligned neither to the
    160-sample hop nor to the 8-frame chunks (one POST completes no frame
    and answers pending_frames), end with /recognize's tokens on the whole
    audio; the session's features are the offline features."""
    from rnn_transducer_tpu_torch.data.tokenizer import CharTokenizer

    srv = http_server("127.0.0.1", 0, engine, streaming,
                      tok=CharTokenizer(ALPHABET), cmvn=audio_cmvn)
    th, url = _serve(srv)
    rng = np.random.default_rng(3)
    try:
        emitted = 0
        for audio in _audio_utts():
            code, ref = _request(f"{url}/recognize", "POST",
                                 {"audio": audio.tolist()})
            assert code == 200
            sid = _request(f"{url}/session", "POST", {})[1]["sid"]
            cuts = sorted(rng.choice(np.arange(1, audio.shape[0] - 60), 4,
                                     replace=False).tolist())
            cuts.insert(2, cuts[1] + 50)  # a 50-sample POST: no frame
            parts = np.split(audio, cuts)
            outs = []
            for i, part in enumerate(parts):
                code, out = _request(f"{url}/session/{sid}", "POST", {
                    "audio": part.tolist(), "last": i == len(parts) - 1})
                assert code == 200 and isinstance(out["tokens"], list)
                outs.append(out)
            assert any("pending_frames" in o for o in outs[:-1])
            code, final = _request(f"{url}/session/{sid}", "DELETE")
            assert code == 200 and final["tokens"] == ref["tokens"]
            assert final["text"] == ref["text"]
            assert outs[-1]["frames"] == ref["frames"]
            emitted += len(ref["tokens"])
        assert emitted > 0
    finally:
        _stop(srv, th)


def test_pcm_session_closed_by_the_engine_answers_400(engine, streaming):
    """A PCM session the engine no longer knows (closed or reaped without
    a DELETE) answers 400 once its audio reaches the engine; DELETE of a
    live PCM session answers 200."""
    srv = http_server("127.0.0.1", 0, engine, streaming)
    th, url = _serve(srv)
    try:
        a = _audio_utts()[0]
        sids = [_request(f"{url}/session", "POST", {})[1]["sid"]
                for _ in range(2)]
        for sid in sids:
            assert _request(f"{url}/session/{sid}", "POST",
                            {"audio": a[:1000].tolist()})[0] == 200
        streaming.close_session(sids[1])  # gone from the engine alone
        assert _request(f"{url}/session/{sids[0]}", "DELETE")[0] == 200
        code, out = _request(f"{url}/session/{sids[1]}", "POST",
                             {"audio": a[1000:].tolist(), "last": True})
        assert code == 400 and "unknown session" in out["error"]
    finally:
        _stop(srv, th)


# ------------------------- the trainer's checkpoints ----------------------

TRAIN_ARGS = ["--device", "cpu", "--steps", "2", "--batch-size", "4",
              "--max-frames", "40", "--max-labels", "5", "--log-every", "1",
              "--warmup-steps", "1"]


@pytest.fixture(scope="module", params=["smoke", "conformer_smoke"])
def trained(request, tmp_path_factory):
    """2 CPU steps of the port's train CLI with a char tokenizer: the
    checkpoint directory and the in-memory params."""
    from rnn_transducer_tpu_torch.train.__main__ import main as train_main

    d = str(tmp_path_factory.mktemp(f"ck_{request.param}"))
    state = train_main(["--config", request.param, "--tokenizer", "char",
                        "--ckpt-dir", d] + TRAIN_ARGS)
    return request.param, d, state.params


def test_ckpt_dir_serves_the_trained_params(trained):
    """serve.py --ckpt-dir's model (config, tokenizer and weights from the
    directory, on the CPU here) answers what the trainer's in-memory
    params answer, LSTM and conformer alike."""
    from rnn_transducer_tpu_torch.data.tokenizer import CharTokenizer

    name, d, params = trained
    args = port_serve.parse_args(["--ckpt-dir", d])
    cfg, tok, cmvn = port_serve.model_meta(args)
    assert cfg == port_serve.get_model_config(name)
    assert isinstance(tok, CharTokenizer) and cmvn is None
    loaded = port_serve.load_params(args, cfg, "cpu")
    rng = np.random.default_rng(4)
    utts = [rng.normal(size=(T, cfg.input_dim)).astype(np.float32)
            for T in (40, 23, 64)]
    answers = []
    for p in (loaded, params):
        eng = BatchingEngine(p, cfg, max_symbols=20, frame_buckets=(64,),
                             max_batch=3, device="cpu")
        try:
            answers.append([eng.submit_full(u) for u in utts])
        finally:
            eng.close()
    assert answers[0] == answers[1]


def test_ckpt_dir_refuses_another_config(trained):
    _, d, _ = trained
    with pytest.raises(SystemExit, match="does not match the checkpoint"):
        port_serve.main(["--ckpt-dir", d, "--config", "libri100"])
    with pytest.raises(SystemExit, match="one"):
        port_serve.main(["--ckpt-dir", d, "--state-dict", "x.pt"])


def test_cli_boost_file_needs_beam_and_a_tokenizer(trained, tmp_path):
    _, d, _ = trained
    phrases = tmp_path / "phrases.txt"
    phrases.write_text("a cab\nbad\t1.5\n")
    with pytest.raises(SystemExit, match="requires --mode beam"):
        port_serve.main(["--ckpt-dir", d, "--boost-file", str(phrases)])
    with pytest.raises(SystemExit, match="tokenizer"):
        port_serve.main(["--mode", "beam", "--boost-file", str(phrases)])
    # with beam and the checkpoint's tokenizer the phrases are read, and
    # the CLI goes on as far as the card
    import unittest.mock as um

    with um.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(SystemExit, match="CUDA"):
            port_serve.main(["--ckpt-dir", d, "--mode", "beam",
                             "--boost-file", str(phrases)])
