"""PyTorch port streaming vs the JAX package's: `encode_chunk` with the
carried LSTM state and conformer caches, `stream_transcribe` and
`stream_transcribe_beam`, chunked against offline within the port, int8
at equal lengths, and a JAX stream continued in the port.

Three small streamable encoders, each made to walk its utterances (tokens
at several frames, rows that reach their end): the LSTM of
tests/test_torch_greedy.py (2 layers, 2x frame stacking), and the
conformer of tests/test_torch_conformer.py (4x stacking) in its causal
form (a 3-frame left window) and its chunked form (2-frame attention
chunks, 2 frames of left context). Chunks are 8 input frames; the batch
has ragged lengths (a partial last chunk) and a zero-length row.

Tolerances: at f32 tokens, lengths and frames identical; encoder outputs
and carried states within 1e-5 (the products run through another matmul
library); beam scores within 1e-4 (test_torch_beam.py's SCORE_ATOL).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.decode import streaming as js
from rnn_transducer_tpu.models import config as jax_config
from rnn_transducer_tpu.models import transducer as jm
from rnn_transducer_tpu_torch.decode import streaming as ts
from rnn_transducer_tpu_torch.decode.beam import recognize_beam
from rnn_transducer_tpu_torch.decode.greedy import recognize_greedy
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.models import transducer as tm
from rnn_transducer_tpu_torch.weights import params_from_numpy
from test_torch_beam import beam_params
from test_torch_greedy import SMALL as LSTM_SMALL
from test_torch_greedy import walking_params

pytestmark = pytest.mark.quick

CONF_SMALL = dict(enc_type="conformer", input_dim=8, enc_layers=2,
                  enc_hidden=32, enc_heads=4, enc_ff_mult=2,
                  enc_conv_kernel=5, pred_layers=1, pred_hidden=16,
                  embed_dim=8, joint_dim=16, vocab_size=13, time_reduction=4,
                  compute_dtype="float32")
MODELS = {"lstm": LSTM_SMALL,
          "causal": {**CONF_SMALL, "enc_att_left": 3},
          "chunked": {**CONF_SMALL, "enc_chunk_att": 2, "enc_att_left": 2}}
CHUNK = 8
MAX_SYMBOLS = 30
BEAM = dict(beam=4, max_symbols=MAX_SYMBOLS, expansions=2)
ATOL = 1e-5
SCORE_ATOL = 1e-4


def _cfgs(name):
    return (jax_config.TransducerConfig(**MODELS[name]),
            port_config.TransducerConfig(**MODELS[name]))


def _params(name, beam=False):
    """numpy params of the model, made to walk: the LSTM's of
    test_torch_greedy.py (beam=True: test_torch_beam.py's confident
    labels); the conformer's with the predictor's side of the joint scaled
    4x, so an emission moves the logits, and blank raised by 0.65 (beam:
    the logits scaled 4x)."""
    if name == "lstm":
        return beam_params() if beam else walking_params()
    jcfg, _ = _cfgs(name)
    p = jax.tree.map(np.array, jm.init_params(jax.random.PRNGKey(3), jcfg))
    p["joint"]["pred_proj"]["w"] *= 4.0
    p["joint"]["out"]["b"][jcfg.blank] += 0.65
    if beam:
        p["joint"]["out"]["w"] *= 4.0
        p["joint"]["out"]["b"] *= 4.0
    return p


# batch seeds on which each model walks (greedy) or emits several tokens a
# top beam (beam)
GREEDY_SEED = {"lstm": 2, "causal": 8, "chunked": 8}
BEAM_SEED = {"lstm": 4, "causal": 5, "chunked": 5}


def _batch(seed=1, T=40):
    rng = np.random.default_rng(seed)
    feats = (3 * rng.normal(size=(5, T, 8))).astype(np.float32)
    lens = np.array([T, 33, 21, 0, 7], np.int32)  # partial chunks, a 0 row
    return feats, lens


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _chunk_lens(lens, i):
    return np.clip(lens - i * CHUNK, 0, CHUNK).astype(np.int32)


def _assert_tree_close(got, want, atol=ATOL):
    """A port tree (tensors) against a JAX tree (arrays), leaf by leaf."""
    got_l = jax.tree.leaves(jax.tree.map(
        lambda t: t.numpy(), got,
        is_leaf=lambda x: isinstance(x, torch.Tensor)))
    want_l = jax.tree.leaves(_np(want))
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)


# ------------------------------ encode_chunk -----------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_encode_chunk_matches_jax(name):
    """Chunk by chunk, the port's encoder output, lengths and carried
    state against JAX's on the same chunks."""
    jcfg, tcfg = _cfgs(name)
    p = _params(name)
    feats, lens = _batch()
    jp, tp = _jnp(p), params_from_numpy(p)
    jst, tst = jm.init_enc_state(jcfg, 5), tm.init_enc_state(tcfg, 5, "cpu")
    _assert_tree_close(tst, jst)
    for i in range(feats.shape[1] // CHUNK):
        x = feats[:, i * CHUNK:(i + 1) * CHUNK]
        cl = _chunk_lens(lens, i)
        j_out, j_lens, jst = jm.encode_chunk(jp, jcfg, jnp.asarray(x),
                                             jnp.asarray(cl), jst)
        t_out, t_lens, tst = tm.encode_chunk(tp, tcfg, torch.from_numpy(x),
                                             torch.from_numpy(cl), tst)
        np.testing.assert_array_equal(t_lens.numpy(), np.asarray(j_lens))
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                                   atol=ATOL, rtol=0)
        _assert_tree_close(tst, jst)


@pytest.mark.parametrize("name", list(MODELS))
def test_chunked_encode_equals_offline(name):
    """Within the port: the chunks' outputs, concatenated, are `encode` of
    the whole batch on every valid frame."""
    _, tcfg = _cfgs(name)
    tp = params_from_numpy(_params(name))
    feats, lens = _batch(seed=2)
    want, want_lens = tm.encode(tp, tcfg, torch.from_numpy(feats),
                                torch.from_numpy(lens))
    state, outs = tm.init_enc_state(tcfg, 5, "cpu"), []
    for i in range(feats.shape[1] // CHUNK):
        out, _, state = tm.encode_chunk(
            tp, tcfg, torch.from_numpy(feats[:, i * CHUNK:(i + 1) * CHUNK]),
            torch.from_numpy(_chunk_lens(lens, i)), state)
        outs.append(out)
    got = torch.cat(outs, dim=1)
    assert got.shape == want.shape
    for b, n in enumerate(want_lens.tolist()):
        np.testing.assert_allclose(got[b, :n].numpy(), want[b, :n].numpy(),
                                   atol=ATOL, rtol=0)


def test_encode_chunk_refusals():
    """The JAX package's refusals, with its messages."""
    lstm = port_config.TransducerConfig(**LSTM_SMALL)
    with pytest.raises(ValueError, match="unidirectional"):
        tm.init_enc_state(dataclasses.replace(lstm, bidirectional=True), 2,
                          "cpu")
    conf = port_config.TransducerConfig(**CONF_SMALL)
    with pytest.raises(ValueError, match="enc_att_left > 0"):
        tm.init_enc_state(conf, 2, "cpu")
    tp = params_from_numpy(walking_params())
    with pytest.raises(ValueError, match="divisible by time_reduction"):
        tm.encode_chunk(tp, lstm, torch.zeros((2, 7, 8)),
                        torch.full((2,), 7), tm.init_enc_state(lstm, 2, "cpu"))
    _, chunked = _cfgs("chunked")
    cp = params_from_numpy(_params("chunked"))
    with pytest.raises(ValueError, match="multiple of enc_chunk_att"):
        tm.encode_chunk(cp, chunked, torch.zeros((2, 4, 8)),
                        torch.full((2,), 4),
                        tm.init_enc_state(chunked, 2, "cpu"))


# ---------------------------- stream_transcribe --------------------------

@pytest.mark.parametrize("name", list(MODELS))
def test_stream_transcribe_matches_jax_and_offline(name):
    """Tokens, lengths and global emission frames identical to JAX's
    stream_transcribe, and to the port's offline recognize_greedy."""
    jcfg, tcfg = _cfgs(name)
    p = _params(name)
    feats, lens = _batch(seed=GREEDY_SEED[name])
    want = js.stream_transcribe(_jnp(p), jcfg, jnp.asarray(feats),
                                jnp.asarray(lens), CHUNK, MAX_SYMBOLS,
                                with_timestamps=True)
    tp = params_from_numpy(p)
    got = ts.stream_transcribe(tp, tcfg, torch.from_numpy(feats),
                               torch.from_numpy(lens), CHUNK, MAX_SYMBOLS,
                               with_timestamps=True, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    off = recognize_greedy(tp, tcfg, torch.from_numpy(feats),
                           torch.from_numpy(lens), MAX_SYMBOLS,
                           with_timestamps=True)
    for g, o in zip(got, off):
        torch.testing.assert_close(g, o, rtol=0, atol=0)
    n, frames = got[1].numpy(), got[2].numpy()
    # the rows walked: tokens below the cap at frames of several chunks
    assert n[3] == 0 and 0 < n.max() < MAX_SYMBOLS
    chunk_enc = CHUNK // tcfg.time_reduction
    assert len({int(frames[b, i]) // chunk_enc for b in range(5)
                for i in range(n[b])}) > 1


@pytest.mark.parametrize("name", list(MODELS))
def test_stream_transcribe_beam_matches_jax(name):
    """The n-best's tokens, lengths and frames identical to JAX's
    stream_transcribe_beam, scores within SCORE_ATOL."""
    jcfg, tcfg = _cfgs(name)
    p = _params(name, beam=True)
    feats, lens = _batch(seed=BEAM_SEED[name])
    want = js.stream_transcribe_beam(_jnp(p), jcfg, jnp.asarray(feats),
                                     jnp.asarray(lens), CHUNK,
                                     with_timestamps=True, **BEAM)
    got = ts.stream_transcribe_beam(params_from_numpy(p), tcfg,
                                    torch.from_numpy(feats),
                                    torch.from_numpy(lens), CHUNK,
                                    with_timestamps=True, device="cpu",
                                    **BEAM)
    tok, n, sc, fr = (a.numpy() for a in got)
    tok_w, n_w, sc_w, fr_w = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(n, n_w)
    np.testing.assert_array_equal(tok, tok_w)
    np.testing.assert_array_equal(fr, fr_w)
    live = sc_w > -5e29
    np.testing.assert_array_equal(sc > -5e29, live)
    np.testing.assert_allclose(sc[live], sc_w[live], atol=SCORE_ATOL, rtol=0)
    assert n[:, 0].sum() >= 4 and (live.sum(1) > 1).any()


@pytest.mark.parametrize("name", ["lstm", "causal"])
def test_stream_beam_equals_offline_beam(name):
    """Within the port, frame-synchronous beam search does not see the
    chunking: the same n-best as recognize_beam."""
    _, tcfg = _cfgs(name)
    tp = params_from_numpy(_params(name, beam=True))
    feats, lens = _batch(seed=BEAM_SEED[name])
    f, n = torch.from_numpy(feats), torch.from_numpy(lens)
    got = ts.stream_transcribe_beam(tp, tcfg, f, n, CHUNK, device="cpu",
                                    with_timestamps=True, **BEAM)
    want = recognize_beam(tp, tcfg, f, n, with_timestamps=True, **BEAM)
    for i in (0, 1, 3):
        torch.testing.assert_close(got[i], want[i], rtol=0, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=SCORE_ATOL)


def test_transcript_grows_chunk_by_chunk():
    """tokens[:lens] of chunk i is a prefix of chunk i+1's: greedy output
    is final."""
    _, tcfg = _cfgs("lstm")
    tp = params_from_numpy(walking_params())
    feats, _ = _batch(seed=6)
    state = ts.init_stream(tp, tcfg, 5, MAX_SYMBOLS, device="cpu")
    prev_tok, prev_n = None, torch.zeros(5, dtype=torch.int32)
    for i in range(feats.shape[1] // CHUNK):
        state, tok, n = ts.stream_chunk(
            tp, tcfg, state,
            torch.from_numpy(feats[:, i * CHUNK:(i + 1) * CHUNK]),
            torch.full((5,), CHUNK, dtype=torch.int32), MAX_SYMBOLS)
        assert (n >= prev_n).all()
        if prev_tok is not None:
            for b in range(5):
                assert tok[b, :prev_n[b]].tolist() == \
                    prev_tok[b, :prev_n[b]].tolist()
        prev_tok, prev_n = tok, n
    assert prev_n.sum() > 0


# --------------------------------- int8 ----------------------------------

INT8 = dict(LSTM_SMALL, enc_hidden=128)  # H % 128 == 0: the W8A8 route


def test_int8_stream_equals_offline_at_equal_lengths(monkeypatch):
    """Quantized params, 8 rows of one length (a batch tile's rows share
    one requantisation scale, so a padded row would move the others,
    ROADMAP §3): the W8A8 recurrence streamed with its carried state gives
    the offline encode's output and tokens."""
    from rnn_transducer_tpu_torch.ops import lstm_int8_cuda
    from rnn_transducer_tpu_torch.ops.quant import quantize_params

    cfg = port_config.TransducerConfig(**INT8)
    rng = np.random.default_rng(7)
    p = tm.init_params(cfg, rng, "cpu")
    p["joint"]["out"]["b"][cfg.blank] += 0.11  # rows emit at several frames
    qp = quantize_params(p)
    feats = torch.from_numpy((3 * rng.normal(size=(8, 32, 8))).astype(
        np.float32))
    lens = torch.full((8,), 32, dtype=torch.int32)
    calls = []
    real = lstm_int8_cuda.lstm_recurrence_int8

    def spy(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(lstm_int8_cuda, "lstm_recurrence_int8", spy)
    want, _ = tm.encode(qp, cfg, feats, lens)
    state, outs = tm.init_enc_state(cfg, 8, "cpu"), []
    for i in range(4):
        out, _, state = tm.encode_chunk(qp, cfg,
                                        feats[:, i * CHUNK:(i + 1) * CHUNK],
                                        torch.full((8,), CHUNK), state)
        outs.append(out)
    got = ts.stream_transcribe(qp, cfg, feats, lens, CHUNK, MAX_SYMBOLS,
                               device="cpu")
    assert len(calls) == 2 + 2 * 4 + 2 * 4  # every layer on the W8A8 route
    torch.testing.assert_close(torch.cat(outs, 1), want, rtol=0, atol=ATOL)
    tok, n = recognize_greedy(qp, cfg, feats, lens, MAX_SYMBOLS)
    assert n.sum() > 0
    torch.testing.assert_close(got[0], tok, rtol=0, atol=0)
    torch.testing.assert_close(got[1], n, rtol=0, atol=0)


# ------------------------ a JAX stream, continued ------------------------

def _jax_state_to_port(state, beam=False):
    """A JAX StreamState to the port's, leaf by leaf through
    params_from_numpy; the beam carry's uint32 hash lanes become the
    port's int64 lanes."""
    enc = params_from_numpy(_np(state.enc_state))
    dec = _np(state.decode_state)
    if beam:
        dec = dec[:3] + (dec[3].astype(np.int64),) + dec[4:]
    return ts.StreamState(enc, params_from_numpy(dec))


@pytest.mark.parametrize("name, beam", [("lstm", False), ("causal", False),
                                        ("lstm", True)],
                         ids=["lstm", "causal", "lstm-beam"])
def test_jax_stream_continues_in_the_port(name, beam):
    """JAX feeds the first two chunks; its state crosses to the port, which
    feeds the rest: the result is JAX's own continuation."""
    jcfg, tcfg = _cfgs(name)
    p = _params(name, beam=beam)
    feats, lens = _batch(seed=8)
    jp, tp = _jnp(p), params_from_numpy(p)
    if beam:
        jstate = js.init_stream_beam(jp, jcfg, 5, beam=BEAM["beam"],
                                     max_symbols=MAX_SYMBOLS)
    else:
        jstate = js.init_stream(jp, jcfg, 5, MAX_SYMBOLS)
    kw = BEAM if beam else {"max_symbols": MAX_SYMBOLS}
    for i in range(feats.shape[1] // CHUNK):
        x = feats[:, i * CHUNK:(i + 1) * CHUNK]
        cl = _chunk_lens(lens, i)
        if i == 2:
            tstate = _jax_state_to_port(jstate, beam)
        if beam:
            jstate, *want = js.stream_chunk_beam(jp, jcfg, jstate,
                                                 jnp.asarray(x),
                                                 jnp.asarray(cl), **kw)
        else:
            jstate, *want = js.stream_chunk(jp, jcfg, jstate, jnp.asarray(x),
                                            jnp.asarray(cl), **kw)
        if i >= 2:
            step = ts.stream_chunk_beam if beam else ts.stream_chunk
            tstate, *got = step(tp, tcfg, tstate, torch.from_numpy(x),
                                torch.from_numpy(cl), **kw)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if beam:
        live = np.asarray(want[2]) > -5e29
        np.testing.assert_allclose(got[2].numpy()[live],
                                   np.asarray(want[2])[live],
                                   atol=SCORE_ATOL, rtol=0)
    else:  # the greedy carry: frames, offsets, predictor state
        dec, dec_w = tstate.decode_state, jstate.decode_state
        for i in (0, 1, 3, 4, 7):
            np.testing.assert_array_equal(dec[i].numpy(), np.asarray(dec_w[i]))
        np.testing.assert_allclose(dec[5].numpy(), np.asarray(dec_w[5]),
                                   atol=ATOL)
    assert got[1].numpy().max() > 0
