"""PyTorch port beam search (`decode/beam.py`) vs the JAX package's.

The same seeded inputs go through JAX's `recognize_beam` / `beam_search`
and the port's, on the small config of tests/test_torch_greedy.py. The
walking model there emits a handful of tokens greedily, but beam search
prefers the shortest prefixes of its flat joint; scaling the joint's
output layer by 12 (blank 1 below) makes its label choices confident, so
the best beams carry 3 to 6 tokens and the beams' scores lie apart.

Every live beam (score above -5e29) must match: tokens and lengths
identical, scores within 1e-4, per-token confidences within 1e-5,
frames identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.decode import beam as jb
from rnn_transducer_tpu.models import config as jax_config
from rnn_transducer_tpu.models import transducer as jm
from rnn_transducer_tpu_torch.decode import beam as tb
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.models import transducer as tm
from rnn_transducer_tpu_torch.weights import params_from_numpy
from test_torch_greedy import JCFG, SMALL, TCFG, batch, walking_params

pytestmark = pytest.mark.quick

MAX_SYMBOLS = 30
SCORE_ATOL = 1e-4
CONF_ATOL = 1e-5
LIVE = -5e29


def beam_params(scale=12.0, blank_offset=-1.0, seed=3):
    """walking_params with the joint's output layer scaled: confident
    label choices, so beams of several tokens (module docstring)."""
    p = walking_params(blank_offset=0.0, seed=seed)
    out = p["joint"]["out"]
    out["w"] = out["w"] * np.float32(scale)
    out["b"] = out["b"] * np.float32(scale)
    out["b"][JCFG.blank] += blank_offset
    return p


def _jax_recognize(p, jcfg, feats, lens, **kw):
    out = jb.recognize_beam(jax.tree.map(jnp.asarray, p), jcfg,
                            jnp.asarray(feats), jnp.asarray(lens),
                            with_confidence=True, with_timestamps=True, **kw)
    return [np.asarray(a) for a in out]


def _port_recognize(p, tcfg, feats, lens, **kw):
    out = tb.recognize_beam(params_from_numpy(p), tcfg,
                            torch.from_numpy(feats), torch.from_numpy(lens),
                            with_confidence=True, with_timestamps=True, **kw)
    return [a.numpy() for a in out]


def assert_same_beams(got, want, score_atol=SCORE_ATOL, beams=None):
    """Live beams (the first `beams` of each row, all by default) equal:
    tokens, lengths and frames identical, scores and confidences close."""
    tok, n, sc, conf, fr = (a[:, :beams] for a in got)
    tok_w, n_w, sc_w, conf_w, fr_w = (a[:, :beams] for a in want)
    live = sc_w > LIVE
    np.testing.assert_array_equal(sc > LIVE, live)
    np.testing.assert_array_equal(n[live], n_w[live])
    np.testing.assert_allclose(sc[live], sc_w[live], atol=score_atol, rtol=0)
    for b, k in zip(*np.nonzero(live)):
        m = n_w[b, k]
        np.testing.assert_array_equal(tok[b, k, :m], tok_w[b, k, :m])
        np.testing.assert_array_equal(fr[b, k, :m], fr_w[b, k, :m])
        np.testing.assert_allclose(conf[b, k, :m], conf_w[b, k, :m],
                                   atol=CONF_ATOL, rtol=0)
    return live


# ------------------------------ primitives -------------------------------

def test_hash_append_lanes_are_jax_bits():
    rng = np.random.default_rng(0)
    h = rng.integers(0, 2 ** 32, size=(6, 8, 2), dtype=np.uint64).astype(
        np.uint32)
    h[0] = 0
    h[1] = 2 ** 32 - 1  # every bit set: the split multiply's worst case
    lab = rng.integers(0, 1024, size=(6, 8)).astype(np.int32)
    want = np.asarray(jb._hash_append(jnp.asarray(h), jnp.asarray(lab)))
    got = tb._hash_append(torch.from_numpy(h.astype(np.int64)),
                          torch.from_numpy(lab))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # chained appends stay equal (prefix hashes of a label sequence)
    hj, ht = jnp.zeros((3, 2), jnp.uint32), torch.zeros((3, 2),
                                                         dtype=torch.int64)
    for step in range(40):
        labs = rng.integers(0, 1024, size=(3,)).astype(np.int32)
        hj = jb._hash_append(hj, jnp.asarray(labs))
        ht = tb._hash_append(ht, torch.from_numpy(labs))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj).astype(np.int64))


def _tie_heavy(rng, B, N):
    """Rows of exact ties: dead beams at -1e30 (and -1e30 + a log-prob,
    which rounds back to -1e30 in f32), repeated finite values, zeros."""
    x = np.full((B, N), -1e30, np.float32)
    x += rng.normal(size=(B, N)).astype(np.float32) * -5.0  # still -1e30
    vals = np.array([-1.5, -0.25, 0.0, -7.0], np.float32)
    live = rng.random((B, N)) < 0.3
    x[live] = rng.choice(vals, size=int(live.sum()))
    x[0] = -1e30  # a row with nothing but ties
    return x


@pytest.mark.parametrize("k", [1, 4, 8, 40])
def test_top_k_takes_the_lower_index_among_ties_as_lax(k):
    rng = np.random.default_rng(k)
    x = _tie_heavy(rng, 5, 88)
    assert (x == np.float32(-1e30)).sum() > 100
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = tb._top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_final_order_is_jax_stable_argsort():
    rng = np.random.default_rng(1)
    x = _tie_heavy(rng, 5, 8)
    want = np.asarray(jnp.argsort(-jnp.asarray(x), axis=-1))
    got = torch.argsort(-torch.from_numpy(x), dim=-1, stable=True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_take_is_take_along_axis():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 7, 4, 5)).astype(np.float32)
    idx = rng.integers(0, 7, size=(3, 6)).astype(np.int32)
    want = np.take_along_axis(x, idx[:, :, None, None], axis=1)
    got = tb._take(torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------ the search -------------------------------

@pytest.mark.parametrize("beam, expansions", [(1, 1), (1, 3), (4, 1),
                                              (4, 3), (8, 1), (8, 3)])
def test_recognize_beam_matches_jax(beam, expansions):
    """K in {1, 4, 8}, expansions in {1, 3}, a ragged batch with a
    zero-length row (b = 3): every live beam identical."""
    p = beam_params()
    feats, lens = batch()
    kw = dict(beam=beam, max_symbols=MAX_SYMBOLS, expansions=expansions)
    want = _jax_recognize(p, JCFG, feats, lens, **kw)
    got = _port_recognize(p, TCFG, feats, lens, **kw)
    live = assert_same_beams(got, want)
    n = got[1]
    assert live[:, 0].all() and n[3].max() == 0  # the zero-length row
    if beam > 1:  # beams of several tokens; distinct n-best, best first
        assert n[live].max() >= 3
        assert live[:, 1].any()
        assert (np.diff(got[2], axis=1) <= 0).all()


def test_max_symbols_cap_matches_jax():
    """A cap of 4 labels: the long rows run into it."""
    p = beam_params()
    feats, lens = batch(seed=4)
    kw = dict(beam=4, max_symbols=4, expansions=3)
    want = _jax_recognize(p, JCFG, feats, lens, **kw)
    got = _port_recognize(p, TCFG, feats, lens, **kw)
    live = assert_same_beams(got, want)
    assert (got[1][live] == 4).sum() >= 3


def test_all_rows_empty_decode_nothing():
    p = beam_params()
    feats, _ = batch(B=2)
    tok, n, sc = tb.recognize_beam(params_from_numpy(p), TCFG,
                                   torch.from_numpy(feats),
                                   torch.zeros(2, dtype=torch.int32),
                                   beam=4, max_symbols=5)
    assert n.tolist() == [[0] * 4] * 2 and (tok == TCFG.blank).all()
    assert sc[:, 0].tolist() == [0.0, 0.0] and (sc[:, 1:] == -1e30).all()


def _carry_equal(got, want):
    """The carry's live fields equal JAX's: tokens, lengths, hash lanes,
    conf / frame / foff / wake, the predictor output and states."""
    tokens, lens, scores, hashes, outs, states = got
    tokens_w, lens_w, scores_w, hashes_w, outs_w, states_w = [
        jax.tree.map(np.asarray, x) for x in want]
    live = scores_w > LIVE
    np.testing.assert_array_equal(scores.numpy() > LIVE, live)
    np.testing.assert_allclose(scores.numpy()[live], scores_w[live],
                               atol=SCORE_ATOL, rtol=0)
    np.testing.assert_array_equal(lens.numpy()[live], lens_w[live])
    np.testing.assert_array_equal(tokens.numpy()[live], tokens_w[live])
    np.testing.assert_array_equal(hashes.numpy()[live],
                                  hashes_w[live].astype(np.int64))
    for key in ("frame", "foff", "wake"):
        np.testing.assert_array_equal(outs[key].numpy()[live],
                                      outs_w[key][live])
    np.testing.assert_allclose(outs["conf"].numpy()[live],
                               outs_w["conf"][live], atol=CONF_ATOL, rtol=0)
    np.testing.assert_allclose(outs["pred"].numpy()[live],
                               outs_w["pred"][live], atol=1e-5, rtol=0)
    for (h, c), (h_w, c_w) in zip(states["pred"], states_w["pred"]):
        np.testing.assert_allclose(h.numpy()[live], h_w[live], atol=1e-5)
        np.testing.assert_allclose(c.numpy()[live], c_w[live], atol=1e-5)
    return live


def _encode(p, feats, lens):
    enc, enc_lens = jm.encode(jax.tree.map(jnp.asarray, p), JCFG,
                              jnp.asarray(feats), jnp.asarray(lens))
    return np.array(enc), np.array(enc_lens)


def test_beam_search_carry_matches_jax():
    p = beam_params()
    enc, enc_lens = _encode(p, *batch(seed=2))
    kw = dict(beam=8, max_symbols=MAX_SYMBOLS, expansions=3)
    *_, carry_w = jb.beam_search(jax.tree.map(jnp.asarray, p), JCFG,
                                 jnp.asarray(enc), jnp.asarray(enc_lens),
                                 **kw)
    *_, carry = tb.beam_search(params_from_numpy(p), TCFG,
                               torch.from_numpy(enc),
                               torch.from_numpy(enc_lens), **kw)
    _carry_equal(carry, carry_w)
    # foff advanced by each row's frames; wake re-based to 0
    np.testing.assert_array_equal(carry[4]["foff"].numpy(),
                                  np.repeat(enc_lens[:, None], 8, 1))
    assert not carry[4]["wake"].any()


def test_beam_state_carries_across_two_calls_as_jax():
    """beam_search on the first frames, then on the rest with beam_state=
    the returned carry (as streaming chunks do): the carry and the sorted
    result equal JAX's on the same two calls."""
    p = beam_params()
    enc, _ = _encode(p, *batch(seed=2))
    enc_lens = np.full((enc.shape[0],), 8, np.int32)
    kw = dict(beam=4, max_symbols=MAX_SYMBOLS, expansions=3)
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p)
    st_w = st = None
    for lo in (0, 8):
        chunk = enc[:, lo:lo + 8]
        tok_w, n_w, sc_w, st_w = jb.beam_search(
            jp, JCFG, jnp.asarray(chunk), jnp.asarray(enc_lens),
            beam_state=st_w, **kw)
        tok, n, sc, st = tb.beam_search(
            tp, TCFG, torch.from_numpy(chunk), torch.from_numpy(enc_lens),
            beam_state=st, **kw)
    _carry_equal(st, st_w)
    live = np.asarray(sc_w) > LIVE
    np.testing.assert_array_equal(n.numpy()[live], np.asarray(n_w)[live])
    np.testing.assert_array_equal(tok.numpy()[live],
                                  np.asarray(tok_w)[live])
    # timestamps are global: the second call's emissions stamp 8 + t
    assert st[4]["foff"].min() == 16


def test_bf16_top_beam_matches_jax():
    jcfg = dataclasses.replace(JCFG, compute_dtype="bfloat16")
    tcfg = dataclasses.replace(TCFG, compute_dtype="bfloat16")
    p = beam_params()
    feats, lens = batch()
    kw = dict(beam=8, max_symbols=MAX_SYMBOLS, expansions=3)
    want = _jax_recognize(p, jcfg, feats, lens, **kw)
    got = _port_recognize(p, tcfg, feats, lens, **kw)
    assert_same_beams(got, want, beams=1)


def test_int8_params_match_jax():
    from rnn_transducer_tpu.ops.quant import quantize_params

    p = beam_params()
    q = jax.tree.map(np.asarray, quantize_params(
        jax.tree.map(jnp.asarray, p)))
    feats, lens = batch()
    kw = dict(beam=8, max_symbols=MAX_SYMBOLS, expansions=3)
    want = _jax_recognize(q, JCFG, feats, lens, **kw)
    got = _port_recognize(q, TCFG, feats, lens, **kw)
    assert_same_beams(got, want)


def test_conformer_encoder_matches_jax():
    """A small conformer encoder (2 blocks, d 32, 4x stacking) under the
    same beam search."""
    fields = dict(enc_type="conformer", input_dim=8, enc_layers=2,
                  enc_hidden=32, enc_heads=4, enc_ff_mult=2,
                  enc_conv_kernel=5, pred_layers=1, pred_hidden=16,
                  embed_dim=8, joint_dim=16, vocab_size=13, time_reduction=4,
                  compute_dtype="float32")
    jcfg = jax_config.TransducerConfig(**fields)
    tcfg = port_config.TransducerConfig(**fields)
    p = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(1), jcfg))
    out = p["joint"]["out"]
    out["w"], out["b"] = out["w"] * np.float32(12), out["b"] * np.float32(12)
    rng = np.random.default_rng(3)
    feats = (3 * rng.normal(size=(3, 64, 8))).astype(np.float32)
    lens = np.array([64, 41, 0], np.int32)
    kw = dict(beam=4, max_symbols=MAX_SYMBOLS, expansions=3)
    want = _jax_recognize(p, jcfg, feats, lens, **kw)
    got = _port_recognize(p, tcfg, feats, lens, **kw)
    live = assert_same_beams(got, want)
    assert got[1][live].max() >= 2


def test_int8_params_are_dequantized_once_a_call(monkeypatch):
    """beam_search dequantizes an int8 tree once a call, before its frame
    loop: as many dequantizations at 3 frames as at 9, and as many as one
    `DecodeWeights` build makes (init_beam_state shares beam_search's)."""
    from rnn_transducer_tpu_torch.ops import quant
    from rnn_transducer_tpu_torch.ops.quant import quantize_params

    params = quantize_params(params_from_numpy(beam_params()))
    real = quant.dequantize_tensor
    calls = []

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(quant, "dequantize_tensor", spy)
    tm.DecodeWeights(params, TCFG)
    once = len(calls)
    counts = []
    for T in (3, 9):
        calls.clear()
        tb.beam_search(params, TCFG, torch.zeros(1, T, SMALL["enc_hidden"]),
                       torch.tensor([T], dtype=torch.int32), beam=2,
                       max_symbols=4, expansions=1)
        counts.append(len(calls))
    assert once > 0
    assert counts == [once, once]


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_decode_weights_step_and_joint_are_the_models_bits(cd):
    """One `DecodeWeights` steps the predictor as `predict_step` does, bit
    for bit, and the beam loop's joint, the encoder side projected once
    for all frames, gives `joint_step`'s bits on every frame."""
    cfg = dataclasses.replace(TCFG, compute_dtype=cd)
    params = params_from_numpy(beam_params())
    dw = tm.DecodeWeights(params, cfg)
    rng = np.random.default_rng(6)
    lab = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=6))
    st = [(torch.from_numpy(rng.normal(size=(6, cfg.pred_hidden))).float(),
           torch.from_numpy(rng.normal(size=(6, cfg.pred_hidden))).float())]
    enc = torch.from_numpy(
        rng.normal(size=(6, 5, SMALL["enc_hidden"]))).float()
    want_p, want_s = tm.predict_step(params, cfg, lab, st)
    got_p, got_s = dw.predict_step(lab, st)
    assert torch.equal(got_p, want_p)
    assert all(torch.equal(a, b) for x, y in zip(got_s, want_s)
               for a, b in zip(x, y))
    f_all, g = dw.enc_proj(enc), dw.pred_proj(want_p)
    for t in range(enc.shape[1]):
        want = tm.joint_step(params, cfg, enc[:, t], want_p)
        assert torch.equal(dw.joint(f_all[:, t], g), want)
