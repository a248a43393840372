"""PyTorch port int8 serving vs the JAX package.

`ops/quant.py` bit for bit; the W8A8 LSTM recurrence (the plain version of
the CUDA kernel K7, `lstm_int8_cuda`, and the port's `lstm_layer` route)
against the JAX Pallas int8 core in interpret mode, as tests/test_quant.py
runs it; the dequantized route against the JAX scan; int8 `encode` and
`recognize_greedy` against the JAX package with its encoder's LSTM forced
onto the Pallas path (the route the TPU takes); the serving engine and CLI
flag on quantized params.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.decode.greedy import recognize_greedy as jax_recognize
from rnn_transducer_tpu.models import config as jax_config
from rnn_transducer_tpu.models import transducer as jm
from rnn_transducer_tpu.ops import lstm as jax_lstm
from rnn_transducer_tpu.ops import quant as jq
from rnn_transducer_tpu_torch import serve as port_serve
from rnn_transducer_tpu_torch.decode.greedy import recognize_greedy
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.models import transducer as tm
from rnn_transducer_tpu_torch.ops import lstm_int8_cuda as q8
from rnn_transducer_tpu_torch.ops import quant as tq
from rnn_transducer_tpu_torch.ops.lstm import lstm_layer, w8a8_supported
from rnn_transducer_tpu_torch.serve import BatchingEngine
from rnn_transducer_tpu_torch.weights import params_from_numpy, params_to_numpy

pytestmark = pytest.mark.quick

# The encoder is 128 wide, so that B = 8 takes the W8A8 route as on the TPU.
SMALL = dict(input_dim=8, enc_layers=2, enc_hidden=128, time_reduction=2,
             pred_layers=1, pred_hidden=16, embed_dim=10, joint_dim=16,
             vocab_size=11, compute_dtype="float32")
JCFG = jax_config.TransducerConfig(**SMALL)
TCFG = port_config.TransducerConfig(**SMALL)
MAX_SYMBOLS = 12
# hs of the W8A8 recurrence, port vs JAX. f32: the two sides round the same
# operations; a difference of h in its last bit can flip one requantized
# int8 value only at a .5 boundary. bf16: x_proj is rounded to bf16 after
# a matmul summed in another order, so one bf16 ulp (2^-8) can differ.
HS_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(scope="module")
def params_np():
    return jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0),
                                                   JCFG))


def _tree_pairs(got, want):
    """Leaves of the port's numpy tree and the JAX tree, in order."""
    return zip(jax.tree.leaves(got), jax.tree.leaves(want))


# ------------------------------ ops/quant --------------------------------

@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_tensor_is_bit_equal_to_jax(axis):
    rng = np.random.default_rng(1)
    w = (rng.normal(size=(24, 40)) * rng.uniform(0.01, 3, size=40)).astype(
        np.float32)
    w[:, 3] = 0.0  # an all-zero channel: scale 1
    w[5, :] = 0.0
    want = jq.quantize_tensor(jnp.asarray(w), channel_axis=axis)
    got = tq.quantize_tensor(torch.from_numpy(w), channel_axis=axis)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(
        tq.dequantize_tensor(got).numpy(),
        np.asarray(jq.dequantize_tensor(want)))


def test_quantize_params_is_bit_equal_to_jax(params_np):
    want = jax.tree.map(np.asarray, jq.quantize_params(
        jax.tree.map(jnp.asarray, params_np)))
    got = params_to_numpy(tq.quantize_params(params_from_numpy(params_np)))
    assert isinstance(got["embed"], tq.QTensor)
    assert got["embed"].scale.shape == (SMALL["vocab_size"], 1)  # per row
    assert got["encoder"][0]["w_hh"].scale.shape == (1, 4 * 128)
    assert not isinstance(got["encoder"][0]["b"], tq.QTensor)
    pairs = list(_tree_pairs(got, want))
    assert len(pairs) == len(jax.tree.leaves(want))
    for a, b in pairs:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_quantize_params_min_size_matches_jax(params_np):
    want = jq.quantize_params(jax.tree.map(jnp.asarray, params_np),
                              min_size=1000)
    got = tq.quantize_params(params_from_numpy(params_np), min_size=1000)
    for part in ("enc_proj", "pred_proj", "out"):
        assert (isinstance(got["joint"][part]["w"], tq.QTensor)
                == isinstance(want["joint"][part]["w"], jq.QTensor))
    assert tq.quantized_bytes(got) == jq.quantized_bytes(want)


@pytest.mark.parametrize("keep", [(), ("w_hh",)])
def test_maybe_dequant_tree_matches_jax(params_np, keep):
    jqp = jq.quantize_params(jax.tree.map(jnp.asarray, params_np))
    want = jax.tree.map(np.asarray, jq.maybe_dequant_tree(jqp, keep=keep))
    got = params_to_numpy(tq.maybe_dequant_tree(
        tq.quantize_params(params_from_numpy(params_np)), keep=keep))
    assert isinstance(got["encoder"][1]["w_hh"], tq.QTensor) == bool(keep)
    assert not isinstance(got["encoder"][1]["w_ih"], tq.QTensor)
    for a, b in _tree_pairs(got, want):
        np.testing.assert_array_equal(a, b)


def test_maybe_dequant_tree_leaves_a_float_tree_alone(params_np):
    p = params_from_numpy(params_np)
    assert tq.maybe_dequant_tree(p) is p


def test_quantized_bytes_match_jax(params_np):
    jqp = jq.quantize_params(jax.tree.map(jnp.asarray, params_np))
    tqp = tq.quantize_params(params_from_numpy(params_np))
    assert tq.quantized_bytes(tqp) == jq.quantized_bytes(jqp)
    qb, fb = tq.quantized_bytes(tqp)
    assert qb < fb / 3


# ----------------------- the W8A8 LSTM recurrence -------------------------

def _layer(seed, I, H):
    """A JAX LSTM layer, quantized on both sides, and its numpy params."""
    p = jax_lstm.init_lstm_params(jax.random.PRNGKey(seed), I, H)
    jqp = {"w_ih": jq.quantize_tensor(p["w_ih"]),
           "w_hh": jq.quantize_tensor(p["w_hh"]), "b": p["b"]}
    return jqp, params_from_numpy(jax.tree.map(np.asarray, jqp))


def _inputs(seed, B, T, I, H):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, I)).astype(np.float32)
    h0 = (0.5 * rng.normal(size=(B, H))).astype(np.float32)
    c0 = rng.normal(size=(B, H)).astype(np.float32)
    return x, h0, c0


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B", [8, 16, 32])
def test_w8a8_route_matches_jax_pallas(B, cd):
    """B = 8, 16, 32 give batch tiles of 8, 16 and 32 rows, each with its
    own amax; carried h0/c0; T = 11 is not a multiple of the JAX time
    tile."""
    I, H, T = 12, 128, 11
    assert w8a8_supported(B, H) and q8.batch_tile(B, H) == B
    jqp, tqp = _layer(B, I, H)
    x, h0, c0 = _inputs(B, B, T, I, H)
    want, (hT_w, cT_w) = jax_lstm.lstm_layer(
        jqp, jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0),
        compute_dtype=JDT[cd], impl="pallas")
    got, (hT, cT) = lstm_layer(tqp, torch.from_numpy(x), torch.from_numpy(h0),
                               torch.from_numpy(c0), compute_dtype=cd)
    for a, b in ((got, want), (hT, hT_w), (cT, cT_w)):
        err = float(np.abs(a.numpy() - np.asarray(b)).max())
        assert err <= HS_ATOL[cd], f"max abs err {err}"
    assert torch.equal(hT, got[:, -1])


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_int8_reference_matches_jax_core(cd):
    """The plain version of K7 itself, on the x_proj the JAX core is
    given, at B = 32 (one 32-row tile) and B = 24 (three 8-row tiles).
    The two sides' sigmoid and tanh differ in the last bit; where such a
    difference moves h * 127 / amax across a .5 boundary, one int8 value
    of hq flips and hs moves by up to ~6e-4 (seeds 24 and 524 at f32 do
    that), so the seeds here are ones without a flip: the bound is then
    the last bits."""
    from rnn_transducer_tpu.ops import lstm_pallas

    H = 128
    for B in (32, 24):
        rng = np.random.default_rng(100 + B)
        qw = jq.quantize_tensor(jnp.asarray(
            rng.uniform(-0.1, 0.1, (H, 4 * H)).astype(np.float32)))
        xp = jnp.asarray(rng.normal(size=(B, 9, 4 * H)), JDT[cd])
        h0 = (0.5 * rng.normal(size=(B, H))).astype(np.float32)
        c0 = rng.normal(size=(B, H)).astype(np.float32)
        want = lstm_pallas._lstm_core_fwd_v2_q(
            xp, qw.q, qw.scale, jnp.asarray(h0), jnp.asarray(c0))[0]
        got, _ = q8.lstm_recurrence_int8_reference(
            torch.tensor(np.asarray(xp.astype(jnp.float32))).to(cd),
            torch.from_numpy(np.asarray(qw.q)),
            torch.from_numpy(np.asarray(qw.scale)),
            torch.from_numpy(h0), torch.from_numpy(c0))
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-5


def test_batch_tile_matches_jax():
    from rnn_transducer_tpu.ops import lstm_pallas

    for B in (1, 3, 8, 16, 24, 32, 48, 64, 128):
        for H in (128, 512, 1024, 2048):
            assert q8.batch_tile(B, H) == min(
                lstm_pallas._tile_bt_v2(B, H)[0], B), (B, H)


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B, H", [(3, 128), (8, 100)])
def test_dequantized_route_matches_jax_scan(B, H, cd):
    """Shapes outside the W8A8 gate dequantize w_hh to the compute dtype,
    as the JAX scan path does on the encoder's tree (w_ih dequantized to
    f32 by encode's maybe_dequant_tree)."""
    I, T = 12, 9
    assert not w8a8_supported(B, H)
    jqp, tqp = _layer(7, I, H)
    jqp = dict(jqp, w_ih=jq.dequantize_tensor(jqp["w_ih"]))
    x, h0, c0 = _inputs(7, B, T, I, H)
    want, _ = jax_lstm.lstm_layer(jqp, jnp.asarray(x), jnp.asarray(h0),
                                  jnp.asarray(c0), compute_dtype=JDT[cd],
                                  impl="scan")
    got, _ = lstm_layer(tqp, torch.from_numpy(x), torch.from_numpy(h0),
                        torch.from_numpy(c0), compute_dtype=cd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


@pytest.mark.parametrize("B", [8, 3])  # the W8A8 and the dequantized route
def test_int8_layer_with_grad_raises(B):
    _, tqp = _layer(0, 4, 128)
    x = torch.zeros(B, 3, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only|no autograd"):
        lstm_layer(tqp, x, compute_dtype=torch.float32)


def test_int8_wrapper_rejects_a_partial_batch_tile():
    H = 128
    args = (torch.zeros(12, 2, 4 * H), torch.zeros(H, 4 * H, dtype=torch.int8),
            torch.ones(1, 4 * H), torch.zeros(12, H), torch.zeros(12, H))
    with pytest.raises(ValueError, match="batch tiles"):
        q8.lstm_recurrence_int8(*args)


# ----------------------- the model and its decoders -----------------------

def walking_params(params_np, blank_offset=0.25):
    """The random model with its encoder side of the joint scaled up 8x and
    blank raised: some rows emit at several frames up to the cap, others
    emit nothing (the decisions depend on the frames and on the int8
    encoder)."""
    p = jax.tree.map(np.copy, params_np)
    p["joint"]["enc_proj"]["w"] *= 8.0
    p["joint"]["out"]["b"][JCFG.blank] += blank_offset
    return p


def _batch(seed=1, B=8, T=30):
    rng = np.random.default_rng(seed)
    feats = (3 * rng.normal(size=(B, T, SMALL["input_dim"]))).astype(
        np.float32)
    lens = np.array([30, 25, 0, 17, 9, 30, 3, 22], np.int32)[:B]
    return feats, lens


@pytest.fixture
def jax_w8a8(monkeypatch):
    """The JAX encoder on the route the TPU takes for int8 params."""
    monkeypatch.setattr(jm, "lstm_layer",
                        functools.partial(jax_lstm.lstm_layer, impl="pallas"))


def test_int8_encode_matches_jax(params_np, jax_w8a8):
    feats, lens = _batch()
    jqp = jq.quantize_params(jax.tree.map(jnp.asarray, params_np))
    want, want_lens = jm.encode(jqp, JCFG, jnp.asarray(feats),
                                jnp.asarray(lens))
    tqp = tq.quantize_params(params_from_numpy(params_np))
    got, got_lens = tm.encode(tqp, TCFG, torch.from_numpy(feats),
                              torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_int8_recognize_greedy_matches_jax(params_np, jax_w8a8):
    p = walking_params(params_np)
    feats, lens = _batch(seed=2)
    jqp = jq.quantize_params(jax.tree.map(jnp.asarray, p))
    want = jax_recognize(jqp, JCFG, jnp.asarray(feats), jnp.asarray(lens),
                         max_symbols=MAX_SYMBOLS, with_confidence=True,
                         with_timestamps=True)
    tqp = tq.quantize_params(params_from_numpy(p))
    got = recognize_greedy(tqp, TCFG, torch.from_numpy(feats),
                           torch.from_numpy(lens), max_symbols=MAX_SYMBOLS,
                           with_confidence=True, with_timestamps=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-5, rtol=0)
    n, frames = got[1].numpy(), got[3].numpy()
    assert n.max() == MAX_SYMBOLS and n[2] == 0 and (n == 0).sum() > 1
    assert len({int(frames[b, i]) for b in range(8) for i in range(n[b])}) > 1


def test_engine_serves_int8_params(params_np):
    """BatchingEngine on quantized params gives each utterance the tokens
    of recognize_greedy on the padded batch it was served in."""
    p = walking_params(params_np)
    tqp = tq.quantize_params(params_from_numpy(p))
    feats, lens = _batch(seed=3)
    want = recognize_greedy(tqp, TCFG, torch.from_numpy(feats),
                            torch.from_numpy(lens), max_symbols=MAX_SYMBOLS)
    eng = BatchingEngine(tqp, TCFG, max_symbols=MAX_SYMBOLS,
                         frame_buckets=(30,), max_batch=8, window_ms=1.0,
                         device="cpu")
    try:
        for b in (0, 3, 4):
            got = eng.submit(feats[b, :lens[b]])
            assert got == want[0][b, :want[1][b]].tolist()
    finally:
        eng.close()


def test_serve_cli_takes_quantize_int8():
    assert port_serve.parse_args(["--quantize", "int8"]).quantize == "int8"
    assert port_serve.parse_args([]).quantize is None
    with pytest.raises(SystemExit):
        port_serve.parse_args(["--quantize", "int4"])
