"""PyTorch port greedy decode in one program vs the JAX package's
`greedy_decode_fused` (its Pallas kernel in interpret mode, as
tests/test_greedy_pallas.py runs it).

On the CPU `greedy_fused_tokens` runs the plain version of the CUDA
kernel K9; the tests hold it, `greedy_decode_fused` and
`recognize_greedy_fused` against JAX at E = H = J = 128, V = 11, in f32 and
bf16, with ragged lengths and a zero-length row, at the max_symbols cap,
and on int8 params (the W8A8 encoder and the fused decoder together).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.decode import greedy_pallas as jgp
from rnn_transducer_tpu.models import config as jax_config
from rnn_transducer_tpu.models import transducer as jm
from rnn_transducer_tpu.ops import lstm as jax_lstm
from rnn_transducer_tpu.ops import quant as jq
from rnn_transducer_tpu_torch.decode import greedy_fused as tgf
from rnn_transducer_tpu_torch.decode.greedy import greedy_decode
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.models import transducer as tm
from rnn_transducer_tpu_torch.ops import quant as tq
from rnn_transducer_tpu_torch.weights import params_from_numpy

pytestmark = pytest.mark.quick

# tests/test_greedy_pallas.py's config
SMALL = dict(enc_layers=1, enc_hidden=128, pred_layers=1, pred_hidden=128,
             embed_dim=128, joint_dim=128, vocab_size=11, input_dim=8,
             compute_dtype="float32")
MAX_SYMBOLS = 16
DTYPES = ["float32", "bfloat16"]


def _cfgs(compute_dtype="float32", **kw):
    fields = dict(SMALL, compute_dtype=compute_dtype, **kw)
    return (jax_config.TransducerConfig(**fields),
            port_config.TransducerConfig(**fields))


@pytest.fixture(scope="module")
def params_np():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0),
                                                   jcfg))


def _with_blank_offset(params_np, offset):
    p = jax.tree.map(np.copy, params_np)
    p["joint"]["out"]["b"][0] += offset
    return p


def _encoded(params_np, compute_dtype, seed=0, B=4, T=14):
    """The JAX encoder's output (B, T, 128) and ragged lengths with a
    zero-length row, as numpy."""
    jcfg, _ = _cfgs(compute_dtype)
    rng = np.random.default_rng(seed)
    feats = jnp.asarray(rng.normal(size=(B, T, 8)), jnp.float32)
    lens = jnp.asarray(np.array([14, 9, 0, 12, 5, 14, 1, 7][:B], np.int32))
    enc, enc_lens = jm.encode(jax.tree.map(jnp.asarray, params_np), jcfg,
                              feats, lens)
    return np.asarray(enc), np.asarray(enc_lens)


def _jax_fused(params, compute_dtype, enc, enc_lens, max_symbols=MAX_SYMBOLS):
    jcfg, _ = _cfgs(compute_dtype)
    toks, lens = jgp.greedy_decode_fused(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(enc),
        jnp.asarray(enc_lens), max_symbols=max_symbols)
    return np.asarray(toks), np.asarray(lens)


def _port_fused(params, compute_dtype, enc, enc_lens,
                max_symbols=MAX_SYMBOLS):
    _, tcfg = _cfgs(compute_dtype)
    toks, lens = tgf.greedy_decode_fused(
        params_from_numpy(params), tcfg, torch.from_numpy(enc),
        torch.from_numpy(enc_lens), max_symbols=max_symbols)
    return toks.numpy(), lens.numpy()


def test_supported_predicate_matches_jax():
    cases = [{}, {"pred_hidden": 100}, {"pred_layers": 2}, {"embed_dim": 96},
             {"joint_dim": 256}, {"embed_dim": 512, "pred_hidden": 512,
                                  "joint_dim": 512}]
    for kw in cases:
        jcfg, tcfg = _cfgs(**kw)
        assert tgf.supported(tcfg) == jgp.supported(jcfg), kw
    assert tgf.supported(port_config.config_libri100())


def test_unsupported_config_raises():
    _, tcfg = _cfgs(pred_hidden=100)
    with pytest.raises(ValueError, match="multiples of 128"):
        tgf.greedy_decode_fused({}, tcfg, torch.zeros(1, 2, 128),
                                torch.ones(1, dtype=torch.int32))


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("offset", [0.0, 0.02])
def test_fused_matches_jax(params_np, compute_dtype, offset):
    """Tokens and lengths identical to the JAX kernel, ragged lengths and
    a zero-length row; at offset 0 most rows run into the cap, at 0.02
    they emit a few tokens each at several frames."""
    p = _with_blank_offset(params_np, offset)
    enc, enc_lens = _encoded(p, compute_dtype, B=8)
    want = _jax_fused(p, compute_dtype, enc, enc_lens)
    got = _port_fused(p, compute_dtype, enc, enc_lens)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == got[1].dtype == np.int32
    assert got[1][2] == 0 and (got[0][2] == 0).all() and got[1].sum() > 8


@pytest.mark.parametrize("max_symbols", [1, 8])
def test_fused_max_symbols_cap_matches_jax(params_np, max_symbols):
    """Blank pushed far down (-50): every row with frames stops at the
    cap."""
    p = _with_blank_offset(params_np, -50.0)
    enc, enc_lens = _encoded(p, "float32", seed=1)
    want = _jax_fused(p, "float32", enc, enc_lens, max_symbols)
    got = _port_fused(p, "float32", enc, enc_lens, max_symbols)
    np.testing.assert_array_equal(got[0], want[0])
    want_n = [max_symbols, max_symbols, 0, max_symbols]
    assert got[1].tolist() == want[1].tolist() == want_n


@pytest.mark.parametrize("offset", [0.0, 0.02])
def test_fused_equals_the_lockstep_decoder(params_np, offset):
    """At f32 the fused loop gives the lock-step decoder's tokens."""
    p = _with_blank_offset(params_np, offset)
    enc, enc_lens = _encoded(p, "float32", seed=2, B=8)
    _, tcfg = _cfgs()
    tp = params_from_numpy(p)
    want_t, want_n, _ = greedy_decode(tp, tcfg, torch.from_numpy(enc),
                                      torch.from_numpy(enc_lens), MAX_SYMBOLS)
    got_t, got_n = tgf.greedy_decode_fused(tp, tcfg, torch.from_numpy(enc),
                                           torch.from_numpy(enc_lens),
                                           MAX_SYMBOLS)
    assert torch.equal(got_t, want_t) and torch.equal(got_n, want_n)


def test_reference_steps_count_frames_and_tokens(params_np):
    """The plain version counts one step per frame consumed and per token;
    a row at the cap stops before its last frame."""
    p = _with_blank_offset(params_np, 0.02)
    enc, enc_lens = _encoded(p, "float32", seed=3, B=8)
    _, tcfg = _cfgs()
    tp = params_from_numpy(p)
    jpar = tp["joint"]
    f = (tm._dot(torch.from_numpy(enc), jpar["enc_proj"]["w"], torch.float32)
         + jpar["enc_proj"]["b"])
    layer = tp["predictor"][0]
    weights = (tp["embed"], layer["w_ih"], layer["w_hh"], layer["b"],
               jpar["pred_proj"]["w"], jpar["pred_proj"]["b"],
               jpar["out"]["w"], jpar["out"]["b"])
    toks, steps = tgf.greedy_fused_tokens(
        f.contiguous(), torch.from_numpy(enc_lens), weights, MAX_SYMBOLS, 0,
        torch.float32)
    n = (toks != 0).sum(1)
    capped = n == MAX_SYMBOLS
    lens = torch.from_numpy(enc_lens)
    assert torch.equal(steps[~capped], (lens + n)[~capped].to(torch.int32))
    assert bool((steps[capped] <= (lens + n)[capped]).all())
    assert steps[2] == 0 and n.sum() > 0


@pytest.fixture
def jax_w8a8(monkeypatch):
    """The JAX encoder on the route the TPU takes for int8 params."""
    monkeypatch.setattr(jm, "lstm_layer",
                        functools.partial(jax_lstm.lstm_layer, impl="pallas"))


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_int8_recognize_greedy_fused_matches_jax(params_np, compute_dtype,
                                                 jax_w8a8):
    """int8 params at B = 8: the W8A8 encoder (K7's plain version) and the
    fused decoder (K9's) against JAX's Pallas int8 core and fused kernel."""
    p = _with_blank_offset(params_np, 0.02)
    jcfg, tcfg = _cfgs(compute_dtype)
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(8, 14, 8)).astype(np.float32)
    lens = np.array([14, 9, 0, 12, 5, 14, 1, 7], np.int32)
    jqp = jq.quantize_params(jax.tree.map(jnp.asarray, p))
    want = jgp.recognize_greedy_fused(jqp, jcfg, jnp.asarray(feats),
                                      jnp.asarray(lens), MAX_SYMBOLS)
    tqp = tq.quantize_params(params_from_numpy(p))
    got = tgf.recognize_greedy_fused(tqp, tcfg, torch.from_numpy(feats),
                                     torch.from_numpy(lens), MAX_SYMBOLS)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert int(got[1].sum()) > 8 and got[1][2] == 0


def test_recognize_greedy_fused_matches_jax_float(params_np):
    p = _with_blank_offset(params_np, 0.02)
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(3, 14, 8)).astype(np.float32)
    lens = np.array([14, 9, 12], np.int32)
    want = jgp.recognize_greedy_fused(jax.tree.map(jnp.asarray, p), jcfg,
                                      jnp.asarray(feats), jnp.asarray(lens),
                                      MAX_SYMBOLS)
    got = tgf.recognize_greedy_fused(params_from_numpy(p), tcfg,
                                     torch.from_numpy(feats),
                                     torch.from_numpy(lens), MAX_SYMBOLS)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
