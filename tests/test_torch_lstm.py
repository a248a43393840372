"""PyTorch port LSTM ops vs the JAX package: the scan layer and the Pallas
kernel (interpret mode on the CPU), plus the recurrence wrapper's checks.
The CUDA kernel itself is tested in test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.ops.lstm import init_lstm_params
from rnn_transducer_tpu.ops.lstm import lstm_cell as jax_lstm_cell
from rnn_transducer_tpu.ops.lstm import lstm_layer as jax_lstm_layer
from rnn_transducer_tpu.ops.lstm import mask_padding as jax_mask_padding
from rnn_transducer_tpu.ops.lstm_pallas import lstm_layer_pallas
from rnn_transducer_tpu_torch.ops import lstm_cuda
from rnn_transducer_tpu_torch.ops.lstm import lstm_cell, lstm_layer, mask_padding
from rnn_transducer_tpu_torch.weights import params_from_numpy

pytestmark = pytest.mark.quick

TOL = dict(rtol=1e-5, atol=1e-5)  # fp32 on both sides; sums in another order


def _params(I, H, seed):
    return jax.tree.map(np.asarray,
                        init_lstm_params(jax.random.PRNGKey(seed), I, H))


def _inputs(B, T, I, H, seed, with_state):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, I)).astype(np.float32)
    if not with_state:
        return x, None, None
    return (x, rng.normal(size=(B, H)).astype(np.float32),
            rng.normal(size=(B, H)).astype(np.float32))


def _port_layer(p, x, h0, c0, cdtype=torch.float32):
    t = (lambda a: None if a is None else torch.from_numpy(a))
    hs, (hT, cT) = lstm_layer(params_from_numpy(p), t(x), t(h0), t(c0),
                              compute_dtype=cdtype)
    return hs.numpy(), hT.numpy(), cT.numpy()


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("reference", ["scan", "pallas"])
def test_layer_matches_jax(reference, with_state):
    """B=8, T=21 (not a TPU time-tile multiple), I=64, H=128."""
    B, T, I, H = 8, 21, 64, 128
    p = _params(I, H, seed=int(with_state))
    x, h0, c0 = _inputs(B, T, I, H, seed=3, with_state=with_state)
    j = (lambda a: None if a is None else jnp.asarray(a))
    if reference == "scan":
        want, (hT_w, cT_w) = jax_lstm_layer(
            p, j(x), j(h0), j(c0), compute_dtype=jnp.float32, impl="scan")
    else:
        want, (hT_w, cT_w) = lstm_layer_pallas(
            p, j(x), j(h0), j(c0), compute_dtype=jnp.float32)
    got, hT, cT = _port_layer(p, x, h0, c0)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(hT, np.asarray(hT_w), **TOL)
    np.testing.assert_allclose(cT, np.asarray(cT_w), **TOL)


def test_layer_bf16_matches_scan():
    """At bf16 both sides round h and the weights the same way and keep
    x_proj, c and the products in fp32: equal up to fp32 summation order
    and the rare bf16 rounding flip that order causes."""
    B, T, I, H = 4, 9, 16, 32
    p = _params(I, H, seed=5)
    x, _, _ = _inputs(B, T, I, H, seed=5, with_state=False)
    want, _ = jax_lstm_layer(p, jnp.asarray(x), compute_dtype=jnp.bfloat16,
                             impl="scan")
    got, _, _ = _port_layer(p, x, None, None, torch.bfloat16)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-3)


def test_cell_matches_jax():
    B, H = 5, 24
    p = _params(7, H, seed=6)
    rng = np.random.default_rng(6)
    xp = rng.normal(size=(B, 4 * H)).astype(np.float32)
    h = rng.normal(size=(B, H)).astype(np.float32)
    c = rng.normal(size=(B, H)).astype(np.float32)
    hw, cw = jax_lstm_cell(p, jnp.asarray(xp), jnp.asarray(h), jnp.asarray(c),
                           jnp.float32)
    hg, cg = lstm_cell(params_from_numpy(p), torch.from_numpy(xp),
                       torch.from_numpy(h), torch.from_numpy(c),
                       torch.float32)
    np.testing.assert_allclose(hg.numpy(), np.asarray(hw), **TOL)
    np.testing.assert_allclose(cg.numpy(), np.asarray(cw), **TOL)


def test_mask_padding_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 6, 4)).astype(np.float32)
    lens = np.array([6, 2, 0], np.int32)
    want = np.asarray(jax_mask_padding(jnp.asarray(x), jnp.asarray(lens)))
    got = mask_padding(torch.from_numpy(x), torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(got, want)


def _recurrence_args(B=2, T=3, H=4, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    return (torch.randn(B, T, 4 * H, generator=g),
            torch.randn(H, 4 * H, generator=g).to(dtype),
            torch.randn(B, H, generator=g), torch.randn(B, H, generator=g))


def test_cpu_recurrence_is_the_reference_and_launches_nothing():
    before = lstm_cuda.LAUNCHES
    args = _recurrence_args(dtype=torch.bfloat16)
    hs, (hT, cT) = lstm_cuda.lstm_recurrence(*args)
    hs_r, (hT_r, cT_r) = lstm_cuda.lstm_recurrence_reference(*args)
    torch.testing.assert_close(hs, hs_r, rtol=0, atol=0)
    torch.testing.assert_close(hT, hT_r, rtol=0, atol=0)
    torch.testing.assert_close(cT, cT_r, rtol=0, atol=0)
    assert lstm_cuda.LAUNCHES == before


def test_zero_length_recurrence_returns_initial_state():
    x, w, h0, c0 = _recurrence_args(T=0)
    hs, (hT, cT) = lstm_cuda.lstm_recurrence(x, w, h0, c0)
    assert hs.shape == (2, 0, 4)
    torch.testing.assert_close(hT, h0)
    torch.testing.assert_close(cT, c0)


@pytest.mark.parametrize("bad, exc", [
    ("x_rank", ValueError), ("w_shape", ValueError), ("h0_shape", ValueError),
    ("x_dtype", TypeError), ("w_dtype", TypeError),
    ("noncontiguous", ValueError), ("device", ValueError),
])
def test_recurrence_rejects_bad_inputs(bad, exc):
    x, w, h0, c0 = _recurrence_args()
    if bad == "x_rank":
        x = x[0]
    elif bad == "w_shape":
        w = w[:, :-1]
    elif bad == "h0_shape":
        h0 = h0[:1]
    elif bad == "x_dtype":
        x = x.double()
    elif bad == "w_dtype":
        w = w.half()
    elif bad == "noncontiguous":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "device":
        x, w, h0, c0 = (a.to("meta") for a in (x, w, h0, c0))
    with pytest.raises(exc):
        lstm_cuda.lstm_recurrence(x, w, h0, c0)
