"""The port's fused band joint (ops/rnnt_band_fused.py, K6's plain versions
on the CPU) against the JAX package's `band_lp_fused`, its Pallas kernels
in interpret mode, at f32: the band scores and the gradients in f, g_w, w
and b from random loss cotangents."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.ops import rnnt_band_fused as jband
from rnn_transducer_tpu_torch.ops import rnnt_band_fused as tband

pytestmark = pytest.mark.quick

# f32 on both sides: the scores differ by summation order only; the
# gradients are sums over V (dz), over the band rows (dW, db) and over S
# (df) in another order.
LP_ATOL = 1e-5
GRAD_TOL = dict(rtol=1e-5, atol=2e-5)
BLANK = 0


def _inputs(B, T, S, J, V, seed):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(B, T, J)).astype(np.float32)
    g_w = rng.normal(size=(B, T, S, J)).astype(np.float32)
    w = (0.4 * rng.normal(size=(J, V))).astype(np.float32)
    b = (0.1 * rng.normal(size=V)).astype(np.float32)
    lab_w = rng.integers(0, V, size=(B, T, S)).astype(np.int32)
    lab_w[:, ::2, 0] = BLANK  # cells whose label is the blank id
    cb = rng.normal(size=(B, T, S)).astype(np.float32)
    cy = rng.normal(size=(B, T, S)).astype(np.float32)
    return f, g_w, w, b, lab_w, cb, cy


def _pad_band(x, Sp, fill=None):
    """(B, T, S, ...) -> (B, T, Sp, ...): the TPU kernel's band padding,
    the last row repeated (or `fill`), as `_pruned_lp` pads."""
    S = x.shape[2]
    if Sp == S:
        return x
    tail = (np.repeat(x[:, :, -1:], Sp - S, axis=2) if fill is None
            else np.full(x.shape[:2] + (Sp - S,) + x.shape[3:], fill,
                         x.dtype))
    return np.concatenate([x, tail], axis=2)


def _jax_band(f, g_w, w, b, lab_w, cb, cy):
    """JAX band_lp_fused on S padded to a multiple of 8, cut back to S."""
    S = g_w.shape[2]
    Sp = -(-S // 8) * 8
    lab_p = jnp.asarray(_pad_band(lab_w, Sp))
    out, vjp = jax.vjp(
        lambda f_, g_, w_, b_: jband.band_lp_fused(f_, g_, w_, b_, lab_p,
                                                   BLANK, jnp.float32),
        *(jnp.asarray(a) for a in (f, _pad_band(g_w, Sp), w, b)))
    grads = vjp((jnp.asarray(_pad_band(cb, Sp, 0.0)),
                 jnp.asarray(_pad_band(cy, Sp, 0.0))))
    lp = [np.asarray(o)[:, :, :S] for o in out]
    df, dgw, dw, db = (np.asarray(g) for g in grads)
    return lp, (df, dgw[:, :, :S], dw, db)


def _port_band(f, g_w, w, b, lab_w, cb, cy):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (f, g_w, w, b)]
    lpb, lpy = tband.band_lp_fused(*leaves, torch.from_numpy(lab_w), BLANK,
                                   torch.float32)
    grads = torch.autograd.grad((lpb, lpy), leaves,
                                (torch.from_numpy(cb), torch.from_numpy(cy)))
    return ([lpb.detach().numpy(), lpy.detach().numpy()],
            [g.numpy() for g in grads])


# (B, T, S, J, V): S not a multiple of 8 (JAX pads the band to Sp), S a
# multiple of 8, V not a multiple of 128 (JAX pads it to the lane width)
@pytest.mark.parametrize("B, T, S, J, V", [(2, 5, 3, 16, 40),
                                           (3, 4, 8, 12, 29),
                                           (1, 7, 4, 8, 33)])
def test_band_lp_fused_matches_jax(B, T, S, J, V):
    args = _inputs(B, T, S, J, V, seed=S + V)
    want_lp, want_g = _jax_band(*args)
    got_lp, got_g = _port_band(*args)
    for name, a, e in zip(("lp_blank", "lp_y"), got_lp, want_lp):
        np.testing.assert_allclose(a, e, rtol=0, atol=LP_ATOL, err_msg=name)
    for name, a, e in zip(("df", "dg_w", "dw", "db"), got_g, want_g):
        np.testing.assert_allclose(a, e, err_msg=name, **GRAD_TOL)


def test_band_lp_fwd_picks_zero_for_a_label_outside_the_vocabulary():
    """lab_w outside [0, V) scores lp_y = -base, the TPU kernel's iota
    compare (a row the caller masks may carry any id)."""
    f, g_w, w, b, lab_w, _, _ = _inputs(2, 3, 4, 8, 20, seed=1)
    lab_w[0, 1, 2] = -1
    lab_w[1, 0, 0] = 20
    lpb, lpy, base = tband.band_lp_fwd(*(torch.from_numpy(a) for a in
                                         (f, g_w, lab_w, w, b)))
    assert float(lpy[0, 1, 2]) == -float(base[0, 1, 2])
    assert float(lpy[1, 0, 0]) == -float(base[1, 0, 0])


def test_band_lp_bwd_b_repeats_bit_for_bit():
    f, g_w, w, b, lab_w, cb, cy = (torch.from_numpy(a) for a in
                                   _inputs(2, 5, 3, 16, 40, seed=2))
    base = tband.band_lp_fwd(f, g_w, lab_w, w, b)[2]
    args = (f, g_w, lab_w, w, b, base, cb, cy)
    first = tband.band_lp_bwd_b(*args)
    second = tband.band_lp_bwd_b(*args)
    for a, e in zip(first, second):
        assert torch.equal(a, e)


def test_bf16_weights_give_bf16_gradients_from_f32_sums():
    """compute_dtype bf16: the products round their operands to bf16 and
    sum in f32 (the wrapper's dtypes); the gradients come back in the
    inputs' dtypes."""
    f, g_w, w, b, lab_w, cb, cy = _inputs(1, 3, 4, 16, 24, seed=3)
    leaves = [torch.from_numpy(f).requires_grad_(True),
              torch.from_numpy(g_w).requires_grad_(True),
              torch.from_numpy(w).to(torch.bfloat16).requires_grad_(True),
              torch.from_numpy(b).requires_grad_(True)]
    lpb, lpy = tband.band_lp_fused(*leaves, torch.from_numpy(lab_w), BLANK,
                                   torch.bfloat16)
    assert lpb.dtype == lpy.dtype == torch.float32
    grads = torch.autograd.grad((lpb, lpy), leaves,
                                (torch.from_numpy(cb), torch.from_numpy(cy)))
    assert [g.dtype for g in grads] == [a.dtype for a in leaves]


def test_row_splits_follow_the_vocabulary():
    """Kernel B's row splits: 16 at V = 1024 (32 column tiles), 3 at the
    pruned card shape's V = 8192 (256 tiles), never below 1."""
    assert tband.row_splits(1024) == 16
    assert tband.row_splits(8192) == 3
    assert tband.row_splits(100_000) == 1
