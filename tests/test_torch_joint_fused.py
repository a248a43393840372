"""The port's fused joint + RNN-T loss (`ops/rnnt_joint_fused.py`; on the
CPU the plain versions of K1 and K2) against the JAX package's
`rnnt_loss_fused` in interpret mode, at the shapes of
tests/test_joint_fused.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.ops.rnnt_joint_fused import (
    _pad_axis, _prep_labels, _prep_wb)
from rnn_transducer_tpu.ops.rnnt_joint_fused import (
    joint_lp_fwd as jax_joint_lp_fwd)
from rnn_transducer_tpu.ops.rnnt_joint_fused import (
    rnnt_loss_fused as jax_fused)
from rnn_transducer_tpu.ops.rnnt_loss import rnnt_loss as jax_rnnt_loss
from rnn_transducer_tpu_torch.ops import rnnt_joint_fused as tf
from rnn_transducer_tpu_torch.ops.rnnt_loss import rnnt_loss

pytestmark = pytest.mark.quick


def _setup(B=3, T=11, U=4, J=32, V=21, seed=0, zero_frame_row=False):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(B, T, J)).astype(np.float32)
    g = rng.normal(size=(B, U + 1, J)).astype(np.float32)
    w = (rng.normal(size=(J, V)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(V,)) * 0.1).astype(np.float32)
    labels = rng.integers(1, V, size=(B, U)).astype(np.int32)
    fl = rng.integers(max(2, T - 3), T + 1, size=(B,)).astype(np.int32)
    ll = rng.integers(1, U + 1, size=(B,)).astype(np.int32)
    if zero_frame_row:
        fl[1] = 0
    return f, g, w, b, labels, fl, ll


def _jax(args, cot, cdtype, fused=True):
    f, g, w, b, labels, fl, ll = (jnp.asarray(a) for a in args)

    def loss(f, g, w, b):
        if fused:
            return jax_fused(f, g, w, b, labels, fl, ll,
                             compute_dtype=cdtype)
        z = jnp.tanh(f[:, :, None, :] + g[:, None, :, :])
        return jax_rnnt_loss(jnp.einsum("btuj,jv->btuv", z, w) + b, labels,
                             fl, ll)

    val = loss(f, g, w, b)
    grads = jax.grad(lambda *a: jnp.sum(loss(*a) * cot),
                     argnums=(0, 1, 2, 3))(f, g, w, b)
    return np.asarray(val), [np.asarray(x) for x in grads]


def _port(args, cot, cdtype, fastemit=0.0):
    f, g, w, b = (torch.tensor(a, requires_grad=True) for a in args[:4])
    labels, fl, ll = (torch.from_numpy(a) for a in args[4:])
    loss = tf.rnnt_loss_fused(f, g, w, b, labels, fl, ll, 0, cdtype, fastemit)
    (loss * torch.from_numpy(cot)).sum().backward()
    return loss.detach().numpy(), [x.grad.numpy() for x in (f, g, w, b)]


@pytest.mark.parametrize("zero_frame_row", [False, True])
def test_fused_loss_and_grads_match_jax(zero_frame_row):
    """f32, a non-uniform cotangent with a negative weight."""
    args = _setup(seed=1, zero_frame_row=zero_frame_row)
    cot = np.asarray([0.5, -1.25, 2.0], np.float32)
    want, want_g = _jax(args, cot, jnp.float32)
    got, got_g = _port(args, cot, torch.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    for name, a, e in zip("fgwb", got_g, want_g):
        np.testing.assert_allclose(a, e, rtol=2e-4, atol=2e-5,
                                   err_msg=f"grad d{name}")
    if zero_frame_row:
        assert got[1] == 0.0 and not got_g[0][1].any()


def test_fused_fastemit_matches_materialised_loss():
    """FastEmit through the fused op equals it through the materialised
    logits and the port's `rnnt_loss`: the emit occupancies are scaled by
    1 + lambda, the loss value is unchanged."""
    args = _setup(seed=2)
    cot = np.ones(3, np.float32)
    got, got_g = _port(args, cot, torch.float32, fastemit=0.3)
    f, g, w, b = (torch.tensor(a, requires_grad=True) for a in args[:4])
    z = torch.tanh(f[:, :, None] + g[:, None])
    loss = rnnt_loss(z @ w + b, *(torch.from_numpy(a) for a in args[4:]),
                     0, 0.3)
    loss.sum().backward()
    np.testing.assert_allclose(got, loss.detach().numpy(), rtol=1e-5)
    for a, e in zip(got_g, (f.grad, g.grad, w.grad, b.grad)):
        np.testing.assert_allclose(a, e.numpy(), rtol=2e-4, atol=2e-5)


def test_fused_bf16_grad_error_bounded():
    """bf16 compute: z, dlogits and W are rounded to bf16 for the products,
    as in the JAX kernels. Bound as tests/test_joint_fused.py states it:
    relative L2 gradient error under 2% against the f32 materialised
    reference (one bf16 rounding is 2^-8 = 0.4%), and the loss within
    1e-3 relative (the forward's reductions stay f32)."""
    args = _setup(B=4, T=24, U=6, J=32, V=64, seed=4)
    cot = np.ones(4, np.float32)
    want, want_g = _jax(args, cot, jnp.float32, fused=False)
    got, got_g = _port(args, cot, torch.bfloat16)
    for name, a, e in zip("fgwb", got_g, want_g):
        rel = np.linalg.norm(a - e) / (np.linalg.norm(e) + 1e-30)
        assert rel < 0.02, f"grad d{name} rel L2 error {rel:.4f}"
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-3)


def test_joint_lp_fwd_reference_matches_log_softmax():
    """lp_blank, lp_y and base of the plain K1 against log_softmax over the
    materialised logits in JAX; lp_y is -1e30 at u = U."""
    f, g, w, b, labels, _, _ = _setup(seed=3)
    z = jnp.tanh(jnp.asarray(f)[:, :, None] + jnp.asarray(g)[:, None])
    logits = jnp.einsum("btuj,jv->btuv", z, jnp.asarray(w)) + b
    lp = np.asarray(jax.nn.log_softmax(logits, axis=-1))
    base = np.asarray(jax.nn.logsumexp(logits, axis=-1))
    lpb, lpy, got_base = tf.joint_lp_fwd(*(torch.from_numpy(a) for a in
                                           (f, g, labels, w, b)))
    np.testing.assert_allclose(got_base.numpy(), base, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lpb.numpy(), lp[..., 0], atol=1e-5)
    U = labels.shape[1]
    want_y = np.take_along_axis(lp[:, :, :U], labels[:, None, :, None]
                                .repeat(lp.shape[1], 1), axis=-1)[..., 0]
    np.testing.assert_allclose(lpy.numpy()[:, :, :U], want_y, atol=1e-5)
    assert (lpy.numpy()[:, :, U] == -1e30).all()


@pytest.mark.parametrize("B, T, U, J, V, blank", [(3, 11, 4, 32, 21, 0),
                                                  (2, 19, 9, 16, 130, 3)])
def test_joint_lp_fwd_matches_the_jax_kernel(B, T, U, J, V, blank):
    """K1 on the CPU, all three arrays, against the JAX package's Pallas
    forward in interpret mode, its inputs padded as its caller
    `_fused_fwd` pads them (U+1 to a multiple of 8, V to 128 lanes with a
    -1e30 bias, labels -1 past U) and its outputs cropped to (B, T, U+1):
    f32 within 1e-5 (the same sums in another order); lp_y is -1e30 at
    u = U on both sides. T=19 spans two of its 16-frame tiles."""
    f, g, w, b, labels, _, _ = _setup(B=B, T=T, U=U, J=J, V=V,
                                      seed=T + V)
    U1 = U + 1
    g_p = _pad_axis(jnp.asarray(g), 1, 8)
    w_p, b_p = _prep_wb(jnp.asarray(w), jnp.asarray(b))
    want = jax_joint_lp_fwd(jnp.asarray(f), g_p,
                            _prep_labels(jnp.asarray(labels), g_p.shape[1]),
                            w_p, b_p, blank, jnp.float32)
    got = tf.joint_lp_fwd(*(torch.from_numpy(a) for a in
                            (f, g, labels, w, b)), blank)
    for name, a, e in zip(("lp_blank", "lp_y", "base"), got, want):
        e = np.asarray(e)[:, :, :U1]
        assert a.shape == e.shape == (B, T, U1), name
        np.testing.assert_allclose(a.numpy(), e, rtol=0, atol=1e-5,
                                   err_msg=name)
    assert (got[1].numpy()[:, :, U] == -1e30).all()


def test_wrappers_on_cpu_are_the_references_and_count_nothing():
    f, g, w, b, labels, fl, ll = (torch.from_numpy(a) for a in
                                  _setup(B=2, T=5, U=3, J=8, V=7, seed=5))
    before = (tf.LAUNCHES_FWD, tf.LAUNCHES_BWD)
    fwd = tf.joint_lp_fwd(f, g, labels, w, b)
    for a, e in zip(fwd, tf.joint_lp_fwd_reference(f, g, labels, w, b)):
        torch.testing.assert_close(a, e, rtol=0, atol=0)
    gb = torch.rand(2, 5, 4)
    gy = torch.rand(2, 5, 4)
    gbar = torch.tensor([1.0, -2.0])
    bwd_args = (f, g, labels, w, b, gb, gy, fwd[2], gbar)
    for a, e in zip(tf.joint_lp_bwd(*bwd_args),
                    tf.joint_lp_bwd_reference(*bwd_args)):
        torch.testing.assert_close(a, e, rtol=0, atol=0)
    assert (tf.LAUNCHES_FWD, tf.LAUNCHES_BWD) == before


@pytest.mark.parametrize("bad, exc", [
    ("labels_dtype", TypeError), ("labels_shape", ValueError),
    ("w_rows", ValueError), ("f_dtype", TypeError),
    ("noncontiguous", ValueError), ("gy_shape", ValueError),
])
def test_wrappers_reject_bad_inputs(bad, exc):
    f, g, w, b, labels, _, _ = (torch.from_numpy(a) for a in
                                _setup(B=2, T=5, U=3, J=8, V=7, seed=6))
    gb = gy = base = torch.zeros(2, 5, 4)
    if bad == "labels_dtype":
        labels = labels.long()
    elif bad == "labels_shape":
        labels = labels[:, :2]
    elif bad == "w_rows":
        w = w[:-1]
    elif bad == "f_dtype":
        f = f.double()
    elif bad == "noncontiguous":
        g = g.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "gy_shape":
        gy = torch.zeros(2, 5, 3)
    with pytest.raises(exc):
        if bad == "gy_shape":
            tf.joint_lp_bwd(f, g, labels, w, b, gb, gy, base,
                            torch.ones(2))
        else:
            tf.joint_lp_fwd(f, g, labels, w, b)
