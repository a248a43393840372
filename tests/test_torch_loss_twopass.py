"""The port's two-pass RNN-T loss (`ops/rnnt_loss_cuda.py`: `extract_lp`,
`assemble_grad` and the autograd op, the plain versions of the K5 kernels
on the CPU) against the JAX package's `rnnt_loss_pallas` (its Pallas
kernels in interpret mode on the CPU) and the float64 oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.ops import rnnt_loss as jl
from rnn_transducer_tpu.ops import rnnt_loss_pallas as jp
from rnn_transducer_tpu.ops.rnnt_oracle import (rnnt_grad_oracle,
                                                rnnt_loss_oracle)
from rnn_transducer_tpu_torch.ops import rnnt_loss as tl
from rnn_transducer_tpu_torch.ops import rnnt_loss_cuda as lc

pytestmark = pytest.mark.quick

LOSS_TOL = dict(rtol=1e-5, atol=1e-4)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed=0, B=5, T=7, U=3, V=130):
    """V = 130 is not a multiple of 128 (the TPU's lanes) nor of 4 or 8
    (the kernels' vectors). Ragged lengths with one zero-frame row (b=2)
    and one label_len 0 row (b=3); padded labels are blank."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, U + 1, V)).astype(np.float32)
    frame_lens = np.array([T, T - 2, 0, 4, 1], np.int32)[:B]
    label_lens = np.array([U, 2, 1, 0, 1], np.int32)[:B]
    labels = rng.integers(1, V, size=(B, U)).astype(np.int32)
    labels = np.where(np.arange(U)[None] < label_lens[:, None], labels, 0)
    cot = rng.normal(size=(B,)).astype(np.float32)
    return logits, labels, frame_lens, label_lens, cot


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extract_lp_matches_jax(dtype):
    logits, labels, *_ = _case()
    x = jnp.asarray(logits).astype(dtype)
    want = jp.extract_lp(x, jnp.asarray(labels), 0)
    got = lc.extract_lp(torch.from_numpy(np.array(x.astype(jnp.float32)))
                        .to(getattr(torch, dtype)), torch.from_numpy(labels))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    assert (got[1][:, :, -1] == tl.NEG_INF).all()  # no label at u = U


@pytest.mark.parametrize("real_occupancies", [True, False])
def test_assemble_grad_matches_jax(real_occupancies):
    """On the lattice's own occupancies, and on random ones with labels
    equal to blank inside the label length, where both one-hot terms
    apply."""
    logits, labels, fl, ll, cot = _case(seed=1)
    rng = np.random.default_rng(2)
    if real_occupancies:
        lp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
        gb, gy = jl.occupancies_from_lp(
            lp[..., 0], jl._gather_label_logprobs(lp, jnp.asarray(labels)),
            jnp.asarray(fl), jnp.asarray(ll))
        gb, gy = (np.asarray(a) * cot[:, None, None] for a in (gb, gy))
    else:
        labels[:, 0] = 0
        gb, gy = (rng.uniform(0, 1, size=logits.shape[:3]).astype(np.float32)
                  for _ in range(2))
    occ = (gb + gy).astype(np.float32)
    want = jp.assemble_grad(*(jnp.asarray(a) for a in (logits, labels, occ,
                                                        gb, gy)), 0)
    got = lc.assemble_grad(*(torch.from_numpy(np.ascontiguousarray(a))
                             for a in (logits, labels, occ, gb, gy)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


def _port(logits, labels, fl, ll, cot, fastemit=0.0, dtype=torch.float32):
    x = torch.tensor(logits).to(dtype).requires_grad_(True)
    loss = lc.rnnt_loss_twopass(x, torch.from_numpy(labels),
                                torch.from_numpy(fl), torch.from_numpy(ll), 0,
                                fastemit)
    (loss * torch.from_numpy(cot)).sum().backward()
    return loss.detach().numpy(), x.grad


@pytest.mark.parametrize("fastemit", [0.0, 0.5])
def test_loss_and_grad_match_jax_pallas(fastemit):
    logits, labels, fl, ll, cot = _case(seed=3)
    args = (jnp.asarray(labels), jnp.asarray(fl), jnp.asarray(ll), 0,
            fastemit)
    want = np.asarray(jp.rnnt_loss_pallas(jnp.asarray(logits), *args))
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(
        jp.rnnt_loss_pallas(x, *args) * cot))(jnp.asarray(logits)))
    got, got_g = _port(logits, labels, fl, ll, cot, fastemit)
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert got_g.dtype == torch.float32
    np.testing.assert_allclose(got_g.numpy(), want_g, **GRAD_TOL)
    assert got[2] == 0.0 and not got_g[2].any()  # zero-frame row


def test_loss_and_grad_match_float64_oracle():
    logits, labels, fl, ll, cot = _case(seed=4, V=33)
    got, got_g = _port(logits, labels, fl, ll, np.ones_like(cot))
    keep = fl > 0  # the oracle has no zero-frame convention
    want = rnnt_loss_oracle(logits[keep], labels[keep], fl[keep], ll[keep])
    want_g = rnnt_grad_oracle(logits[keep], labels[keep], fl[keep], ll[keep])
    np.testing.assert_allclose(got[keep], want, **LOSS_TOL)
    np.testing.assert_allclose(got_g.numpy()[keep], want_g, atol=1e-5)


def test_two_pass_equals_the_xla_path():
    """The two routes over the same logits: one pass of extraction against
    the materialised log-softmax, the fused gradient against the scatter."""
    logits, labels, fl, ll, cot = _case(seed=5, V=40)
    got, got_g = _port(logits, labels, fl, ll, cot, 0.5)
    x = torch.tensor(logits, requires_grad=True)
    want = tl.rnnt_loss(x, torch.from_numpy(labels), torch.from_numpy(fl),
                        torch.from_numpy(ll), 0, 0.5)
    (want * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got, want.detach().numpy(), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), x.grad.numpy(), rtol=1e-6,
                               atol=1e-6)
    mean = lc.rnnt_loss_twopass_mean(
        torch.tensor(logits), torch.from_numpy(labels), torch.from_numpy(fl),
        torch.from_numpy(ll))
    np.testing.assert_allclose(float(mean), got.mean(), rtol=1e-6)


def test_bf16_logits_give_a_finite_bf16_gradient():
    logits, labels, fl, ll, cot = _case(seed=6)
    got, got_g = _port(logits, labels, fl, ll, cot, dtype=torch.bfloat16)
    assert got_g.dtype == torch.bfloat16
    assert torch.isfinite(got_g.float()).all()
    # the same math on the bf16-rounded logits, its gradient rounded once
    x = np.asarray(torch.tensor(logits).bfloat16().float())
    want, want_g = _port(x, labels, fl, ll, cot)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(got_g.float().numpy(),
                                  want_g.bfloat16().float().numpy())


def test_cpu_runs_the_reference_without_counting():
    logits, labels, *_ = _case(seed=7)
    x, lab = torch.from_numpy(logits), torch.from_numpy(labels)
    before = (lc.LAUNCHES_EXTRACT, lc.LAUNCHES_GRAD)
    got = lc.extract_lp(x, lab)
    for g, w in zip(got, lc.extract_lp_reference(x, lab)):
        assert torch.equal(g, w)
    occ = torch.rand(got[0].shape)
    args = (x, lab, occ, occ * 0.25, occ * 0.75)
    assert torch.equal(lc.assemble_grad(*args),
                       lc.assemble_grad_reference(*args))
    assert (lc.LAUNCHES_EXTRACT, lc.LAUNCHES_GRAD) == before


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(2, 3, 4, 5)
    lab = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        lc.extract_lp(x.double(), lab)
    with pytest.raises(TypeError, match="int32"):
        lc.extract_lp(x, lab.long())
    with pytest.raises(ValueError, match="labels must be"):
        lc.extract_lp(x, lab[:, :2])
    with pytest.raises(ValueError, match="blank 5 outside"):
        lc.extract_lp(x, lab, blank=5)
    with pytest.raises(ValueError, match="occ must be"):
        lc.assemble_grad(x, lab, torch.zeros(2, 3, 3), torch.zeros(2, 3, 4),
                         torch.zeros(2, 3, 4))
    meta = torch.empty(2, 3, 4, 5, device="meta")
    with pytest.raises(ValueError, match="no extract_lp for device meta"):
        lc.extract_lp(meta, lab.to("meta"))
