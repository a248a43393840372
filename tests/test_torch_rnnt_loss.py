"""The port's plain RNN-T loss (`ops/rnnt_loss.py`: masking, alpha and beta
along anti-diagonals, occupancies, the occupancy-gradient autograd op,
FastEmit) against the JAX package's `rnnt_loss` and the float64 oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.ops import rnnt_loss as jl
from rnn_transducer_tpu.ops.rnnt_oracle import (rnnt_grad_oracle,
                                                rnnt_loss_oracle)
from rnn_transducer_tpu_torch.ops import rnnt_lattice_cuda
from rnn_transducer_tpu_torch.ops import rnnt_loss as tl

pytestmark = pytest.mark.quick


def _case(seed=0, B=5, T=7, U=3, V=6):
    """Ragged lengths with one zero-frame row (b=2) and one label_len 0
    row (b=3); padded labels are blank."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, U + 1, V)).astype(np.float32)
    frame_lens = np.array([T, T - 2, 0, 4, 1], np.int32)[:B]
    label_lens = np.array([U, 2, 1, 0, 1], np.int32)[:B]
    labels = rng.integers(1, V, size=(B, U)).astype(np.int32)
    labels = np.where(np.arange(U)[None] < label_lens[:, None], labels, 0)
    cot = rng.normal(size=(B,)).astype(np.float32)
    return logits, labels, frame_lens, label_lens, cot


def _port(logits, labels, fl, ll, cot, fastemit=0.0):
    x = torch.tensor(logits, requires_grad=True)
    loss = tl.rnnt_loss(x, torch.from_numpy(labels), torch.from_numpy(fl),
                        torch.from_numpy(ll), 0, fastemit)
    (loss * torch.from_numpy(cot)).sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("fastemit", [0.0, 0.5])
def test_loss_and_grad_match_jax(fastemit):
    logits, labels, fl, ll, cot = _case()
    args = (jnp.asarray(labels), jnp.asarray(fl), jnp.asarray(ll), 0,
            fastemit)
    want = np.asarray(jl.rnnt_loss(jnp.asarray(logits), *args))
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(
        jl.rnnt_loss(x, *args) * cot))(jnp.asarray(logits)))
    got, got_g = _port(logits, labels, fl, ll, cot, fastemit)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-5, atol=1e-5)
    assert got[2] == 0.0 and not got_g[2].any()  # zero-frame row


def test_loss_and_grad_match_float64_oracle():
    logits, labels, fl, ll, cot = _case(seed=1)
    got, got_g = _port(logits, labels, fl, ll, np.ones_like(cot))
    keep = fl > 0  # the oracle has no zero-frame convention
    want = rnnt_loss_oracle(logits[keep], labels[keep], fl[keep], ll[keep])
    want_g = rnnt_grad_oracle(logits[keep], labels[keep], fl[keep], ll[keep])
    np.testing.assert_allclose(got[keep], want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got_g[keep], want_g, atol=1e-5)


def test_alpha_beta_occupancies_match_jax():
    logits, labels, fl, ll, _ = _case(seed=2, T=9, U=4)
    lp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    lpb = np.asarray(lp[..., 0])
    lpy = np.asarray(jl._gather_label_logprobs(lp, jnp.asarray(labels)))
    j = [jnp.asarray(a) for a in (lpb, lpy, fl, ll)]
    t = [torch.tensor(np.asarray(a)) for a in (lpb, lpy, fl, ll)]
    want_loss, want_alpha = jl.forward_from_lp_with_alpha(*j)
    got_loss, got_alpha = tl.forward_from_lp_with_alpha(*t)
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(want_loss),
                               atol=1e-4)
    valid = np.asarray(want_alpha) > -1e29  # reachable cells
    np.testing.assert_allclose(got_alpha.numpy()[valid],
                               np.asarray(want_alpha)[valid], atol=1e-4)
    assert (got_alpha.numpy()[~valid] <= -1e29).all()
    bm, ym = jl._masked_transitions(*j)
    tbm, tym = tl._masked_transitions(*t)
    np.testing.assert_array_equal(tbm.numpy(), np.asarray(bm))
    np.testing.assert_array_equal(tym.numpy(), np.asarray(ym))
    for g, w in zip(tl.occupancies_from_lp(*t),
                    jl.occupancies_from_lp(*j)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    # the occupancies of a lattice sum to the number of frames consumed
    gb, gy = tl.occupancies_from_lp(*t)
    np.testing.assert_allclose(gb.sum(dim=(1, 2)).numpy(), fl, atol=1e-4)


def test_logaddexp_keeps_masked_cells():
    a = torch.tensor([tl.NEG_INF, 0.0, tl.NEG_INF, 2.0])
    b = torch.tensor([tl.NEG_INF, tl.NEG_INF, 1.0, 3.0])
    got = rnnt_lattice_cuda._logaddexp(a, b)
    assert got[0] == tl.NEG_INF
    np.testing.assert_allclose(got[1:].numpy(), [0.0, 1.0,
                                                 np.logaddexp(2.0, 3.0)],
                               rtol=1e-6)
