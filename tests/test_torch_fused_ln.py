"""The port's fused LayerNorm (ops/fused_ln.py) against the JAX package's.

On the CPU `fused_layer_norm` runs the plain versions of K8-fwd and
K8-bwd; the JAX `fused_layer_norm` runs its Pallas kernels in interpret
mode. Tolerances are those of tests/test_fused_ln.py: the forward within
1e-5, the gradients within 2e-4 relative and 2e-5 absolute (f32 sums in
another order, dg and db summed over every row).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.ops import fused_ln as jfl
from rnn_transducer_tpu_torch.ops import fused_ln as tfl

pytestmark = pytest.mark.quick

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
# (2, 7, 64): a (B, T, D) activation; (ROWS + 3, 32): rows that are not
# a multiple of the TPU kernel's 256-row tile
SHAPES = [((2, 7, 64), 64), ((jfl.ROWS + 3, 32), 32)]


def _inputs(shape, d, seed=0):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.normal(size=shape)).astype(np.float32)
    g = rng.normal(size=(d,)).astype(np.float32)
    b = rng.normal(size=(d,)).astype(np.float32)
    w = rng.normal(size=shape).astype(np.float32)  # non-uniform cotangent
    return x, g, b, w


@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("shape, d", SHAPES)
def test_fused_layer_norm_matches_jax_kernel(act, shape, d):
    x, g, b, w = _inputs(shape, d)
    want = jfl.fused_layer_norm(jnp.asarray(x), jnp.asarray(g),
                                jnp.asarray(b), act)
    want_grads = jax.grad(
        lambda *a: jnp.sum(jfl.fused_layer_norm(*a, act) * w),
        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    xs, gs, bs = (torch.from_numpy(a).requires_grad_(True) for a in (x, g, b))
    got = tfl.fused_layer_norm(xs, gs, bs, act)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **FWD_TOL)
    grads = torch.autograd.grad((got * torch.from_numpy(w)).sum(),
                                (xs, gs, bs))
    for name, a, e in zip("xgb", grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), **GRAD_TOL,
                                   err_msg=f"d{name} act={act}")


@pytest.mark.parametrize("act", ["none", "silu"])
def test_row_statistics_match_jax_residuals(act):
    """mu and rstd of the port's forward are the JAX forward's residuals
    (its rows past N are the TPU padding and are dropped)."""
    x, g, b, _ = _inputs((jfl.ROWS + 3, 32), 32, seed=1)
    _, (_, _, _, mu, rstd, _) = jfl._fln_fwd(jnp.asarray(x), jnp.asarray(g),
                                             jnp.asarray(b), act)
    _, got_mu, got_rstd = tfl.fln_fwd(*(torch.from_numpy(a) for a in
                                        (x, g, b)), act)
    n = x.shape[0]
    np.testing.assert_allclose(got_mu.numpy(), np.asarray(mu)[:n, 0],
                               **FWD_TOL)
    np.testing.assert_allclose(got_rstd.numpy(), np.asarray(rstd)[:n, 0],
                               **FWD_TOL)


@pytest.mark.parametrize("act", ["none", "silu"])
def test_plain_backward_matches_autograd_of_reference(act):
    """fln_bwd's plain version (the `_bwd_kernel` math) against autograd
    through `layer_norm_reference`, the comparison chip_smoke.py makes
    for K8-bwd on the card."""
    x, g, b, w = _inputs((2, 7, 64), 64, seed=2)
    xs, gs, bs = (torch.from_numpy(a).requires_grad_(True) for a in (x, g, b))
    ref = tfl.layer_norm_reference(xs, gs, bs, act)
    want = torch.autograd.grad((ref * torch.from_numpy(w)).sum(),
                               (xs, gs, bs))
    x2 = torch.from_numpy(x).reshape(-1, 64)
    _, mu, rstd = tfl.fln_fwd(x2, torch.from_numpy(g), torch.from_numpy(b),
                              act)
    got = tfl.fln_bwd(x2, torch.from_numpy(g), torch.from_numpy(b), mu, rstd,
                      torch.from_numpy(w).reshape(-1, 64), act)
    np.testing.assert_allclose(got[0].reshape(x.shape).numpy(),
                               want[0].numpy(), **GRAD_TOL)
    for a, e in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), e.numpy(), **GRAD_TOL)


def test_cpu_runs_the_plain_version_and_counts_no_launch():
    x, g, b, _ = _inputs((4, 32), 32)
    before = (tfl.LAUNCHES_FWD, tfl.LAUNCHES_BWD)
    xs = torch.from_numpy(x).requires_grad_(True)
    y = tfl.fused_layer_norm(xs, torch.from_numpy(g), torch.from_numpy(b))
    y.sum().backward()
    assert (tfl.LAUNCHES_FWD, tfl.LAUNCHES_BWD) == before
    torch.testing.assert_close(
        y, tfl.layer_norm_reference(torch.from_numpy(x), torch.from_numpy(g),
                                    torch.from_numpy(b)), rtol=0, atol=0)


@pytest.mark.parametrize("bad, err", [
    (dict(act="gelu"), ValueError),
    (dict(x=torch.zeros(4, 32, dtype=torch.bfloat16)), TypeError),
    (dict(g=torch.ones(31)), ValueError),
    (dict(x=torch.zeros(4, 64)[:, ::2]), ValueError),  # not contiguous
])
def test_wrappers_refuse_bad_inputs(bad, err):
    args = {"x": torch.zeros(4, 32), "g": torch.ones(32),
            "b": torch.zeros(32), "act": "none", **bad}
    with pytest.raises(err):
        tfl.fln_fwd(args["x"], args["g"], args["b"], args["act"])


@pytest.mark.parametrize("n", [1, 7, 1600, 6400, 100_003])
def test_backward_row_ranges_cover_the_rows(n):
    """The backward's one launch: at most TARGET_BLOCKS blocks, every row
    in exactly one block, block sizes within one row of each other, all of
    it (and the order of the dg / db sums) a function of N alone; the
    partial rows added in groups of GROUP, in block order, then the groups
    in order, within the kernel's ticket array."""
    ranges = tfl.row_ranges(n)
    blocks = len(ranges)
    assert blocks == tfl.bwd_blocks(n) == min(n, tfl.TARGET_BLOCKS)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [stop - start for start, stop in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert sorted(set(sizes)) == sorted({n // blocks, -(-n // blocks)})
    groups = tfl.sum_groups(n)
    assert [p for grp in groups for p in grp] == list(range(blocks))
    assert all(1 <= len(grp) <= tfl.GROUP for grp in groups)
    assert len(groups) <= tfl.GROUP and len(groups) + 1 <= tfl.TICKETS
    assert (tfl.row_ranges(n), tfl.sum_groups(n)) == (ranges, groups)
