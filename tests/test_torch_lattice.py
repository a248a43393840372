"""The port's RNN-T lattice (`ops/rnnt_lattice_cuda.py`: alpha, beta and the
occupancies, the plain versions of the K3 kernel on the CPU) against the
JAX package's Pallas wavefront (`alpha_wavefront`, `beta_wavefront`, in
interpret mode on the CPU), its scan recursions (`_alpha_scan`,
`_beta_scan`) and `occupancies_from_lp`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.ops import rnnt_loss as jl
from rnn_transducer_tpu.ops.rnnt_lattice_pallas import (alpha_wavefront,
                                                        beta_wavefront)
from rnn_transducer_tpu_torch.ops import rnnt_lattice_cuda as lat

pytestmark = pytest.mark.quick

# Reachable cells: float32 sums in another order (the anti-diagonal
# recursion against the scan's row solve) over at most T + U terms.
REACH_TOL = dict(rtol=1e-5, atol=1e-4)
# An occupancy is exp(... - log Z): a few ulps of log Z in float32 are an
# error of g * |log Z| * 2^-23, within 1e-5 while |log Z| stays below ~40
# (T + U <= ~26 at these scores).
OCC_ATOL = 1e-5

# (B, T, U): ragged lengths with a zero-frame row and a label_len-0 row;
# U+1 odd in three of them; one with a single frame.
SHAPES = [(5, 7, 4), (5, 1, 3), (4, 12, 6), (3, 16, 10)]


def _problem(B, T, U, seed=0, V=6):
    """The JAX package's masked scores and acceptance scores, as numpy."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(B, T, U + 1, V)).astype(np.float32)
    fl = np.array([T, max(T - 2, 1), 0, min(4, T), 1], np.int32)[:B]
    ll = np.array([U, 2, 1, 0, U], np.int32)[:B]
    labels = rng.integers(1, V, size=(B, U)).astype(np.int32)
    labels = np.where(np.arange(U)[None] < ll[:, None], labels, 0)
    _, lpb, lpy, lpb_m, lpy_m, accept = jl._prepare(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(fl),
        jnp.asarray(ll), 0)
    arrays = {k: np.asarray(v) for k, v in (
        ("lpb", lpb), ("lpy", lpy), ("lpb_m", lpb_m), ("lpy_m", lpy_m),
        ("accept", accept))}
    return arrays, fl, ll


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_lattice_close(got, want):
    """Reachable cells within REACH_TOL; unreachable cells at or below
    -1e29 on both sides."""
    got, want = np.asarray(got), np.asarray(want)
    reach = want > -1e29
    np.testing.assert_allclose(got[reach], want[reach], **REACH_TOL)
    assert (got[~reach] <= -1e29).all()
    assert (got > -1e29).sum() == reach.sum()


@pytest.mark.parametrize("B, T, U", SHAPES)
def test_alpha_matches_jax_wavefront_and_scan(B, T, U):
    a, _, _ = _problem(B, T, U)
    got = lat.alpha_wavefront(_t(a["lpb_m"]), _t(a["lpy_m"])).numpy()
    j = (jnp.asarray(a["lpb_m"]), jnp.asarray(a["lpy_m"]))
    _assert_lattice_close(got, alpha_wavefront(*j))
    _assert_lattice_close(got, jl._alpha_scan(*j))
    assert got[0, 0, 0] == 0.0


@pytest.mark.parametrize("B, T, U", SHAPES)
def test_beta_matches_jax_wavefront_and_scan(B, T, U):
    a, _, _ = _problem(B, T, U, seed=1)
    got = lat.beta_wavefront(_t(a["lpb_m"]), _t(a["lpy_m"]),
                             _t(a["accept"])).numpy()
    j = (jnp.asarray(a["lpb_m"]), jnp.asarray(a["lpy_m"]),
         jnp.asarray(a["accept"]))
    _assert_lattice_close(got, beta_wavefront(*j))
    _assert_lattice_close(got, jl._beta_scan(*j))
    assert (got[2] <= -1e29).all()  # the zero-frame row accepts nowhere


@pytest.mark.parametrize("B, T, U", SHAPES)
def test_beta_occupancies_match_jax(B, T, U):
    a, fl, ll = _problem(B, T, U, seed=2)
    alpha = lat.alpha_wavefront(_t(a["lpb_m"]), _t(a["lpy_m"]))
    beta, gb, gy = lat.beta_occupancies(_t(a["lpb_m"]), _t(a["lpy_m"]),
                                        _t(a["accept"]), alpha, _t(fl))
    want_gb, want_gy = jl.occupancies_from_lp(
        *(jnp.asarray(x) for x in (a["lpb"], a["lpy"], fl, ll)))
    np.testing.assert_allclose(gb.numpy(), np.asarray(want_gb), rtol=0,
                               atol=OCC_ATOL)
    np.testing.assert_allclose(gy.numpy(), np.asarray(want_gy), rtol=0,
                               atol=OCC_ATOL)
    _assert_lattice_close(beta.numpy(), jl._beta_scan(
        *(jnp.asarray(a[k]) for k in ("lpb_m", "lpy_m", "accept"))))
    # a lattice's blank occupancies sum to its frames; none for no frames
    np.testing.assert_allclose(gb.sum(dim=(1, 2)).numpy(), fl, atol=1e-4)
    assert not gb[2].any() and not gy[2].any()
    # the emit occupancies sum to the labels emitted
    np.testing.assert_allclose(gy.sum(dim=(1, 2)).numpy()[fl > 0],
                               ll[fl > 0], atol=1e-4)


def test_beta_occupancies_agrees_with_beta_wavefront():
    a, fl, _ = _problem(4, 12, 6, seed=3)
    args = (_t(a["lpb_m"]), _t(a["lpy_m"]), _t(a["accept"]))
    alpha = lat.alpha_wavefront(*args[:2])
    beta, _, _ = lat.beta_occupancies(*args, alpha, _t(fl))
    assert torch.equal(beta, lat.beta_wavefront(*args))


@pytest.mark.parametrize("fn, n_args", [
    (lat.alpha_wavefront, 2), (lat.beta_wavefront, 3),
    (lat.beta_occupancies, 4)])
def test_cpu_runs_the_reference_without_counting(fn, n_args):
    a, fl, _ = _problem(3, 9, 4, seed=4)
    args = [_t(a[k]) for k in ("lpb_m", "lpy_m", "accept")][:n_args]
    if n_args == 4:
        args = args[:3] + [lat.alpha_wavefront(*args[:2]), _t(fl)]
    ref = getattr(lat, fn.__name__ + "_reference")
    before = (lat.LAUNCHES_ALPHA, lat.LAUNCHES_BETA)
    got, want = fn(*args), ref(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    assert (lat.LAUNCHES_ALPHA, lat.LAUNCHES_BETA) == before


def test_wrappers_refuse_what_the_kernel_does_not_take():
    x = torch.zeros(2, 3, 4)
    with pytest.raises(TypeError, match="float32"):
        lat.alpha_wavefront(x.double(), x.double())
    with pytest.raises(ValueError, match="must be"):
        lat.alpha_wavefront(x, x[:, :2])
    with pytest.raises(ValueError, match="contiguous"):
        lat.beta_wavefront(x, x, x.transpose(0, 1).contiguous()
                           .transpose(0, 1))
    with pytest.raises(ValueError, match="frame_lens"):
        lat.beta_occupancies(x, x, x, x, torch.zeros(3, dtype=torch.int32))
    meta = torch.empty(2, 3, 4, device="meta")
    with pytest.raises(ValueError, match="no lattice_alpha for device meta"):
        lat.alpha_wavefront(meta, meta)
    with pytest.raises(ValueError, match="no lattice_beta for device meta"):
        lat.beta_occupancies(meta, meta, meta, meta,
                             torch.zeros(2, dtype=torch.int32, device="meta"))
