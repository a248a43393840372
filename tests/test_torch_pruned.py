"""The port's pruned RNN-T loss (ops/rnnt_pruned.py) against the JAX
package's: the simple joiner, the pruning bounds, the banded lattice (the
port's scatter into the full lattice against JAX's banded scans), the
pruned loss through K6 (its plain versions here) against JAX's Pallas band
kernels in interpret mode and its XLA path, the two-pass objective, and a
2-step `loss_impl="pruned"` training trajectory."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.models import config as jax_config
from rnn_transducer_tpu.ops import rnnt_loss as jloss
from rnn_transducer_tpu.ops import rnnt_pruned as jpr
from rnn_transducer_tpu.train import loop as jloop
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.ops import rnnt_loss as tloss
from rnn_transducer_tpu_torch.ops import rnnt_pruned as tpr
from rnn_transducer_tpu_torch.train import loop as tloop
from rnn_transducer_tpu_torch.weights import params_from_numpy, params_to_numpy

pytestmark = pytest.mark.quick

B, T, U, V = 3, 8, 5, 7
U1 = U + 1
BLANK = 0
# Losses: f32 lattice sums in another order (the port runs the banded
# lattice as the full one, JAX as scans in window coordinates).
LOSS_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _lengths(fl=(T, T - 2, T - 3), ll=(U, U - 1, U - 2)):
    return np.asarray(fl, np.int32), np.asarray(ll, np.int32)


def _lp_pair(rng, shape=(B, T, U1)):
    return (rng.normal(size=shape).astype(np.float32) - 1.0,
            rng.normal(size=shape).astype(np.float32) - 1.0)


def test_simple_lp_matches_jax():
    rng = np.random.default_rng(0)
    am = rng.normal(size=(B, T, V)).astype(np.float32)
    lm = rng.normal(size=(B, U1, V)).astype(np.float32)
    labels = rng.integers(1, V, size=(B, U)).astype(np.int32)
    want = jpr.simple_lp(jnp.asarray(am), jnp.asarray(lm),
                         jnp.asarray(labels), BLANK)
    got = tpr.simple_lp(_t(am), _t(lm), _t(labels), BLANK)
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("quantize", [1, 2])
@pytest.mark.parametrize("S", [2, 3, 4])
def test_prune_bounds_match_jax_with_ties(S, quantize):
    rng = np.random.default_rng(S + 10 * quantize)
    fl, ll = _lengths()
    occ = rng.integers(0, 3, size=(B, T, U1)).astype(np.float32)
    occ[:, 2, :] = 1.0  # a frame whose every column ties
    want = jpr.prune_bounds(jnp.asarray(occ), S, jnp.asarray(fl),
                            jnp.asarray(ll), quantize=quantize)
    got = tpr.prune_bounds(_t(occ), S, _t(fl), _t(ll), quantize=quantize)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quantize", [1, 2])
def test_bounds_from_centers_match_jax(quantize):
    """Random centres, a short frame count whose terminal raise lifts
    s_begin[0] above 0, and a zero-frame row."""
    rng = np.random.default_rng(5)
    Bc, Tc, U1c, S = 4, 9, 12, 3
    center = rng.integers(0, U1c, size=(Bc, Tc)).astype(np.int32)
    fl = np.asarray([Tc, 2, 0, 5], np.int32)
    ll = np.asarray([U1c - 1, 6, 3, 0], np.int32)
    for offset in (None, 0, 2):
        want = jpr.bounds_from_centers(jnp.asarray(center), U1c, S,
                                       jnp.asarray(fl), jnp.asarray(ll),
                                       quantize, offset=offset)
        got = tpr.bounds_from_centers(_t(center), U1c, S, _t(fl), _t(ll),
                                      quantize, offset=offset)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _window(lp, sb, S):
    u = sb[:, :, None] + np.arange(S)[None, None, :]
    return np.take_along_axis(lp, np.clip(u, 0, U1 - 1), axis=2), u


def _banded_case(seed, S, fl, ll, lift=False):
    rng = np.random.default_rng(seed)
    lpb, lpy = _lp_pair(rng)
    gb, gy = jloss.occupancies_from_lp(jnp.asarray(lpb), jnp.asarray(lpy),
                                       jnp.asarray(fl), jnp.asarray(ll))
    sb = np.asarray(jpr.prune_bounds(gb + gy, S, jnp.asarray(fl),
                                     jnp.asarray(ll)))
    if lift:
        assert sb[:, 0].max() > 0, "the case must start a band above u = 0"
    lpb_w, u = _window(lpb, sb, S)
    lpy_w, _ = _window(lpy, sb, S)
    lpy_w = np.where(u < U1, lpy_w, np.float32(-1e30)).astype(np.float32)
    return lpb_w, lpy_w, sb


def _banded_both(lpb_w, lpy_w, sb, fl, ll, fastemit):
    def jfn(a, b_):
        return jpr.rnnt_loss_banded(a, b_, jnp.asarray(sb), jnp.asarray(fl),
                                    jnp.asarray(ll), U1, fastemit)
    want, vjp = jax.vjp(jfn, jnp.asarray(lpb_w), jnp.asarray(lpy_w))
    gbar = np.linspace(0.5, 1.5, len(fl)).astype(np.float32)
    want_g = vjp(jnp.asarray(gbar))
    a = _t(lpb_w).requires_grad_(True)
    b_ = _t(lpy_w).requires_grad_(True)
    got = tpr.rnnt_loss_banded(a, b_, _t(sb), _t(fl), _t(ll), U1, fastemit)
    got_g = torch.autograd.grad(got, (a, b_), _t(gbar))
    return (got.detach().numpy(), [g.numpy() for g in got_g],
            np.asarray(want), [np.asarray(g) for g in want_g])


@pytest.mark.parametrize("S, fl, ll, fastemit, lift", [
    (3, (T, T - 2, T - 3), (U, U - 1, U - 2), 0.0, False),
    (4, (T, 0, T - 1), (U, U - 1, 0), 0.0, False),  # no frames; no labels
    (3, (T, T - 2, T - 3), (U, U - 1, U - 2), 0.5, False),  # FastEmit
    (2, (2, T, 1), (U, 3, 2), 0.0, True),  # the band starts above u = 0
])
def test_rnnt_loss_banded_matches_jax(S, fl, ll, fastemit, lift):
    fl, ll = _lengths(fl, ll)
    lpb_w, lpy_w, sb = _banded_case(S, S, fl, ll, lift)
    got, got_g, want, want_g = _banded_both(lpb_w, lpy_w, sb, fl, ll,
                                            fastemit)
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    for a, e in zip(got_g, want_g):
        np.testing.assert_allclose(a, e, rtol=1e-4, atol=1e-4)
    assert not got_g[0][fl == 0].any() and not got_g[1][fl == 0].any()


def test_terminal_outside_the_band_scores_neg_inf():
    """A band that misses the terminal cell at the last frame gives log Z =
    NEG_INF, a loss of 1e30, as JAX's `_band_forward` (:293-297) does;
    feasible bounds never do this, a caller's s_begin may."""
    rng = np.random.default_rng(6)
    fl, ll = _lengths()
    S = 2
    sb = np.zeros((B, T), np.int32)  # the band is u = 0, 1; rows end at 3-5
    lpb_w, _ = _window(_lp_pair(rng)[0], sb, S)
    lpy_w, _ = _window(_lp_pair(rng)[1], sb, S)
    want = np.asarray(jpr.rnnt_loss_banded(
        jnp.asarray(lpb_w), jnp.asarray(lpy_w), jnp.asarray(sb),
        jnp.asarray(fl), jnp.asarray(ll), U1))
    got = tpr.rnnt_loss_banded(_t(lpb_w), _t(lpy_w), _t(sb), _t(fl), _t(ll),
                               U1).numpy()
    assert (want == np.float32(1e30)).all()
    np.testing.assert_array_equal(got, want)


def test_full_width_band_equals_the_unbanded_loss():
    """S = U + 1 and s_begin = 0: the band is the lattice."""
    rng = np.random.default_rng(1)
    fl, ll = _lengths()
    lpb, lpy = (_t(a) for a in _lp_pair(rng))
    sb = torch.zeros((B, T), dtype=torch.int32)
    leaves = [lpb.clone().requires_grad_(True), lpy.clone().requires_grad_(True)]
    band = tpr.rnnt_loss_banded(*leaves, sb, _t(fl), _t(ll), U1)
    g_band = torch.autograd.grad(band.sum(), leaves)
    full_leaves = [lpb.clone().requires_grad_(True),
                   lpy.clone().requires_grad_(True)]
    full = tloss.rnnt_loss_from_lp(*full_leaves, _t(fl), _t(ll))
    g_full = torch.autograd.grad(full.sum(), full_leaves)
    torch.testing.assert_close(band, full, rtol=1e-6, atol=1e-5)
    for a, e in zip(g_band, g_full):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-6)


def test_rnnt_loss_from_lp_matches_jax_with_fastemit():
    rng = np.random.default_rng(2)
    fl, ll = _lengths((T, 0, T - 1), (U, 2, 0))
    lpb, lpy = _lp_pair(rng)
    want, vjp = jax.vjp(lambda a, b_: jloss.rnnt_loss_from_lp(
        a, b_, jnp.asarray(fl), jnp.asarray(ll), 0.3), jnp.asarray(lpb),
        jnp.asarray(lpy))
    want_g = vjp(jnp.ones((B,), jnp.float32))
    leaves = [_t(lpb).requires_grad_(True), _t(lpy).requires_grad_(True)]
    got = tloss.rnnt_loss_from_lp(*leaves, _t(fl), _t(ll), 0.3)
    got_g = torch.autograd.grad(got.sum(), leaves)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LOSS_TOL)
    for a, e in zip(got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-4,
                                   atol=1e-5)


def _joint_case(seed, J=8):
    rng = np.random.default_rng(seed)
    labels = rng.integers(1, V, size=(B, U)).astype(np.int32)
    f = rng.normal(size=(B, T, J)).astype(np.float32)
    g = rng.normal(size=(B, U1, J)).astype(np.float32)
    w = (0.4 * rng.normal(size=(J, V))).astype(np.float32)
    b = (0.1 * rng.normal(size=V)).astype(np.float32)
    return rng, labels, f, g, w, b


@pytest.mark.parametrize("band_kernel", ["1", "0"])
@pytest.mark.parametrize("S", [3, 4, U1])
def test_rnnt_loss_pruned_matches_jax(monkeypatch, band_kernel, S):
    """JAX through its Pallas band kernels (interpret mode) and through
    its XLA path; the port through K6's plain versions. S = U + 1 is the
    full-width band."""
    monkeypatch.setenv("RNNT_TPU_BAND_KERNEL", band_kernel)
    rng, labels, f, g, w, b = _joint_case(8 + S)
    fl, ll = _lengths()
    lpb, lpy = _lp_pair(rng)
    gb, gy = jloss.occupancies_from_lp(jnp.asarray(lpb), jnp.asarray(lpy),
                                       jnp.asarray(fl), jnp.asarray(ll))
    sb = np.asarray(jpr.prune_bounds(gb + gy, S, jnp.asarray(fl),
                                     jnp.asarray(ll)))
    gbar = np.linspace(0.5, 1.5, B).astype(np.float32)

    def jfn(*a):
        return jpr.rnnt_loss_pruned(*a, jnp.asarray(labels), jnp.asarray(fl),
                                    jnp.asarray(ll), jnp.asarray(sb), S,
                                    BLANK, jnp.float32)
    want, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (f, g, w, b)))
    want_g = vjp(jnp.asarray(gbar))
    leaves = [_t(a).requires_grad_(True) for a in (f, g, w, b)]
    got = tpr.rnnt_loss_pruned(*leaves, _t(labels), _t(fl), _t(ll), _t(sb), S,
                               BLANK, torch.float32)
    got_g = torch.autograd.grad(got, leaves, _t(gbar))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LOSS_TOL)
    for name, a, e in zip(("f", "g", "w", "b"), got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), err_msg=name,
                                   **GRAD_TOL)


def test_pruned_two_pass_loss_matches_jax():
    rng, labels, f, g, w, b = _joint_case(11)
    De, Dp = 6, 5
    fl, ll = _lengths((T, T - 1, 0), (U, 0, U - 1))
    am_in = rng.normal(size=(B, T, De)).astype(np.float32)
    lm_in = rng.normal(size=(B, U1, Dp)).astype(np.float32)
    simple = {"am": {"w": rng.normal(size=(De, V)).astype(np.float32),
                     "b": rng.normal(size=V).astype(np.float32)},
              "lm": {"w": rng.normal(size=(Dp, V)).astype(np.float32),
                     "b": rng.normal(size=V).astype(np.float32)}}
    S = 3

    def jfn(ps, f_, g_, w_, b_, am_, lm_):
        s_pu, p_pu, sb = jpr.pruned_two_pass_loss(
            ps, f_, g_, w_, b_, am_, lm_, jnp.asarray(labels),
            jnp.asarray(fl), jnp.asarray(ll), S, BLANK, jnp.float32, 0.2)
        return jnp.sum(p_pu) + 0.5 * jnp.sum(s_pu), (s_pu, p_pu, sb)

    j_args = (jax.tree.map(jnp.asarray, simple),
              *(jnp.asarray(a) for a in (f, g, w, b, am_in, lm_in)))
    (_, (s_want, p_want, sb_want)), j_grads = jax.value_and_grad(
        jfn, argnums=tuple(range(7)), has_aux=True)(*j_args)

    t_simple = params_from_numpy(simple)
    leaves = [t_simple["am"]["w"], t_simple["am"]["b"], t_simple["lm"]["w"],
              t_simple["lm"]["b"]] + [_t(a) for a in (f, g, w, b, am_in,
                                                      lm_in)]
    for x in leaves:
        x.requires_grad_(True)
    s_pu, p_pu, sb = tpr.pruned_two_pass_loss(
        t_simple, *leaves[4:8], *leaves[8:], _t(labels), _t(fl), _t(ll), S,
        BLANK, torch.float32, 0.2)
    got_g = torch.autograd.grad(p_pu.sum() + 0.5 * s_pu.sum(), leaves)
    np.testing.assert_array_equal(sb.numpy(), np.asarray(sb_want))
    np.testing.assert_allclose(s_pu.detach().numpy(), np.asarray(s_want),
                               **LOSS_TOL)
    np.testing.assert_allclose(p_pu.detach().numpy(), np.asarray(p_want),
                               **LOSS_TOL)
    want_g = [j_grads[0]["am"]["w"], j_grads[0]["am"]["b"],
              j_grads[0]["lm"]["w"], j_grads[0]["lm"]["b"], *j_grads[1:]]
    names = ("am.w", "am.b", "lm.w", "lm.b", "f", "g", "w", "b", "am_in",
             "lm_in")
    for name, a, e in zip(names, got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), err_msg=name,
                                   rtol=1e-4, atol=5e-5)


# ------------------------- the training step ------------------------------

TINY = dict(input_dim=8, enc_layers=2, enc_hidden=32, time_reduction=2,
            pred_layers=1, pred_hidden=16, embed_dim=8, joint_dim=16,
            vocab_size=21, compute_dtype="float32", pruned_range=3)
# As tests/test_torch_train.py's trajectories.
TRAJ_LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=0, atol=2e-6)


def _batches(n, seed=0):
    from rnn_transducer_tpu_torch.data.synthetic import random_batch
    rng = np.random.default_rng(seed)
    return [random_batch(rng, 3, 12, 4, TINY["input_dim"],
                         TINY["vocab_size"]) for _ in range(n)]


def test_pruned_trajectory_matches_jax():
    """Two steps of make_train_step(loss_impl="pruned"): losses and params
    against the JAX package's (its XLA band path on the CPU)."""
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
              loss_impl="pruned", simple_loss_scale=0.5)
    jcfg = jax_config.TransducerConfig(**TINY)
    jt = jax_config.TrainConfig(**kw)
    state = jloop.init_train_state(jax.random.PRNGKey(0), jcfg, jt)
    params0 = jax.tree.map(np.asarray, state.params)
    assert "simple" in params0
    jstep = jloop.make_train_step(jcfg, jt)
    want = []
    for batch in _batches(2):
        state, info = jstep(state, *(jnp.asarray(a) for a in batch))
        want.append(float(info["loss"]))

    cfg = port_config.TransducerConfig(**TINY)
    tcfg = port_config.TrainConfig(**kw)
    tstate = tloop.init_train_state(None, cfg, tcfg,
                                    params=params_from_numpy(params0))
    step = tloop.make_train_step(cfg, tcfg)
    got = []
    for batch in _batches(2):
        tstate, info = step(tstate, *(torch.from_numpy(a) for a in batch))
        assert int(info["skipped_nonfinite"]) == 0
        got.append(float(info["loss"]))
    np.testing.assert_allclose(got, want, **TRAJ_LOSS_TOL)
    for (path, a), e in zip(
            jax.tree_util.tree_leaves_with_path(params_to_numpy(tstate.params)),
            jax.tree.leaves(jax.tree.map(np.asarray, state.params))):
        np.testing.assert_allclose(a, e, err_msg=str(path), **PARAM_TOL)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(params_to_numpy(tstate.params)),
        jax.tree.leaves(params0)))
    assert moved > 1e-4


def test_pruned_config_round_trips_through_the_mirror():
    cfg = dataclasses.asdict(port_config.TransducerConfig(**TINY))
    assert cfg == dataclasses.asdict(jax_config.TransducerConfig(**TINY))
