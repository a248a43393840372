"""The port's alignment-restricted RNN-T (ops/rnnt_align.py, the `ar`
branch of train/loop.py) against the JAX package's: the Viterbi path and
its backpointers (earliest index on a tie), the host and device
backtraces, the band around an alignment, the AR loss self-aligned and
with an aligner's params, a 2-step trajectory, the guards, and the
training CLI's --ar-range and --pruned-range on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.models import config as jax_config
from rnn_transducer_tpu.models import transducer as jm
from rnn_transducer_tpu.ops import rnnt_align as jalign
from rnn_transducer_tpu.ops import rnnt_pruned as jpr
from rnn_transducer_tpu.train import loop as jloop
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.ops import rnnt_align as talign
from rnn_transducer_tpu_torch.ops import rnnt_pruned as tpr
from rnn_transducer_tpu_torch.train import checkpoint as ckpt
from rnn_transducer_tpu_torch.train import loop as tloop
from rnn_transducer_tpu_torch.train.__main__ import main as train_main
from rnn_transducer_tpu_torch.weights import params_from_numpy, params_to_numpy

pytestmark = pytest.mark.quick

TINY = dict(input_dim=8, enc_layers=2, enc_hidden=32, time_reduction=2,
            pred_layers=1, pred_hidden=16, embed_dim=8, joint_dim=16,
            vocab_size=12, compute_dtype="float32")
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=0, atol=2e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _lattice(seed, B=5, T=9, U1=7, ties=False):
    rng = np.random.default_rng(seed)
    if ties:  # small integers: every sum is exact, so ties are real ties
        lpb = -rng.integers(1, 3, size=(B, T, U1)).astype(np.float32)
        lpy = -rng.integers(1, 3, size=(B, T, U1)).astype(np.float32)
    else:
        lpb = rng.normal(size=(B, T, U1)).astype(np.float32)
        lpy = rng.normal(size=(B, T, U1)).astype(np.float32)
    fl = rng.integers(1, T + 1, size=B).astype(np.int32)
    ll = rng.integers(0, U1, size=B).astype(np.int32)
    fl[0], ll[0] = T, U1 - 1
    return lpb, lpy, fl, ll


def test_argcummax_keeps_the_earliest_index():
    """torch.cummax gives [0, 1, 2, 2, 4] on [1, 3, 3, 2, 3]; JAX's
    strict `>` keeps the first maximiser."""
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = talign._argcummax(x)
    want_v, want_i = jalign._argcummax(jnp.asarray(x.numpy()))
    assert idx.tolist() == [[0, 1, 1, 1, 1]] == np.asarray(want_i).tolist()
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("ties", [True, False])
def test_viterbi_matches_jax(ties):
    lpb, lpy, fl, ll = _lattice(3, ties=ties)
    score, K = talign.rnnt_viterbi(_t(lpb), _t(lpy), _t(fl), _t(ll))
    want_s, want_K = jalign.rnnt_viterbi(*(jnp.asarray(a) for a in
                                           (lpb, lpy, fl, ll)))
    np.testing.assert_allclose(score.numpy(), np.asarray(want_s), rtol=1e-5,
                               atol=1e-5)
    assert K.dtype == torch.int32
    np.testing.assert_array_equal(K.numpy(), np.asarray(want_K))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_emit_frames_match_jax_and_each_other(seed):
    lpb, lpy, fl, ll = _lattice(seed, ties=seed == 2)
    _, K = talign.rnnt_viterbi(_t(lpb), _t(lpy), _t(fl), _t(ll))
    host = talign.backtrace_emit_frames(K, _t(fl), _t(ll))
    dev = talign.emit_frames_device(K, _t(fl), _t(ll))
    _, jK = jalign.rnnt_viterbi(*(jnp.asarray(a) for a in (lpb, lpy, fl, ll)))
    want = jalign.backtrace_emit_frames(jK, fl, ll)
    want_dev = np.asarray(jalign.emit_frames_device(jK, jnp.asarray(fl),
                                                    jnp.asarray(ll)))
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(dev.numpy(), want_dev)
    np.testing.assert_array_equal(dev.numpy(), host)


def test_forced_align_matches_jax():
    rng = np.random.default_rng(4)
    B, T, U, V = 3, 6, 4, 9
    logits = rng.normal(size=(B, T, U + 1, V)).astype(np.float32)
    labels = rng.integers(1, V, size=(B, U)).astype(np.int32)
    fl = np.asarray([T, 4, 5], np.int32)
    ll = np.asarray([U, 2, 3], np.int32)
    emit, score = talign.rnnt_forced_align(_t(logits), _t(labels), _t(fl),
                                           _t(ll))
    want_e, want_s = jalign.rnnt_forced_align(
        *(jnp.asarray(a) for a in (logits, labels, fl, ll)))
    np.testing.assert_array_equal(emit, want_e)
    np.testing.assert_allclose(score.numpy(), np.asarray(want_s), rtol=1e-5)


@pytest.mark.parametrize("left", [None, 0, 1])
def test_alignment_bounds_match_jax(left):
    rng = np.random.default_rng(5)
    B, T, U, S = 6, 14, 9, 4
    fl = rng.integers(2, T + 1, size=B).astype(np.int32)
    ll = rng.integers(1, U + 1, size=B).astype(np.int32)
    fl[1], ll[1] = 2, U  # too few frames: the terminal raise lifts the band
    emit = np.full((B, U), -1, np.int32)
    for b in range(B):
        emit[b, :ll[b]] = np.sort(rng.integers(0, fl[b], size=ll[b]))
    got = tpr.alignment_bounds(_t(emit), T, S, _t(fl), _t(ll), U + 1,
                               left_labels=left)
    want = jpr.alignment_bounds(jnp.asarray(emit), T, S, jnp.asarray(fl),
                                jnp.asarray(ll), U + 1, left_labels=left)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _batch(B=4, T=12, U=5, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, TINY["input_dim"])).astype(np.float32)
    fl = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    labels = rng.integers(1, TINY["vocab_size"], size=(B, U)).astype(np.int32)
    ll = rng.integers(1, U + 1, size=B).astype(np.int32)
    return feats, fl, labels, ll


def _params(seed):
    cfg = jax_config.TransducerConfig(**TINY)
    return jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed),
                                                   cfg))


@pytest.mark.parametrize("teacher", [False, True])
def test_ar_loss_matches_jax(teacher):
    """loss_fn(loss_impl="ar"): self-aligned, and aligned by another
    model's params; loss, per-utterance losses and gradients."""
    jcfg = jax_config.TransducerConfig(**TINY)
    cfg = port_config.TransducerConfig(**TINY)
    p_np = _params(1)
    t_np = _params(2) if teacher else None
    batch = _batch(seed=3)
    kw = dict(loss_impl="ar", ar_range=3, ar_left=1)

    def jfn(p):
        return jloop.loss_fn(p, jcfg, *(jnp.asarray(a) for a in batch),
                             align_cfg=jcfg if teacher else None,
                             teacher_params=(jax.tree.map(jnp.asarray, t_np)
                                             if teacher else None), **kw)
    (want, want_pu), want_g = jax.value_and_grad(jfn, has_aux=True)(
        jax.tree.map(jnp.asarray, p_np))
    params = params_from_numpy(p_np)
    leaves, spec = torch.utils._pytree.tree_flatten(params)
    for x in leaves:
        x.requires_grad_(True)
    got, got_pu = tloop.loss_fn(
        params, cfg, *(torch.from_numpy(a) for a in batch),
        align_cfg=cfg if teacher else None,
        teacher_params=params_from_numpy(t_np) if teacher else None, **kw)
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want), **LOSS_TOL)
    np.testing.assert_allclose(got_pu.detach().numpy(), np.asarray(want_pu),
                               rtol=1e-5, atol=1e-4)
    for g, e in zip(grads, jax.tree.leaves(want_g)):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-4,
                                   atol=1e-5)


def test_ar_trajectory_matches_jax():
    """Two self-aligned AR steps (ar_range=3, ar_left=1) against the JAX
    package's make_train_step."""
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
              ar_range=3, ar_left=1)
    jcfg = jax_config.TransducerConfig(**TINY)
    jstate = jloop.init_train_state(jax.random.PRNGKey(7), jcfg,
                                    jax_config.TrainConfig(**kw))
    params0 = jax.tree.map(np.asarray, jstate.params)
    jstep = jloop.make_train_step(jcfg, jax_config.TrainConfig(**kw))
    cfg = port_config.TransducerConfig(**TINY)
    tcfg = port_config.TrainConfig(**kw)
    state = tloop.init_train_state(None, cfg, tcfg,
                                   params=params_from_numpy(params0))
    step = tloop.make_train_step(cfg, tcfg)
    want, got = [], []
    for seed in (0, 1):
        batch = _batch(seed=seed)
        jstate, info = jstep(jstate, *(jnp.asarray(a) for a in batch))
        want.append(float(info["loss"]))
        state, info = step(state, *(torch.from_numpy(a) for a in batch))
        assert int(info["skipped_nonfinite"]) == 0
        got.append(float(info["loss"]))
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    for (path, a), e in zip(
            jax.tree_util.tree_leaves_with_path(params_to_numpy(state.params)),
            jax.tree.leaves(jax.tree.map(np.asarray, jstate.params))):
        np.testing.assert_allclose(a, e, err_msg=str(path), **PARAM_TOL)


def test_ar_step_with_an_aligner_takes_its_params():
    cfg = port_config.TransducerConfig(**TINY)
    tcfg = port_config.TrainConfig(ar_range=3, warmup_steps=1)
    state = tloop.init_train_state(0, cfg, tcfg, device="cpu")
    aligner = tloop.init_train_state(1, cfg, tcfg, device="cpu").params
    step = tloop.make_train_step(cfg, tcfg, teacher_cfg=cfg)
    batch = [torch.from_numpy(a) for a in _batch(seed=5)]
    new, info = step(state, *batch, aligner)
    assert new.step == 1 and np.isfinite(float(info["loss"]))
    with pytest.raises(ValueError, match="teacher_params"):
        step(state, *batch)


@pytest.mark.parametrize("tcfg_kw, match", [
    (dict(ar_range=3, distill_weight=0.5), "mutually exclusive"),
    (dict(ar_range=3, loss_impl="pruned"), "loss_impl"),
])
def test_ar_guards(tcfg_kw, match):
    cfg = port_config.TransducerConfig(**TINY)
    with pytest.raises(ValueError, match=match):
        tloop.make_train_step(cfg, port_config.TrainConfig(**tcfg_kw),
                              teacher_cfg=cfg)


def test_ar_compat_guard():
    cfg = port_config.TransducerConfig(**TINY)
    bad = port_config.TransducerConfig(**{**TINY, "time_reduction": 4})
    with pytest.raises(ValueError, match="time_reduction"):
        tloop.check_ar_compat(cfg, bad)
    with pytest.raises(ValueError, match="time_reduction"):
        tloop.make_train_step(cfg, port_config.TrainConfig(ar_range=3),
                              teacher_cfg=bad)


def test_ar_loss_needs_a_range():
    cfg = port_config.TransducerConfig(**TINY)
    tcfg = port_config.TrainConfig(loss_impl="ar")
    state = tloop.init_train_state(0, cfg, tcfg, device="cpu")
    step = tloop.make_train_step(cfg, tcfg)
    with pytest.raises(ValueError, match="ar_range > 0"):
        step(state, *(torch.from_numpy(a) for a in _batch()))


CLI = ["--device", "cpu", "--config", "smoke", "--batch-size", "2",
       "--max-frames", "24", "--max-labels", "4", "--warmup-steps", "1",
       "--log-every", "1"]


@pytest.mark.parametrize("extra", [["--ar-range", "3"],
                                   ["--ar-range", "3", "--ar-left", "0"],
                                   ["--pruned-range", "3"]])
def test_cli_trains_the_banded_losses(extra, capsys):
    state = train_main(CLI + ["--steps", "2"] + extra)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])
    assert state.opt_state["count"] == 2
    if "--pruned-range" in extra:
        assert "simple" in state.params


def test_cli_aligns_from_a_checkpoint(tmp_path, capsys):
    aligner = tmp_path / "aligner"
    train_main(CLI + ["--steps", "1", "--ckpt-dir", str(aligner)])
    assert ckpt.load_model_config(str(aligner)).enc_hidden == 64
    state = train_main(CLI + ["--steps", "2", "--ar-range", "3",
                              "--ar-align-from", str(aligner)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 2 and state.step == 2
    with pytest.raises(SystemExit, match="--ar-range"):
        train_main(CLI + ["--steps", "1", "--ar-align-from", str(aligner)])
