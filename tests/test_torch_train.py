"""The port's training step, schedules, checkpoints and CLI against the JAX
package's train/loop.py: a 2-step loss and parameter trajectory at a tiny
f32 config, through the port's `fused` (plain K1 / K2 on the CPU),
`pallas` (plain K5) and `xla` losses, against JAX's `make_train_step` with
loss_impl="xla", and the port's `pallas` against JAX's `pallas` (the
Pallas kernels in interpret mode)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.models import config as jax_config
from rnn_transducer_tpu.train import loop as jloop
from rnn_transducer_tpu_torch.data.synthetic import random_batch
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.ops.rnnt_joint_fused import MAX_J
from rnn_transducer_tpu_torch.train import checkpoint as ckpt
from rnn_transducer_tpu_torch.train import loop as tloop
from rnn_transducer_tpu_torch.train.__main__ import main as train_main
from rnn_transducer_tpu_torch.weights import params_from_numpy, params_to_numpy

pytestmark = pytest.mark.quick

TINY = dict(input_dim=8, enc_layers=2, enc_hidden=32, time_reduction=2,
            pred_layers=1, pred_hidden=16, embed_dim=8, joint_dim=16,
            vocab_size=21, compute_dtype="float32")
# Losses are f32 sums in another order; the params move by at most lr
# per step under Adam, and differ where a gradient near zero is amplified
# by mu / sqrt(nu): bounded well below the lr of 1e-3.
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=0, atol=2e-6)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [random_batch(rng, 3, 12, 4, TINY["input_dim"],
                         TINY["vocab_size"]) for _ in range(n)]


def _adam_state(opt_state, accum):
    """mu, nu and count out of the optax state of make_optimizer."""
    inner = opt_state.inner_opt_state if accum > 1 else opt_state
    adam = inner[1][0]
    return adam.mu, adam.nu, int(adam.count)


def _jax_run(tcfg_kw, n_steps):
    cfg = jax_config.TransducerConfig(**TINY)
    tcfg = jax_config.TrainConfig(**tcfg_kw)
    state = jloop.init_train_state(jax.random.PRNGKey(0), cfg, tcfg)
    params0 = jax.tree.map(np.asarray, state.params)
    step = jloop.make_train_step(cfg, tcfg)
    losses = []
    for batch in _batches(n_steps):
        state, info = step(state, *(jnp.asarray(a) for a in batch))
        losses.append(float(info["loss"]))
    mu, nu, count = _adam_state(state.opt_state, tcfg.grad_accum)
    return (params0, losses, jax.tree.map(np.asarray, state.params),
            jax.tree.map(np.asarray, mu), jax.tree.map(np.asarray, nu), count)


def _port_run(params0, tcfg_kw, n_steps, loss_impl):
    cfg = port_config.TransducerConfig(**TINY)
    tcfg = port_config.TrainConfig(**{**tcfg_kw, "loss_impl": loss_impl})
    state = tloop.init_train_state(None, cfg, tcfg,
                                   params=params_from_numpy(params0))
    step = tloop.make_train_step(cfg, tcfg)
    losses = []
    for batch in _batches(n_steps):
        state, info = step(state, *(torch.from_numpy(a) for a in batch))
        assert int(info["skipped_nonfinite"]) == 0
        losses.append(float(info["loss"]))
    adam = state.opt_state["inner"] if tcfg.grad_accum > 1 else state.opt_state
    return losses, state, adam


def _assert_trees_close(got, want, **tol):
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, err_msg=str(path), **tol)


TRAJECTORIES = {
    # warmup 1: the first update has lr = schedule(0) = 0, the second the
    # peak (optax evaluates the schedule at the count before the update)
    "warmup_cosine": (dict(learning_rate=1e-3, warmup_steps=1,
                           total_steps=10), 2),
    # MultiSteps(2): the mean of 2 gradients, clipped, one update per 2
    # calls; noam with warmup 1 gives the peak from count 0
    "accum2_noam": (dict(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                         lr_schedule="noam", grad_accum=2), 4),
}


@pytest.fixture(scope="module", params=sorted(TRAJECTORIES))
def jax_trajectory(request):
    kw, n = TRAJECTORIES[request.param]
    return request.param, kw, n, _jax_run({**kw, "loss_impl": "xla"}, n)


def _assert_trajectory(name, kw, n, jax_result, loss_impl):
    (params0, want_losses, want_params, want_mu, want_nu,
     want_count) = jax_result
    losses, state, adam = _port_run(params0, kw, n, loss_impl)
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    assert state.step == n and adam["count"] == want_count
    _assert_trees_close(params_to_numpy(state.params), want_params,
                        **PARAM_TOL)
    _assert_trees_close(params_to_numpy(adam["mu"]), want_mu, rtol=1e-4,
                        atol=1e-7)
    _assert_trees_close(params_to_numpy(adam["nu"]), want_nu, rtol=1e-4,
                        atol=1e-10)
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(params_to_numpy(state.params)),
        jax.tree.leaves(params0)))
    assert moved > 1e-4, f"{name}: the params did not move"


@pytest.mark.parametrize("loss_impl", ["fused", "pallas", "xla"])
def test_trajectory_matches_jax(jax_trajectory, loss_impl):
    name, kw, n, jax_result = jax_trajectory
    _assert_trajectory(name, kw, n, jax_result, loss_impl)


def test_pallas_trajectory_matches_jax_pallas():
    """The port's two-pass loss against JAX's make_train_step with
    loss_impl="pallas": extract_lp and assemble_grad in interpret mode."""
    kw, n = TRAJECTORIES["warmup_cosine"]
    _assert_trajectory("warmup_cosine", kw, n,
                       _jax_run({**kw, "loss_impl": "pallas"}, n), "pallas")


@pytest.mark.parametrize("device, joint_dim, want", [
    ("cuda", 512, "fused"), ("cuda", MAX_J + 1, "pallas"),
    ("cpu", 512, "xla"), ("cpu", MAX_J + 1, "xla")])
def test_auto_loss_impl_follows_device_and_joint_width(device, joint_dim,
                                                       want):
    """auto: fused on the card where the fused kernels take J (libri100's
    512), the two-pass loss above MAX_J, xla on the CPU; an explicit
    choice stays."""
    cfg = dataclasses.replace(port_config.config_libri100(),
                              joint_dim=joint_dim)
    dev = torch.device(device)
    assert tloop._resolve_loss_impl("auto", dev, cfg) == want
    for impl in ("fused", "pallas", "xla"):
        assert tloop._resolve_loss_impl(impl, dev, cfg) == impl


@pytest.mark.parametrize("schedule", ["warmup_cosine", "noam", "step_decay",
                                      "constant"])
def test_lr_schedules_match_jax(schedule):
    kw = dict(learning_rate=3e-3, warmup_steps=10, total_steps=100,
              lr_schedule=schedule, decay_every=20)
    want = jloop.make_lr_schedule(jax_config.TrainConfig(**kw))
    got = tloop.make_lr_schedule(port_config.TrainConfig(**kw))
    for count in (0, 1, 5, 10, 11, 37, 100, 150):
        np.testing.assert_allclose(got(count),
                                   float(want(jnp.asarray(count))),
                                   rtol=1e-5, atol=1e-9, err_msg=str(count))


def test_eval_step_matches_jax_loss():
    """make_eval_step: the batch-mean and per-utterance losses without
    gradients, equal to the JAX package's eval step at f32."""
    jcfg = jax_config.TransducerConfig(**TINY)
    params_np = jax.tree.map(np.asarray, jloop.init_train_state(
        jax.random.PRNGKey(1), jcfg, jax_config.TrainConfig()).params)
    batch = _batches(1, seed=3)[0]
    want, want_pu = jloop.make_eval_step(jcfg)(
        jax.tree.map(jnp.asarray, params_np), *(jnp.asarray(a) for a in batch))
    got, got_pu = tloop.make_eval_step(port_config.TransducerConfig(**TINY))(
        params_from_numpy(params_np), *(torch.from_numpy(a) for a in batch))
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    np.testing.assert_allclose(got_pu.numpy(), np.asarray(want_pu), rtol=1e-5,
                               atol=1e-4)


def test_nonfinite_step_is_skipped():
    """A non-finite loss skips the update: step advances, params and
    Adam's count stay."""
    cfg = port_config.TransducerConfig(**TINY)
    tcfg = port_config.TrainConfig(learning_rate=1e-2, warmup_steps=1)
    state = tloop.init_train_state(0, cfg, tcfg, device="cpu")
    step = tloop.make_train_step(cfg, tcfg)
    feats, fl, labels, ll = (torch.from_numpy(a) for a in _batches(1)[0])
    feats[0, 0, 0] = float("nan")
    new, info = step(state, feats, fl, labels, ll)
    assert int(info["skipped_nonfinite"]) == 1
    assert new.step == 1 and new.opt_state["count"] == 0
    for a, b in zip(jax.tree.leaves(params_to_numpy(new.params)),
                    jax.tree.leaves(params_to_numpy(state.params))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tcfg_kw, item", [
    (dict(dropout=0.1), "item 13"), (dict(ema_decay=0.9), "item 13"),
    (dict(weight_noise_std=0.1), "item 13"), (dict(ctc_weight=0.3), "item 8"),
    (dict(data_parallel=2), "item 6"),
])
def test_unported_options_raise(tcfg_kw, item):
    cfg = port_config.TransducerConfig(**TINY)
    with pytest.raises(NotImplementedError, match=item):
        tloop.make_train_step(cfg, port_config.TrainConfig(**tcfg_kw))


def test_pruned_without_a_pruned_range_raises():
    """loss_impl="pruned" is ported; with pruned_range 0 the step raises the
    JAX package's ValueError (train/loop.py:260-262)."""
    cfg = port_config.TransducerConfig(**TINY)
    tcfg = port_config.TrainConfig(loss_impl="pruned")
    state = tloop.init_train_state(0, cfg, tcfg, device="cpu")
    step = tloop.make_train_step(cfg, tcfg)
    with pytest.raises(ValueError, match="pruned_range > 0"):
        step(state, *(torch.from_numpy(a) for a in _batches(1)[0]))


def test_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    argv = ["--device", "cpu", "--config", "smoke", "--batch-size", "2",
            "--max-frames", "24", "--max-labels", "4", "--warmup-steps", "1",
            "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    state = train_main(argv + ["--steps", "3"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 3 and np.isfinite(out["final_loss"])
    restored, step = ckpt.restore_checkpoint(str(tmp_path))
    assert step == 3 and restored.step == 3
    assert restored.opt_state["count"] == state.opt_state["count"] == 3
    for a, b in zip(jax.tree.leaves(params_to_numpy(restored.params)),
                    jax.tree.leaves(params_to_numpy(state.params))):
        np.testing.assert_array_equal(a, b)
    meta = ckpt.load_meta(str(tmp_path))
    assert meta["model_config"]["enc_hidden"] == 64
    assert meta["train_config"]["batch_size"] == 2

    train_main(argv + ["--steps", "5", "--resume"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 5 and ckpt.latest_step(str(tmp_path)) == 5
    resumed, _ = ckpt.restore_checkpoint(str(tmp_path))
    assert resumed.opt_state["count"] == 5


def test_cli_trains_with_the_two_pass_loss(capsys):
    state = train_main(["--device", "cpu", "--config", "smoke",
                        "--batch-size", "2", "--max-frames", "24",
                        "--max-labels", "4", "--warmup-steps", "1",
                        "--steps", "2", "--loss-impl", "pallas"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])
    assert state.opt_state["count"] == 2


def test_cli_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_main(["--steps", "1"])


def test_train_config_mirror_is_unchanged():
    assert (dataclasses.asdict(port_config.TrainConfig())
            == dataclasses.asdict(jax_config.TrainConfig()))
