"""Lattice distillation in the port (`train/loop.distill_loss_fn`,
`make_train_step` with distill_weight, the training CLI's --distill-from)
on the CPU, after tests/test_distill.py.

An identity teacher adds nothing; the KD term against a float64 numpy
oracle (a bidirectional, wider teacher); `distill_loss_fn` against JAX's
per utterance within 1e-5 relative; a 2-step `make_train_step`
trajectory against JAX's at tests/test_torch_train.py's tolerances; the
guards; the CLI with a unidirectional and a BiLSTM teacher checkpoint;
two gloo ranks against one process, as tests/test_torch_dp.py holds the
other routes (loss within 1e-5 relative, params within 2e-5 / 2e-6, the
ranks bit-equal). All f32.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.models import config as jax_config
from rnn_transducer_tpu.train import loop as jloop
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.models import transducer as tm
from rnn_transducer_tpu_torch.parallel import mesh as meshlib
from rnn_transducer_tpu_torch.train import loop as tloop
from rnn_transducer_tpu_torch.train.__main__ import main as train_main
from rnn_transducer_tpu_torch.weights import params_from_numpy, params_to_numpy

pytestmark = pytest.mark.quick

SMALL = dict(input_dim=8, enc_layers=1, enc_hidden=16, pred_layers=1,
             pred_hidden=12, embed_dim=10, joint_dim=14, vocab_size=11,
             compute_dtype="float32")
BIG = dict(SMALL, enc_layers=2, enc_hidden=24, bidirectional=True)
CFG, TEACHER = (port_config.TransducerConfig(**SMALL),
                port_config.TransducerConfig(**BIG))
JCFG, JTEACHER = (jax_config.TransducerConfig(**SMALL),
                  jax_config.TransducerConfig(**BIG))
# tests/test_torch_train.py's bounds for a 2-step trajectory
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=0, atol=2e-6)
DP_PARAM_TOL = dict(rtol=2e-5, atol=2e-6)  # tests/test_torch_dp.py's


def _batch(seed=0, B=3, T=12, U=4):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, SMALL["input_dim"])).astype(np.float32)
    fl = (T - rng.integers(0, T // 2, size=B)).astype(np.int32)
    labels = rng.integers(1, SMALL["vocab_size"], size=(B, U)).astype(
        np.int32)
    ll = np.maximum(U - rng.integers(0, U, size=B), 1).astype(np.int32)
    return feats, fl, labels, ll


def _params_np(jcfg, seed):
    return jax.tree.map(np.asarray, jloop.init_train_state(
        jax.random.PRNGKey(seed), jcfg, jax_config.TrainConfig()).params)


def _t(batch):
    return tuple(torch.from_numpy(x) for x in batch)


def test_identity_teacher_adds_nothing():
    """teacher == student: KL(p || p) = 0, the loss is the xla NLL."""
    p = params_from_numpy(_params_np(JCFG, 0))
    batch = _t(_batch())
    want, want_pu = tloop.loss_fn(p, CFG, *batch, loss_impl="xla")
    got, got_pu = tloop.distill_loss_fn(p, p, CFG, CFG, *batch,
                                        distill_weight=0.7)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(got_pu.numpy(), want_pu.numpy(), rtol=1e-6)


def test_kd_term_matches_numpy_oracle():
    """The KD contribution equals the masked, tau^2-scaled KL of the two
    models' softened posteriors computed in float64 numpy from their
    logits (a bidirectional, wider teacher)."""
    sp = params_from_numpy(_params_np(JCFG, 1))
    tp = params_from_numpy(_params_np(JTEACHER, 2))
    feats, fl, labels, ll = _t(_batch(1))
    tau, w = 2.0, 0.45
    _, plain_pu = tloop.loss_fn(sp, CFG, feats, fl, labels, ll,
                                loss_impl="xla")
    _, dist_pu = tloop.distill_loss_fn(sp, tp, CFG, TEACHER, feats, fl,
                                       labels, ll, distill_weight=w,
                                       distill_temp=tau)
    with torch.no_grad():
        s_logits, enc_lens = tm.forward(sp, CFG, feats, fl, labels)
        t_logits, _ = tm.forward(tp, TEACHER, feats, fl, labels)

    def log_softmax(x):
        mx = x.max(-1, keepdims=True)
        return x - mx - np.log(np.exp(x - mx).sum(-1, keepdims=True))

    lp_s = log_softmax(s_logits.numpy().astype(np.float64) / tau)
    lp_t = log_softmax(t_logits.numpy().astype(np.float64) / tau)
    kl = (np.exp(lp_t) * (lp_t - lp_s)).sum(-1)
    B, T, U1 = kl.shape
    mask = ((np.arange(T)[None, :, None] < enc_lens.numpy()[:, None, None])
            & (np.arange(U1)[None, None, :] <= ll.numpy()[:, None, None]))
    want_kd = (kl * mask).sum((1, 2)) / mask.sum((1, 2)) * tau * tau
    got_kd = (dist_pu.detach().numpy() - plain_pu.detach().numpy()) / w
    np.testing.assert_allclose(got_kd, want_kd, rtol=1e-4, atol=1e-6)
    assert (want_kd > 0).all()


@pytest.mark.parametrize("tau, teacher", [(1.0, "small"), (2.0, "big")])
def test_distill_loss_matches_jax(tau, teacher):
    """Per-utterance loss (NLL + weight * KD) against JAX's
    distill_loss_fn within 1e-5 relative, and the gradients of the batch
    loss within 1e-5 of each leaf's largest value."""
    jt, pt = (JCFG, CFG) if teacher == "small" else (JTEACHER, TEACHER)
    s_np, t_np = _params_np(JCFG, 3), _params_np(jt, 4)
    batch = _batch(2)
    jb = tuple(jnp.asarray(x) for x in batch)

    def jloss(p):
        return jloop.distill_loss_fn(p, jax.tree.map(jnp.asarray, t_np),
                                     JCFG, jt, *jb, distill_weight=0.3,
                                     distill_temp=tau)
    (_, want_pu), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, s_np))
    leaves, spec = torch.utils._pytree.tree_flatten(params_from_numpy(s_np))
    leaves = [x.requires_grad_(True) for x in leaves]
    loss, got_pu = tloop.distill_loss_fn(
        torch.utils._pytree.tree_unflatten(leaves, spec),
        params_from_numpy(t_np), CFG, pt, *_t(batch), distill_weight=0.3,
        distill_temp=tau)
    np.testing.assert_allclose(got_pu.detach().numpy(), np.asarray(want_pu),
                               rtol=1e-5)
    grads = torch.autograd.grad(loss, leaves)
    got_g = params_to_numpy(torch.utils._pytree.tree_unflatten(
        list(grads), spec))
    for a, b in zip(jax.tree.leaves(got_g), jax.tree.leaves(want_g)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * max(np.abs(b).max(), 1e-30))


def test_two_step_trajectory_matches_jax():
    """Two make_train_step steps with a BiLSTM teacher riding the sixth
    argument: losses and params against JAX's step."""
    tkw = dict(batch_size=3, learning_rate=1e-3, warmup_steps=1,
               total_steps=10, distill_weight=0.5, distill_temp=2.0)
    s_np, t_np = _params_np(JCFG, 5), _params_np(JTEACHER, 6)
    batches = [_batch(10 + i) for i in range(2)]
    jtcfg = jax_config.TrainConfig(**tkw)
    jstate = jloop.init_train_state(jax.random.PRNGKey(5), JCFG, jtcfg)
    jstep = jloop.make_train_step(JCFG, jtcfg, teacher_cfg=JTEACHER)
    jteacher = jax.tree.map(jnp.asarray, t_np)
    want = []
    for b in batches:
        jstate, info = jstep(jstate, *(jnp.asarray(x) for x in b), jteacher)
        want.append(float(info["loss"]))
    tcfg = port_config.TrainConfig(**tkw)
    state = tloop.init_train_state(None, CFG, tcfg,
                                   params=params_from_numpy(s_np))
    step = tloop.make_train_step(CFG, tcfg, teacher_cfg=TEACHER)
    teacher = params_from_numpy(t_np)
    got = []
    for b in batches:
        state, info = step(state, *_t(b), teacher)
        assert int(info["skipped_nonfinite"]) == 0
        got.append(float(info["loss"]))
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    for a, b in zip(jax.tree.leaves(params_to_numpy(state.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 jstate.params))):
        np.testing.assert_allclose(a, b, **PARAM_TOL)


@pytest.mark.parametrize("tkw, teacher_kw, err, match", [
    (dict(loss_impl="fused"), {}, ValueError, "xla loss tier"),
    (dict(loss_impl="pallas"), {}, ValueError, "xla loss tier"),
    ({}, dict(vocab_size=12), ValueError, "vocab_size"),
    ({}, dict(time_reduction=2), ValueError, "time_reduction"),
    ({}, None, ValueError, "teacher_cfg"),
    (dict(fastemit_lambda=0.1), {}, ValueError, "fastemit"),
    (dict(ar_range=3), {}, ValueError, "mutually exclusive"),
    (dict(ctc_weight=0.2), {}, ValueError, "ctc_weight"),
])
def test_distill_guards(tkw, teacher_kw, err, match):
    tcfg = port_config.TrainConfig(distill_weight=0.3, **tkw)
    teacher = (None if teacher_kw is None
               else dataclasses.replace(CFG, **teacher_kw))
    with pytest.raises(err, match=match):
        tloop.make_train_step(CFG, tcfg, teacher_cfg=teacher, device="cpu")


def test_distill_takes_the_xla_route_on_the_card_at_any_joint_width():
    """auto resolves to fused on the card, but distillation is built on
    the xla route: libri960's J=1024, which refuses the fused ring loss,
    builds; the step refuses a call without the teacher."""
    cfg = port_config.config_libri960()
    tcfg = port_config.TrainConfig(distill_weight=0.3)
    tloop.make_train_step(cfg, tcfg, teacher_cfg=cfg, device="cuda:0")
    with pytest.raises(NotImplementedError, match=r"item 6\(b\)"):
        tloop.make_train_step(cfg, port_config.TrainConfig(
            loss_impl="fused"), device="cuda:0")
    step = tloop.make_train_step(CFG, tcfg, teacher_cfg=CFG, device="cpu")
    state = tloop.init_train_state(0, CFG, tcfg, device="cpu")
    with pytest.raises(ValueError, match="teacher_params"):
        step(state, *_t(_batch()))


def _config_file(tmp_path, name, **kw):
    smoke = dict(enc_layers=1, enc_hidden=64, pred_layers=1, pred_hidden=64,
                 embed_dim=32, joint_dim=64, vocab_size=32, input_dim=80)
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps({**smoke, **kw}))
    return str(path)


def test_distill_cli(tmp_path, capsys):
    """A 1-step teacher checkpoint (unidirectional, then a BiLSTM from a
    JSON config), then 2 student steps with --distill-from; the refusals."""
    common = ["--config", "smoke", "--batch-size", "2", "--max-frames",
              "40", "--max-labels", "5", "--log-every", "1", "--eval-every",
              "0", "--device", "cpu"]
    teachers = {"uni": "smoke",
                "bi": _config_file(tmp_path, "bi", bidirectional=True)}
    for name, config in teachers.items():
        d = str(tmp_path / name)
        train_main(common[2:] + ["--config", config, "--steps", "1",
                                 "--ckpt-dir", d])
        capsys.readouterr()
        train_main(common + ["--steps", "2", "--distill-from", d,
                             "--distill-weight", "0.5", "--distill-temp",
                             "2.0"])
        out = capsys.readouterr()
        res = json.loads(out.out.strip().splitlines()[-1])
        assert res["steps"] == 2 and np.isfinite(res["final_loss"])
        assert f"distilling from {d} (step 1" in out.err
    with pytest.raises(SystemExit, match="mutually exclusive"):
        train_main(common + ["--distill-from", d, "--ar-range", "3"])
    with pytest.raises(SystemExit, match="no meta.json"):
        train_main(common + ["--distill-from", str(tmp_path / "none")])
    wide = str(tmp_path / "wide")
    train_main(common[2:] + ["--config", _config_file(
        tmp_path, "v40", vocab_size=40), "--steps", "1", "--ckpt-dir", wide])
    with pytest.raises(ValueError, match="vocab_size"):
        train_main(common + ["--distill-from", wide])


def _dp_distill(mesh, s_np, t_np, batches):
    """Two distillation steps on `mesh` (None: one process): losses,
    final params, every rank's params digest."""
    tcfg = port_config.TrainConfig(batch_size=4, warmup_steps=1,
                                   total_steps=10, distill_weight=0.5,
                                   distill_temp=2.0)
    state = tloop.init_train_state(None, CFG, tcfg,
                                   params=params_from_numpy(s_np))
    teacher = params_from_numpy(t_np)
    if mesh is not None:
        state = dataclasses.replace(
            state, params=meshlib.replicate(mesh, state.params),
            opt_state=meshlib.replicate(mesh, state.opt_state))
        teacher = meshlib.replicate(mesh, teacher)
    step = tloop.make_train_step(CFG, tcfg, mesh=mesh, teacher_cfg=TEACHER,
                                 device="cpu")
    losses = []
    for b in batches:
        b = _t(b) if mesh is None else meshlib.shard_batch(mesh, b)
        state, info = step(state, *b, teacher)
        losses.append(float(info["loss"]))
    flat = torch.cat([x.reshape(-1) for x in
                      torch.utils._pytree.tree_leaves(state.params)])
    digest = flat.numpy().tobytes()
    digests = ([digest] if mesh is None
               else meshlib.all_gather_objects(mesh, digest))
    return losses, params_to_numpy(state.params), digests


def test_two_ranks_match_one_process(tmp_path):
    s_np, t_np = _params_np(JCFG, 7), _params_np(JTEACHER, 8)
    batches = [_batch(20 + i, B=4) for i in range(2)]
    want = _dp_distill(None, s_np, t_np, batches)
    losses, params, digests = meshlib.spawn(
        _dp_distill, 2, ["cpu", "cpu"], args=(s_np, t_np, batches),
        init_method=f"file://{tmp_path}/rendezvous")
    np.testing.assert_allclose(losses, want[0], rtol=1e-5)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(want[1])):
        np.testing.assert_allclose(a, b, **DP_PARAM_TOL)
    assert len(digests) == 2 and digests[0] == digests[1]
