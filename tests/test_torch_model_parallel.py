"""The port's sequence- and expert-parallel training (parallel/tp.py, the
2-D mesh of parallel/mesh.py, the training CLI's --model-parallel) on the
CPU.

Gloo ranks (this process and spawned workers, meeting at a file:// path
under tmp_path) on 1x2 and 2x2 (data, model) meshes against one process
on the whole batch (an MoE model at ample capacity with dropout, weight
noise and the EMA; a conformer under ep; ctc_weight, the multi-blank and
TDT families, the CTC and MWER phases under sp): the loss within 2e-5
relative and the params within 2e-5, tests/test_moe.py's bounds
(:224-232). Against JAX's `make_tp_train_step` on `make_mesh_2d` (the
conftest's CPU devices) with JAX's dropout masks and weight noise fed to
the port's step, ctc_weight, the EMA, padded frames and dropped tokens;
`moe_top1_ep` against `moe_top1`; the CLI's train, resume, topology
refusal and the decode CLI on an ep checkpoint; and the refusals of tp,
pp and the other combinations in train.py's words. JAX is imported inside
the tests that compare with it, so that a worker process, which imports
this module to find its function, starts without it.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from rnn_transducer_tpu_torch.data.synthetic import random_batch
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.models import transducer as tm
from rnn_transducer_tpu_torch.ops import moe as tmoe
from rnn_transducer_tpu_torch.parallel import mesh as meshlib
from rnn_transducer_tpu_torch.parallel import tp
from rnn_transducer_tpu_torch.train import checkpoint as ckpt
from rnn_transducer_tpu_torch.train import loop as tloop
from rnn_transducer_tpu_torch.train.__main__ import main as train_main
from rnn_transducer_tpu_torch.train.regularizers import leaf_paths
from rnn_transducer_tpu_torch.weights import params_from_numpy, params_to_numpy

pytestmark = pytest.mark.quick

TINY = dict(input_dim=8, enc_layers=2, enc_hidden=16, time_reduction=2,
            pred_layers=1, pred_hidden=12, embed_dim=8, joint_dim=16,
            vocab_size=21, compute_dtype="float32")
MOE = dict(joint_experts=4, joint_expert_hidden=12)
MODELS = {
    "moe": dict(TINY, **MOE, moe_capacity_factor=4.0),
    "conformer_moe": dict(TINY, **MOE, moe_capacity_factor=4.0,
                          enc_type="conformer", enc_heads=2, enc_ff_mult=2,
                          enc_conv_kernel=3, enc_hidden=16),
    "ctc": dict(TINY, ctc_head=True),
    "multiblank": dict(TINY, big_blank_durations=(2, 3)),
    "tdt": dict(TINY, tdt_durations=(0, 1, 2)),
    # a CTC head for the CTC phase; capacity 1 for JAX's per-rank drops
    "moe_ctc": dict(TINY, **MOE, moe_capacity_factor=4.0, ctc_head=True),
    "moe_drop": dict(TINY, **MOE, moe_capacity_factor=1.0, ctc_head=True),
}
REGULARIZERS = dict(dropout=0.1, embed_dropout=0.1, weight_noise_std=0.01,
                    ema_decay=0.9)
# no warm-up, so that every step moves the params
TCFG_KW = dict(batch_size=8, learning_rate=1e-3, warmup_steps=0,
               total_steps=100, grad_clip_norm=1e9)
# the gradient norm is held to the loss's bound: Adam's update does not
# see a leaf's gradient scaled by a constant, the norm does
LOSS_RTOL, PARAM_ATOL = 2e-5, 2e-5
# Adam's first moment, a sum of the steps' gradients: each leaf within
# this share of its largest value (the port's f32 gradient bound)
GRAD_RTOL = 1e-3


def _cfgs(model, **tkw):
    return (port_config.TransducerConfig(**MODELS[model]),
            port_config.TrainConfig(**TCFG_KW, **tkw))


def _batches(n=2, seed=7, T=16, U=4):
    rng = np.random.default_rng(seed)
    return [random_batch(rng, 8, T, U, TINY["input_dim"], TINY["vocab_size"])
            for _ in range(n)]


def _params_np(model, seed=3):
    cfg, _ = _cfgs(model)
    return params_to_numpy(tm.init_params(cfg, np.random.default_rng(seed),
                                          device="cpu"))


def _run(mesh, mode, model, tkw, params_np, batches, loss_kind="rnnt",
         noise=None, masks=None):
    """Steps of `mode` on `mesh` (None: one process, whole batch): the
    losses, the final plain params (and EMA), every rank's digest of its
    replicated leaves, the gradient norms, Adam's first moment. noise /
    masks: JAX's draws by (step, path) and (step, site), fed to the
    step."""
    cfg, tcfg = _cfgs(model, **tkw)
    params = params_from_numpy(params_np)
    kw = {}
    if noise is not None:
        kw["noise_fn"] = lambda step, paths, leaves: [
            torch.from_numpy(noise[(step, mesh.model_rank, p)])
            for p in paths]
    if masks is not None:
        def masks_fn(step, offset, n):
            def drop(site, x, keep):
                mk = torch.from_numpy(masks[(step, site)])
                assert mk.shape[0] == n and mk.shape[1:] == x.shape[1:]
                return mk[offset:offset + x.shape[0]]
            return drop
        kw["masks_fn"] = masks_fn
    if mesh is None:
        state = tloop.init_train_state(None, cfg, tcfg, params=params)
        step = tloop.make_train_step(cfg, tcfg, device="cpu",
                                     loss_kind=loss_kind)
    elif mode == "ep":
        state = tp.init_ep_train_state(None, cfg, tcfg, mesh.n_model,
                                       mesh.model_rank, params=params)
        step = tp.make_tp_train_step(cfg, tcfg, mesh, "ep", loss_kind, **kw)
    else:
        state = tp.init_sp_train_state(None, cfg, tcfg, params=params)
        step = tp.make_tp_train_step(cfg, tcfg, mesh, "sp", loss_kind, **kw)
    losses, norms = [], []
    for batch in batches:
        if mesh is None:
            batch = tuple(torch.from_numpy(a) for a in batch)
        else:
            batch = meshlib.shard_batch_2d(mesh, batch)
        state, info = step(state, *batch)
        assert int(info["skipped_nonfinite"]) == 0
        losses.append(float(info["loss"]))
        norms.append(float(info["grad_norm"]))
    if mesh is None:
        ema = None if state.ema is None else params_to_numpy(state.ema)
        return (losses, params_to_numpy(state.params), ema, [], norms,
                params_to_numpy(state.opt_state["mu"]))
    rep = state.params.rep if mode == "ep" else state.params
    digest = [float(x.double().sum()) for x in pytree.tree_leaves(rep)]
    digests = meshlib.all_gather_objects(mesh, digest)
    plain = params_to_numpy(tp.plain_params(mesh, state.params, mode, cfg))
    ema = (None if state.ema is None else
           params_to_numpy(tp.plain_params(mesh, state.ema, mode, cfg)))
    mu = params_to_numpy(tp.plain_params(mesh, state.opt_state["mu"], mode,
                                         cfg))
    return losses, plain, ema, digests, norms, mu


def _spawn(fn, tmp_path, n_data, n_model, *args):
    n = n_data * n_model
    return meshlib.spawn(fn, n, ["cpu"] * n, args=args, n_model=n_model,
                         init_method=f"file://{tmp_path}/rendezvous")


def _assert_grads_close(got, want):
    """Adam's first moments (linear in the steps' gradients, which Adam's
    update is not): every leaf within GRAD_RTOL of its largest value; a
    conformer's attention key bias, whose exact gradient is 0 (its
    rounding is all there is), within GRAD_RTOL of the model's largest."""
    model_top = max(np.abs(b).max() for b in pytree.tree_leaves(want))
    for path, a, b in zip(leaf_paths(got), pytree.tree_leaves(got),
                          pytree.tree_leaves(want)):
        top = model_top if path.endswith("/k/b") else np.abs(b).max()
        assert np.abs(a - b).max() <= GRAD_RTOL * top, path


def _assert_close(got, want):
    """Every leaf within PARAM_ATOL; a conformer's attention key bias,
    which gets no gradient in exact arithmetic but f32 noise that Adam
    turns into steps of up to lr, within 2 lr (tests/test_torch_conformer.py
    KEY_BIAS_TOL)."""
    for path, a, b in zip(leaf_paths(got), pytree.tree_leaves(got),
                          pytree.tree_leaves(want)):
        atol = (2 * TCFG_KW["learning_rate"] if path.endswith("/k/b")
                else PARAM_ATOL)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=path)


# ------------------------- against one process --------------------------------

ONE_PROCESS = {
    "sp-1x2-moe": ("sp", 1, 2, "moe", REGULARIZERS),
    "sp-2x2-moe": ("sp", 2, 2, "moe", REGULARIZERS),
    "ep-1x2-moe": ("ep", 1, 2, "moe", REGULARIZERS),
    "ep-2x2-moe": ("ep", 2, 2, "moe", REGULARIZERS),
    "ep-1x2-conformer": ("ep", 1, 2, "conformer_moe", {}),
    "sp-2x2-ctc_weight": ("sp", 2, 2, "ctc", dict(REGULARIZERS,
                                                  ctc_weight=0.3)),
    "sp-1x2-multiblank": ("sp", 1, 2, "multiblank", {}),
    "sp-1x2-tdt": ("sp", 1, 2, "tdt", {}),
}


@pytest.mark.parametrize("case", sorted(ONE_PROCESS))
def test_steps_match_one_process(case, tmp_path):
    mode, nd, nm, model, tkw = ONE_PROCESS[case]
    params_np = _params_np(model)
    batches = _batches()
    want = _run(None, None, model, tkw, params_np, batches)
    losses, params, ema, digests, norms, mu = _spawn(
        _run, tmp_path, nd, nm, mode, model, tkw, params_np, batches)
    np.testing.assert_allclose(losses, want[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(norms, want[4], rtol=LOSS_RTOL)
    _assert_grads_close(mu, want[5])
    _assert_close(params, want[1])
    if tkw.get("ema_decay"):
        _assert_close(ema, want[2])
    # every rank holds the same replicated leaves
    assert all(d == digests[0] for d in digests)
    # the step moved the params
    assert max(np.abs(a - b).max() for a, b in zip(
        pytree.tree_leaves(params), pytree.tree_leaves(params_np))) > 1e-4


@pytest.mark.parametrize("mode, model", [("sp", "ctc"), ("ep", "moe_ctc")])
def test_ctc_phase_matches_one_process(mode, model, tmp_path):
    params_np = _params_np(model)
    batches = _batches()
    want = _run(None, None, model, {}, params_np, batches, "ctc")
    got = _spawn(_run, tmp_path, 1, 2, mode, model, {}, params_np, batches,
                 "ctc")
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[4], want[4], rtol=LOSS_RTOL)
    _assert_grads_close(got[5], want[5])
    _assert_close(got[1], want[1])


def test_mwer_phase_matches_one_process(tmp_path):
    tkw = dict(mwer_beam=2, mwer_max_symbols=6)
    params_np = _params_np("moe")
    batches = _batches(n=1)
    want = _run(None, None, "moe", tkw, params_np, batches, "mwer")
    got = _spawn(_run, tmp_path, 1, 2, "sp", "moe", tkw, params_np, batches,
                 "mwer")
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got[4], want[4], rtol=LOSS_RTOL)
    _assert_grads_close(got[5], want[5])
    _assert_close(got[1], want[1])


# ------------------------------ against JAX -----------------------------------

def _jax_path(path) -> str:
    return "".join(f"/{getattr(k, 'name', getattr(k, 'key', getattr(k, 'idx', k)))}"
                   for k in path)


def _jax_noise(seed, step, params, shd_of, n_model):
    """JAX's `apply_weight_noise` (tp.py :1476) draws of one step for each
    model rank, by the port's path: leaf i of the (squeezed) params keyed
    fold_in(fold_in(PRNGKey(seed ^ 0x5EED), step), i), an expert shard's
    then by the model rank."""
    import jax

    base = jax.random.fold_in(jax.random.PRNGKey(seed ^ 0x5EED), step)
    out = {}
    for i, (path, leaf) in enumerate(
            jax.tree_util.tree_flatten_with_path(params)[0]):
        name = _jax_path(path)
        k = jax.random.fold_in(base, i)
        for mi in range(n_model):
            if shd_of(name):
                out[(step, mi, name)] = np.asarray(jax.random.normal(
                    jax.random.fold_in(k, mi), leaf.shape[1:], leaf.dtype))
            else:
                out[(step, mi, name)] = np.asarray(jax.random.normal(
                    k, leaf.shape, leaf.dtype))
    return out


def _jax_masks(seed, step, B, shapes, rate):
    """JAX's dropout masks of one step for the global batch (tp.py
    `dropout_rngs` :1500 and `_dropout`): row r's key fold_in(fold_in(
    PRNGKey(seed ^ 0xD120), step), r), a site's fold_in(row key, site)."""
    import jax
    import jax.numpy as jnp

    base = jax.random.fold_in(jax.random.PRNGKey(seed ^ 0xD120), step)
    rows = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(base,
                                                            jnp.arange(B))
    return {(step, site): np.asarray(jax.vmap(lambda k: jax.random.bernoulli(
        jax.random.fold_in(k, site), 1.0 - rate, shape))(rows))
            for site, shape in shapes.items()}


JAX_CASES = {
    "sp-1x2": ("sp", 1, 2, "ctc"),
    "sp-2x2": ("sp", 2, 2, "ctc"),
    "ep-1x2": ("ep", 1, 2, "moe_drop"),
    "ep-2x2": ("ep", 2, 2, "moe_drop"),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_steps_match_jax_make_tp_train_step(case, tmp_path):
    """JAX's shard_map step on make_mesh_2d against the port's ranks, two
    steps with ctc_weight 0.3, dropout (JAX's masks), weight noise (JAX's
    draws) and, for ep, the EMA, T' = 9 frames (padded to the model group)
    and a capacity factor of 1 (tokens dropped per rank, as in JAX).
    JAX's sp step cannot carry an EMA: its shard_map state spec
    (tp.py :1735) has no `ema` field."""
    import jax
    import jax.numpy as jnp

    from rnn_transducer_tpu.models import config as jax_config
    from rnn_transducer_tpu.parallel import tp as jtp

    mode, nd, nm, model = JAX_CASES[case]
    tkw = dict(REGULARIZERS, ctc_weight=0.3,
               ema_decay=REGULARIZERS["ema_decay"] if mode == "ep" else 0.0)
    jcfg = jax_config.TransducerConfig(**MODELS[model])
    jtcfg = jax_config.TrainConfig(**TCFG_KW, **tkw)
    key = jax.random.PRNGKey(4)
    if mode == "ep":
        jstate = jtp.init_ep_train_state(key, jcfg, jtcfg, nm)
        params_np = jax.tree.map(np.asarray, jtp.merge_params_ep(
            jstate.params, jcfg))
        noise_tree = jstate.params
    else:
        jstate = jtp.init_sp_train_state(key, jcfg, jtcfg)
        params_np = jax.tree.map(np.asarray, jstate.params)
        noise_tree = jstate.params
    mesh = jtp.make_mesh_2d(nd, nm)
    step = jtp.make_tp_train_step(jcfg, jtcfg, mesh, mode)
    jstate = (jtp.shard_tp_state(mesh, jstate) if mode == "ep"
              else jtp.replicate_state(mesh, jstate))
    batches = _batches(T=18)
    B, T, U = 8, 18, 4
    shapes = {0: (T, TINY["enc_hidden"]), 1000: (U + 1, TINY["embed_dim"])}
    noise, masks, want, want_norms = {}, {}, [], []
    for i, batch in enumerate(batches):
        noise.update(_jax_noise(jtcfg.seed, i, noise_tree,
                                lambda n: n.startswith("/shd/"), nm))
        masks.update(_jax_masks(jtcfg.seed, i, B, shapes, tkw["dropout"]))
        jstate, info = step(jstate, *jtp.shard_batch_2d(
            mesh, tuple(jnp.asarray(a) for a in batch)))
        want.append(float(info["loss"]))
        want_norms.append(float(info["grad_norm"]))
    want_params = jax.tree.map(np.asarray, jax.device_get(jstate.params))
    pairs = [(want_params, "params")]
    if mode == "ep":
        want_ema = jax.tree.map(np.asarray, jax.device_get(jstate.ema))
        pairs = [(jtp.merge_params_ep(want_params, jcfg), "params"),
                 (jtp.merge_params_ep(want_ema, jcfg), "ema")]
    losses, params, ema, _, norms, _ = _spawn(
        _run, tmp_path, nd, nm, mode, model, tkw, params_np, batches, "rnnt",
        noise, masks)
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(norms, want_norms, rtol=LOSS_RTOL)
    got_trees = {"params": params, "ema": ema}
    for ref, name in pairs:
        got = got_trees[name]
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree.leaves(ref)):
            np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL,
                                       err_msg=str(path))


# ---------------------------- moe_top1_ep --------------------------------------

def _ep_tokens(mesh, p_np, x, cf):
    """Each rank routes its own rows of x through moe_top1_ep."""
    p = params_from_numpy(p_np)
    M = mesh.n_model
    E_loc = p["b1"].shape[0] // M
    local = {k: p[k][mesh.model_rank * E_loc:(mesh.model_rank + 1) * E_loc]
             for k in ("w1", "b1", "w2", "b2")}
    local["router"] = p["router"]
    n = x.shape[0] // mesh.size
    xs = torch.from_numpy(x[mesh.rank * n:(mesh.rank + 1) * n])
    y, aux = tmoe.moe_top1_ep(
        local, xs, exchange=lambda t: tp._Exchange.apply(t, mesh),
        n_shards=M, capacity_factor=cf, compute_dtype=torch.float32,
        stats_mean=lambda t: tp.mesh_mean(mesh, t))
    ys = meshlib.all_gather_objects(mesh, y.numpy())
    return np.concatenate(ys), float(aux)


@pytest.mark.parametrize("nd, nm", [(1, 2), (2, 2), (1, 4)])
def test_moe_top1_ep_matches_moe_top1(nd, nm, tmp_path):
    """Ample capacity: every rank's tokens through the experts of their
    model group equal moe_top1 over all of them; aux the one-process
    value over the union (statistics averaged over the mesh)."""
    rng = np.random.default_rng(nd * 10 + nm)
    p_np = tmoe.init_moe_params(rng, 4, 16, 24)
    x = rng.normal(size=(48, 16)).astype(np.float32)
    want_y, want_aux = tmoe.moe_top1(params_from_numpy(p_np),
                                     torch.from_numpy(x), capacity_factor=4.0,
                                     compute_dtype=torch.float32)
    y, aux = _spawn(_ep_tokens, tmp_path, nd, nm, p_np, x, 4.0)
    np.testing.assert_allclose(y, want_y.numpy(), atol=1e-5)
    np.testing.assert_allclose(aux, float(want_aux), atol=1e-6)


# ------------------------------ the 2-D mesh ----------------------------------

def _where(mesh, batch):
    rows = meshlib.shard_batch_2d(mesh, batch)[0]
    return (mesh.rank, mesh.data_rank, mesh.model_rank,
            rows[:, 0].tolist())


def test_mesh_2d_places_ranks_as_jax_and_shards_rows(tmp_path):
    batch = (np.arange(8, dtype=np.float32)[:, None],)
    out = _spawn(_where_all, tmp_path, 2, 2, batch)
    assert out == [(0, 0, 0, [0.0, 1.0, 2.0, 3.0]),
                   (1, 0, 1, [0.0, 1.0, 2.0, 3.0]),
                   (2, 1, 0, [4.0, 5.0, 6.0, 7.0]),
                   (3, 1, 1, [4.0, 5.0, 6.0, 7.0])]


def _where_all(mesh, batch):
    return meshlib.all_gather_objects(mesh, _where(mesh, batch))


def test_split_and_merge_params_ep_round_trip():
    cfg, _ = _cfgs("moe")
    params = tm.init_params(cfg, np.random.default_rng(0), device="cpu")
    tpp = tp.split_params_ep(params, cfg, 2)
    assert tpp.shd["moe"]["w1"].shape == (2, 2, 16, 12)
    assert "moe" not in tpp.rep and "moe_router" in tpp.rep
    back = tp.merge_params_ep(tpp, cfg)
    for a, b in zip(pytree.tree_leaves(back), pytree.tree_leaves(params)):
        assert torch.equal(a, b)
    shard = tp.shard_of(tpp, 1)
    assert torch.equal(shard.shd["moe"]["b2"], params["moe"]["b2"][2:])
    merged = tp.merge_params_ep({"rep": tpp.rep, "shd": tpp.shd}, cfg)
    assert torch.equal(merged["moe"]["w2"], params["moe"]["w2"])


# ------------------------------- the CLI --------------------------------------

SMALL = ["--device", "cpu", "--max-frames", "32", "--max-labels", "4",
         "--batch-size", "4", "--log-every", "1", "--eval-every", "0"]


def _moe_config(tmp_path) -> str:
    c = port_config.TransducerConfig(
        enc_layers=1, enc_hidden=64, pred_layers=1, pred_hidden=64,
        embed_dim=32, joint_dim=64, vocab_size=32, input_dim=80,
        joint_experts=4, joint_expert_hidden=64)
    path = tmp_path / "moe.json"
    path.write_text(json.dumps(dataclasses.asdict(c)))
    return str(path)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_ep_trains_resumes_and_decodes(tmp_path, capsys):
    """--model-parallel 2 --parallel-mode ep (a CTC step first, dropout):
    2 steps into a checkpoint in JAX's stacked layout, one more on
    --resume, a refused topology, and the decode CLI on the checkpoint
    equal to a decode of its merged params."""
    from rnn_transducer_tpu_torch import recognize as rec

    cfg_path = _moe_config(tmp_path)
    ck = str(tmp_path / "ck")
    common = ["--config", cfg_path, "--model-parallel", "2",
              "--parallel-mode", "ep", "--ckpt-dir", ck,
              "--ctc-pretrain-steps", "1", "--dropout", "0.1"] + SMALL
    train_main(common + ["--steps", "2"])
    assert _last_json(capsys)["steps"] == 2
    meta = ckpt.load_meta(ck)
    assert meta["parallel"] == {"mode": "ep", "mp": 2}
    train_main(common + ["--steps", "3", "--resume"])
    assert _last_json(capsys)["steps"] == 3
    state, step = ckpt.restore_checkpoint(ck)
    assert step == 3 and state.opt_state["count"] == 3
    assert state.params["shd"]["moe"]["w1"].shape == (2, 2, 64, 64)
    assert state.opt_state["mu"]["shd"]["moe"]["b1"].shape == (2, 2, 64)
    with pytest.raises(SystemExit, match="topology"):
        train_main(["--config", cfg_path, "--model-parallel", "2",
                    "--parallel-mode", "sp", "--ckpt-dir", ck, "--resume",
                    "--ctc-pretrain-steps", "1", "--steps", "4"] + SMALL)
    with pytest.raises(SystemExit, match="topology"):
        train_main(["--config", cfg_path, "--ckpt-dir", ck, "--resume",
                    "--ctc-pretrain-steps", "1", "--steps", "4"] + SMALL)
    params, cfg, _, _ = ckpt.load_plain_params(ck)
    assert params["moe"]["w1"].shape == (4, 64, 64)
    out = rec.main(["--ckpt-dir", ck, "--device", "cpu", "--mode", "greedy",
                    "--batch-size", "2", "--batches", "1",
                    "--max-symbols", "8", "--hyps-file",
                    str(tmp_path / "hyps.jsonl")])
    assert out["n"] == 2
    hyps = [json.loads(x) for x in open(tmp_path / "hyps.jsonl")]
    assert len(hyps) == 2


def test_cli_sp_with_mwer_and_ctc_weight(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    train_main(["--config", "smoke", "--model-parallel", "2",
                "--parallel-mode", "sp", "--steps", "3", "--mwer-steps", "1",
                "--mwer-beam", "2", "--ctc-weight", "0.3", "--ckpt-dir", ck]
               + SMALL)
    res = _last_json(capsys)
    assert res["steps"] == 3 and np.isfinite(res["final_loss"])
    assert ckpt.load_meta(ck)["parallel"] == {"mode": "sp", "mp": 2}
    params, _, _, _ = ckpt.load_plain_params(ck)
    assert "moe" not in params


REFUSED = {
    "tp": (["--parallel-mode", "tp"], "16\\(b\\)"),
    "pp": (["--parallel-mode", "pp"], "16\\(c\\)"),
    "microbatches": (["--parallel-mode", "sp", "--microbatches", "2"],
                     "pp only"),
    "microbatches_alone": (["--microbatches", "2"], "pp only"),
    "mwer_ep": (["--parallel-mode", "ep", "--mwer-steps", "1"],
                "requires --parallel-mode sp"),
    "duration_ep": (["--parallel-mode", "ep", "--big-blanks", "2"],
                    "require --parallel-mode sp, tp, or pp"),
    "pruned_ep": (["--parallel-mode", "ep", "--pruned-range", "3"],
                  "requires --parallel-mode sp, tp, or pp"),
    "pruned_sp": (["--parallel-mode", "sp", "--pruned-range", "3"],
                  "16\\(b\\)"),
    "distill_ep": (["--parallel-mode", "ep", "--distill-from", "x"],
                   "not pp/ep"),
    "distill_sp": (["--parallel-mode", "sp", "--distill-from", "x"],
                   "16\\(b\\)"),
    "ar_ep": (["--parallel-mode", "ep", "--ar-range", "3"], "not pp/ep"),
    "ar_sp": (["--parallel-mode", "sp", "--ar-range", "3"], "16\\(b\\)"),
    "ep_without_experts": (["--parallel-mode", "ep", "--config", "smoke"],
                           "needs an MoE joint"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_cli_refusals(case, tmp_path):
    extra, match = REFUSED[case]
    mp = [] if case == "microbatches_alone" else ["--model-parallel", "2"]
    argv = ["--config", _moe_config(tmp_path), "--steps", "1"] + mp + SMALL
    with pytest.raises(SystemExit, match=match):
        train_main(argv + extra)


def test_step_refusals():
    cfg, tcfg = _cfgs("moe")
    mesh = meshlib.Mesh2D(0, 1, torch.device("cpu"), None, 1, 1)
    with pytest.raises(NotImplementedError, match="16\\(b\\)"):
        tp.make_tp_train_step(cfg, tcfg, mesh, "tp")
    with pytest.raises(NotImplementedError, match="16\\(c\\)"):
        tp.make_tp_train_step(cfg, tcfg, mesh, "pp")
    with pytest.raises(ValueError, match="grad_accum"):
        tp.make_tp_train_step(cfg, dataclasses.replace(tcfg, grad_accum=2),
                              mesh, "sp")
    with pytest.raises(ValueError, match="mode='sp'"):
        tp.make_tp_train_step(cfg, tcfg, mesh, "ep", "mwer")
    plain, _ = _cfgs("ctc")
    with pytest.raises(ValueError, match="joint_experts > 0"):
        tp.make_tp_train_step(plain, tcfg, mesh, "ep")
    with pytest.raises(NotImplementedError, match="16\\(b\\)"):
        tp.make_tp_train_step(plain, dataclasses.replace(
            tcfg, loss_impl="pruned"), mesh, "sp")
