"""The port's data parallelism (`parallel/mesh.py`, `make_train_step(mesh=)`,
the train and decode CLIs' --data-parallel) on the CPU.

Two gloo ranks (this process and one spawned worker, meeting at a
file:// path under tmp_path, so parallel test workers never share a port)
against one process on the whole batch, as tests/test_train.py and
tests/test_recognize_dp.py hold the JAX package's mesh: the loss within
1e-5 relative, the params within 2e-5 relative / 2e-6 absolute after
every route's step, the two ranks' params bit-equal; the 2-rank step
against JAX's `make_mesh(2)` step; the CLIs' N = 2 runs against N = 1 and
their refusals with JAX's words. JAX is imported inside the tests that
compare with it, so that a worker process, which imports this module to
find its function, starts without it.
"""

import dataclasses
import hashlib
import json

import numpy as np
import pytest
import torch

from rnn_transducer_tpu_torch import recognize as rec
from rnn_transducer_tpu_torch.data.synthetic import random_batch
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.parallel import mesh as meshlib
from rnn_transducer_tpu_torch.train import checkpoint as ckpt
from rnn_transducer_tpu_torch.train import loop as tloop
from rnn_transducer_tpu_torch.train.__main__ import main as train_main
from rnn_transducer_tpu_torch.weights import params_from_numpy, params_to_numpy

pytestmark = pytest.mark.quick

TINY = dict(input_dim=8, enc_layers=2, enc_hidden=16, time_reduction=2,
            pred_layers=1, pred_hidden=12, embed_dim=8, joint_dim=16,
            vocab_size=21, compute_dtype="float32")
TCFG_KW = dict(batch_size=8, learning_rate=1e-3, warmup_steps=1,
               total_steps=100)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-5, atol=2e-6)
# each route's config and TrainConfig over TINY
ROUTES = {
    "xla": ({}, dict(loss_impl="xla")),
    "fused": ({}, dict(loss_impl="fused")),
    "pallas": ({}, dict(loss_impl="pallas")),
    "pruned": (dict(pruned_range=3), dict(loss_impl="pruned")),
    "ar": ({}, dict(ar_range=3)),
    "bilstm": (dict(bidirectional=True), dict(loss_impl="xla")),
}


def _cfgs(route):
    cfg_kw, tcfg_kw = ROUTES[route]
    return (port_config.TransducerConfig(**{**TINY, **cfg_kw}),
            port_config.TrainConfig(**{**TCFG_KW, **tcfg_kw}))


def _batches(n=2, seed=7):
    rng = np.random.default_rng(seed)
    return [random_batch(rng, 8, 12, 4, TINY["input_dim"],
                         TINY["vocab_size"]) for _ in range(n)]


def _digest(params) -> str:
    h = hashlib.sha256()
    for leaf in torch.utils._pytree.tree_leaves(params):
        h.update(leaf.detach().contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes() if isinstance(leaf, torch.Tensor)
                 else repr(leaf).encode())
    return h.hexdigest()


def _train(mesh, route, params_np, batches):
    """The steps of `route` on `mesh` (None: one process, whole batch):
    losses, grad norms, final params and every rank's params digest."""
    cfg, tcfg = _cfgs(route)
    state = tloop.init_train_state(None, cfg, tcfg,
                                   params=params_from_numpy(params_np))
    if mesh is not None:
        state = dataclasses.replace(
            state, params=meshlib.replicate(mesh, state.params),
            opt_state=meshlib.replicate(mesh, state.opt_state))
    step = tloop.make_train_step(cfg, tcfg, mesh=mesh, device="cpu")
    losses, gnorms = [], []
    for batch in batches:
        if mesh is None:
            batch = tuple(torch.from_numpy(a) for a in batch)
        else:
            batch = meshlib.shard_batch(mesh, batch)
            assert batch[0].shape[0] == 8 // mesh.size
        state, info = step(state, *batch)
        assert int(info["skipped_nonfinite"]) == 0
        losses.append(float(info["loss"]))
        gnorms.append(float(info["grad_norm"]))
    digests = (meshlib.all_gather_objects(mesh, _digest(state.params))
               if mesh is not None else [_digest(state.params)])
    return losses, gnorms, params_to_numpy(state.params), digests


def _spawn(fn, tmp_path, *args):
    return meshlib.spawn(fn, 2, ["cpu", "cpu"], args=args,
                         init_method=f"file://{tmp_path}/rendezvous")


def _assert_close(got, want):
    leaves = torch.utils._pytree.tree_leaves
    for a, b in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(a, b, **PARAM_TOL)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_two_ranks_match_one_process(route, tmp_path):
    cfg, _ = _cfgs(route)
    from rnn_transducer_tpu_torch.models import transducer as tm
    params_np = params_to_numpy(tm.init_params(cfg, np.random.default_rng(3),
                                               device="cpu"))
    batches = _batches()
    want = _train(None, route, params_np, batches)
    losses, gnorms, params, digests = _spawn(_train, tmp_path, route,
                                             params_np, batches)
    np.testing.assert_allclose(losses, want[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(gnorms, want[1], rtol=1e-4)
    _assert_close(params, want[2])
    assert len(digests) == 2 and digests[0] == digests[1]


def test_two_ranks_match_jax_make_mesh(tmp_path):
    """JAX's shard_map step on make_mesh(2) (two of the conftest's eight
    CPU devices) against the port's two gloo ranks, two steps: loss and
    params within tests/test_torch_train.py's bounds."""
    import jax
    import jax.numpy as jnp

    from rnn_transducer_tpu.models import config as jax_config
    from rnn_transducer_tpu.parallel.mesh import (make_mesh, replicate,
                                                  shard_batch)
    from rnn_transducer_tpu.train import loop as jloop

    jcfg = jax_config.TransducerConfig(**TINY)
    jtcfg = jax_config.TrainConfig(**TCFG_KW, loss_impl="xla")
    state = jloop.init_train_state(jax.random.PRNGKey(4), jcfg, jtcfg)
    params_np = jax.tree.map(np.asarray, state.params)
    mesh = make_mesh(2)
    state = jloop.TrainState(params=replicate(mesh, state.params),
                             opt_state=replicate(mesh, state.opt_state),
                             step=replicate(mesh, state.step))
    step = jloop.make_train_step(jcfg, jtcfg, mesh=mesh)
    batches = _batches(seed=8)
    want_losses = []
    for batch in batches:
        state, info = step(state, *shard_batch(
            mesh, tuple(jnp.asarray(a) for a in batch)))
        want_losses.append(float(info["loss"]))
    losses, _, params, digests = _spawn(_train, tmp_path, "xla", params_np,
                                        batches)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5, atol=1e-5)
    for a, b in zip(jax.tree.leaves(params),
                    jax.tree.leaves(jax.tree.map(np.asarray, state.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)
    assert digests[0] == digests[1]


# ------------------------------ the mesh ---------------------------------

def _replicated(mesh, seed_by_rank):
    """Each rank's own params, with leaves of every other dtype (a 0-dim
    and an empty one too), replicated: every rank's digest."""
    from rnn_transducer_tpu_torch.models import transducer as tm
    cfg = port_config.TransducerConfig(**TINY)
    rng = np.random.default_rng(seed_by_rank[mesh.rank])
    params = tm.init_params(cfg, rng, device="cpu")
    x = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32))
    params["other"] = {"bf16": x.to(torch.bfloat16), "f16": x.half(),
                       "i8": (x * 50).to(torch.int8), "bool": x > 0,
                       "step": torch.tensor(int(rng.integers(1 << 40))),
                       "empty": torch.zeros(0, 4), "name": "kept"}
    mine = _digest(params)
    got = meshlib.replicate(mesh, params)
    assert _digest(params) == mine  # the caller's tensors stay
    return meshlib.all_gather_objects(mesh, (mine, _digest(got)))


def test_replicate_broadcasts_rank_0(tmp_path):
    (own0, got0), (own1, got1) = _spawn(_replicated, tmp_path, (1, 2))
    assert own0 != own1 and got0 == got1 == own0


def test_shard_batch_and_backends():
    one = meshlib.make_mesh(1, ["cpu"])
    assert (one.rank, one.size, one.group) == (0, 1, None)
    half = meshlib.Mesh(1, 2, torch.device("cpu"), "gloo")
    x = np.arange(8 * 3).reshape(8, 3)
    got = meshlib.shard_batch(half, (x, x[:, 0]))
    np.testing.assert_array_equal(got[0].numpy(), x[4:])
    np.testing.assert_array_equal(got[1].numpy(), x[4:, 0])
    with pytest.raises(ValueError, match="does not divide"):
        meshlib.shard_batch(half, x[:5])
    dev = meshlib.mesh_devices
    assert meshlib.backend_for(dev(2, ["cpu", "cpu"])) == "gloo"
    assert meshlib.backend_for(dev(2, ["cuda:0", "cuda:1"])) == "nccl"
    assert meshlib.backend_for(dev(2, ["cuda", "cuda:0"])) == "gloo"
    with pytest.raises(ValueError, match="all on the CPU or all on cards"):
        meshlib.backend_for(dev(2, ["cpu", "cuda:0"]))
    with pytest.raises(ValueError, match="available devices"):
        dev(3, ["cpu", "cpu"])


def test_make_mesh_takes_the_cards_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        meshlib.make_mesh(2)


# ------------------------------ the CLIs ---------------------------------

def _train_cli(tmp_path, name, n, capsys):
    """train.py's smoke model at f32 (a JSON config), 3 steps on n ranks."""
    cfg = tmp_path / "smoke_f32.json"
    cfg.write_text(json.dumps(dict(
        enc_layers=1, enc_hidden=64, pred_layers=1, pred_hidden=64,
        embed_dim=32, joint_dim=64, vocab_size=32, input_dim=80,
        compute_dtype="float32")))
    d = tmp_path / name
    train_main(["--device", "cpu", "--config", str(cfg), "--batch-size", "4",
                "--max-frames", "24", "--max-labels", "4", "--warmup-steps",
                "1", "--steps", "3", "--log-every", "1", "--ckpt-dir", str(d),
                "--data-parallel", str(n)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    state, step = ckpt.restore_checkpoint(str(d), device="cpu")
    return out, state, step, ckpt.load_meta(str(d))


def test_train_cli_two_ranks_match_one(tmp_path, capsys):
    out1, s1, step1, _ = _train_cli(tmp_path, "dp1", 1, capsys)
    out2, s2, step2, meta = _train_cli(tmp_path, "dp2", 2, capsys)
    assert step1 == step2 == 3 and out2["steps"] == 3
    np.testing.assert_allclose(out2["final_loss"], out1["final_loss"],
                               rtol=1e-4, atol=1e-4)  # printed to 4 places
    _assert_close(params_to_numpy(s2.params), params_to_numpy(s1.params))
    assert meta["train_config"]["data_parallel"] == 2


def test_train_cli_refusals(monkeypatch):
    with pytest.raises(SystemExit, match="divide"):
        train_main(["--device", "cpu", "--batch-size", "3",
                    "--data-parallel", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="available devices"):
        train_main(["--batch-size", "4", "--data-parallel", "2"])


def _decode(tmp_path, name, extra):
    hyps = tmp_path / f"{name}.jsonl"
    rec.main(["--config", "smoke", "--data", "synthetic", "--batch-size",
              "8", "--batches", "2", "--hyps-file", str(hyps), "--device",
              "cpu"] + extra)
    return [json.loads(line) for line in hyps.read_text().splitlines()]


def test_decode_cli_dp_greedy_matches_single_device(tmp_path):
    want = _decode(tmp_path, "g1", ["--mode", "greedy"])
    got = _decode(tmp_path, "g2", ["--mode", "greedy", "--data-parallel",
                                   "2"])
    assert got == want and len(got) == 16


def test_decode_cli_dp_beam_with_confidence_nbest_matches(tmp_path):
    extra = ["--mode", "beam", "--beam", "4", "--confidence", "--nbest", "2"]
    want = _decode(tmp_path, "b1", extra)
    got = _decode(tmp_path, "b2", extra + ["--data-parallel", "2"])
    assert got == want and all(len(r["nbest"]) == 2 for r in got)


def test_decode_cli_dp_guards():
    """tests/test_recognize_dp.py's guards, with JAX's words."""
    with pytest.raises(SystemExit, match="divide"):
        rec.main(["--config", "smoke", "--batch-size", "6",
                  "--data-parallel", "4", "--device", "cpu"])
    with pytest.raises(SystemExit, match="streaming"):
        rec.main(["--config", "smoke", "--mode", "streaming",
                  "--data-parallel", "2", "--device", "cpu"])
