"""Two gloo ranks of the port's CTC steps against one process on the CPU.

make_train_step(loss_kind="ctc") and ctc_weight=0.3 on a data-parallel
mesh (this process and one spawned worker, meeting at a file:// path
under tmp_path): the CTC term rides the one flat all-reduce of the loss
and gradients, so two ranks on halves of the batch give one process's
loss within 1e-5 relative and its params within 2e-5 relative / 2e-6
absolute after two steps, and the ranks' params are bit-equal, as
tests/test_ctc_multitask.py:72 asks of the JAX package's mesh; and the
decode CLI's CTC modes under --data-parallel 2 write the one-device
hypotheses. The module imports no JAX: the worker process imports it to
find its function.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rnn_transducer_tpu_torch.data.synthetic import random_batch
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.models import transducer as tm
from rnn_transducer_tpu_torch.parallel import mesh as meshlib
from rnn_transducer_tpu_torch.train import loop as tloop
from rnn_transducer_tpu_torch.weights import params_from_numpy, params_to_numpy
from test_torch_dp import PARAM_TOL, _decode, _digest

pytestmark = pytest.mark.quick

TINY = dict(input_dim=8, enc_layers=2, enc_hidden=16, time_reduction=2,
            pred_layers=1, pred_hidden=12, embed_dim=8, joint_dim=16,
            vocab_size=21, compute_dtype="float32", ctc_head=True)
TCFG_KW = dict(batch_size=8, learning_rate=1e-3, warmup_steps=1,
               total_steps=100)
# (loss_kind, TrainConfig and TransducerConfig fields)
KINDS = {"ctc": ("ctc", {}, {}),
         "ctc_weight": ("rnnt", dict(ctc_weight=0.3, loss_impl="xla"), {}),
         "ctc_weight_stateless": ("rnnt", dict(ctc_weight=0.3,
                                               loss_impl="fused"),
                                  dict(pred_type="stateless"))}


def _train(mesh, kind, params_np, batches):
    loss_kind, tkw, ckw = KINDS[kind]
    cfg = port_config.TransducerConfig(**{**TINY, **ckw})
    tcfg = port_config.TrainConfig(**{**TCFG_KW, **tkw})
    state = tloop.init_train_state(None, cfg, tcfg,
                                   params=params_from_numpy(params_np))
    if mesh is not None:
        state = dataclasses.replace(
            state, params=meshlib.replicate(mesh, state.params),
            opt_state=meshlib.replicate(mesh, state.opt_state))
    step = tloop.make_train_step(cfg, tcfg, mesh=mesh, device="cpu",
                                 loss_kind=loss_kind)
    losses = []
    for batch in batches:
        batch = (tuple(torch.from_numpy(a) for a in batch) if mesh is None
                 else meshlib.shard_batch(mesh, batch))
        state, info = step(state, *batch)
        assert int(info["skipped_nonfinite"]) == 0
        losses.append(float(info["loss"]))
    digests = (meshlib.all_gather_objects(mesh, _digest(state.params))
               if mesh is not None else [_digest(state.params)])
    return losses, params_to_numpy(state.params), digests


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_two_ranks_match_one_process(kind, tmp_path):
    ckw = KINDS[kind][2]
    cfg = port_config.TransducerConfig(**{**TINY, **ckw})
    params_np = params_to_numpy(tm.init_params(cfg, np.random.default_rng(3),
                                               device="cpu"))
    rng = np.random.default_rng(7)
    batches = [random_batch(rng, 8, 12, 4, TINY["input_dim"],
                            TINY["vocab_size"]) for _ in range(2)]
    want = _train(None, kind, params_np, batches)
    losses, params, digests = meshlib.spawn(
        _train, 2, ["cpu", "cpu"], args=(kind, params_np, batches),
        init_method=f"file://{tmp_path}/rendezvous")
    np.testing.assert_allclose(losses, want[0], rtol=1e-5)
    leaves = torch.utils._pytree.tree_leaves
    for a, b in zip(leaves(params), leaves(want[1])):
        np.testing.assert_allclose(a, b, **PARAM_TOL)
    assert len(digests) == 2 and digests[0] == digests[1]


@pytest.mark.parametrize("extra", [
    ["--mode", "ctc_greedy", "--confidence", "--timestamps"],
    ["--mode", "ctc_beam", "--beam", "4", "--nbest", "2",
     "--length-bonus", "0.5"],
], ids=["ctc_greedy", "ctc_beam"])
def test_decode_cli_dp_ctc_modes_match_single_device(tmp_path, extra):
    """The decode CLI's CTC modes on two gloo ranks write the one-device
    hypotheses (JAX's recognize.py takes them under --data-parallel too)."""
    want = _decode(tmp_path, "c1", extra)
    got = _decode(tmp_path, "c2", extra + ["--data-parallel", "2"])
    assert got == want and len(got) == 16
    assert sum(len(r["hyp"]) for r in got) > 0
