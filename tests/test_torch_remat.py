"""Encoder rematerialisation (TransducerConfig.remat_encoder) in the port,
against the JAX package's `jax.checkpoint` of each encoder block or layer,
on the CPU.

A 2-step make_train_step trajectory with remat_encoder equals the one
without it bit for bit (losses, grad norms, params), for the conformer,
the LSTM and the BiLSTM encoder, with dropout too, and equals JAX's
trajectory with remat_encoder to the trajectory tolerances of
tests/test_torch_train.py and tests/test_torch_conformer.py. The backward
recomputes each block or layer: every LSTM layer's forward with
activations (K4-fwd's wrapper on the card) or every LayerNorm's forward
(K8-fwd's) runs twice a step, the backward wrappers once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.models import config as jax_config
from rnn_transducer_tpu.train import loop as jloop
from rnn_transducer_tpu_torch.data.synthetic import random_batch
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.models import transducer as tm
from rnn_transducer_tpu_torch.ops import fused_ln as fl
from rnn_transducer_tpu_torch.ops import lstm_cuda
from rnn_transducer_tpu_torch.train import loop as tloop
from rnn_transducer_tpu_torch.weights import params_from_numpy, params_to_numpy

pytestmark = pytest.mark.quick

LSTM = dict(input_dim=8, enc_layers=3, enc_hidden=16, time_reduction=2,
            pred_layers=1, pred_hidden=12, embed_dim=8, joint_dim=16,
            vocab_size=13, compute_dtype="float32")
ENCODERS = {
    "lstm": LSTM,
    "bilstm": dict(LSTM, bidirectional=True),
    "conformer": dict(LSTM, enc_type="conformer", enc_layers=2,
                      enc_hidden=32, enc_heads=4, enc_ff_mult=2,
                      enc_conv_kernel=5, time_reduction=4),
}
TKW = dict(batch_size=3, learning_rate=1e-3, warmup_steps=1, total_steps=10,
           loss_impl="xla")
# tests/test_torch_train.py's and tests/test_torch_conformer.py's
# trajectory tolerances; the conformer's attention key bias has no
# gradient in exact arithmetic, only f32 noise on both sides, which Adam
# turns into steps of up to the learning rate
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=0, atol=2e-6)
KEY_BIAS_TOL = dict(rtol=0, atol=2 * TKW["learning_rate"])


def _batches(fields, n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [random_batch(rng, 3, 16, 3, fields["input_dim"],
                         fields["vocab_size"]) for _ in range(n)]


def _jax_run(fields, remat):
    jcfg = jax_config.TransducerConfig(**fields, remat_encoder=remat)
    jt = jax_config.TrainConfig(**TKW)
    state = jloop.init_train_state(jax.random.PRNGKey(0), jcfg, jt)
    params0 = jax.tree.map(np.asarray, state.params)
    step = jloop.make_train_step(jcfg, jt)
    losses = []
    for batch in _batches(fields):
        state, info = step(state, *(jnp.asarray(a) for a in batch))
        losses.append(float(info["loss"]))
    return params0, losses, jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, state.params))


def _port_run(fields, params0, remat, **tkw):
    cfg = port_config.TransducerConfig(**fields, remat_encoder=remat)
    tcfg = port_config.TrainConfig(**{**TKW, **tkw})
    state = tloop.init_train_state(None, cfg, tcfg,
                                   params=params_from_numpy(params0))
    step = tloop.make_train_step(cfg, tcfg, device="cpu")
    infos = []
    for batch in _batches(fields):
        state, info = step(state, *(torch.from_numpy(a) for a in batch))
        assert int(info["skipped_nonfinite"]) == 0
        infos.append((float(info["loss"]), float(info["grad_norm"])))
    return infos, state


@pytest.mark.parametrize("enc", sorted(ENCODERS))
def test_remat_trajectory_equals_no_remat_and_jax(enc):
    fields = ENCODERS[enc]
    params0, want_losses, want_params = _jax_run(fields, remat=True)
    got, state = _port_run(fields, params0, remat=True)
    plain, plain_state = _port_run(fields, params0, remat=False)
    assert got == plain  # the same bits: a recomputed forward is the same
    leaves = torch.utils._pytree.tree_leaves
    assert all(torch.equal(a, b) for a, b in zip(
        leaves(state.params), leaves(plain_state.params)))
    np.testing.assert_allclose([l for l, _ in got], want_losses, **LOSS_TOL)
    for a, (path, b) in zip(jax.tree.leaves(params_to_numpy(state.params)),
                            want_params):
        name = jax.tree_util.keystr(path)
        tol = KEY_BIAS_TOL if "['k']['b']" in name else PARAM_TOL
        np.testing.assert_allclose(a, b, **tol, err_msg=name)


@pytest.mark.parametrize("enc", ["lstm", "conformer"])
def test_remat_with_dropout_equals_no_remat(enc):
    """Dropout stays outside the recomputed function, as in JAX: its
    masks are drawn once and the trajectory is the one without remat."""
    fields = ENCODERS[enc]
    params0 = params_to_numpy(tm.init_params(
        port_config.TransducerConfig(**fields), np.random.default_rng(1),
        device="cpu"))
    kw = dict(dropout=0.3, embed_dropout=0.1)
    got, state = _port_run(fields, params0, remat=True, **kw)
    plain, plain_state = _port_run(fields, params0, remat=False, **kw)
    assert got == plain
    leaves = torch.utils._pytree.tree_leaves
    assert all(torch.equal(a, b) for a, b in zip(
        leaves(state.params), leaves(plain_state.params)))


def _count(monkeypatch, mod, name):
    calls = []
    real = getattr(mod, name)

    def counted(*args, **kw):
        calls.append(name)
        return real(*args, **kw)

    monkeypatch.setattr(mod, name, counted)
    return calls


@pytest.mark.parametrize("enc, remat, fwd, bwd", [
    # 3 LSTM layers (BiLSTM: 6 directions) and a 1-layer LSTM predictor
    ("lstm", False, 4, 4), ("lstm", True, 7, 4),
    ("bilstm", False, 7, 7), ("bilstm", True, 13, 7),
    # 2 conformer blocks of 6 LayerNorms each
    ("conformer", False, 12, 12), ("conformer", True, 24, 12),
])
def test_remat_recomputes_each_encoder_layer(monkeypatch, enc, remat, fwd,
                                             bwd):
    """One step's calls of the kernel wrappers that launch K4-fwd (with
    activations) / K4-bwd, or K8-fwd / K8-bwd, on the card: with remat
    every encoder layer's forward runs again in the backward."""
    fields = ENCODERS[enc]
    if enc == "conformer":
        f_calls = _count(monkeypatch, fl, "fln_fwd")
        b_calls = _count(monkeypatch, fl, "fln_bwd")
    else:
        f_calls = _count(monkeypatch, lstm_cuda, "lstm_recurrence_with_acts")
        b_calls = _count(monkeypatch, lstm_cuda, "lstm_recurrence_bwd")
    params0 = params_to_numpy(tm.init_params(
        port_config.TransducerConfig(**fields), np.random.default_rng(2),
        device="cpu"))
    cfg = port_config.TransducerConfig(**fields, remat_encoder=remat)
    params = params_from_numpy(params0)
    leaves, spec = torch.utils._pytree.tree_flatten(params)
    loss, grads = tloop.loss_and_grads(
        leaves, spec, cfg, *(torch.from_numpy(a) for a in
                             _batches(fields, n=1)[0]), loss_impl="xla")
    assert np.isfinite(float(loss))
    assert (len(f_calls), len(b_calls)) == (fwd, bwd)


def test_check_supported_takes_remat():
    for fields in ENCODERS.values():
        tm.check_supported(port_config.TransducerConfig(
            **fields, remat_encoder=True))
