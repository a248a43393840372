"""Gradients of the port's LSTM (`ops/lstm.LSTMCore`, the plain versions
of K4-fwd with activations and K4-bwd on the CPU) against jax.grad of the
JAX package's scan layer and of its Pallas layer in interpret mode, and
through `encode` / `predict`: every encoder and predictor weight gets a
gradient, equal to JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.models import config as jax_config
from rnn_transducer_tpu.models import transducer as jm
from rnn_transducer_tpu.ops.lstm import init_lstm_params
from rnn_transducer_tpu.ops.lstm import lstm_layer as jax_lstm_layer
from rnn_transducer_tpu.ops.lstm_pallas import lstm_layer_pallas
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.models import transducer as tm
from rnn_transducer_tpu_torch.ops import lstm_cuda
from rnn_transducer_tpu_torch.ops.lstm import lstm_layer
from rnn_transducer_tpu_torch.weights import params_from_numpy, params_to_numpy

pytestmark = pytest.mark.quick

TOL = dict(rtol=1e-5, atol=1e-5)  # fp32 both sides; sums in another order


def _case(B, T, I, H, seed, with_state):
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray,
                     init_lstm_params(jax.random.PRNGKey(seed), I, H))
    x = rng.normal(size=(B, T, I)).astype(np.float32)
    h0 = c0 = None
    if with_state:
        h0 = rng.normal(size=(B, H)).astype(np.float32)
        c0 = rng.normal(size=(B, H)).astype(np.float32)
    # cotangents of hs, h_T and c_T
    cot = [rng.normal(size=s).astype(np.float32)
           for s in ((B, T, H), (B, H), (B, H))]
    return p, x, h0, c0, cot


def _jax_grads(layer_fn, p, x, h0, c0, cot, cdtype):
    def loss(p, x, h0, c0):
        hs, (hT, cT) = layer_fn(p, x, h0, c0, compute_dtype=cdtype)
        return (jnp.sum(hs * cot[0]) + jnp.sum(hT * cot[1])
                + jnp.sum(cT * cot[2]))
    j = (lambda a: None if a is None else jnp.asarray(a))
    argnums = (0, 1, 2, 3) if h0 is not None else (0, 1)
    g = jax.grad(loss, argnums=argnums)(jax.tree.map(jnp.asarray, p), j(x),
                                        j(h0), j(c0))
    return jax.tree.map(np.asarray, g)


def _port_grads(p, x, h0, c0, cot, cdtype):
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    th0 = tc0 = None
    if h0 is not None:
        th0 = torch.from_numpy(h0).requires_grad_(True)
        tc0 = torch.from_numpy(c0).requires_grad_(True)
    hs, (hT, cT) = lstm_layer(tp, tx, th0, tc0, compute_dtype=cdtype)
    loss = sum(torch.sum(a * torch.from_numpy(c))
               for a, c in zip((hs, hT, cT), cot))
    loss.backward()
    out = ({k: v.grad.numpy() for k, v in tp.items()}, tx.grad.numpy())
    if h0 is not None:
        out += (th0.grad.numpy(), tc0.grad.numpy())
    return out


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("reference", ["scan", "pallas"])
def test_lstm_grads_match_jax(reference, with_state):
    """B=8, T=11 (not a TPU time-tile multiple), I=16, H=128, f32; the final
    states carry cotangents too (dh_T folded into step T-1, dc_T)."""
    p, x, h0, c0, cot = _case(8, 11, 16, 128, seed=int(with_state),
                              with_state=with_state)
    fn = ((lambda *a, **k: jax_lstm_layer(*a, impl="scan", **k))
          if reference == "scan" else lstm_layer_pallas)
    want = _jax_grads(fn, p, x, h0, c0, cot, jnp.float32)
    got = _port_grads(p, x, h0, c0, cot, torch.float32)
    for k in ("w_ih", "w_hh", "b"):
        np.testing.assert_allclose(got[0][k], want[0][k], err_msg=k, **TOL)
    for i, name in enumerate(("x", "h0", "c0")[:len(got) - 1]):
        np.testing.assert_allclose(got[i + 1], want[i + 1], err_msg=name,
                                   **TOL)


def test_lstm_grads_bf16_bounded():
    """At bf16 both sides round h, the weights and dgates to bf16 for the
    products; the JAX scan's autodiff also rounds the cotangents of its
    bf16 dots, the port keeps them fp32. Bound: relative L2 error 1e-2,
    the order of one bf16 rounding (2^-8 = 3.9e-3) over a few steps."""
    p, x, h0, c0, cot = _case(4, 9, 16, 32, seed=5, with_state=True)
    fn = lambda *a, **k: jax_lstm_layer(*a, impl="scan", **k)  # noqa: E731
    want = _jax_grads(fn, p, x, h0, c0, cot, jnp.bfloat16)
    got = _port_grads(p, x, h0, c0, cot, torch.bfloat16)
    pairs = [(got[0][k], want[0][k]) for k in ("w_ih", "w_hh", "b")]
    pairs += list(zip(got[1:], want[1:]))
    for a, e in pairs:
        rel = np.linalg.norm(a - e) / np.linalg.norm(e)
        assert rel < 1e-2, rel


SMALL = dict(input_dim=8, enc_layers=2, enc_hidden=16, time_reduction=2,
             pred_layers=1, pred_hidden=12, embed_dim=10, joint_dim=14,
             vocab_size=11, compute_dtype="float32")


def test_encode_and_predict_weight_grads_exist_and_match_jax():
    """Through `encode` (ragged lengths, a zero-length row, 2x frame
    stacking) and `predict`: every encoder and predictor LSTM weight and
    the embedding get a gradient (none is cut from the graph), equal to
    jax.grad's."""
    jcfg = jax_config.TransducerConfig(**SMALL)
    tcfg = port_config.TransducerConfig(**SMALL)
    params_np = jax.tree.map(np.asarray,
                             jm.init_params(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(3)
    B, T, U = 4, 14, 5
    feats = rng.normal(size=(B, T, SMALL["input_dim"])).astype(np.float32)
    lens = np.array([T, 9, 0, 3], np.int32)
    labels = rng.integers(1, SMALL["vocab_size"], size=(B, U)).astype(np.int32)
    enc_cot = rng.normal(size=(B, T // 2, SMALL["enc_hidden"])).astype(
        np.float32)
    pred_cot = rng.normal(size=(B, U + 1, SMALL["pred_hidden"])).astype(
        np.float32)

    def jloss(p):
        enc, _ = jm.encode(p, jcfg, jnp.asarray(feats), jnp.asarray(lens))
        pred, _ = jm.predict(p, jcfg, jnp.asarray(labels))
        return jnp.sum(enc * enc_cot) + jnp.sum(pred * pred_cot)

    want = jax.tree.map(np.asarray, jax.grad(jloss)(
        jax.tree.map(jnp.asarray, params_np)))

    params = params_from_numpy(params_np)
    for leaf in torch.utils._pytree.tree_leaves(params):
        leaf.requires_grad_(True)
    enc, _ = tm.encode(params, tcfg, torch.from_numpy(feats),
                       torch.from_numpy(lens))
    pred, _ = tm.predict(params, tcfg, torch.from_numpy(labels))
    (torch.sum(enc * torch.from_numpy(enc_cot))
     + torch.sum(pred * torch.from_numpy(pred_cot))).backward()
    for part in ("encoder", "predictor"):
        for i, layer in enumerate(params[part]):
            for k, leaf in layer.items():
                assert leaf.grad is not None, f"{part}[{i}].{k} has no grad"
                np.testing.assert_allclose(
                    leaf.grad.numpy(), want[part][i][k], rtol=1e-5,
                    atol=1e-5, err_msg=f"{part}[{i}].{k}")
    np.testing.assert_allclose(params["embed"].grad.numpy(), want["embed"],
                               rtol=1e-5, atol=1e-5)


def test_recurrence_refuses_to_cut_the_graph():
    """The wrappers record no graph: handed a tensor that requires grad with
    grad mode on they raise; under no_grad they run."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 16, generator=g, requires_grad=True)
    w = torch.randn(4, 16, generator=g)
    h0, c0 = torch.zeros(2, 4), torch.zeros(2, 4)
    for fn in (lstm_cuda.lstm_recurrence, lstm_cuda.lstm_recurrence_with_acts):
        with pytest.raises(RuntimeError, match="LSTMCore"):
            fn(x, w, h0, c0)
        with torch.no_grad():
            fn(x, w, h0, c0)


def test_with_acts_reference_matches_the_serving_recurrence():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, 32, generator=g)
    w = (torch.randn(8, 32, generator=g) / 3).to(torch.bfloat16)
    h0, c0 = torch.randn(3, 8, generator=g), torch.randn(3, 8, generator=g)
    hs, (hT, cT) = lstm_cuda.lstm_recurrence(x, w, h0, c0)
    hs2, cs, acts = lstm_cuda.lstm_recurrence_with_acts(x, w, h0, c0)
    torch.testing.assert_close(hs2, hs, rtol=0, atol=0)
    torch.testing.assert_close(cs[:, -1], cT, rtol=0, atol=0)
    assert acts.shape == (3, 5, 32)
    i, f, gg, o = acts.chunk(4, dim=-1)
    assert float(i.min()) > 0 and float(i.max()) < 1
    assert float(gg.abs().max()) < 1


def test_bwd_wrapper_on_cpu_is_the_reference_and_counts_nothing():
    g = torch.Generator().manual_seed(2)
    B, T, H = 2, 4, 8
    acts = torch.rand(B, T, 4 * H, generator=g)
    args = (acts, torch.randn(B, T, H, generator=g),
            torch.randn(B, T, H, generator=g), torch.randn(B, H, generator=g),
            torch.randn(H, 4 * H, generator=g))
    before = lstm_cuda.LAUNCHES_BWD
    got = lstm_cuda.lstm_recurrence_bwd(*args)
    want = lstm_cuda.lstm_recurrence_bwd_reference(*args)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=0, atol=0)
    assert lstm_cuda.LAUNCHES_BWD == before
    with pytest.raises(ValueError, match="dhs"):
        lstm_cuda.lstm_recurrence_bwd(acts, args[1], args[2][:, :-1],
                                      args[3], args[4])


def test_params_round_trip_keeps_grad_free_leaves():
    params_np = jax.tree.map(np.asarray, jm.init_params(
        jax.random.PRNGKey(0), jax_config.TransducerConfig(**SMALL)))
    back = params_to_numpy(params_from_numpy(params_np))
    np.testing.assert_array_equal(back["encoder"][1]["w_hh"],
                                  params_np["encoder"][1]["w_hh"])
    assert dataclasses.asdict(port_config.TransducerConfig(**SMALL)) == \
        dataclasses.asdict(jax_config.TransducerConfig(**SMALL))
