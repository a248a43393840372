"""The port's MoE joint (`ops/moe.py` and its hooks in the model, the loss,
the decoders and serving) against the JAX package's on the CPU.

`moe_dense`, `moe_top1` and `router_top1` on the same params (through
`params_from_numpy`) within tests/test_moe.py's bounds (1e-4, 1e-5, 1e-6),
capacity drops at small capacity factors, gradients against `jax.grad`;
the model's `joint(with_aux=True)` and `joint_step` (the dense residual);
`loss_fn` on every route an MoE model resolves to (xla, the two-pass
pallas in its plain version, auto, fused, pruned: all the materialised
routed logits) with its gradients, and one `make_train_step` trajectory;
greedy, beam and streaming tokens equal to JAX's on an MoE model made to
emit; int8 params (the router and the 2-D biases quantized bit for bit,
w1 / w2 kept float); the engines against a direct decode; and the
refusals: K9 (its joint has no experts), the AR band, the duration
families, ctc_weight, distillation and the torch-layout state dict.
Everything runs at f32: JAX's CPU backend has no bf16 x bf16 -> f32
einsum for the expert products.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.decode import beam as jbeam
from rnn_transducer_tpu.decode import greedy as jgreedy
from rnn_transducer_tpu.decode import streaming as jstream
from rnn_transducer_tpu.models import config as jax_config
from rnn_transducer_tpu.models import transducer as jm
from rnn_transducer_tpu.ops import moe as jmoe
from rnn_transducer_tpu.ops import quant as jq
from rnn_transducer_tpu.train import loop as jloop
from rnn_transducer_tpu_torch.data.synthetic import random_batch
from rnn_transducer_tpu_torch.decode import beam as tbeam
from rnn_transducer_tpu_torch.decode import greedy as tgreedy
from rnn_transducer_tpu_torch.decode import greedy_fused as gf
from rnn_transducer_tpu_torch.decode import streaming as tstream
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.models import transducer as tm
from rnn_transducer_tpu_torch.ops import moe as tmoe
from rnn_transducer_tpu_torch.ops import quant as tq
from rnn_transducer_tpu_torch.serve import BatchingEngine, StreamingEngine
from rnn_transducer_tpu_torch.train import loop as tloop
from rnn_transducer_tpu_torch.weights import (load_state_dict,
                                              params_from_numpy,
                                              params_to_numpy)
from test_torch_beam import assert_same_beams

pytestmark = pytest.mark.quick

E, D, H = 4, 16, 32
SMALL = dict(input_dim=8, enc_layers=2, enc_hidden=16, time_reduction=2,
             pred_layers=1, pred_hidden=12, embed_dim=10, joint_dim=14,
             vocab_size=11, compute_dtype="float32", joint_experts=4,
             joint_expert_hidden=20)
MAX_SYMBOLS = 30


def _j(x):
    return jnp.asarray(np.asarray(x))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _moe_params(seed=0):
    return jax.tree.map(np.asarray, jmoe.init_moe_params(
        jax.random.PRNGKey(seed), E, D, H))


def _tokens(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def _cfgs(**kw):
    f = dict(SMALL, **kw)
    return jax_config.TransducerConfig(**f), port_config.TransducerConfig(**f)


# ------------------------------ ops/moe.py -----------------------------------

def test_init_moe_params_has_the_jax_shapes_and_ranges():
    got = tmoe.init_moe_params(np.random.default_rng(0), E, D, H)
    want = _moe_params()
    assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, want)
    assert np.abs(got["router"]).max() <= 1 / np.sqrt(D)
    assert np.abs(got["w2"]).max() <= 1 / np.sqrt(H)
    assert not got["b1"].any() and not got["b2"].any()
    assert all(v.dtype == np.float32 for v in got.values())


def test_router_top1_matches_jax():
    p, x = _moe_params(1), _tokens(48, 1)
    wg, wi, wa = jmoe.router_top1(jax.tree.map(jnp.asarray, p), _j(x))
    gg, gi, ga = tmoe.router_top1(params_from_numpy(p), _t(x))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gg.numpy(), np.asarray(wg), atol=1e-6)
    np.testing.assert_allclose(float(ga), float(wa), atol=1e-6)


def test_router_takes_the_first_of_equal_maxima():
    """A zero router gives equal probabilities: argmax picks expert 0, as
    jnp.argmax does."""
    p = params_from_numpy(_moe_params())
    p["router"] = torch.zeros_like(p["router"])
    gate, idx, aux = tmoe.router_top1(p, _t(_tokens(5)))
    assert idx.tolist() == [0] * 5
    np.testing.assert_allclose(gate.numpy(), 1.0 / E)
    np.testing.assert_allclose(float(aux), 1.0, atol=1e-6)


def test_dense_matches_jax():
    p, x = _moe_params(2), _tokens(24, 2)
    wy, wa = jmoe.moe_dense(jax.tree.map(jnp.asarray, p), _j(x),
                            compute_dtype=jnp.float32)
    gy, ga = tmoe.moe_dense(params_from_numpy(p), _t(x),
                            compute_dtype=torch.float32)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=1e-4)
    np.testing.assert_allclose(float(ga), float(wa), atol=1e-6)
    assert float(ga) >= 1.0 - 1e-6  # the Switch aux's lower bound


@pytest.mark.parametrize("cf", [0.25, 0.5, 1.0, float(E)])
def test_top1_matches_jax(cf):
    """Through the capacity buffer, dropped tokens (cf < E) included."""
    p, x = _moe_params(3), _tokens(64, 3)
    wy, wa = jmoe.moe_top1(jax.tree.map(jnp.asarray, p), _j(x),
                           capacity_factor=cf, compute_dtype=jnp.float32)
    gy, ga = tmoe.moe_top1(params_from_numpy(p), _t(x), capacity_factor=cf,
                           compute_dtype=torch.float32)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), atol=1e-5)
    np.testing.assert_allclose(float(ga), float(wa), atol=1e-6)
    dropped = int((np.abs(np.asarray(wy)).sum(1) == 0).sum())
    assert int((gy.abs().sum(1) == 0).sum()) == dropped
    assert (dropped > 0) == (cf < E)


def test_top1_with_ample_capacity_equals_dense():
    p, x = params_from_numpy(_moe_params(4)), _t(_tokens(40, 4))
    yd, ad = tmoe.moe_dense(p, x, compute_dtype=torch.float32)
    yr, ar = tmoe.moe_top1(p, x, capacity_factor=float(E),
                           compute_dtype=torch.float32)
    np.testing.assert_allclose(yr.numpy(), yd.numpy(), atol=1e-5)
    assert float(ar) == float(ad)


def test_capacity_keeps_the_first_tokens_of_each_expert():
    """C = ceil(N cf / E) slots an expert; a token past its expert's C-th
    in the flattened order contributes 0, the earlier ones do not."""
    p, x = params_from_numpy(_moe_params(5)), _t(_tokens(64, 5))
    cf = 0.5
    C = tmoe.capacity(64, E, cf)
    assert C == 8
    _, idx, _ = tmoe.router_top1(p, x)
    y, _ = tmoe.moe_top1(p, x, capacity_factor=cf,
                         compute_dtype=torch.float32)
    for e in range(E):
        rows = torch.nonzero(idx == e)[:, 0]
        kept = y[rows].abs().sum(1) > 0
        assert kept.tolist() == [i < C for i in range(len(rows))]


@pytest.mark.parametrize("cf", [0.5, float(E)])
def test_top1_gradients_match_jax(cf):
    p, x = _moe_params(6), _tokens(32, 6)
    rng = np.random.default_rng(7)
    w = rng.normal(size=(32, D)).astype(np.float32)

    def jloss(q, xx):
        y, aux = jmoe.moe_top1(q, xx, capacity_factor=cf,
                               compute_dtype=jnp.float32)
        return jnp.sum(y * _j(w)) + 0.3 * aux

    wg_p, wg_x = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), _j(x))
    tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(p).items()}
    tx = _t(x).requires_grad_(True)
    y, aux = tmoe.moe_top1(tp, tx, capacity_factor=cf,
                           compute_dtype=torch.float32)
    (torch.sum(y * _t(w)) + 0.3 * aux).backward()
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(wg_p[k]),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(wg_x), atol=1e-5)


def test_top1_ep_with_one_shard_and_local_stats_is_top1():
    p, x = params_from_numpy(_moe_params(8)), _t(_tokens(30, 8))
    want = tmoe.moe_top1(p, x, capacity_factor=1.0,
                         compute_dtype=torch.float32)
    got = tmoe.moe_top1_ep(p, x, exchange=lambda t: t, n_shards=1,
                           capacity_factor=1.0, compute_dtype=torch.float32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ------------------------------- the model -----------------------------------

def moe_params(seed=8, blank_offset=0.6, **kw):
    """JAX init params of the MoE model made to emit: the joint's encoder
    side standardized over the test batch's frames, a blank offset."""
    jcfg, _ = _cfgs(**kw)
    p = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed),
                                                jcfg))
    feats, lens = _batch()
    enc, el = jm.encode(jax.tree.map(jnp.asarray, p), jcfg, _j(feats),
                        _j(lens))
    enc = np.concatenate([np.asarray(enc)[b, :int(el[b])]
                          for b in range(len(lens))])
    jp = p["joint"]
    z = enc @ jp["enc_proj"]["w"]
    s = np.float32(1.0 / z.std(0).mean())
    jp["enc_proj"]["w"] = jp["enc_proj"]["w"] * s
    jp["enc_proj"]["b"] = jp["enc_proj"]["b"] - s * z.mean(0)
    jp["out"]["b"] = jp["out"]["b"].copy()
    jp["out"]["b"][jcfg.blank] += blank_offset
    return p


def _batch(seed=1, B=5, T=40):
    rng = np.random.default_rng(seed)
    feats = (3 * rng.normal(size=(B, T, SMALL["input_dim"]))).astype(
        np.float32)
    return feats, np.array([40, 33, 21, 0, 7], np.int32)[:B]


def test_init_params_has_the_jax_tree():
    jcfg, tcfg = _cfgs(ctc_head=True)
    want = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    got = params_to_numpy(tm.init_params(tcfg, np.random.default_rng(0),
                                         device="cpu"))
    assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, want)
    assert got["moe"]["w1"].shape == (4, 14, 20)


def _enc_pred(seed=2, B=3, T=6, U1=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, SMALL["enc_hidden"])).astype(np.float32),
            rng.normal(size=(B, U1, SMALL["pred_hidden"])).astype(np.float32))


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_joint_with_aux_matches_jax(cf):
    jcfg, tcfg = _cfgs(moe_capacity_factor=cf)
    p = moe_params()
    enc, pred = _enc_pred()
    wl, wa = jm.joint(jax.tree.map(jnp.asarray, p), jcfg, _j(enc), _j(pred),
                      with_aux=True)
    gl, ga = tm.joint(params_from_numpy(p), tcfg, _t(enc), _t(pred),
                      with_aux=True)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=1e-5)
    np.testing.assert_allclose(float(ga), float(wa), atol=1e-6)
    plain = tm.joint(params_from_numpy(p), tcfg, _t(enc), _t(pred))
    assert torch.equal(plain, gl)


def test_joint_step_is_the_dense_residual_as_jax():
    jcfg, tcfg = _cfgs()
    p = moe_params()
    enc, pred = _enc_pred(3, B=5, T=1, U1=1)
    want = jm.joint_step(jax.tree.map(jnp.asarray, p), jcfg, _j(enc[:, 0]),
                         _j(pred[:, 0]))
    got = tm.joint_step(params_from_numpy(p), tcfg, _t(enc[:, 0]),
                        _t(pred[:, 0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the experts take part: without them the logits move
    no_moe = dataclasses.replace(tcfg, joint_experts=0)
    bare = tm.joint_step(params_from_numpy(p), no_moe, _t(enc[:, 0]),
                         _t(pred[:, 0]))
    assert float((bare - got).abs().max()) > 1e-3


def test_int8_joint_step_matches_jax():
    """quantize_params takes every 2-D float leaf: the router, b1 and b2
    go int8 bit for bit with JAX's; the 3-D w1 and w2 stay float."""
    jcfg, tcfg = _cfgs()
    p = moe_params()
    q = jax.tree.map(np.asarray, jq.quantize_params(
        jax.tree.map(jnp.asarray, p)))
    tq_params = tq.quantize_params(params_from_numpy(p))
    for k in ("router", "b1", "b2"):
        assert isinstance(tq_params["moe"][k], tq.QTensor), k
    for k in ("w1", "w2"):
        assert isinstance(tq_params["moe"][k], torch.Tensor), k
    for a, b in zip(jax.tree.leaves(params_to_numpy(tq_params)),
                    jax.tree.leaves(q)):
        np.testing.assert_array_equal(a, b)
    enc, pred = _enc_pred(4, B=5, T=1, U1=1)
    want = jm.joint_step(jax.tree.map(jnp.asarray, q), jcfg, _j(enc[:, 0]),
                         _j(pred[:, 0]))
    got = tm.joint_step(tq_params, tcfg, _t(enc[:, 0]), _t(pred[:, 0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ------------------------------- the loss ------------------------------------

def _jax_loss_and_grads(p, jcfg, batch, **kw):
    (wl, wpu), wg = jax.value_and_grad(
        lambda q: jloop.loss_fn(q, jcfg, *(_j(a) for a in batch), **kw),
        has_aux=True)(jax.tree.map(jnp.asarray, p))
    return float(wl), np.asarray(wpu), jax.tree.map(np.asarray, wg)


@pytest.mark.parametrize("loss_impl", ["xla", "pallas", "auto", "fused",
                                       "pruned"])
def test_loss_fn_matches_jax_on_every_route(loss_impl):
    """Every route of an MoE model materialises the routed logits: pallas
    (the two-pass loss, plain K5 on the CPU) and xla (and auto, fused,
    pruned, which resolve to it) against JAX's xla, with the aux term."""
    jcfg, tcfg = _cfgs(moe_capacity_factor=1.0, vocab_size=21)
    p = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(1), jcfg))
    batch = random_batch(np.random.default_rng(2), 4, 12, 4, 8, 21)
    wl, wpu, wg = _jax_loss_and_grads(p, jcfg, batch, loss_impl="xla",
                                      fastemit=0.01)
    params = params_from_numpy(p)
    leaves, spec = torch.utils._pytree.tree_flatten(params)
    xs = [x.detach().requires_grad_(True) for x in leaves]
    loss, per_utt = tloop.loss_fn(
        torch.utils._pytree.tree_unflatten(xs, spec), tcfg,
        *(_t(a) for a in batch), loss_impl=loss_impl, fastemit=0.01)
    grads = torch.autograd.grad(loss, xs)
    np.testing.assert_allclose(float(loss.detach()), wl, rtol=1e-6)
    np.testing.assert_allclose(per_utt.detach().numpy(), wpu, rtol=1e-5)
    aux_part = wl - float(np.mean(wpu))
    assert aux_part > 0.0099  # moe_aux_weight * aux, aux >= 1
    got = params_to_numpy(torch.utils._pytree.tree_unflatten(list(grads),
                                                             spec))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(wg)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                   err_msg=str(path))


def test_moe_route_names_the_materialised_routes():
    assert tloop.moe_route("pallas") == "pallas"
    for impl in ("auto", "fused", "pruned", "xla"):
        assert tloop.moe_route(impl) == "xla"


def test_train_step_trajectory_matches_jax():
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    jcfg, cfg = _cfgs(vocab_size=21)
    jt = jax_config.TrainConfig(**kw, loss_impl="xla")
    jstate = jloop.init_train_state(jax.random.PRNGKey(4), jcfg, jt)
    params0 = jax.tree.map(np.asarray, jstate.params)
    jstep = jloop.make_train_step(jcfg, jt)
    tcfg = port_config.TrainConfig(**kw, loss_impl="auto")
    state = tloop.init_train_state(None, cfg, tcfg,
                                   params=params_from_numpy(params0))
    step = tloop.make_train_step(cfg, tcfg, device="cpu")
    rng = np.random.default_rng(0)
    want, got = [], []
    for _ in range(2):
        batch = random_batch(rng, 3, 12, 4, 8, 21)
        jstate, info = jstep(jstate, *(_j(a) for a in batch))
        want.append(float(info["loss"]))
        state, info = step(state, *(_t(a) for a in batch))
        assert int(info["skipped_nonfinite"]) == 0
        got.append(float(info["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for (path, a), e in zip(
            jax.tree_util.tree_leaves_with_path(params_to_numpy(state.params)),
            jax.tree.leaves(jax.tree.map(np.asarray, jstate.params))):
        np.testing.assert_allclose(a, e, rtol=0, atol=2e-6,
                                   err_msg=str(path))


# ------------------------------- decoding ------------------------------------

def _greedy(p, jcfg, tcfg, feats, lens):
    want = [np.asarray(a) for a in jgreedy.recognize_greedy(
        jax.tree.map(jnp.asarray, p), jcfg, _j(feats), _j(lens),
        max_symbols=MAX_SYMBOLS, with_confidence=True, with_timestamps=True)]
    got = [a.numpy() for a in tgreedy.recognize_greedy(
        params_from_numpy(p), tcfg, _t(feats), _t(lens),
        max_symbols=MAX_SYMBOLS, with_confidence=True, with_timestamps=True)]
    return got, want


def _assert_same_greedy(got, want, conf_atol=1e-5):
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[2], want[2], atol=conf_atol, rtol=0)


def test_greedy_matches_jax():
    jcfg, tcfg = _cfgs()
    got, want = _greedy(moe_params(), jcfg, tcfg, *_batch())
    _assert_same_greedy(got, want)
    assert got[1].sum() >= 20  # it emits


def test_int8_greedy_matches_jax():
    jcfg, tcfg = _cfgs()
    q = jax.tree.map(np.asarray, jq.quantize_params(
        jax.tree.map(jnp.asarray, moe_params())))
    got, want = _greedy(q, jcfg, tcfg, *_batch())
    _assert_same_greedy(got, want)


def test_beam_matches_jax():
    jcfg, tcfg = _cfgs()
    p = moe_params()
    feats, lens = _batch()
    kw = dict(beam=4, max_symbols=MAX_SYMBOLS, expansions=2)
    want = [np.asarray(a) for a in jbeam.recognize_beam(
        jax.tree.map(jnp.asarray, p), jcfg, _j(feats), _j(lens),
        with_confidence=True, with_timestamps=True, **kw)]
    got = [a.numpy() for a in tbeam.recognize_beam(
        params_from_numpy(p), tcfg, _t(feats), _t(lens),
        with_confidence=True, with_timestamps=True, **kw)]
    live = assert_same_beams(got, want)
    assert live.sum() > len(lens) and got[1][live].max() >= 1


def test_streaming_matches_jax_and_offline():
    jcfg, tcfg = _cfgs()
    p = moe_params()
    feats, lens = _batch()
    want = [np.asarray(a) for a in jstream.stream_transcribe(
        jax.tree.map(jnp.asarray, p), jcfg, _j(feats), _j(lens), 8,
        max_symbols=MAX_SYMBOLS, with_timestamps=True)]
    got = [a.numpy() for a in tstream.stream_transcribe(
        params_from_numpy(p), tcfg, _t(feats), _t(lens), 8,
        max_symbols=MAX_SYMBOLS, with_timestamps=True, device="cpu")]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    offline, _ = _greedy(p, jcfg, tcfg, feats, lens)
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[min(i, 2)], offline[i])


def test_streaming_beam_matches_jax():
    jcfg, tcfg = _cfgs()
    p = moe_params()
    feats, lens = _batch()
    kw = dict(beam=4, max_symbols=MAX_SYMBOLS, expansions=2)
    want = [np.asarray(a) for a in jstream.stream_transcribe_beam(
        jax.tree.map(jnp.asarray, p), jcfg, _j(feats), _j(lens), 8, **kw)]
    got = [a.numpy() for a in tstream.stream_transcribe_beam(
        params_from_numpy(p), tcfg, _t(feats), _t(lens), 8, device="cpu",
        **kw)]
    live = want[2] > -5e29
    np.testing.assert_array_equal(got[2] > -5e29, live)
    np.testing.assert_array_equal(got[1][live], want[1][live])
    np.testing.assert_allclose(got[2][live], want[2][live], atol=1e-4)


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_engines_match_a_direct_decode(mode):
    """BatchingEngine and StreamingEngine on an MoE model, float and int8,
    give each utterance the direct decode's tokens."""
    _, tcfg = _cfgs()
    feats, lens = _batch()
    kw = dict(beam=4, expansions=2) if mode == "beam" else {}
    for quant in (False, True):
        params = params_from_numpy(moe_params())
        if quant:
            params = tq.quantize_params(params)
        if mode == "greedy":
            tok, n = tgreedy.recognize_greedy(params, tcfg, _t(feats),
                                              _t(lens), MAX_SYMBOLS)
        else:
            tok, n, _ = tbeam.recognize_beam(params, tcfg, _t(feats),
                                             _t(lens), beam=4,
                                             max_symbols=MAX_SYMBOLS,
                                             expansions=2)
            tok, n = tok[:, 0], n[:, 0]
        want = [tok[b, :n[b]].tolist() for b in range(len(lens)) if lens[b]]
        eng = BatchingEngine(params, tcfg, mode=mode, max_symbols=MAX_SYMBOLS,
                             frame_buckets=(40,), max_batch=8, device="cpu",
                             **kw)
        st = StreamingEngine(params, tcfg, mode=mode, slots=4,
                             chunk_frames=8, max_symbols=MAX_SYMBOLS,
                             device="cpu", **kw)
        try:
            got = [eng.submit(feats[b, :lens[b]]) for b in range(len(lens))
                   if lens[b]]
            streamed = []
            for b in range(len(lens)):
                if not lens[b]:
                    continue
                sid = st.open_session()
                for t0 in range(0, int(lens[b]), 8):
                    st.feed(sid, feats[b, t0:min(t0 + 8, int(lens[b]))])
                streamed.append(st.close_session(sid))
        finally:
            eng.close()
            st.close()
        assert got == want, quant
        assert streamed == want, quant
        # the beam's top hypotheses emit less than greedy on this model
        assert sum(map(len, want)) >= (20 if mode == "greedy" else 2)


# ------------------------------- refusals ------------------------------------

def test_fused_greedy_refuses_an_moe_joint():
    """K9's joint has no experts: its predicate refuses an MoE model,
    which the lock-step decoder serves (JAX's predicate does not ask)."""
    _, tcfg = _cfgs(embed_dim=128, pred_hidden=128, joint_dim=128)
    assert not gf.supported(tcfg)
    assert gf.supported(dataclasses.replace(tcfg, joint_experts=0))
    with pytest.raises(ValueError, match="no MoE joint"):
        gf.recognize_greedy_fused({}, tcfg, torch.zeros(1, 4, 8),
                                  torch.ones(1))


def test_refusals_with_an_moe_joint():
    _, tcfg = _cfgs(vocab_size=21)
    params = tm.init_params(tcfg, np.random.default_rng(0), device="cpu")
    batch = tuple(_t(a) for a in random_batch(np.random.default_rng(1), 2,
                                              12, 4, 8, 21))
    with pytest.raises(ValueError, match="alignment-restricted"):
        tloop.loss_fn(params, tcfg, *batch, loss_impl="ar", ar_range=3)
    with pytest.raises(ValueError, match="alignment-restricted"):
        tloop.make_train_step(tcfg, port_config.TrainConfig(ar_range=3),
                              device="cpu")
    with pytest.raises(ValueError, match="ctc_weight with an MoE joint"):
        tloop.loss_fn(params, dataclasses.replace(tcfg, ctc_head=True),
                      *batch, ctc_weight=0.3)
    mb = dataclasses.replace(tcfg, big_blank_durations=(2,))
    with pytest.raises(ValueError, match="duration families"):
        tloop.make_train_step(mb, port_config.TrainConfig(), device="cpu")
    with pytest.raises(ValueError, match="TDT with an MoE joint"):
        tm.init_params(dataclasses.replace(tcfg, tdt_durations=(0, 1)),
                       np.random.default_rng(0), device="cpu")
    with pytest.raises(ValueError, match="MoE student"):
        tloop.make_train_step(
            tcfg, port_config.TrainConfig(distill_weight=0.3),
            teacher_cfg=tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 18"):
        load_state_dict("unused.pt", tcfg, device="cpu")
