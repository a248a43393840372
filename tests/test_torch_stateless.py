"""The port's stateless (bounded-context, k2-style) predictor against the
JAX package's on the CPU.

`predict` over a label batch against JAX's and against a chain of
`predict_step` calls, its context bounded, for pred_context C = 1, 2, 3;
`init_pred_state`'s (B, C - 1) int32 buffer; `DecodeWeights.predict_step`
against JAX's `predict_step`; greedy, beam, streaming and streaming-beam
tokens equal to JAX's at f32 (greedy at bf16 too, and under int8
params); a 2-step trajectory on the xla and fused routes; the serving
engines on a stateless model against a direct decode; and the refusals:
the fused greedy kernel (K9 steps w_ih / w_hh) and the torch-layout state
dict, which tools/export_torch_ckpt.py writes for LSTM predictors only.

The random model is made to emit by standardizing the joint's encoder
side over the test batch's frames and shrinking the embeddings: its
greedy decode emits label runs whose pattern follows the context window
(e.g. 10, 1, 1, 10, 1, 1 at C = 2).
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
from rnn_transducer_tpu.ops import quant as jq
from rnn_transducer_tpu.train import loop as jloop
from rnn_transducer_tpu_torch.data.synthetic import random_batch
from rnn_transducer_tpu_torch.decode import beam as tbeam
from rnn_transducer_tpu_torch.decode import greedy as tgreedy
from rnn_transducer_tpu_torch.decode import greedy_fused as gf
from rnn_transducer_tpu_torch.decode import streaming as tstream
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.models import transducer as tm
from rnn_transducer_tpu_torch.ops import quant as tq
from rnn_transducer_tpu_torch.serve import BatchingEngine, StreamingEngine
from rnn_transducer_tpu_torch.train import loop as tloop
from rnn_transducer_tpu_torch.weights import (load_state_dict,
                                              params_from_numpy,
                                              params_to_numpy)
from test_torch_beam import assert_same_beams

pytestmark = pytest.mark.quick

SMALL = dict(input_dim=8, enc_layers=2, enc_hidden=16, time_reduction=2,
             pred_layers=1, pred_hidden=12, embed_dim=10, joint_dim=14,
             vocab_size=11, compute_dtype="float32", pred_type="stateless")
CONTEXTS = [1, 2, 3]
MAX_SYMBOLS = 30


def _cfgs(C=2, **kw):
    f = dict(SMALL, pred_context=C, **kw)
    return jax_config.TransducerConfig(**f), port_config.TransducerConfig(**f)


def _batch(seed=1, B=5, T=40):
    rng = np.random.default_rng(seed)
    feats = (3 * rng.normal(size=(B, T, SMALL["input_dim"]))).astype(
        np.float32)
    return feats, np.array([40, 33, 21, 0, 7], np.int32)[:B]


def stateless_params(C=2, seed=8, blank_offset=0.6):
    """JAX init params of context C made to emit (module docstring)."""
    jcfg, _ = _cfgs(C)
    p = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed),
                                                jcfg))
    p["embed"] = p["embed"] * 0.3
    feats, lens = _batch()
    enc, el = jm.encode(jax.tree.map(jnp.asarray, p), jcfg,
                        jnp.asarray(feats), jnp.asarray(lens))
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


def _j(x):
    return jnp.asarray(np.asarray(x))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _labels(seed=0, B=3, U=8):
    rng = np.random.default_rng(seed)
    return rng.integers(1, SMALL["vocab_size"], size=(B, U)).astype(np.int32)


# ------------------------------- the predictor -------------------------------

@pytest.mark.parametrize("C", CONTEXTS)
def test_predict_matches_jax(C):
    jcfg, tcfg = _cfgs(C)
    p = stateless_params(C)
    labels = _labels()
    want, want_ids = jm.predict(jax.tree.map(jnp.asarray, p), jcfg,
                                _j(labels))
    got, ids = tm.predict(params_from_numpy(p), tcfg, _t(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert ids.dtype == torch.int32 and ids.shape == (3, C - 1)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))


@pytest.mark.parametrize("C", CONTEXTS)
def test_predict_equals_a_chain_of_steps(C):
    _, tcfg = _cfgs(C)
    params = params_from_numpy(stateless_params(C))
    labels = _t(_labels(1))
    out, final = tm.predict(params, tcfg, labels)
    state = tm.init_pred_state(tcfg, 3, device="cpu")
    inp = torch.cat([torch.zeros((3, 1), dtype=labels.dtype), labels], 1)
    steps = []
    for u in range(inp.shape[1]):
        o, state = tm.predict_step(params, tcfg, inp[:, u], state)
        steps.append(o)
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), out.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(state, final)


@pytest.mark.parametrize("C", CONTEXTS)
def test_context_is_bounded(C):
    """Changing labels[k] changes the outputs at k+1 .. k+C alone."""
    _, tcfg = _cfgs(C)
    params = params_from_numpy(stateless_params(C))
    labels = _labels(2, B=2)
    base, _ = tm.predict(params, tcfg, _t(labels))
    k = 3
    pert = labels.copy()
    pert[:, k] = pert[:, k] % (SMALL["vocab_size"] - 1) + 1
    out, _ = tm.predict(params, tcfg, _t(pert))
    diff = (out - base).abs().amax(dim=-1)  # (B, U+1)
    for u in range(labels.shape[1] + 1):
        changed = bool((diff[:, u] > 1e-6).all())
        assert changed == (k + 1 <= u < k + 1 + C), u
        if not changed:
            assert float(diff[:, u].max()) == 0.0


@pytest.mark.parametrize("C", CONTEXTS)
def test_init_pred_state_and_step_match_jax(C):
    jcfg, tcfg = _cfgs(C)
    p = stateless_params(C)
    want = jm.init_pred_state(jcfg, 4)
    got = tm.init_pred_state(tcfg, 4, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (4, C - 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(3)
    state = rng.integers(0, SMALL["vocab_size"], size=(4, C - 1)).astype(
        np.int32)
    label = rng.integers(0, SMALL["vocab_size"], size=(4,)).astype(np.int32)
    w_out, w_state = jm.predict_step(jax.tree.map(jnp.asarray, p), jcfg,
                                     _j(label), _j(state))
    dw = tm.DecodeWeights(params_from_numpy(p), tcfg)
    out, new = dw.predict_step(_t(label).long(), _t(state))
    np.testing.assert_allclose(out.numpy(), np.asarray(w_out), rtol=1e-6,
                               atol=1e-6)
    assert new.dtype == torch.int32
    np.testing.assert_array_equal(new.numpy(), np.asarray(w_state))


def test_init_params_and_round_trip_have_the_jax_tree():
    jcfg, tcfg = _cfgs(3, ctc_head=True)
    want = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    got = params_to_numpy(tm.init_params(tcfg, np.random.default_rng(0),
                                         device="cpu"))
    assert jax.tree.map(np.shape, got) == jax.tree.map(np.shape, want)
    assert set(got["predictor"][0]) == {"w", "b"}
    back = params_to_numpy(params_from_numpy(want))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


# --------------------------------- decoding ----------------------------------

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


@pytest.mark.parametrize("C", CONTEXTS)
def test_greedy_matches_jax(C):
    jcfg, tcfg = _cfgs(C)
    got, want = _greedy(stateless_params(C), jcfg, tcfg, *_batch())
    _assert_same_greedy(got, want)
    assert got[1].sum() >= 30  # it emits


def test_bf16_greedy_matches_jax():
    jcfg, tcfg = _cfgs(2, compute_dtype="bfloat16")
    got, want = _greedy(stateless_params(2), jcfg, tcfg, *_batch())
    _assert_same_greedy(got, want, conf_atol=1e-4)
    assert got[1].sum() >= 30


def test_int8_greedy_matches_jax():
    jcfg, tcfg = _cfgs(2)
    q = jax.tree.map(np.asarray, jq.quantize_params(
        jax.tree.map(jnp.asarray, stateless_params(2))))
    assert isinstance(q["predictor"][0]["w"], tuple)  # quantized
    tq_params = tq.quantize_params(params_from_numpy(stateless_params(2)))
    for a, b in zip(jax.tree.leaves(params_to_numpy(tq_params)),
                    jax.tree.leaves(q)):
        np.testing.assert_array_equal(a, b)
    got, want = _greedy(q, jcfg, tcfg, *_batch())
    _assert_same_greedy(got, want)


@pytest.mark.parametrize("C", CONTEXTS)
def test_beam_matches_jax(C):
    jcfg, tcfg = _cfgs(C)
    p = stateless_params(C)
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


@pytest.mark.parametrize("C", CONTEXTS)
def test_streaming_matches_jax_and_offline(C):
    jcfg, tcfg = _cfgs(C)
    p = stateless_params(C)
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
    jcfg, tcfg = _cfgs(2)
    p = stateless_params(2)
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
    for b, k in zip(*np.nonzero(live)):
        n = want[1][b, k]
        np.testing.assert_array_equal(got[0][b, k, :n], want[0][b, k, :n])


# --------------------------------- training ----------------------------------

@pytest.mark.parametrize("loss_impl", ["xla", "fused"])
def test_trajectory_matches_jax(loss_impl):
    """Two steps at C = 3 (the port's fused route, plain K1 / K2 on the CPU,
    against JAX's xla): losses and params."""
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    f = dict(SMALL, pred_context=3, vocab_size=21)
    jcfg = jax_config.TransducerConfig(**f)
    jt = jax_config.TrainConfig(**kw, loss_impl="xla")
    jstate = jloop.init_train_state(jax.random.PRNGKey(4), jcfg, jt)
    params0 = jax.tree.map(np.asarray, jstate.params)
    jstep = jloop.make_train_step(jcfg, jt)
    cfg = port_config.TransducerConfig(**f)
    tcfg = port_config.TrainConfig(**kw, loss_impl=loss_impl)
    state = tloop.init_train_state(None, cfg, tcfg,
                                   params=params_from_numpy(params0))
    step = tloop.make_train_step(cfg, tcfg, device="cpu")
    rng = np.random.default_rng(0)
    want, got = [], []
    for _ in range(2):
        batch = random_batch(rng, 3, 12, 4, f["input_dim"], f["vocab_size"])
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


# ---------------------------------- serving ----------------------------------

@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_engines_match_a_direct_decode(mode):
    """BatchingEngine and StreamingEngine on a stateless model, float and
    int8, give each utterance the direct decode's tokens."""
    _, tcfg = _cfgs(2)
    feats, lens = _batch()
    kw = dict(beam=4, expansions=2) if mode == "beam" else {}
    for quant in (False, True):
        params = params_from_numpy(stateless_params(2))
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
        assert sum(map(len, want)) >= 3


# --------------------------------- refusals ----------------------------------

def test_fused_greedy_refuses_a_stateless_predictor():
    """K9 steps an LSTM cell (w_ih, w_hh): its predicate asks pred_type,
    which JAX's (greedy_pallas.py:33-37) does not."""
    _, tcfg = _cfgs(2, embed_dim=128, pred_hidden=128, joint_dim=128)
    assert not gf.supported(tcfg)
    assert gf.supported(dataclasses.replace(tcfg, pred_type="lstm"))
    with pytest.raises(ValueError, match="LSTM predictor"):
        gf.recognize_greedy_fused({}, tcfg, torch.zeros(1, 4, 8),
                                  torch.ones(1))


def test_load_state_dict_refuses_a_stateless_predictor(tmp_path):
    _, tcfg = _cfgs(2)
    path = tmp_path / "model.pt"
    torch.save({}, path)
    with pytest.raises(NotImplementedError,
                       match=r"export_torch_ckpt.py:57-59"):
        load_state_dict(str(path), tcfg, device="cpu")
