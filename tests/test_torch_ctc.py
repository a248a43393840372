"""The port's CTC (`ops/ctc_loss.py`, `decode/ctc.py`, the multitask term
and the pretraining step of train/loop.py, the CLIs' CTC flags) against
the JAX package's on the CPU.

The loss and its analytic dlogits within 1e-5 (ragged lengths, a
zero-length label, a dead lattice, repeated labels); greedy collapse
equal, the max_symbols cut included; the prefix beam's n-best equal and
its scores within 1e-5 for K 1/4/8 and C = V-1 and 8, plain and with an
LSTM LM, a transformer LM, an n-gram and a length bonus; `loss_fn` with
ctc_weight on every route against JAX's and against its own parts; 2-step
trajectories of loss_kind="ctc" and of ctc_weight; the training CLI's
phases and an exact resume across the CTC / RNN-T boundary; the decode
CLI's ctc_greedy and ctc_beam against the JAX decoders.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.decode import ctc as jctc
from rnn_transducer_tpu.models import config as jax_config
from rnn_transducer_tpu.models import lm as jlm
from rnn_transducer_tpu.models import lm_transformer as jlt
from rnn_transducer_tpu.models import ngram as jng
from rnn_transducer_tpu.models import transducer as jm
from rnn_transducer_tpu.ops import ctc_loss as jloss
from rnn_transducer_tpu.train import loop as jloop
from rnn_transducer_tpu_torch import recognize as rec
from rnn_transducer_tpu_torch.data.synthetic import random_batch
from rnn_transducer_tpu_torch.decode import ctc as tctc
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.models import lm as tlm
from rnn_transducer_tpu_torch.models import lm_transformer as tlt
from rnn_transducer_tpu_torch.models import ngram as tng
from rnn_transducer_tpu_torch.models import transducer as tm
from rnn_transducer_tpu_torch.ops import ctc_loss as tloss
from rnn_transducer_tpu_torch.train import checkpoint as ckpt
from rnn_transducer_tpu_torch.train import loop as tloop
from rnn_transducer_tpu_torch.train.__main__ import main as train_main
from rnn_transducer_tpu_torch.train.loop import TrainState
from rnn_transducer_tpu_torch.weights import params_from_numpy, params_to_numpy

pytestmark = pytest.mark.quick

TOL = dict(rtol=1e-5, atol=1e-5)
BLANK = 0


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


# --------------------------------- the loss ---------------------------------

def _loss_case(name):
    """(logits (B, T, V), labels, frame lens, label lens) of one case."""
    rng = np.random.default_rng({"ragged": 0, "zero_label": 1, "dead": 2,
                                 "repeats": 3}[name])
    B, T, U, V = 4, 12, 5, 9
    logits = (2 * rng.normal(size=(B, T, V))).astype(np.float32)
    labels = rng.integers(1, V, size=(B, U)).astype(np.int32)
    fl = np.array([12, 9, 7, 1], np.int32)
    ll = np.array([5, 3, 2, 1], np.int32)
    if name == "zero_label":
        ll[1] = ll[3] = 0
    elif name == "dead":
        # 5 labels with two repeats need 7 frames: 4 and 6 frames cannot
        labels[0] = [3, 3, 4, 4, 5]
        fl[0], ll[0] = 6, 5
        fl[2], ll[2] = 4, 5
    elif name == "repeats":
        labels[:] = [2, 2, 2, 5, 5]  # no skip arc between equal labels
        ll[:] = [5, 3, 2, 1]
    return logits, labels, fl, ll


LOSS_CASES = ["ragged", "zero_label", "dead", "repeats"]


@pytest.mark.parametrize("case", LOSS_CASES)
def test_ctc_loss_from_logits_matches_jax(case):
    logits, labels, fl, ll = _loss_case(case)
    w = np.arange(1, logits.shape[0] + 1, dtype=np.float32)  # a cotangent

    def jfn(x):
        return jloss.ctc_loss_from_logits(x, _j(labels), _j(fl), _j(ll))

    want = np.asarray(jfn(_j(logits)))
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(jfn(x) * w))(
        _j(logits)))
    x = _t(logits).requires_grad_(True)
    got = tloss.ctc_loss_from_logits(x, _t(labels), _t(fl), _t(ll))
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(x.grad.numpy(), want_g, **TOL)
    if case == "dead":  # JAX's convention, not inf: ~1e30 and no gradient
        assert got[0] > 1e29 and got[2] > 1e29
        assert float(x.grad[[0, 2]].abs().max()) == 0.0


@pytest.mark.parametrize("case", LOSS_CASES)
def test_ctc_loss_on_log_probs_matches_jax(case):
    """`ctc_loss` over log-softmax inputs, differentiated through the
    recursion by autograd (JAX differentiates through its scan)."""
    logits, labels, fl, ll = _loss_case(case)

    def jfn(x):
        return jnp.sum(jloss.ctc_loss(jax.nn.log_softmax(x), _j(labels),
                                      _j(fl), _j(ll)))

    want, want_g = jax.value_and_grad(jfn)(_j(logits))
    x = _t(logits).requires_grad_(True)
    got = tloss.ctc_loss(torch.log_softmax(x, -1), _t(labels), _t(fl),
                         _t(ll)).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                               rtol=1e-4, atol=1e-5)


def test_ctc_loss_matches_torch_ctc_where_feasible():
    logits, labels, fl, ll = _loss_case("ragged")
    lp = torch.log_softmax(_t(logits), -1)
    want = torch.nn.functional.ctc_loss(
        lp.transpose(0, 1), _t(labels).long(), _t(fl).long(), _t(ll).long(),
        blank=0, reduction="none")
    got = tloss.ctc_loss_from_logits(_t(logits), _t(labels), _t(fl), _t(ll))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)


# --------------------------------- greedy -----------------------------------

@pytest.mark.parametrize("max_symbols", [32, 5])
def test_ctc_greedy_matches_jax(max_symbols):
    rng = np.random.default_rng(0)
    B, T, V = 6, 40, 12
    logits = rng.normal(size=(B, T, V)).astype(np.float32)
    logits[:, :, 3] += 1.0  # repeats, so that the collapse acts
    fl = np.array([40, 37, 1, 0, 40, 23], np.int32)
    want = [np.asarray(a) for a in jctc.ctc_greedy_decode(
        _j(logits), _j(fl), blank=BLANK, max_symbols=max_symbols)]
    got = [a.numpy() for a in tctc.ctc_greedy_decode(
        _t(logits), _t(fl), blank=BLANK, max_symbols=max_symbols)]
    for g, w, name in zip(got, want, ("tokens", "lengths", "confs",
                                      "frames")):
        assert g.dtype == w.dtype, name
        if name == "confs":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    if max_symbols == 5:
        assert (got[1] == 5).any()  # the cut acted


# ------------------------------- prefix beam --------------------------------

def _log_probs(seed, B=3, T=10, V=8, scale=1.5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, V)) * scale
    x = x - np.log(np.sum(np.exp(x), axis=-1, keepdims=True))
    return x.astype(np.float32)


FL = np.array([10, 6, 0], np.int32)  # a zero-frame row


def _assert_same_nbest(got, want):
    (tok, n, sc), (tok_w, n_w, sc_w) = ([np.asarray(a) for a in x]
                                        for x in (got, want))
    np.testing.assert_array_equal(n, n_w)
    np.testing.assert_array_equal(tok, tok_w)
    live = sc_w > -1e29
    np.testing.assert_array_equal(sc > -1e29, live)
    np.testing.assert_allclose(sc[live], sc_w[live], **TOL)
    return live


@pytest.mark.parametrize("K", [1, 4, 8])
@pytest.mark.parametrize("C", ["V-1", 8])
def test_prefix_beam_matches_jax(K, C):
    V = 6
    lp = _log_probs(K, V=V)
    cand = V - 1 if C == "V-1" else C
    kw = dict(beam=K, cand=cand, blank=BLANK, max_symbols=7)
    want = jctc.ctc_prefix_beam_search(_j(lp), _j(FL), **kw)
    got = tctc.ctc_prefix_beam_search(_t(lp), _t(FL), **kw)
    live = _assert_same_nbest(got, want)
    assert live.sum() >= K  # the zero-frame row keeps its empty prefix


def _lstm_lm(V):
    f = dict(vocab_size=V, embed_dim=6, hidden=10, layers=1,
             compute_dtype="float32")
    p = jax.tree.map(np.asarray,
                     jlm.init_lm_params(jax.random.PRNGKey(7),
                                        jlm.LMConfig(**f)))
    return ((jax.tree.map(jnp.asarray, p), jlm.LMConfig(**f), 0.7),
            (params_from_numpy(p), tlm.LMConfig(**f), 0.7))


def _transformer_lm(V):
    f = dict(vocab_size=V, d_model=16, heads=4, layers=2, ff_mult=2,
             max_len=40, compute_dtype="float32")
    jc, tc = jlt.TransformerLMConfig(**f), tlt.TransformerLMConfig(**f)
    p = jax.tree.map(np.asarray, jlm.init_lm_params(jax.random.PRNGKey(8),
                                                    jc))
    return ((jax.tree.map(jnp.asarray, p), jc, 0.5),
            (params_from_numpy(p), tc, 0.5))


def _ngram(V):
    seqs = [[1, 2, 3], [1, 2, 4], [2, 3, 1], [5, 1, 2]] * 5
    return ((jng.train_ngram(seqs, 3, V), 0.5),
            (tng.train_ngram(seqs, 3, V), 0.5))


@pytest.mark.parametrize("fusion", ["lstm_lm", "transformer_lm", "ngram",
                                    "length_bonus", "all"])
def test_fused_prefix_beam_matches_jax(fusion):
    V = 8
    lp = _log_probs(11, V=V)
    jkw, tkw = {}, {}
    if fusion in ("lstm_lm", "all"):
        jkw["lm"], tkw["lm"] = _lstm_lm(V)
    if fusion == "transformer_lm":
        jkw["lm"], tkw["lm"] = _transformer_lm(V)
    if fusion in ("ngram", "all"):
        jkw["ngram"], tkw["ngram"] = _ngram(V)
    if fusion in ("length_bonus", "all"):
        jkw["length_bonus"] = tkw["length_bonus"] = 1.5
    kw = dict(beam=4, cand=3, blank=BLANK, max_symbols=9)
    want = jctc.ctc_prefix_beam_search(_j(lp), _j(FL), **kw, **jkw)
    got = tctc.ctc_prefix_beam_search(_t(lp), _t(FL), **kw, **tkw)
    _assert_same_nbest(got, want)
    plain = tctc.ctc_prefix_beam_search(_t(lp), _t(FL), **kw)
    assert not np.array_equal(plain[2].numpy(), got[2].numpy())


# ------------------------------ recognize_ctc -------------------------------

SMALL = dict(input_dim=8, enc_layers=2, enc_hidden=16, time_reduction=2,
             pred_layers=1, pred_hidden=12, embed_dim=10, joint_dim=14,
             vocab_size=11, compute_dtype="float32", ctc_head=True)
JCFG = jax_config.TransducerConfig(**SMALL)
TCFG = port_config.TransducerConfig(**SMALL)


def ctc_params(seed=3, scale=4.0):
    """JAX params whose CTC head is scaled so that the head emits several
    tokens an utterance."""
    p = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed),
                                                JCFG))
    p["ctc_head"]["w"] = p["ctc_head"]["w"] * scale
    return p


def _feats(seed=1, B=4, T=40):
    rng = np.random.default_rng(seed)
    feats = (3 * rng.normal(size=(B, T, SMALL["input_dim"]))).astype(
        np.float32)
    return feats, np.array([40, 33, 0, 7], np.int32)[:B]


def test_recognize_ctc_matches_jax():
    p = ctc_params()
    feats, lens = _feats()
    jp = jax.tree.map(jnp.asarray, p)
    want = jctc.recognize_ctc(jp, JCFG, _j(feats), _j(lens), mode="greedy",
                              max_symbols=16, with_confidence=True,
                              with_timestamps=True)
    got = tctc.recognize_ctc(params_from_numpy(p), TCFG, _t(feats),
                             _t(lens), mode="greedy", max_symbols=16,
                             with_confidence=True, with_timestamps=True)
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **TOL)
    assert got[1].numpy().sum() >= 4
    want = jctc.recognize_ctc(jp, JCFG, _j(feats), _j(lens), mode="beam",
                              beam=4, max_symbols=16)
    got = tctc.recognize_ctc(params_from_numpy(p), TCFG, _t(feats),
                             _t(lens), mode="beam", beam=4, max_symbols=16)
    _assert_same_nbest(got, want)


def test_recognize_ctc_refuses_a_model_without_the_head():
    cfg = dataclasses.replace(TCFG, ctc_head=False)
    params = tm.init_params(cfg, np.random.default_rng(0), device="cpu")
    feats, lens = _feats()
    with pytest.raises(ValueError, match="ctc_head"):
        tctc.recognize_ctc(params, cfg, _t(feats), _t(lens))
    with pytest.raises(ValueError, match="unknown CTC decode mode"):
        tctc.recognize_ctc(tm.init_params(TCFG, np.random.default_rng(0),
                                          device="cpu"), TCFG, _t(feats),
                           _t(lens), mode="sampled")


# -------------------------------- multitask ---------------------------------

TINY = dict(input_dim=8, enc_layers=2, enc_hidden=32, time_reduction=2,
            pred_layers=1, pred_hidden=16, embed_dim=8, joint_dim=16,
            vocab_size=21, compute_dtype="float32", ctc_head=True,
            pruned_range=3)
# the port's route and the JAX route it is held against (on the CPU JAX's
# auto is xla; pallas runs its kernels in interpret mode)
ROUTES = {"xla": ("xla", {}), "fused": ("xla", {}), "pallas": ("xla", {}),
          "pruned": ("pruned", {}), "ar": ("ar", dict(ar_range=3,
                                                      ar_left=1))}


def _batch(B=4, T=12, U=5, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, TINY["input_dim"])).astype(np.float32)
    fl = np.array([12, 9, 12, 7], np.int32)[:B]
    labels = rng.integers(1, TINY["vocab_size"], size=(B, U)).astype(np.int32)
    ll = np.array([5, 3, 0, 2], np.int32)[:B]
    return feats, fl, labels, ll


def _tiny_params(seed=1):
    return jax.tree.map(np.asarray, jm.init_params(
        jax.random.PRNGKey(seed), jax_config.TransducerConfig(**TINY)))


def _port_loss_and_grads(fn, p_np, *args, **kw):
    params = params_from_numpy(p_np)
    leaves, _ = torch.utils._pytree.tree_flatten(params)
    for x in leaves:
        x.requires_grad_(True)
    loss, per_utt = fn(params, *args, **kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return (float(loss.detach()), per_utt.detach().numpy(),
            [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)])


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_multitask_loss_matches_jax(route):
    """loss_fn(ctc_weight=0.3) equals loss_fn() + 0.3 ctc_loss_fn() in the
    port, and JAX's loss_fn(ctc_weight=0.3): the loss, the per-utterance
    losses and every gradient leaf."""
    jcfg = jax_config.TransducerConfig(**TINY)
    cfg = port_config.TransducerConfig(**TINY)
    p_np = _tiny_params()
    batch = _batch(seed=3)
    jimpl, kw = ROUTES[route]
    loss_kw = dict(kw, loss_impl=route if route != "ar" else "ar")

    def jfn(p):
        return jloop.loss_fn(p, jcfg, *(_j(a) for a in batch),
                             ctc_weight=0.3, **dict(kw, loss_impl=jimpl))

    (want, want_pu), want_g = jax.value_and_grad(jfn, has_aux=True)(
        jax.tree.map(jnp.asarray, p_np))
    tb = tuple(_t(a) for a in batch)
    got, got_pu, grads = _port_loss_and_grads(
        tloop.loss_fn, p_np, cfg, *tb, ctc_weight=0.3, **loss_kw)
    np.testing.assert_allclose(got, float(want), **TOL)
    np.testing.assert_allclose(got_pu, np.asarray(want_pu), rtol=1e-5,
                               atol=1e-4)
    for g, e in zip(grads, jax.tree.leaves(want_g)):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-4,
                                   atol=1e-5)
    # the combination of its parts
    rnnt, rnnt_pu, _ = _port_loss_and_grads(tloop.loss_fn, p_np, cfg, *tb,
                                            **loss_kw)
    ctc, ctc_pu, _ = _port_loss_and_grads(tloop.ctc_loss_fn, p_np, cfg, *tb)
    np.testing.assert_allclose(got_pu, rnnt_pu + 0.3 * ctc_pu, rtol=1e-6,
                               atol=1e-5)
    if route != "pruned":  # pruned adds the simple loss beside
        np.testing.assert_allclose(got, rnnt + 0.3 * ctc, rtol=1e-6)
    # the CTC head gets a gradient only through the multitask term
    head = [i for i, (path, _) in enumerate(
        jax.tree_util.tree_leaves_with_path(p_np)) if "ctc_head" in str(path)]
    assert head and all(float(grads[i].abs().max()) > 0 for i in head)


def test_ctc_loss_fn_matches_jax():
    jcfg = jax_config.TransducerConfig(**TINY)
    cfg = port_config.TransducerConfig(**TINY)
    p_np = _tiny_params(2)
    batch = _batch(seed=4)
    (want, want_pu), want_g = jax.value_and_grad(
        lambda p: jloop.ctc_loss_fn(p, jcfg, *(_j(a) for a in batch)),
        has_aux=True)(jax.tree.map(jnp.asarray, p_np))
    got, got_pu, grads = _port_loss_and_grads(
        tloop.ctc_loss_fn, p_np, cfg, *(_t(a) for a in batch))
    np.testing.assert_allclose(got, float(want), **TOL)
    np.testing.assert_allclose(got_pu, np.asarray(want_pu), **TOL)
    for g, e in zip(grads, jax.tree.leaves(want_g)):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-4,
                                   atol=1e-5)


def test_ctc_weight_refuses_an_moe_joint():
    cfg = port_config.TransducerConfig(**{**TINY, "joint_experts": 2})
    with pytest.raises(ValueError, match="MoE"):
        tloop.loss_fn({}, cfg, *(_t(a) for a in _batch()), ctc_weight=0.1)
    with pytest.raises(ValueError, match="MoE"):
        tloop.make_train_step(cfg, port_config.TrainConfig(ctc_weight=0.1),
                              device="cpu")


# ------------------------------- trajectories -------------------------------

KINDS = {"ctc": ("ctc", {}), "ctc_weight": ("rnnt", dict(ctc_weight=0.3)),
         "ctc_weight_fused": ("rnnt", dict(ctc_weight=0.3,
                                           loss_impl="fused"))}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_trajectory_matches_jax(kind):
    """Two steps of make_train_step(loss_kind="ctc") and of ctc_weight=0.3
    against JAX's (the port's fused route against JAX's xla on the CPU):
    losses and params."""
    loss_kind, extra = KINDS[kind]
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, **extra)
    jkw = dict(kw, loss_impl="xla")
    jcfg = jax_config.TransducerConfig(**TINY)
    jstate = jloop.init_train_state(jax.random.PRNGKey(5), jcfg,
                                    jax_config.TrainConfig(**jkw))
    params0 = jax.tree.map(np.asarray, jstate.params)
    jstep = jloop.make_train_step(jcfg, jax_config.TrainConfig(**jkw),
                                  loss_kind=loss_kind)
    cfg = port_config.TransducerConfig(**TINY)
    tcfg = port_config.TrainConfig(**kw)
    state = tloop.init_train_state(None, cfg, tcfg,
                                   params=params_from_numpy(params0))
    step = tloop.make_train_step(cfg, tcfg, device="cpu",
                                 loss_kind=loss_kind)
    rng = np.random.default_rng(0)
    want, got = [], []
    for _ in range(2):
        batch = random_batch(rng, 3, 12, 4, TINY["input_dim"],
                             TINY["vocab_size"])
        jstate, info = jstep(jstate, *(_j(a) for a in batch))
        want.append(float(info["loss"]))
        state, info = step(state, *(_t(a) for a in batch))
        assert int(info["skipped_nonfinite"]) == 0
        got.append(float(info["loss"]))
    np.testing.assert_allclose(got, want, **TOL)
    for (path, a), e in zip(
            jax.tree_util.tree_leaves_with_path(params_to_numpy(state.params)),
            jax.tree.leaves(jax.tree.map(np.asarray, jstate.params))):
        np.testing.assert_allclose(a, e, rtol=0, atol=2e-6,
                                   err_msg=str(path))
    moved = max(float(np.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(params_to_numpy(state.params)),
        jax.tree.leaves(params0)))
    assert moved > 1e-4


# ---------------------------------- CLIs ------------------------------------

def _corpus(tmp_path, n=12):
    rng = np.random.default_rng(0)
    recs = []
    for i in range(n):
        t = int(rng.integers(20, 60))
        p = tmp_path / f"u{i}.npy"
        np.save(p, rng.normal(size=(t, 80)).astype(np.float32))
        recs.append({"feats": str(p), "labels": rng.integers(
            1, 32, size=int(rng.integers(2, 6))).tolist()})
    man = tmp_path / "m.jsonl"
    man.write_text("\n".join(json.dumps(r) for r in recs))
    return str(man)


def _train_argv(man, steps, ck, log, *extra):
    return ["--config", "smoke", "--data", f"manifest:{man}", "--steps",
            str(steps), "--batch-size", "2", "--ckpt-dir", ck,
            "--log-every", "1", "--seed", "5", "--device", "cpu",
            "--eval-every", "0", "--log-file", log, "--pred-type",
            "stateless", *extra]


def _records(log):
    return [r for r in map(json.loads, open(log)) if "loss" in r]


def test_train_cli_phases_ctc_rnnt_mwer(tmp_path, capsys):
    man = _corpus(tmp_path)
    ck, log = str(tmp_path / "ck"), str(tmp_path / "l.jsonl")
    train_main(_train_argv(man, 5, ck, log, "--ctc-pretrain-steps", "2",
                           "--ctc-weight", "0.3", "--mwer-steps", "1",
                           "--mwer-beam", "2"))
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["steps"] == 5 and np.isfinite(last["final_loss"])
    recs = _records(log)
    assert [r["phase"] for r in recs] == ["ctc", "ctc", "rnnt", "rnnt",
                                          "mwer"]
    assert all(np.isfinite(r["loss"]) and r["skipped_nonfinite"] == 0
               for r in recs)
    cfg = ckpt.load_model_config(ck)
    assert cfg.ctc_head and cfg.pred_type == "stateless"
    assert cfg.pred_context == 2
    assert ckpt.load_meta(ck)["train_config"]["ctc_weight"] == 0.3


def test_train_cli_resume_across_the_ctc_boundary(tmp_path, capsys):
    """Run A trains 5 steps (2 CTC, then RNN-T with ctc_weight); run B
    trains 1, checkpoints, and resumes to 5: its params, Adam state and
    losses at steps 2-5 equal A's bit for bit."""
    man = _corpus(tmp_path)
    flags = ("--ctc-pretrain-steps", "2", "--ctc-weight", "0.3",
             "--pred-context", "3")

    def run(steps, name, log, resume=False):
        train_main(_train_argv(man, steps, str(tmp_path / name),
                               str(tmp_path / log), *flags,
                               *(["--resume"] if resume else [])))
        capsys.readouterr()
        return {r["step"]: (r["phase"], r["loss"])
                for r in _records(str(tmp_path / log))}

    la = run(5, "A", "a.jsonl")
    run(1, "B", "b1.jsonl")
    lb = run(5, "B", "b2.jsonl", resume=True)
    assert [la[s] for s in (2, 3, 4, 5)] == [lb[s] for s in (2, 3, 4, 5)]
    assert [la[s][0] for s in (1, 2, 3)] == ["ctc", "ctc", "rnnt"]
    a, _ = ckpt.restore_checkpoint(str(tmp_path / "A"))
    b, _ = ckpt.restore_checkpoint(str(tmp_path / "B"))
    leaves = torch.utils._pytree.tree_leaves
    assert a.step == b.step == 5
    for x, y in zip(leaves((a.params, a.opt_state)),
                    leaves((b.params, b.opt_state))):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    assert ckpt.load_model_config(str(tmp_path / "A")).pred_context == 3


# the decode CLI: the same params at f32 through the port's CLI and the JAX
# decoders on the JAX package's batches of one manifest

LENGTHS = (40, 33, 21, 7, 45, 16)


def _manifest(tmp_path):
    rng = np.random.default_rng(7)
    recs = []
    for i, T in enumerate(LENGTHS):
        p = tmp_path / f"f{i}.npy"
        np.save(p, (3 * rng.normal(size=(T, SMALL["input_dim"]))).astype(
            np.float32))
        recs.append({"feats": str(p), "labels": rng.integers(
            1, SMALL["vocab_size"], size=3 + i % 4).tolist()})
    man = tmp_path / "m.jsonl"
    man.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    return str(man)


def _ckpt_dir(tmp_path, p, cfg=TCFG):
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, 0, TrainState(params=params_from_numpy(p),
                                          opt_state={}, step=0),
                         model_cfg=cfg)
    return d


def _jax_ctc_hyps(p, man, mode, ngram=None):
    from rnn_transducer_tpu.data import manifest as jman
    from rnn_transducer_tpu.data.bucketing import bucket_stream

    jp = jax.tree.map(jnp.asarray, p)
    out = []
    for feats, fl, _, _, n_valid in bucket_stream(
            jman.manifest_examples(man, JCFG),
            jax_config.TrainConfig().buckets, 8, blank=JCFG.blank,
            with_valid=True):
        if mode == "ctc_greedy":
            tok, n, conf, fr = (np.asarray(a) for a in jctc.recognize_ctc(
                jp, JCFG, _j(feats), _j(fl), mode="greedy", max_symbols=30,
                with_confidence=True, with_timestamps=True))
            out += [(tok[i, :n[i]].tolist(),
                     (fr[i, :n[i]] * JCFG.time_reduction).tolist(),
                     conf[i, :n[i]].tolist(), None) for i in range(n_valid)]
        else:
            tok, n, sc = (np.asarray(a) for a in jctc.recognize_ctc(
                jp, JCFG, _j(feats), _j(fl), mode="beam", beam=4,
                max_symbols=30, ngram=ngram))
            out += [(tok[i, 0, :n[i, 0]].tolist(), None, None,
                     [(tok[i, k, :n[i, k]].tolist(), float(sc[i, k]))
                      for k in range(3) if sc[i, k] > -1e29])
                    for i in range(n_valid)]
    return out


@pytest.mark.parametrize("mode", ["ctc_greedy", "ctc_beam"])
def test_decode_cli_ctc_modes_match_the_jax_decoders(tmp_path, mode, capsys):
    p = ctc_params()
    man = _manifest(tmp_path)
    d = _ckpt_dir(tmp_path, p)
    hyps = tmp_path / "hyps.jsonl"
    argv = ["--ckpt-dir", d, "--data", f"manifest:{man}", "--mode", mode,
            "--device", "cpu", "--max-symbols", "30", "--beam", "4",
            "--hyps-file", str(hyps)]
    jng_lm = None
    if mode == "ctc_greedy":
        argv += ["--confidence", "--timestamps"]
    else:
        seqs = [r["labels"] for r in map(json.loads, open(man))] * 3
        tng.save_ngram(tng.train_ngram(seqs, 3, SMALL["vocab_size"]),
                       str(tmp_path / "lm3"))
        jng_lm = (jng.load_ngram(str(tmp_path / "lm3.npz")), 0.4)
        argv += ["--nbest", "3", "--ngram", str(tmp_path / "lm3.npz"),
                 "--ngram-weight", "0.4"]
    out = rec.main(argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == out
    records = [json.loads(ln) for ln in hyps.read_text().splitlines()]
    want = _jax_ctc_hyps(p, man, mode, jng_lm)
    assert len(records) == len(want) == len(LENGTHS)
    for r, (tok, frames, conf, nb) in zip(records, want):
        assert r["hyp"] == tok
        if frames is not None:
            assert r["frames"] == frames
            np.testing.assert_allclose(r["confs"], conf, atol=2e-4)
        if nb is not None:
            assert [h["hyp"] for h in r["nbest"]] == [t for t, _ in nb]
            np.testing.assert_allclose([h["score"] for h in r["nbest"]],
                                       [s for _, s in nb], atol=2e-4)
    assert sum(len(w[0]) for w in want) >= len(LENGTHS)
    assert out["mode"] == mode and out["n"] == len(LENGTHS)


@pytest.mark.parametrize("mode", ["ctc_greedy", "ctc_beam"])
def test_decode_cli_prints_the_jax_clis_keys(mode, capsys):
    import recognize as jax_cli

    argv = ["--config", "smoke", "--mode", mode, "--batches", "1",
            "--batch-size", "2", "--beam", "2", "--max-symbols", "20",
            "--tokenizer", "char"]
    jax_cli.main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = rec.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    assert list(got) == list(want)
    assert got["mode"] == mode and got["n"] == want["n"] == 2


@pytest.mark.parametrize("extra, head, words", [
    pytest.param(["--mode", "ctc_greedy"], False,
                 "needs a checkpoint trained", id="no-head"),
    pytest.param(["--mode", "ctc_beam", "--timestamps"], True, "ctc_beam",
                 id="beam-timestamps"),
    pytest.param(["--mode", "ctc_beam", "--confidence"], True,
                 "--confidence", id="beam-confidence"),
    pytest.param(["--mode", "greedy", "--length-bonus", "1"], True,
                 "requires --mode ctc_beam", id="bonus-greedy"),
])
def test_decode_cli_ctc_refusals(tmp_path, extra, head, words):
    jcfg = dataclasses.replace(JCFG, ctc_head=head)
    p = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0),
                                                jcfg))
    d = _ckpt_dir(tmp_path, p, dataclasses.replace(TCFG, ctc_head=head))
    with pytest.raises(SystemExit, match=words):
        rec.main(["--ckpt-dir", d, "--device", "cpu", *extra])
