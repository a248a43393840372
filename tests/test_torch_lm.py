"""PyTorch port fusion LMs (`models/lm.py`, `models/lm_transformer.py`) vs
the JAX package's, at small widths.

The same JAX-initialised params (crossed with `params_from_numpy`) and the
same seeded labels go through both: the LSTM LM's step, scoring pass,
sequence log-probs and N-best rescoring, and the transformer LM's
forward, step with its KV cache (f32 and bf16 caches) and the step
against the forward position by position.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.models import lm as jlm
from rnn_transducer_tpu.models import lm_transformer as jlt
from rnn_transducer_tpu_torch.models import lm as tlm
from rnn_transducer_tpu_torch.models import lm_transformer as tlt
from rnn_transducer_tpu_torch.weights import (params_from_numpy,
                                              params_to_numpy)

pytestmark = pytest.mark.quick

V = 11
LSTM = dict(vocab_size=V, embed_dim=6, hidden=10, layers=2,
            compute_dtype="float32")
TRANS = dict(vocab_size=V, d_model=16, heads=4, layers=2, ff_mult=2,
             max_len=12, compute_dtype="float32")
ATOL = 1e-5


def _cfgs(kind, **kw):
    if kind == "lstm":
        f = {**LSTM, **kw}
        return jlm.LMConfig(**f), tlm.LMConfig(**f)
    f = {**TRANS, **kw}
    return jlt.TransformerLMConfig(**f), tlt.TransformerLMConfig(**f)


def _params(jcfg, seed=0):
    return jax.tree.map(np.asarray,
                        jlm.init_lm_params(jax.random.PRNGKey(seed), jcfg))


def _labels(B=4, U=7, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(1, V, size=(B, U)).astype(np.int32)
    lens = np.array([U, 3, 0, 5], np.int32)[:B]
    return labels, lens


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("kind", ["lstm", "transformer"])
def test_config_fields_and_defaults_mirror_jax(kind):
    jcls = jlm.LMConfig if kind == "lstm" else jlt.TransformerLMConfig
    tcls = tlm.LMConfig if kind == "lstm" else tlt.TransformerLMConfig
    assert ([(f.name, f.default) for f in dataclasses.fields(jcls)]
            == [(f.name, f.default) for f in dataclasses.fields(tcls)])


@pytest.mark.parametrize("kind", ["lstm", "transformer"])
def test_params_cross_both_ways_and_init_has_the_jax_tree(kind):
    """params_from_numpy carries the LM's tree (to the port and back bit
    for bit), and the port's init draws the same tree of shapes."""
    jcfg, tcfg = _cfgs(kind)
    p = _params(jcfg)
    back = params_to_numpy(params_from_numpy(p))
    assert jax.tree.structure(back) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, b)
    mine = params_to_numpy(tlm.init_lm_params(
        tcfg, np.random.default_rng(0), device="cpu"))
    assert jax.tree.structure(mine) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(p)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_lstm_lm_step_and_forward_match_jax(cd):
    jcfg, tcfg = _cfgs("lstm", compute_dtype=cd)
    p = _params(jcfg)
    tp = params_from_numpy(p)
    labels, _ = _labels()
    atol = ATOL if cd == "float32" else 2e-3
    _close(tlm.lm_forward(tp, tcfg, torch.from_numpy(labels)),
           jlm.lm_forward(p, jcfg, jnp.asarray(labels)), atol)
    # the step from BOS through the labels, state by state
    B = labels.shape[0]
    st_j = jlm.init_lm_state(jcfg, B)
    st_t = tlm.init_lm_state(tcfg, B, device="cpu")
    tok = np.full((B,), jlm.BOS_ID, np.int32)
    for u in range(labels.shape[1]):
        lp_j, st_j = jlm.lm_step(p, jcfg, jnp.asarray(tok), st_j)
        lp_t, st_t = tlm.lm_step(tp, tcfg, torch.from_numpy(tok), st_t)
        _close(lp_t, lp_j, atol)
        for (h, c), (h_j, c_j) in zip(st_t, st_j):
            _close(h, h_j, atol)
            _close(c, c_j, atol)
        tok = labels[:, u]


@pytest.mark.parametrize("kind", ["lstm", "transformer"])
def test_sequence_logprob_and_rescore_nbest_match_jax(kind):
    jcfg, tcfg = _cfgs(kind)
    p = _params(jcfg)
    tp = params_from_numpy(p)
    labels, lens = _labels()
    _close(tlm.lm_sequence_logprob(tp, tcfg, torch.from_numpy(labels),
                                   torch.from_numpy(lens)),
           jlm.lm_sequence_logprob(p, jcfg, jnp.asarray(labels),
                                   jnp.asarray(lens)), 1e-4)
    # an n-best of 2 utterances x 4 beams, with an exact tie in am scores
    rng = np.random.default_rng(1)
    toks = rng.integers(1, V, size=(2, 4, 6)).astype(np.int32)
    nl = rng.integers(0, 7, size=(2, 4)).astype(np.int32)
    am = rng.normal(size=(2, 4)).astype(np.float32)
    am[0, 1] = am[0, 2]
    conf = rng.normal(size=(2, 4, 6)).astype(np.float32)
    want = jlm.rescore_nbest(p, jcfg, jnp.asarray(toks), jnp.asarray(nl),
                             jnp.asarray(am), weight=0.3, length_bonus=0.5,
                             extras=(jnp.asarray(conf),))
    got = tlm.rescore_nbest(tp, tcfg, torch.from_numpy(toks),
                            torch.from_numpy(nl), torch.from_numpy(am),
                            weight=0.3, length_bonus=0.5,
                            extras=(torch.from_numpy(conf),))
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            _close(g, w, 1e-4)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_transformer_forward_matches_jax():
    jcfg, tcfg = _cfgs("transformer")
    p = _params(jcfg)
    labels, _ = _labels()
    _close(tlm.lm_forward(params_from_numpy(p), tcfg,
                          torch.from_numpy(labels)),
           jlm.lm_forward(p, jcfg, jnp.asarray(labels)))


@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_transformer_step_with_its_cache_matches_jax(cache):
    """Fourteen steps of a 12-position cache: the last two past max_len
    clamp at position 11 as JAX's; a bf16 cache rounds only the cache."""
    jcfg, tcfg = _cfgs("transformer", cache_dtype=cache)
    p = _params(jcfg)
    tp = params_from_numpy(p)
    B = 3
    rng = np.random.default_rng(2)
    toks = rng.integers(1, V, size=(14, B)).astype(np.int32)
    st_j = jlm.init_lm_state(jcfg, B)
    st_t = tlm.init_lm_state(tcfg, B, device="cpu")
    assert st_t["kv"][0]["k"].dtype == tcfg.cache_dt
    for tok in toks:
        lp_j, st_j = jlm.lm_step(p, jcfg, jnp.asarray(tok), st_j)
        lp_t, st_t = tlm.lm_step(tp, tcfg, torch.from_numpy(tok), st_t)
        _close(lp_t, lp_j, 1e-5)
    np.testing.assert_array_equal(st_t["pos"].numpy(),
                                  np.asarray(st_j["pos"]))
    for kv_t, kv_j in zip(st_t["kv"], st_j["kv"]):
        for name in ("k", "v"):
            got = kv_t[name].float().numpy()
            want = np.asarray(kv_j[name]).astype(np.float32)
            _close(got, want, 1e-5 if cache == "float32" else 1e-2)


def test_transformer_step_equals_forward_position_by_position():
    jcfg, tcfg = _cfgs("transformer")
    tp = params_from_numpy(_params(jcfg))
    labels, _ = _labels(B=3, U=8, seed=3)
    logits = tlm.lm_forward(tp, tcfg, torch.from_numpy(labels))
    st = tlm.init_lm_state(tcfg, 3, device="cpu")
    tok = torch.full((3,), tlm.BOS_ID, dtype=torch.int32)
    for u in range(labels.shape[1]):
        lp, st = tlm.lm_step(tp, tcfg, tok, st)
        _close(lp, torch.log_softmax(logits[:, u], -1), 1e-5)
        tok = torch.from_numpy(labels[:, u])


def test_gelu_is_the_tanh_form_and_ln_the_population_variance():
    x = jnp.asarray(np.random.default_rng(4).normal(size=(5, 16)) * 3,
                    jnp.float32)
    xt = torch.from_numpy(np.array(x))
    _close(torch.nn.functional.gelu(xt, approximate="tanh"),
           jax.nn.gelu(x), 1e-6)
    g = np.random.default_rng(5).normal(size=(16,)).astype(np.float32)
    p_j = {"g": jnp.asarray(g), "b": jnp.zeros(16)}
    p_t = {"g": torch.from_numpy(g), "b": torch.zeros(16)}
    _close(tlt._ln(p_t, xt), jlt._ln(p_j, x), 1e-5)
