"""PyTorch port shallow fusion in beam search vs the JAX package's.

The port's n-gram (`models/ngram.py`) and context-biasing
(`decode/context.py`) tables are built from the same inputs as JAX's and
must be bit-equal; then the port's `recognize_beam` with an LSTM LM, with
ILM subtraction, with a transformer LM (its cache capped at max_symbols +
1), with a trigram and with a phrase trie must give JAX's beams with the
same objects: every live beam's tokens, lengths and frames identical,
scores within 1e-4, confidences within 1e-5 (tests/test_torch_beam.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.decode import context as jctx
from rnn_transducer_tpu.models import lm as jlm
from rnn_transducer_tpu.models import lm_transformer as jlt
from rnn_transducer_tpu.models import ngram as jng
from rnn_transducer_tpu_torch.decode import beam as tb
from rnn_transducer_tpu_torch.decode import context as tctx
from rnn_transducer_tpu_torch.models import lm as tlm
from rnn_transducer_tpu_torch.models import lm_transformer as tlt
from rnn_transducer_tpu_torch.models import ngram as tng
from rnn_transducer_tpu_torch.weights import (context_from_numpy,
                                              ngram_from_numpy,
                                              params_from_numpy)
from test_torch_beam import (_jax_recognize, _port_recognize,
                             assert_same_beams, beam_params)
from test_torch_greedy import JCFG, TCFG, batch

pytestmark = pytest.mark.quick

V = JCFG.vocab_size
MAX_SYMBOLS = 30
KW = dict(beam=8, max_symbols=MAX_SYMBOLS, expansions=3)


def _seqs(seed=0, n=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, V, size=rng.integers(1, 12)).tolist()
            for _ in range(n)]


def _phrases(seed=0, n=10):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, V, size=rng.integers(1, 4)).tolist()
            for _ in range(n)]


# -------------------------------- tables ---------------------------------

@pytest.mark.parametrize("order", [1, 2, 3])
def test_ngram_tables_are_jax_bits(order):
    want = jng.train_ngram(_seqs(), order, V)
    got = tng.train_ngram(_seqs(), order, V)
    assert got.start == want.start
    np.testing.assert_array_equal(got.lp.numpy(), np.asarray(want.lp))
    np.testing.assert_array_equal(got.next_state.numpy(),
                                  np.asarray(want.next_state))
    crossed = ngram_from_numpy(want)
    assert crossed.start == got.start
    assert torch.equal(crossed.lp, got.lp)
    assert torch.equal(crossed.next_state, got.next_state)
    seq = _seqs(seed=1, n=1)[0]
    assert tng.sequence_logprob(got, seq) == jng.sequence_logprob(want, seq)


def test_ngram_artifacts_load_in_either_package(tmp_path):
    lm = tng.train_ngram(_seqs(), 3, V)
    tng.save_ngram(lm, str(tmp_path / "port"))
    back = jng.load_ngram(str(tmp_path / "port"))
    np.testing.assert_array_equal(np.asarray(back.lp), lm.lp.numpy())
    jng.save_ngram(jng.train_ngram(_seqs(), 3, V), str(tmp_path / "jax"))
    mine = tng.load_ngram(str(tmp_path / "jax.npz"))
    assert mine.start == lm.start and torch.equal(mine.lp, lm.lp)
    assert torch.equal(mine.next_state, lm.next_state)


def test_ngram_refuses_bad_inputs():
    with pytest.raises(ValueError, match="order"):
        tng.train_ngram(_seqs(), 0, V)
    with pytest.raises(ValueError, match="discount"):
        tng.train_ngram(_seqs(), 2, V, discount=1.0)
    with pytest.raises(ValueError, match="invalid"):
        tng.train_ngram([[0, 1]], 2, V)


def test_context_tables_are_jax_bits():
    phrases = _phrases()
    boosts = [1.0 + 0.5 * i for i in range(len(phrases))]
    want = jctx.build_context_bias(phrases, V, blank=0, boosts=boosts)
    got = tctx.build_context_bias(phrases, V, blank=0, boosts=boosts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, c in zip(got, context_from_numpy(want)):
        assert torch.equal(g, c)
    node = torch.tensor([0, 1, 2])
    np.testing.assert_array_equal(
        tctx.final_bias(got, node).numpy(),
        np.asarray(jctx.final_bias(want, jnp.asarray([0, 1, 2]))))


def test_context_refuses_bad_phrases():
    with pytest.raises(ValueError, match="blank"):
        tctx.build_context_bias([[1, 0]], V)
    with pytest.raises(ValueError, match="outside"):
        tctx.build_context_bias([[V]], V)
    with pytest.raises(ValueError, match="empty"):
        tctx.build_context_bias([[]], V)


def test_boost_file_parses_as_jax(tmp_path):
    class Tok:  # characters -> ids 1..V-1
        def encode(self, text):
            return [1 + (ord(c) % (V - 1)) for c in text if c != " "]

    path = tmp_path / "boost.txt"
    path.write_text("# names\nalice\nbob\t3.5\n\n  carol  \n")
    assert (tctx.load_boost_phrases(str(path), Tok(), default_boost=1.5)
            == jctx.load_boost_phrases(str(path), Tok(), default_boost=1.5))


# -------------------------------- fusion ---------------------------------

def _lstm_lm():
    f = dict(vocab_size=V, embed_dim=6, hidden=10, layers=1,
             compute_dtype="float32")
    jcfg, tcfg = jlm.LMConfig(**f), tlm.LMConfig(**f)
    p = jax.tree.map(np.asarray,
                     jlm.init_lm_params(jax.random.PRNGKey(7), jcfg))
    return (jax.tree.map(jnp.asarray, p), jcfg), (params_from_numpy(p), tcfg)


def _transformer_lm():
    # max_len 40 > max_symbols + 1: beam search caps the cache at 31
    f = dict(vocab_size=V, d_model=16, heads=4, layers=2, ff_mult=2,
             max_len=40, compute_dtype="float32")
    jcfg, tcfg = jlt.TransformerLMConfig(**f), tlt.TransformerLMConfig(**f)
    p = jax.tree.map(np.asarray,
                     jlm.init_lm_params(jax.random.PRNGKey(8), jcfg))
    return (jax.tree.map(jnp.asarray, p), jcfg), (params_from_numpy(p), tcfg)


def _fusions(name):
    """(jax kwargs, port kwargs) of one fusion."""
    if name in ("lstm_lm", "ilm"):
        (jp, jc), (tp, tc) = _lstm_lm()
        w = (0.3, 0.1) if name == "ilm" else (0.3,)
        return {"lm": (jp, jc, *w)}, {"lm": (tp, tc, *w)}
    if name == "transformer_lm":
        (jp, jc), (tp, tc) = _transformer_lm()
        return {"lm": (jp, jc, 0.3)}, {"lm": (tp, tc, 0.3)}
    if name == "ngram":
        seqs = _seqs(seed=2, n=60)
        return ({"ngram": (jng.train_ngram(seqs, 3, V), 0.5)},
                {"ngram": (tng.train_ngram(seqs, 3, V), 0.5)})
    if name == "context":
        ph = _phrases(seed=3)
        return ({"context": jctx.build_context_bias(ph, V, boost=1.5)},
                {"context": tctx.build_context_bias(ph, V, boost=1.5)})
    # everything at once
    jk, tk = {}, {}
    for part in ("ilm", "ngram", "context"):
        j, t = _fusions(part)
        jk.update(j)
        tk.update(t)
    return jk, tk


@pytest.mark.parametrize("name", ["lstm_lm", "ilm", "transformer_lm",
                                  "ngram", "context", "all"])
def test_fused_beam_search_matches_jax(name):
    p = beam_params()
    feats, lens = batch()
    jkw, tkw = _fusions(name)
    want = _jax_recognize(p, JCFG, feats, lens, **KW, **jkw)
    got = _port_recognize(p, TCFG, feats, lens, **KW, **tkw)
    live = assert_same_beams(got, want)
    assert got[1][live].max() >= 3
    # the fusion moved the search: the beams differ from plain beam search
    plain = _port_recognize(p, TCFG, feats, lens, **KW)
    assert not np.array_equal(plain[2], got[2])


def test_fused_carry_holds_the_fusion_state_as_jax():
    """lm_lp, the LM's states, cb_node and ng_state ride in the carry and
    equal JAX's on every live beam."""
    from rnn_transducer_tpu.decode import beam as jb
    from rnn_transducer_tpu.models import transducer as jm

    p = beam_params()
    feats, lens = batch(seed=2)
    enc, enc_lens = jm.encode(jax.tree.map(jnp.asarray, p), JCFG,
                              jnp.asarray(feats), jnp.asarray(lens))
    jkw, tkw = _fusions("all")
    *_, cw = jb.beam_search(jax.tree.map(jnp.asarray, p), JCFG, enc,
                            enc_lens, **KW, **jkw)
    *_, ct = tb.beam_search(params_from_numpy(p), TCFG,
                            torch.from_numpy(np.array(enc)),
                            torch.from_numpy(np.array(enc_lens)), **KW,
                            **tkw)
    live = np.asarray(cw[2]) > -5e29
    for key in ("cb_node", "ng_state"):
        np.testing.assert_array_equal(ct[4][key].numpy()[live],
                                      np.asarray(cw[4][key])[live])
    np.testing.assert_allclose(ct[4]["lm_lp"].numpy()[live],
                               np.asarray(cw[4]["lm_lp"])[live], atol=1e-5)
    for (h, c), (hw, cwc) in zip(ct[5]["lm"], cw[5]["lm"]):
        np.testing.assert_allclose(h.numpy()[live], np.asarray(hw)[live],
                                   atol=1e-5)
        np.testing.assert_allclose(c.numpy()[live], np.asarray(cwc)[live],
                                   atol=1e-5)


def test_transformer_cache_is_capped_in_the_carry():
    (_, _), (tp, tc) = _transformer_lm()
    st = tb.init_beam_state(params_from_numpy(beam_params()), TCFG, 2,
                            beam=3, max_symbols=5, lm=(tp, tc, 0.3),
                            device="cpu")
    assert st[5]["lm"]["kv"][0]["k"].shape == (2, 3, 6, 4, 4)
    assert st[5]["lm"]["pos"].tolist() == [[1] * 3] * 2  # BOS consumed
