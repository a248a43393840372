"""PyTorch port greedy decoding vs the JAX package's `recognize_greedy`.

The random small model emits nothing or runs into max_symbols on frame 0
unless the blank logit is tuned: seed 3 with a +0.04 blank-bias offset and
inputs of scale 3 emits a few tokens per utterance at several frames and
walks every utterance to its end (test_greedy.py:80-84 plays the opposite
trick to hit the cap).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.decode.greedy import greedy_decode as jax_greedy_decode
from rnn_transducer_tpu.decode.greedy import recognize_greedy as jax_recognize
from rnn_transducer_tpu.models import config as jax_config
from rnn_transducer_tpu.models import transducer as jm
from rnn_transducer_tpu_torch.decode.greedy import greedy_decode, recognize_greedy
from rnn_transducer_tpu_torch.models import config as port_config
from rnn_transducer_tpu_torch.models import transducer as tm
from rnn_transducer_tpu_torch.weights import params_from_numpy

pytestmark = pytest.mark.quick

SMALL = dict(input_dim=8, enc_layers=2, enc_hidden=16, time_reduction=2,
             pred_layers=1, pred_hidden=12, embed_dim=10, joint_dim=14,
             vocab_size=11, compute_dtype="float32")
JCFG = jax_config.TransducerConfig(**SMALL)
TCFG = port_config.TransducerConfig(**SMALL)
MAX_SYMBOLS = 30


def walking_params(blank_offset=0.04, seed=3):
    p = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed),
                                                JCFG))
    p["joint"]["out"]["b"] = p["joint"]["out"]["b"].copy()
    p["joint"]["out"]["b"][JCFG.blank] += blank_offset
    return p


def batch(seed=1, B=5, T=40):
    rng = np.random.default_rng(seed)
    feats = (3 * rng.normal(size=(B, T, SMALL["input_dim"]))).astype(np.float32)
    lens = np.array([40, 33, 21, 0, 7], np.int32)[:B]  # with a zero-length row
    return feats, lens


def _jax_out(p, feats, lens, max_symbols=MAX_SYMBOLS):
    out = jax_recognize(jax.tree.map(jnp.asarray, p), JCFG,
                        jnp.asarray(feats), jnp.asarray(lens),
                        max_symbols=max_symbols, with_confidence=True,
                        with_timestamps=True)
    return [np.asarray(a) for a in out]


def _port_out(p, feats, lens, max_symbols=MAX_SYMBOLS):
    out = recognize_greedy(params_from_numpy(p), TCFG,
                           torch.from_numpy(feats), torch.from_numpy(lens),
                           max_symbols=max_symbols, with_confidence=True,
                           with_timestamps=True)
    return [a.numpy() for a in out]


def _assert_same(got, want):
    (tok, n, conf, fr), (tok_w, n_w, conf_w, fr_w) = got, want
    np.testing.assert_array_equal(n, n_w)
    np.testing.assert_array_equal(tok, tok_w)
    np.testing.assert_array_equal(fr, fr_w)
    np.testing.assert_allclose(conf, conf_w, atol=1e-5, rtol=0)


def test_recognize_greedy_matches_jax():
    p = walking_params()
    feats, lens = batch()
    want = _jax_out(p, feats, lens)
    got = _port_out(p, feats, lens)
    _assert_same(got, want)
    n, frames = got[1], got[3]
    # the decode walked: tokens below the cap, emitted at several frames,
    # some late in the utterance; the zero-length row emits nothing
    assert 0 < n.max() < MAX_SYMBOLS and n[3] == 0
    emitted_at = {int(frames[b, i]) for b in range(len(n)) for i in range(n[b])}
    assert len(emitted_at) > 1


def test_greedy_decode_state_matches_jax():
    p = walking_params()
    feats, lens = batch(seed=2)
    enc, enc_lens = jm.encode(jax.tree.map(jnp.asarray, p), JCFG,
                              jnp.asarray(feats), jnp.asarray(lens))
    tok_w, n_w, st_w = jax_greedy_decode(jax.tree.map(jnp.asarray, p), JCFG,
                                         enc, enc_lens, MAX_SYMBOLS)
    tok, n, st = greedy_decode(params_from_numpy(p), TCFG,
                               torch.from_numpy(np.array(enc)),
                               torch.from_numpy(np.array(enc_lens)),
                               MAX_SYMBOLS)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_w))
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_w))
    # frame_off, t_over and the predictor carry
    np.testing.assert_array_equal(st[4].numpy(), np.asarray(st_w[4]))
    np.testing.assert_array_equal(st[7].numpy(), np.asarray(st_w[7]))
    np.testing.assert_allclose(st[5].numpy(), np.asarray(st_w[5]), atol=1e-5)


@pytest.mark.parametrize("max_symbols", [1, 4])
def test_max_symbols_cap_matches_jax(max_symbols):
    """Blank pushed far down: every row with frames stops at the cap."""
    p = walking_params(blank_offset=-50.0)
    feats, lens = batch(seed=4)
    want = _jax_out(p, feats, lens, max_symbols)
    got = _port_out(p, feats, lens, max_symbols)
    _assert_same(got, want)
    assert got[1].tolist() == [max_symbols] * 3 + [0, max_symbols]


def test_all_rows_empty_decodes_nothing():
    p = walking_params()
    feats, _ = batch(B=2)
    tok, n = recognize_greedy(params_from_numpy(p), TCFG,
                              torch.from_numpy(feats),
                              torch.zeros(2, dtype=torch.int32), 5)
    assert n.tolist() == [0, 0] and (tok == TCFG.blank).all()


def test_decode_state_carry_is_not_ported():
    p = params_from_numpy(walking_params())
    enc, lens = tm.encode(p, TCFG, *map(torch.from_numpy, batch()))
    with pytest.raises(NotImplementedError, match="streaming"):
        greedy_decode(p, TCFG, enc, lens, 5, decode_state=())
