"""The port's wake-time beam search for the duration families
(`decode/beam.py`: multi-blank arcs, the TDT duration fork, asleep beams
in the pool) against the JAX package's on the CPU, after
tests/test_beam_duration.py.

On the recipe models of tests/test_torch_multiblank.py (random weights
made to emit and jump) and a random encoder output: every live beam's
tokens, lengths and frames equal, scores within 1e-4 and confidences
within 1e-5, for the multi-blank model, the TDT model and a TDT set
without duration 0; the beams carried over 3-frame chunks (jumps asleep
across the boundaries) equal to one offline call; `stream_transcribe_beam`
equal to `recognize_beam` through the encoder.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rnn_transducer_tpu.decode import beam as jb
from rnn_transducer_tpu_torch.decode import beam as tb
from rnn_transducer_tpu_torch.decode import streaming as tstreaming
from rnn_transducer_tpu_torch.weights import params_from_numpy
from test_torch_beam import assert_same_beams
from test_torch_multiblank import (SMALL, _j, _t, configs, encoder_output,
                                   family_params)

pytestmark = pytest.mark.quick

KW = dict(beam=4, max_symbols=10, expansions=2)
FAMILIES = ["multiblank", "tdt", "tdt_no_zero"]


def _port_nbest(params, cfg, enc, lens, state=None):
    tok, n, sc, carry = tb.beam_search(params, cfg, _t(enc), _t(lens),
                                       beam_state=state, **KW)
    return [tok.numpy(), n.numpy(), sc.numpy(),
            tb.sorted_confidence(carry).numpy(),
            tb.sorted_frames(carry).numpy()], carry


@pytest.mark.parametrize("family", FAMILIES)
def test_beam_matches_jax(family):
    jcfg, cfg = configs(family)
    p_np = family_params(family)
    enc, lens = encoder_output(family)
    tok, n, sc, carry = jb.beam_search(jax.tree.map(jnp.asarray, p_np), jcfg,
                                       _j(enc), _j(lens), **KW)
    want = [np.asarray(a) for a in (tok, n, sc, jb.sorted_confidence(carry),
                                    jb.sorted_frames(carry))]
    got, carry_t = _port_nbest(params_from_numpy(p_np), cfg, enc, lens)
    live = assert_same_beams(got, want)
    assert got[1][live].max() >= 2  # the recipe's beams emit
    # the carried wake: equal, re-based past the call's frames
    np.testing.assert_array_equal(carry_t[4]["wake"].numpy(),
                                  np.asarray(carry[4]["wake"]))


@pytest.mark.parametrize("family", FAMILIES)
def test_chunked_beams_equal_offline(family):
    """beam_search over 3-frame pieces with the carried beams: a beam
    asleep in a jump past a piece's end wakes in the next one, and the
    n-best is the offline call's."""
    _, cfg = configs(family)
    params = params_from_numpy(family_params(family))
    enc, lens = encoder_output(family)
    want, _ = _port_nbest(params, cfg, enc, lens)
    state = tb.init_beam_state(params, cfg, enc.shape[0], beam=KW["beam"],
                               max_symbols=KW["max_symbols"], device="cpu")
    asleep = 0
    for c0 in range(0, enc.shape[1], 3):
        cl = np.clip(lens - c0, 0, 3).astype(np.int32)
        got, state = _port_nbest(params, cfg, enc[:, c0:c0 + 3], cl, state)
        asleep += int((state[4]["wake"] > 0).sum())
    assert_same_beams(got, want)
    assert asleep > 0  # some beam slept across a boundary


@pytest.mark.parametrize("family", ["multiblank", "tdt"])
def test_stream_transcribe_beam_equals_recognize_beam(family):
    _, cfg = configs(family)
    params = params_from_numpy(family_params(family))
    rng = np.random.default_rng(11)
    feats = (2 * rng.normal(size=(3, 16, SMALL["input_dim"]))).astype(
        np.float32)
    lens = np.array([16, 9, 5], np.int32)
    got = tstreaming.stream_transcribe_beam(params, cfg, _t(feats), _t(lens),
                                            4, device="cpu", **KW)
    want = tb.recognize_beam(params, cfg, _t(feats), _t(lens), **KW)
    live = want[2].numpy() > -5e29
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy()[live], w.numpy()[live])
    np.testing.assert_allclose(got[2].numpy()[live], want[2].numpy()[live],
                               atol=1e-4, rtol=0)
