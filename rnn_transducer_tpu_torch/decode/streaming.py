"""Streaming chunked inference (PyTorch port of
`rnn_transducer_tpu/decode/streaming.py`).

The utterance arrives in fixed-size chunks of frames; the encoder's
carried state (the LSTM's per-layer (h, c), or the causal conformer's
attention and conv caches), the prediction network's state and the
emitted tokens are carried across chunks, so the transcript grows chunk
by chunk. Each chunk runs `encode_chunk` and the offline decode loop
(`greedy_decode`, or `beam_search` with its carry) on the carried state.

The encoder must stream: a unidirectional LSTM, or a conformer with
enc_att_left > 0 or enc_chunk_att > 0. The chunk's frame count must be a
multiple of the encoder's time_reduction (and, for chunked attention, the
encoded chunk a multiple of enc_chunk_att).

The JAX package jits one chunk step; here a step is a plain call. What the
jit hoists out of its loop, the decode weights (`DecodeWeights`: int8
params dequantized, weights rounded to the compute dtype), a stream builds
once: `stream_transcribe*` once a call, and a caller that keeps a stream
open (the serving engine) passes its own `decode_weights` to every step.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from rnn_transducer_tpu_torch.decode.beam import (_tree_map, beam_search,
                                                  init_beam_state,
                                                  sorted_frames)
from rnn_transducer_tpu_torch.decode.greedy import greedy_decode
from rnn_transducer_tpu_torch.models import transducer as m
from rnn_transducer_tpu_torch.models.config import TransducerConfig


class StreamState(NamedTuple):
    enc_state: Any  # encode_chunk's carry
    decode_state: Any  # greedy: (u, tokens, confs, frames, frame_off,
    #                      pred_out, pred_states, t_over); beam: the carry
    #                      of init_beam_state / beam_search


def select_rows(mask, new, old):
    """The tree of `new` on the rows where mask (B,) bool is set and of
    `old` elsewhere: every leaf of a stream state has the batch first."""
    def sel(n, o):
        return torch.where(mask.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)

    return _tree_map(sel, new, old)


def init_stream(params, cfg: TransducerConfig, batch: int,
                max_symbols: int = 200, *,
                device: str | torch.device = "cuda",
                decode_weights=None) -> StreamState:
    """A fresh greedy stream of `batch` rows on `device`."""
    dw = decode_weights or m.DecodeWeights(params, cfg)
    dev = torch.device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    pred0, states0 = dw.predict_step(
        torch.full((batch,), cfg.blank, dtype=torch.int64, device=dev),
        m.init_pred_state(cfg, batch, dev))
    decode_state = (
        torch.zeros((batch,), **i32),
        torch.full((batch, max_symbols), cfg.blank, **i32),
        torch.zeros((batch, max_symbols), dtype=torch.float32, device=dev),
        torch.zeros((batch, max_symbols), **i32),  # emit-frame indices
        torch.zeros((batch,), **i32),  # global frame offset
        pred0,
        states0,
        torch.zeros((batch,), **i32),  # multi-blank jump overshoot
    )
    return StreamState(m.init_enc_state(cfg, batch, dev), decode_state)


def stream_chunk(params, cfg: TransducerConfig, state: StreamState,
                 feats_chunk, chunk_lens, max_symbols: int = 200, *,
                 decode_weights=None):
    """Feed one chunk -> (state', tokens (B, max_symbols), lens (B,)).

    tokens and lens hold the whole transcript so far."""
    enc_out, enc_lens, enc_state = m.encode_chunk(
        params, cfg, feats_chunk, chunk_lens, state.enc_state)
    tokens, lens, decode_state = greedy_decode(
        params, cfg, enc_out, enc_lens, max_symbols=max_symbols,
        decode_state=state.decode_state, decode_weights=decode_weights)
    return StreamState(enc_state, decode_state), tokens, lens


def init_stream_beam(params, cfg: TransducerConfig, batch: int, *,
                     beam: int = 8, max_symbols: int = 200, lm=None,
                     context=None, ngram=None,
                     device: str | torch.device = "cuda",
                     decode_weights=None) -> StreamState:
    """A fresh beam stream; the fusion tables must lie on `device`."""
    return StreamState(
        m.init_enc_state(cfg, batch, device),
        init_beam_state(params, cfg, batch, beam=beam,
                        max_symbols=max_symbols, lm=lm, context=context,
                        ngram=ngram, device=device,
                        decode_weights=decode_weights))


def stream_chunk_beam(params, cfg: TransducerConfig, state: StreamState,
                      feats_chunk, chunk_lens, *, beam: int = 8,
                      max_symbols: int = 200, expansions: int = 3, lm=None,
                      context=None, ngram=None, decode_weights=None):
    """Streaming beam search: the beams (with prefix merging) carry across
    chunks, and so does a context trie's node, so partial phrase matches
    span chunk boundaries. Returns (state', tokens (B, K, U), lens (B, K),
    scores (B, K)), beams best first."""
    enc_out, enc_lens, enc_state = m.encode_chunk(
        params, cfg, feats_chunk, chunk_lens, state.enc_state)
    tokens, lens, scores, beam_state = beam_search(
        params, cfg, enc_out, enc_lens, beam=beam, max_symbols=max_symbols,
        expansions=expansions, beam_state=state.decode_state, lm=lm,
        context=context, ngram=ngram, decode_weights=decode_weights)
    return StreamState(enc_state, beam_state), tokens, lens, scores


def _chunks(feats, feat_lens, chunk_frames: int, device):
    """(chunk (B, chunk_frames, F), chunk_lens (B,)) of a padded batch,
    its frames zero-padded to a multiple of chunk_frames."""
    feats = torch.as_tensor(feats).to(device)
    feat_lens = torch.as_tensor(feat_lens).to(device=device,
                                              dtype=torch.int32)
    T = feats.shape[1]
    n_chunks = -(-T // chunk_frames)
    feats = F.pad(feats, (0, 0, 0, n_chunks * chunk_frames - T))
    for i in range(n_chunks):
        yield (feats[:, i * chunk_frames:(i + 1) * chunk_frames],
               torch.clamp(feat_lens - i * chunk_frames, 0, chunk_frames))


def stream_transcribe(params, cfg: TransducerConfig, feats, feat_lens,
                      chunk_frames: int, max_symbols: int = 200,
                      with_timestamps: bool = False, *,
                      device: str | torch.device = "cuda"):
    """A whole padded batch through the streaming path on `device`, chunk
    by chunk. Returns (tokens, lens) as recognize_greedy does, and with
    with_timestamps=True the (B, max_symbols) global encoder frame of each
    token."""
    dw = m.DecodeWeights(params, cfg)
    state = init_stream(params, cfg, feats.shape[0], max_symbols,
                        device=device, decode_weights=dw)
    tokens = lens = None
    for chunk, cl in _chunks(feats, feat_lens, chunk_frames, device):
        state, tokens, lens = stream_chunk(params, cfg, state, chunk, cl,
                                           max_symbols, decode_weights=dw)
    if with_timestamps:
        return tokens, lens, state.decode_state[3]
    return tokens, lens


def stream_transcribe_beam(params, cfg: TransducerConfig, feats, feat_lens,
                           chunk_frames: int, *, beam: int = 8,
                           max_symbols: int = 200, expansions: int = 3,
                           lm=None, context=None, ngram=None,
                           with_timestamps: bool = False,
                           device: str | torch.device = "cuda"):
    """A whole padded batch through the streaming beam path (cf.
    stream_transcribe). Returns (tokens (B, K, U), lens, scores) and with
    with_timestamps=True the per-token (B, K, U) emission frames."""
    dw = m.DecodeWeights(params, cfg)
    state = init_stream_beam(params, cfg, feats.shape[0], beam=beam,
                             max_symbols=max_symbols, lm=lm, context=context,
                             ngram=ngram, device=device, decode_weights=dw)
    tokens = lens = scores = None
    for chunk, cl in _chunks(feats, feat_lens, chunk_frames, device):
        state, tokens, lens, scores = stream_chunk_beam(
            params, cfg, state, chunk, cl, beam=beam,
            max_symbols=max_symbols, expansions=expansions, lm=lm,
            context=context, ngram=ngram, decode_weights=dw)
    if with_timestamps:
        return tokens, lens, scores, sorted_frames(state.decode_state,
                                                   context)
    return tokens, lens, scores
