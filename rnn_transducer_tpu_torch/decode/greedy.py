"""Batched greedy RNN-T decoding (PyTorch port of
`rnn_transducer_tpu/decode/greedy.py`).

The whole batch advances in lock-step: each utterance keeps its own
lattice cursor (t, u), prediction-network state and done flag; finished
utterances are masked, not branched on. Per iteration: gather each
utterance's current encoder frame, run one joint evaluation, emit the
argmax or advance time. Worst-case iteration count is T + max_symbols.

The duration families step as JAX's loop does: a multi-blank model's
winning big blank (class >= V) is a blank that skips its duration in one
iteration; a TDT model advances t by the argmax of its duration head after
every emission, token or blank (a blank of duration 0 by 1). A jump past
the last frame is carried as t_over into the next chunk.

The JAX `lax.while_loop` becomes a Python `while` over batched tensor ops;
its condition `any(~done)` is one host sync per iteration.
"""

from __future__ import annotations

import torch

from rnn_transducer_tpu_torch.decode.beam import _tree_map
from rnn_transducer_tpu_torch.models import transducer as m
from rnn_transducer_tpu_torch.models.config import TransducerConfig
from rnn_transducer_tpu_torch.ops.rnnt_multiblank import duration_table


def greedy_decode(params, cfg: TransducerConfig, enc_out, enc_lens,
                  max_symbols: int = 200, decode_state=None, *,
                  decode_weights=None):
    """Greedy decode a batch of encoded utterances.

    Args:
      enc_out: (B, T, De) encoder outputs. enc_lens: (B,) valid frames.
      max_symbols: cap on emitted labels per utterance.
      decode_state: the carry of an earlier chunk (streaming), as returned
        in the third output; None starts fresh utterances.
      decode_weights: a `DecodeWeights` of `params` built by the caller
        (a stream builds it once, not once a chunk); None builds it here.

    Returns:
      tokens: (B, max_symbols) int32, blank-padded.
      lengths: (B,) number of emitted labels.
      decode_state: (u, tokens, confs, frames, frame_off, pred_out,
        pred_states, t_over) as in the JAX function; confs[b, i] is the
        emitted token's log-probability and frames[b, i] the GLOBAL
        encoder frame it was emitted at (frame_off counts the frames of
        earlier chunks), both 0 past the length; t_over carries a
        duration jump past the chunk's end into the next chunk (0 for
        the standard model).
    """
    m.check_supported(cfg)
    # int8 params dequantized and weights rounded once, not in every step
    # (the JAX package's jit hoists them out of its loop)
    dw = decode_weights or m.DecodeWeights(params, cfg)
    B = enc_out.shape[0]
    dev = enc_out.device
    enc_lens = enc_lens.to(device=dev, dtype=torch.int32)
    rows = torch.arange(B, device=dev)
    blank = torch.full((B,), cfg.blank, dtype=torch.int64, device=dev)
    tdt = bool(cfg.tdt_durations)
    if cfg.big_blank_durations:  # frames a winning class advances by
        durs = duration_table(cfg.vocab_size, cfg.big_blank_durations,
                              cfg.n_classes, device=dev)
    if tdt:
        dvals = torch.tensor(cfg.tdt_durations, dtype=torch.int32).to(dev)

    if decode_state is None:
        pred_out, states = dw.predict_step(blank,
                                           m.init_pred_state(cfg, B, dev))
        u = torch.zeros((B,), dtype=torch.int32, device=dev)
        tokens = torch.full((B, max_symbols), cfg.blank, dtype=torch.int32,
                            device=dev)
        confs = torch.zeros((B, max_symbols), dtype=torch.float32,
                            device=dev)
        frames = torch.zeros((B, max_symbols), dtype=torch.int32,
                             device=dev)
        foff = torch.zeros((B,), dtype=torch.int32, device=dev)
        t = torch.zeros((B,), dtype=torch.int32, device=dev)
    else:
        (u, tokens, confs, frames, foff, pred_out, states,
         t) = decode_state
        if tuple(tokens.shape) != (B, max_symbols):
            raise ValueError(f"carried tokens {tuple(tokens.shape)} are not "
                             f"(B, max_symbols) = {(B, max_symbols)}")
        # the loop writes its buffers in place: the caller's carry stays
        tokens, confs, frames = tokens.clone(), confs.clone(), frames.clone()
    # t starts at the carried overshoot t_over (frames a jump past the
    # last chunk consumed; 0 for the standard model)
    done = (t >= enc_lens) | (u >= max_symbols)

    while bool((~done).any()):  # one host sync per iteration
        # Current encoder frame per utterance. The clamp at 0 covers
        # zero-length rows (already done), where JAX's gather wraps -1.
        t_safe = torch.clamp(torch.minimum(t, enc_lens - 1), min=0)
        enc_t = enc_out[rows, t_safe.long()]
        f, g = dw.enc_proj(enc_t), dw.pred_proj(pred_out)
        if tdt:
            logits, dur_logits = dw.joint_tdt(f, g)
        else:
            logits = dw.joint(f, g)
        k = torch.argmax(logits, dim=-1)
        is_blank = (k == cfg.blank) | (k >= cfg.vocab_size)  # big blanks
        emit = ~(is_blank | done)
        # Emit: write token + its log-prob at position u, bump u, step
        # the predictor. Emitting rows have u < max_symbols.
        k_lp = (logits.gather(1, k[:, None])[:, 0]
                - torch.logsumexp(logits, dim=-1))
        u_w = torch.clamp(u, max=max_symbols - 1).long()
        tokens[rows, u_w] = torch.where(emit, k.to(torch.int32),
                                        tokens[rows, u_w])
        confs[rows, u_w] = torch.where(emit, k_lp, confs[rows, u_w])
        frames[rows, u_w] = torch.where(emit, foff + t, frames[rows, u_w])
        new_pred, new_states = dw.predict_step(torch.where(emit, k, blank),
                                               states)
        e = emit[:, None]
        pred_out = torch.where(e, new_pred, pred_out)
        # the LSTM's (h, c) a layer, or the stateless label buffer
        states = _tree_map(lambda n, o: torch.where(e, n, o), new_states,
                           states)
        u = u + emit.to(torch.int32)
        # done rows freeze t, so that the carried overshoot stays exact
        if tdt:
            # every emission, token or blank, advances t by its argmax
            # duration; a blank of duration 0 (a self-loop) advances by 1
            d = dvals[torch.argmax(dur_logits, dim=-1)]
            d = torch.where(is_blank & (d == 0), 1, d)
        elif cfg.big_blank_durations:  # a big blank skips its duration
            d = torch.where(is_blank, durs[k], 0)
        else:
            d = is_blank.to(torch.int32)
        t = t + torch.where(done, 0, d)
        done = (t >= enc_lens) | (u >= max_symbols)

    t_over = torch.clamp(t - enc_lens, min=0)
    return tokens, u, (u, tokens, confs, frames, foff + enc_lens, pred_out,
                       states, t_over)


def recognize_greedy(params, cfg: TransducerConfig, feats, feat_lens,
                     max_symbols: int = 200, with_confidence: bool = False,
                     with_timestamps: bool = False):
    """Features -> label sequences (mirrors the reference `recognize` API).

    with_confidence=True appends (B, max_symbols) per-token emission
    log-probabilities; with_timestamps=True appends (B, max_symbols) int32
    encoder-frame indices each token was emitted at. Both are 0 past each
    utterance's length.
    """
    enc_out, enc_lens = m.encode(params, cfg, feats, feat_lens)
    tokens, lens, state = greedy_decode(params, cfg, enc_out, enc_lens,
                                        max_symbols)
    out = (tokens, lens)
    if with_confidence:
        out = out + (state[2],)
    if with_timestamps:
        out = out + (state[3],)
    return out
