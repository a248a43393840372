"""Batched greedy RNN-T decoding (PyTorch port of
`rnn_transducer_tpu/decode/greedy.py`).

The whole batch advances in lock-step: each utterance keeps its own
lattice cursor (t, u), prediction-network state and done flag; finished
utterances are masked, not branched on. Per iteration: gather each
utterance's current encoder frame, run one joint evaluation, emit the
argmax or advance time. Worst-case iteration count is T + max_symbols.

The JAX `lax.while_loop` becomes a Python `while` over batched tensor ops;
its condition `any(~done)` is one host sync per iteration.
"""

from __future__ import annotations

import torch

from rnn_transducer_tpu_torch.models import transducer as m
from rnn_transducer_tpu_torch.models.config import TransducerConfig


def greedy_decode(params, cfg: TransducerConfig, enc_out, enc_lens,
                  max_symbols: int = 200, decode_state=None):
    """Greedy decode a batch of encoded utterances (standard model).

    Args:
      enc_out: (B, T, De) encoder outputs. enc_lens: (B,) valid frames.
      max_symbols: cap on emitted labels per utterance.

    Returns:
      tokens: (B, max_symbols) int32, blank-padded.
      lengths: (B,) number of emitted labels.
      decode_state: (u, tokens, confs, frames, frame_off, pred_out,
        pred_states, t_over) as in the JAX function; confs[b, i] is the
        emitted token's log-probability and frames[b, i] the encoder frame
        it was emitted at, both 0 past the length.
    """
    m.check_supported(cfg)
    if decode_state is not None:
        raise NotImplementedError(
            "carried decode_state (streaming) is not ported yet (ROADMAP "
            "queue 1, item 4: streaming)")
    B = enc_out.shape[0]
    dev = enc_out.device
    enc_lens = enc_lens.to(device=dev, dtype=torch.int32)
    rows = torch.arange(B, device=dev)
    blank = torch.full((B,), cfg.blank, dtype=torch.int64, device=dev)

    pred_out, states = m.predict_step(params, cfg, blank,
                                      m.init_pred_state(cfg, B, dev))
    t = torch.zeros((B,), dtype=torch.int32, device=dev)
    u = torch.zeros((B,), dtype=torch.int32, device=dev)
    tokens = torch.full((B, max_symbols), cfg.blank, dtype=torch.int32,
                        device=dev)
    confs = torch.zeros((B, max_symbols), dtype=torch.float32, device=dev)
    frames = torch.zeros((B, max_symbols), dtype=torch.int32, device=dev)
    done = (t >= enc_lens) | (u >= max_symbols)

    while bool((~done).any()):  # one host sync per iteration
        # Current encoder frame per utterance. The clamp at 0 covers
        # zero-length rows (already done), where JAX's gather wraps -1.
        t_safe = torch.clamp(torch.minimum(t, enc_lens - 1), min=0)
        enc_t = enc_out[rows, t_safe.long()]
        logits = m.joint_step(params, cfg, enc_t, pred_out)  # (B, V) fp32
        k = torch.argmax(logits, dim=-1)
        is_blank = (k == cfg.blank) | (k >= cfg.vocab_size)
        emit = ~(is_blank | done)
        # Emit: write token + its log-prob at position u, bump u, step
        # the predictor. Emitting rows have u < max_symbols.
        k_lp = (logits.gather(1, k[:, None])[:, 0]
                - torch.logsumexp(logits, dim=-1))
        u_w = torch.clamp(u, max=max_symbols - 1).long()
        tokens[rows, u_w] = torch.where(emit, k.to(torch.int32),
                                        tokens[rows, u_w])
        confs[rows, u_w] = torch.where(emit, k_lp, confs[rows, u_w])
        frames[rows, u_w] = torch.where(emit, t, frames[rows, u_w])
        new_pred, new_states = m.predict_step(
            params, cfg, torch.where(emit, k, blank), states)
        e = emit[:, None]
        pred_out = torch.where(e, new_pred, pred_out)
        states = [(torch.where(e, hn, h), torch.where(e, cn, c))
                  for (hn, cn), (h, c) in zip(new_states, states)]
        u = u + emit.to(torch.int32)
        t = t + (is_blank & ~done).to(torch.int32)
        done = (t >= enc_lens) | (u >= max_symbols)

    t_over = torch.clamp(t - enc_lens, min=0)
    return tokens, u, (u, tokens, confs, frames, enc_lens, pred_out, states,
                       t_over)


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
