"""Token-and-Duration Transducer (TDT) loss (PyTorch port of
`rnn_transducer_tpu/ops/rnnt_tdt.py`; Xu et al. 2023).

A second joint head (`models/transducer.joint_tdt`) predicts how many
frames each emission consumes, from a fixed duration set such as (0, 1,
2, 4); P(k, d | t, u) = P_tok(k) P_dur(d). On the consumed-frames grid of
`ops/duration_lattice.py`, a token of duration d is an arc (d, 1), a
blank of duration d >= 1 an arc (d, 0); a blank may not take duration 0
(a self-loop). The JAX package trains it at the xla tier (autodiff
through its scan); the port runs the lattice as a plain PyTorch
anti-diagonal walk with an analytic backward, on the caller's device.
"""

from __future__ import annotations

import torch

from rnn_transducer_tpu_torch.ops.duration_lattice import (NEG_INF,
                                                           check_tf32,
                                                           duration_walk)
from rnn_transducer_tpu_torch.ops.rnnt_loss import _gather_label_logprobs


def _check_durations(durations) -> tuple:
    ds = tuple(int(d) for d in durations)
    if len(set(ds)) != len(ds) or any(d < 0 for d in ds) \
            or not any(d >= 1 for d in ds):
        raise ValueError(f"bad TDT duration set {durations}")
    return ds


def rnnt_loss_tdt(logits, dur_logits, labels, frame_lens, label_lens,
                  durations, blank: int = 0):
    """Per-utterance NLL (B,) f32 of the TDT model.

    logits: (B, T, U+1, V) token logits; dur_logits: (B, T, U+1, D) over
    `durations` (non-negative, unique, at least one >= 1) in its order;
    labels: (B, U) int; frame_lens, label_lens: (B,)."""
    ds = _check_durations(durations)
    B, T, U1, _ = logits.shape
    if tuple(dur_logits.shape) != (B, T, U1, len(ds)):
        raise ValueError(f"dur_logits {tuple(dur_logits.shape)} vs "
                         f"durations {ds}")
    check_tf32(logits, "TDT loss")
    lp_tok = torch.log_softmax(logits.float(), dim=-1)
    lp_dur = torch.log_softmax(dur_logits.float(), dim=-1)
    return rnnt_loss_tdt_from_lp(lp_tok[..., blank],
                                 _gather_label_logprobs(lp_tok, labels),
                                 lp_dur, frame_lens, label_lens, ds)


def rnnt_loss_tdt_from_lp(lp_b, lp_y, lp_dur, frame_lens, label_lens,
                          durations):
    """The loss from per-cell log-prob streams: lp_b, lp_y (B, T, U+1) the
    blank and label token log-probs, lp_dur (B, T, U+1, D) the duration
    log-probs in the order of `durations`."""
    ds = _check_durations(durations)
    check_tf32(lp_y, "TDT loss")
    B, T, U1 = lp_y.shape
    dev = lp_y.device
    t_ids = torch.arange(T, device=dev)[None, :, None]
    u_ids = torch.arange(U1, device=dev)[None, None, :]
    t_len = frame_lens.to(dev, torch.int64)[:, None, None]
    u_len = label_lens.to(dev, torch.int64)[:, None, None]
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    lp_b, lp_y, lp_dur = lp_b.float(), lp_y.float(), lp_dur.float()
    planes, arcs = [], []
    for j, d in enumerate(ds):
        # every consumed frame must be valid, and the source frame exist
        frames_ok = (t_ids < t_len) & (t_ids + d <= t_len)
        planes.append(torch.where(frames_ok & (u_ids < u_len),
                                  lp_y + lp_dur[..., j], neg))
        arcs.append((d, 1))
        if d >= 1:
            planes.append(torch.where(frames_ok & (u_ids <= u_len),
                                      lp_b + lp_dur[..., j], neg))
            arcs.append((d, 0))
    return duration_walk(torch.stack(planes), frame_lens, label_lens, arcs)
