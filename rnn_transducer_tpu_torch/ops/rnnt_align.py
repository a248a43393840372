"""Forced alignment: the Viterbi best path over the RNN-T (T, U+1) lattice
(port of `rnn_transducer_tpu/ops/rnnt_align.py`).

Within a frame row t the label recurrence V[t, u] = max(A[u], V[t, u-1] +
lp_y[t, u-1]), with A the arrival from frame t - 1 by blank, is solved as
V[t, u] = P[u] + cummax(A - P)[u], P[u] = sum_{j<u} lp_y[t, j]; the
cummax's index is the backpointer "entered row t at column k". The rows
run one after another, as JAX's scan over t. Plain PyTorch: the JAX
package has no Pallas kernel here.
"""

from __future__ import annotations

import numpy as np
import torch

from rnn_transducer_tpu_torch.ops.rnnt_loss import (
    NEG_INF,
    _gather_label_logprobs,
    _masked_transitions,
)


def _argcummax(x):
    """(values, indices) of the running maximum over the last axis; the
    earliest index wins a tie (JAX `_argcummax` :31, a strict `>`).
    `torch.cummax` keeps the last index of a tie instead, so the index is
    taken from where the running maximum last rose strictly."""
    vals = torch.cummax(x, dim=-1).values
    prev = torch.cat([torch.full_like(vals[..., :1], float("-inf")),
                      vals[..., :-1]], dim=-1)
    pos = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    rose = torch.where(x > prev, pos, torch.zeros_like(pos))
    return vals, torch.cummax(rose, dim=-1).values


def _prefix(lpy_t):
    """P[u] = sum_{j<u} lp_y[t, j], at or above NEG_INF (B, U+1)."""
    s = torch.cumsum(lpy_t[:, :-1], dim=-1)
    s = torch.cat([torch.zeros_like(lpy_t[:, :1]), s], dim=-1)
    return torch.clamp(s, min=NEG_INF)


def rnnt_viterbi(lp_blank, lp_y, frame_lens, label_lens):
    """Best-path score (B,) and backpointers K (B, T, U+1) int32 (JAX
    `rnnt_viterbi` :46). lp_blank, lp_y (B, T, U+1) transition log-probs
    (lp_y[..., U] unused). K[b, t, u] is the column at which the best path
    to (t, u) enters frame row t; row 0 enters at column 0."""
    B, T, U1 = lp_blank.shape
    dev = lp_blank.device
    lp_blank_m, lp_y_m = _masked_transitions(lp_blank, lp_y, frame_lens,
                                             label_lens)
    Vs = [_prefix(lp_y_m[:, 0])]
    Ks = [torch.zeros((B, U1), dtype=torch.int64, device=dev)]
    for t in range(1, T):
        A = torch.clamp(Vs[-1] + lp_blank_m[:, t - 1], min=NEG_INF)
        P = _prefix(lp_y_m[:, t])
        vals, idx = _argcummax(A - P)
        Vs.append(torch.clamp(P + vals, min=NEG_INF))
        Ks.append(idx)
    V_all = torch.stack(Vs, dim=1)
    K_all = torch.stack(Ks, dim=1).to(torch.int32)
    fl = frame_lens.to(dev, torch.int64)
    ll = label_lens.to(dev, torch.int64)
    t_last = torch.clamp(fl - 1, 0, T - 1)
    bi = torch.arange(B, device=dev)
    score = V_all[bi, t_last, ll] + lp_blank[bi, t_last, ll]
    return score, K_all


def backtrace_emit_frames(K, frame_lens, label_lens) -> np.ndarray:
    """Backpointers -> per-label emit frames (B, U) int32 on the host (JAX
    `backtrace_emit_frames` :96); positions >= label_len are -1."""
    K, frame_lens, label_lens = (
        np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
        for a in (K, frame_lens, label_lens))
    B, T, U1 = K.shape
    out = np.full((B, U1 - 1), -1, np.int32)
    for b in range(B):
        u = int(label_lens[b])
        for t in range(int(frame_lens[b]) - 1, 0, -1):
            k = int(K[b, t, u])
            out[b, k:u] = t
            u = k
        out[b, :u] = 0  # whatever remains was emitted in frame 0
        out[b, int(label_lens[b]):] = -1
    return out


def rnnt_forced_align(logits, labels, frame_lens, label_lens,
                      blank: int = 0):
    """Full-lattice forced alignment from joint logits (B, T, U+1, V) (JAX
    `rnnt_forced_align` :119) -> (emit_frames (B, U) numpy int32, the
    Viterbi score (B,))."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    score, K = rnnt_viterbi(lp[..., blank], _gather_label_logprobs(lp, labels),
                            frame_lens, label_lens)
    return backtrace_emit_frames(K, frame_lens, label_lens), score


def emit_frames_device(K, frame_lens, label_lens):
    """Backpointers -> per-label emit frames (B, U) int32 on the device
    (JAX `emit_frames_device` :147): colafter (B, T), the path's label
    column after each frame, by a reverse walk over the backpointer rows,
    then emit_frame[j] = #{t < frame_len : colafter[t] <= j}; -1 at
    positions >= label_len, as the host version."""
    B, T, U1 = K.shape
    dev = K.device
    fl = frame_lens.to(dev, torch.int64)
    ll = label_lens.to(dev, torch.int64)
    bi = torch.arange(B, device=dev)
    u = ll
    cols = [ll]
    for t in range(T - 1, 0, -1):
        k = K[bi, t, u].to(torch.int64)
        u = torch.where(t < fl, k, u)  # t >= 1 here
        cols.append(u)  # colafter[t - 1]
    colafter = torch.stack(cols[::-1], dim=1)  # (B, T)
    t_ids = torch.arange(T, device=dev)[None, :]
    valid_t = t_ids < fl[:, None]
    j = torch.arange(U1 - 1, device=dev)[None, None, :]
    emitted_by = (colafter[:, :, None] <= j) & valid_t[:, :, None]
    emit = emitted_by.to(torch.int64).sum(dim=1)
    return torch.where(j[0] < ll[:, None], emit,
                       torch.full_like(emit, -1)).to(torch.int32)
