"""Multi-blank RNN-T loss (PyTorch port of
`rnn_transducer_tpu/ops/rnnt_multiblank.py`; Xu et al., ICASSP 2023).

Besides the standard blank (one frame), the joint emits K big blanks that
consume durations[k] > 1 frames at once (logit columns V..V+K-1,
softmaxed with the vocabulary). The loss marginalises over every
alignment, the jumps included, on the consumed-frames grid of
`ops/duration_lattice.py`: a blank of duration d is an arc (d, 0), an
emission an arc (0, 1) on its frame. Duration-1 blanks alone give the
standard RNN-T loss. The JAX package trains it at the xla tier (autodiff
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
    ds = (1,) + tuple(int(d) for d in durations)
    if any(d <= 1 for d in ds[1:]):
        raise ValueError(f"big-blank durations must be > 1: {durations}")
    return ds


def rnnt_loss_multiblank(logits, labels, frame_lens, label_lens, durations,
                         blank: int = 0):
    """Per-utterance NLL (B,) f32 of the multi-blank transducer.

    logits: (B, T, U+1, V + K), the last K columns the big blanks, K =
    len(durations); labels: (B, U) int (< V, never a blank column);
    frame_lens, label_lens: (B,); durations: each > 1."""
    _check_durations(durations)
    check_tf32(logits, "multi-blank loss")
    V = logits.shape[-1] - len(durations)
    cols = (blank,) + tuple(V + k for k in range(len(durations)))
    lp = torch.log_softmax(logits.float(), dim=-1)
    lp_y = _gather_label_logprobs(lp, labels)
    lp_blanks = torch.stack([lp[..., c] for c in cols], dim=-1)
    return rnnt_loss_multiblank_from_lp(lp_blanks, lp_y, frame_lens,
                                        label_lens, durations)


def rnnt_loss_multiblank_from_lp(lp_blanks, lp_y, frame_lens, label_lens,
                                 durations):
    """The loss from per-cell log-prob streams: lp_blanks (B, T, U+1, K+1),
    column 0 the standard blank, then one a big-blank duration in the
    order of `durations`; lp_y (B, T, U+1) the label log-probs."""
    ds = _check_durations(durations)
    check_tf32(lp_y, "multi-blank loss")
    B, T, U1 = lp_y.shape
    dev = lp_y.device
    t_ids = torch.arange(T, device=dev)[None, :, None]
    u_ids = torch.arange(U1, device=dev)[None, None, :]
    t_len = frame_lens.to(dev, torch.int64)[:, None, None]
    u_len = label_lens.to(dev, torch.int64)[:, None, None]
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    # an emission at row tau reads frame tau: legal while tau < t_len
    planes = [torch.where((u_ids < u_len) & (t_ids < t_len),
                          lp_y.float(), neg)]
    arcs = [(0, 1)]
    # a blank of duration d from row tau consumes frames tau..tau+d-1,
    # each of which must be valid (acceptance by exact consumption)
    for j, d in enumerate(ds):
        planes.append(torch.where((t_ids + d <= t_len) & (u_ids <= u_len),
                                  lp_blanks[..., j].float(), neg))
        arcs.append((d, 0))
    return duration_walk(torch.stack(planes), frame_lens, label_lens, arcs)


def duration_table(vocab_size: int, durations, n_classes: int = 0,
                   device: str | torch.device = "cuda"):
    """Frames a greedy step advances by per emitted class id, (n_classes,)
    int32 on `device`: 1 for the standard blank (and, unused, for labels),
    durations[k] for big blank k."""
    n = n_classes or vocab_size + len(durations)
    durs = torch.ones((n,), dtype=torch.int32)
    for k, d in enumerate(durations):
        durs[vocab_size + k] = int(d)
    return durs.to(device)
