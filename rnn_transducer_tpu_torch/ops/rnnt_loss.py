"""RNN-Transducer loss, plain PyTorch (port of `rnn_transducer_tpu/ops/rnnt_loss.py`).

The lattice conventions are the JAX package's: the stand-in NEG_INF is
-1e30, cells past a length are masked by `_masked_transitions`, the
terminal blank is the acceptance score injected at (t_len-1, u_len), and
an utterance with zero frames has loss 0 and zero gradient.

The alpha and beta recursions, and the occupancies with them, run in
`ops/rnnt_lattice_cuda.py`: on the card in the K3 kernel (`csrc/lattice.cu`,
one launch for alpha and one for beta with the occupancies), on the CPU
along the same anti-diagonals in plain PyTorch. They are called through
the module attribute, so that a caller can swap in the plain versions on
the card. The masking and the final gathers stay PyTorch here. This module
is the `loss_impl="xla"` path, and every loss route of the port (xla,
fused, two-pass) goes through its `forward_from_lp_with_alpha` and
`occupancies_from_lp`.
"""

from __future__ import annotations

import torch

from rnn_transducer_tpu_torch.ops import rnnt_lattice_cuda
from rnn_transducer_tpu_torch.ops.rnnt_lattice_cuda import NEG_INF


def _masked_transitions(lp_blank, lp_y, frame_lens, label_lens):
    """Emit is legal while u < label_len (and t < frame_len); blank within
    the lattice while t + 1 < frame_len and u <= label_len."""
    B, T, U1 = lp_blank.shape
    dev = lp_blank.device
    t_ids = torch.arange(T, device=dev)[None, :, None]
    u_ids = torch.arange(U1, device=dev)[None, None, :]
    t_len = frame_lens.to(dev, torch.int64)[:, None, None]
    u_len = label_lens.to(dev, torch.int64)[:, None, None]
    emit_ok = (u_ids < u_len) & (t_ids < t_len)
    blank_ok = (t_ids + 1 < t_len) & (u_ids <= u_len)
    neg = torch.full((), NEG_INF, dtype=lp_blank.dtype, device=dev)
    return torch.where(blank_ok, lp_blank, neg), torch.where(emit_ok, lp_y, neg)


def _accept_scores(lp_blank, frame_lens, label_lens):
    """The acceptance (terminal blank) score injected at (t_len-1, u_len)."""
    B, T, U1 = lp_blank.shape
    dev = lp_blank.device
    t_ids = torch.arange(T, device=dev)[None, :, None]
    u_ids = torch.arange(U1, device=dev)[None, None, :]
    is_terminal = ((t_ids == frame_lens.to(dev, torch.int64)[:, None, None] - 1)
                   & (u_ids == label_lens.to(dev, torch.int64)[:, None, None]))
    return torch.where(is_terminal, lp_blank,
                       torch.full((), NEG_INF, dtype=lp_blank.dtype,
                                  device=dev))


def forward_from_lp_with_alpha(lp_blank, lp_y, frame_lens, label_lens):
    """Per-utterance loss (B,) and alpha (B, T, U1) from the blank and label
    log-probs (B, T, U1)."""
    lp_blank_m, lp_y_m = _masked_transitions(lp_blank, lp_y, frame_lens,
                                             label_lens)
    alpha = rnnt_lattice_cuda.alpha_wavefront(lp_blank_m, lp_y_m)
    B = lp_blank.shape[0]
    dev = lp_blank.device
    b_idx = torch.arange(B, device=dev)
    fl = frame_lens.to(dev, torch.int64)
    valid = fl >= 1
    t_last = torch.clamp(fl, min=1) - 1
    u_last = label_lens.to(dev, torch.int64)
    log_z = alpha[b_idx, t_last, u_last] + lp_blank[b_idx, t_last, u_last]
    return torch.where(valid, -log_z, torch.zeros_like(log_z)), alpha


def occupancies_from_lp(lp_blank, lp_y, frame_lens, label_lens, alpha=None):
    """Blank and emit arc posteriors g_blank, g_y (B, T, U1):
    d(-log Z)/d lp_blank = -g_blank, d(-log Z)/d lp_y = -g_y."""
    lp_blank_m, lp_y_m = _masked_transitions(lp_blank, lp_y, frame_lens,
                                             label_lens)
    accept = _accept_scores(lp_blank, frame_lens, label_lens)
    if alpha is None:
        alpha = rnnt_lattice_cuda.alpha_wavefront(lp_blank_m, lp_y_m)
    _, g_blank, g_y = rnnt_lattice_cuda.beta_occupancies(
        lp_blank_m, lp_y_m, accept, alpha, frame_lens)
    return g_blank, g_y


def _gather_label_logprobs(log_probs, labels):
    """lp_y[b, t, u] = log_probs[b, t, u, labels[b, u]] for u < U, NEG_INF
    at u = U."""
    B, T, U1, V = log_probs.shape
    U = U1 - 1
    idx = labels.to(log_probs.device, torch.int64)[:, None, :, None]
    lp_y = torch.gather(log_probs[:, :, :U], 3,
                        idx.expand(B, T, U, 1))[..., 0]
    pad = torch.full((B, T, 1), NEG_INF, dtype=log_probs.dtype,
                     device=log_probs.device)
    return torch.cat([lp_y, pad], dim=2)


def _grad_from_occupancies(log_probs, labels, occ, g_blank, g_y, blank):
    """dlogits (B, T, U1, V) f32, materialised from the log-softmax:
    exp(log_probs) occ - [v = blank] g_blank - [v = label] g_y."""
    B, T, U1, V = log_probs.shape
    grad = torch.exp(log_probs) * occ[..., None]
    grad[..., blank] -= g_blank
    idx = labels.to(grad.device, torch.int64)[:, None, :, None].expand(
        B, T, U1 - 1, 1)
    grad[:, :, :U1 - 1].scatter_add_(3, idx, -g_y[:, :, :U1 - 1, None])
    return grad


class _RNNTLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, frame_lens, label_lens, blank,
                fastemit_lambda):
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        lp_blank = log_probs[..., blank]
        lp_y = _gather_label_logprobs(log_probs, labels)
        loss, alpha = forward_from_lp_with_alpha(lp_blank, lp_y, frame_lens,
                                                 label_lens)
        ctx.save_for_backward(log_probs, labels, frame_lens, label_lens,
                              alpha)
        ctx.blank, ctx.fastemit = blank, fastemit_lambda
        ctx.logits_dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        log_probs, labels, frame_lens, label_lens, alpha = ctx.saved_tensors
        lp_blank = log_probs[..., ctx.blank]
        lp_y = _gather_label_logprobs(log_probs, labels)
        g_blank, g_y = occupancies_from_lp(lp_blank, lp_y, frame_lens,
                                           label_lens, alpha=alpha)
        if ctx.fastemit:
            g_y = g_y * (1.0 + ctx.fastemit)
        grad = _grad_from_occupancies(log_probs, labels, g_blank + g_y,
                                      g_blank, g_y, ctx.blank)
        grad = grad * g.float()[:, None, None, None]
        return grad.to(ctx.logits_dtype), None, None, None, None, None


def rnnt_loss(logits, labels, frame_lens, label_lens, blank: int = 0,
              fastemit_lambda: float = 0.0):
    """Per-utterance RNN-T negative log-likelihood (B,) over materialised
    logits (B, T, U+1, V), with the occupancy gradient. fastemit_lambda
    scales the emit-arc gradient by (1 + lambda) and leaves the loss value
    as it is (FastEmit). The `loss_impl="xla"` path, and the plain
    reference of the fused op."""
    return _RNNTLoss.apply(logits, labels, frame_lens, label_lens, blank,
                           fastemit_lambda)
