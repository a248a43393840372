"""RNN-Transducer loss, plain PyTorch (port of `rnn_transducer_tpu/ops/rnnt_loss.py`).

The lattice conventions are the JAX package's: the stand-in NEG_INF is
-1e30, cells past a length are masked by `_masked_transitions`, the
terminal blank is the acceptance score injected at (t_len-1, u_len), and
an utterance with zero frames has loss 0 and zero gradient.

The alpha and beta recursions run along anti-diagonals d = t + u: every
cell of a diagonal depends only on the diagonal before it, so each step is
one vectorised update over (B, U+1), and a lattice takes T + U steps. The
JAX package runs them as a scan over t with a log-depth row solve
(`_alpha_scan`, `_beta_scan`, rnnt_loss.py:99-164); the two give the same
values up to float32 summation order. The JAX package's Pallas wavefront
(K3, `ops/rnnt_lattice_pallas.py`) is off by default, so these stay plain
PyTorch on the card too.
"""

from __future__ import annotations

import torch

NEG_INF = -1.0e30


def _logaddexp(a, b):
    """logaddexp that keeps a doubly masked cell at NEG_INF."""
    mx = torch.maximum(a, b)
    mn = torch.minimum(a, b)
    out = mx + torch.log1p(torch.exp(mn - mx))
    return torch.where(mx <= NEG_INF * 0.5,
                       torch.full_like(out, NEG_INF), out)


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


def _skew_index(T: int, U1: int, device):
    """(D, U1) time index t = d - u of diagonal d, and its validity."""
    D = T + U1 - 1
    t = (torch.arange(D, device=device)[:, None]
         - torch.arange(U1, device=device)[None, :])
    return t.clamp(0, max(T - 1, 0)), (t >= 0) & (t < T)


def _skew(x, t_idx, valid):
    """(B, T, U1) -> (B, D, U1) with s[:, d, u] = x[:, d - u, u], NEG_INF
    off the lattice."""
    B, T, U1 = x.shape
    idx = t_idx[None].expand(B, -1, -1)
    s = torch.gather(x, 1, idx)
    return torch.where(valid[None], s, torch.full_like(s, NEG_INF))


def _unskew(s, T: int):
    """(B, D, U1) -> (B, T, U1): x[:, t, u] = s[:, t + u, u]."""
    B, D, U1 = s.shape
    idx = (torch.arange(T, device=s.device)[:, None]
           + torch.arange(U1, device=s.device)[None, :])
    return torch.gather(s, 1, idx[None].expand(B, -1, -1))


def _alpha(lp_blank_m, lp_y_m):
    """alpha (B, T, U1): alpha[t, u] = logaddexp(alpha[t-1, u] +
    lp_blank[t-1, u], alpha[t, u-1] + lp_y[t, u-1]), alpha[0, 0] = 0."""
    B, T, U1 = lp_blank_m.shape
    dev = lp_blank_m.device
    t_idx, valid = _skew_index(T, U1, dev)
    lpb = _skew(lp_blank_m, t_idx, valid)
    lpy = _skew(lp_y_m, t_idx, valid)
    D = T + U1 - 1
    neg_col = torch.full((B, 1), NEG_INF, dtype=lp_blank_m.dtype, device=dev)
    rows = [torch.cat([torch.zeros_like(neg_col),
                       neg_col.expand(B, U1 - 1)], dim=1)]
    for d in range(1, D):
        prev = rows[-1]
        below = prev + lpb[:, d - 1]
        left = torch.cat([neg_col, (prev + lpy[:, d - 1])[:, :-1]], dim=1)
        row = torch.maximum(_logaddexp(below, left),
                            torch.full_like(below, NEG_INF))
        rows.append(torch.where(valid[d][None], row, neg_col))
    return _unskew(torch.stack(rows, dim=1), T)


def _beta(lp_blank_m, lp_y_m, accept):
    """beta (B, T, U1): beta[t, u] = logaddexp(accept[t, u],
    lp_blank[t, u] + beta[t+1, u], lp_y[t, u] + beta[t, u+1])."""
    B, T, U1 = lp_blank_m.shape
    dev = lp_blank_m.device
    t_idx, valid = _skew_index(T, U1, dev)
    lpb = _skew(lp_blank_m, t_idx, valid)
    lpy = _skew(lp_y_m, t_idx, valid)
    acc = _skew(accept, t_idx, valid)
    D = T + U1 - 1
    neg_col = torch.full((B, 1), NEG_INF, dtype=lp_blank_m.dtype, device=dev)
    nxt = neg_col.expand(B, U1)
    rows = [None] * D
    for d in reversed(range(D)):
        down = lpb[:, d] + nxt
        right = lpy[:, d] + torch.cat([nxt[:, 1:], neg_col], dim=1)
        row = _logaddexp(_logaddexp(acc[:, d], down), right)
        row = torch.maximum(row, torch.full_like(row, NEG_INF))
        nxt = torch.where(valid[d][None], row, neg_col)
        rows[d] = nxt
    return _unskew(torch.stack(rows, dim=1), T)


def forward_from_lp_with_alpha(lp_blank, lp_y, frame_lens, label_lens):
    """Per-utterance loss (B,) and alpha (B, T, U1) from the blank and label
    log-probs (B, T, U1)."""
    lp_blank_m, lp_y_m = _masked_transitions(lp_blank, lp_y, frame_lens,
                                             label_lens)
    alpha = _alpha(lp_blank_m, lp_y_m)
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
        alpha = _alpha(lp_blank_m, lp_y_m)
    beta = _beta(lp_blank_m, lp_y_m, accept)
    B, T, U1 = lp_blank.shape
    log_z = beta[:, 0, 0][:, None, None]
    neg = torch.full((), NEG_INF, dtype=beta.dtype, device=beta.device)
    beta_down = torch.cat([beta[:, 1:], neg.expand(B, 1, U1)], dim=1)
    beta_right = torch.cat([beta[:, :, 1:], neg.expand(B, T, 1)], dim=2)
    arc_blank = _logaddexp(lp_blank_m + beta_down, accept)
    valid = (frame_lens.to(beta.device, torch.int64) >= 1)[:, None, None]
    zero = torch.zeros((), dtype=beta.dtype, device=beta.device)
    g_blank = torch.where(valid, torch.exp(alpha + arc_blank - log_z), zero)
    g_y = torch.where(valid, torch.exp(alpha + lp_y_m + beta_right - log_z),
                      zero)
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
        B, T, U1, V = log_probs.shape
        grad = torch.exp(log_probs) * (g_blank + g_y)[..., None]
        grad[..., ctx.blank] -= g_blank
        idx = labels.to(grad.device, torch.int64)[:, None, :, None].expand(
            B, T, U1 - 1, 1)
        grad[:, :, :U1 - 1].scatter_add_(3, idx, -g_y[:, :, :U1 - 1, None])
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
