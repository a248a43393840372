"""CTC loss (Graves 2006): PyTorch port of
`rnn_transducer_tpu/ops/ctc_loss.py`.

The JAX package runs it as an XLA scan, with no Pallas kernel; the port
runs it as plain PyTorch on the caller's device: a loop over the frames of
vectorised steps over the (B, 2U+1) extended-label lattice, in f32 log
space. The JAX conventions hold: NEG_INF is -1e30, not -inf, so a dead
lattice (a label sequence the frames cannot hold) gives a loss of about
1e30 and zero occupancy, where `F.ctc_loss` gives inf; steps past an
utterance's frames are the identity.

`ctc_loss` differentiates through the loop (autograd), as JAX's
`ctc_loss` does through its scan. `ctc_loss_from_logits` takes raw
logits and has the analytic backward of the JAX `_ctc_vjp`: the forward
keeps every alpha, the backward runs one reverse beta loop and returns
dL/dlogits = softmax(logits) * occupied - occupancy, the occupancy of
each extended state scattered onto the vocabulary by an f32 product with
its one-hot. That product runs with TF32 off (JAX forces HIGHEST
precision there); a CUDA call with `torch.backends.cuda.matmul.allow_tf32`
on is refused rather than rounded. The backward runs under a
`ctc_backward` profiler span (train/loop.py names the forward's `ctc`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1.0e30


def _extend_labels(labels, blank: int):
    """(B, U) -> (B, 2U+1) blank-interleaved: [b, l1, b, l2, ..., b]."""
    B, U = labels.shape
    ext = torch.full((B, 2 * U + 1), blank, dtype=labels.dtype,
                     device=labels.device)
    ext[:, 1::2] = labels
    return ext


def _lattice_tables(labels, label_lens, blank: int):
    """Extended-label lattice constants: z (B, S) int64, can_skip (B, S)
    (the s-2 -> s arc: z[s] not blank and not z[s-2]), s_len (B,)."""
    z = _extend_labels(labels.to(torch.int64), blank)
    prev2 = torch.cat([torch.full_like(z[:, :2], -1), z[:, :-2]], dim=1)
    can_skip = (z != blank) & (z != prev2)
    s_len = 2 * label_lens.to(device=z.device, dtype=torch.int64) + 1
    return z, can_skip, s_len


def _lse3(stacked):
    """log(e^a + e^b + e^c) over stacked (3, B, S), the JAX package's
    expression (max, then the log of the sum of exponentials). JAX's
    NEG_INF clamp (NEG_INF where all three are dead) needs no select
    here: every input is at least NEG_INF = -1e30, so a dead max is
    -1e30 exactly, and -1e30 + log(3) and every log-prob added after it
    round back to -1e30 in f32."""
    m = stacked.amax(dim=0)
    return torch.log(torch.exp(stacked - m).sum(dim=0)) + m


def _skip_bias(can_skip):
    """0 where the skip arc exists, NEG_INF where it does not: added to the
    skip term, it leaves a value at or below NEG_INF that adds nothing to
    a live sum (JAX selects NEG_INF there)."""
    return torch.where(can_skip, 0.0, NEG_INF)


def _final_total(alpha, s_len):
    """log P: alpha at the last state and the one before it (s_len-1,
    s_len-2), NEG_INF for a dead lattice."""
    B = alpha.shape[0]
    rows = torch.arange(B, device=alpha.device)
    last = alpha[rows, s_len - 1]
    last2 = torch.where(s_len >= 2,
                        alpha[rows, torch.clamp(s_len - 2, min=0)],
                        NEG_INF)
    m = torch.maximum(last, last2)
    m_safe = torch.clamp(m, min=NEG_INF)
    total = m_safe + torch.log(torch.exp(last - m_safe)
                               + torch.exp(last2 - m_safe))
    return torch.where(m <= NEG_INF * 0.5, NEG_INF, total)


def _alpha_scan(lp_z, can_skip, frame_lens, s_len, keep: bool = False):
    """The forward recursion over lp_z (B, T, S), the per-state frame
    log-probs. Returns (alphas (T, B, S) when keep else None, the
    per-utterance loss (B,)). Frames at t >= frame_len leave alpha as it
    is. A frame is ~12 launches: the shifts are views of one padded copy
    and the three arcs one stacked log-sum-exp."""
    B, T, S = lp_z.shape
    dev = lp_z.device
    s_ids = torch.arange(S, device=dev)[None, :]
    alpha = torch.where((s_ids < 2) & (s_ids < s_len[:, None]), lp_z[:, 0],
                        NEG_INF)
    active = (torch.arange(T, device=dev)[:, None]
              < frame_lens.to(device=dev)[None, :])[:, :, None]  # (T, B, 1)
    bias = _skip_bias(can_skip)
    alphas = [alpha] if keep else None
    for t in range(1, T):
        p = F.pad(alpha, (2, 0), value=NEG_INF)  # p[:, s + 2] = alpha[s]
        tot = _lse3(torch.stack((alpha, p[:, 1:-1], p[:, :-2] + bias)))
        new = torch.clamp(tot + lp_z[:, t], min=NEG_INF)
        alpha = torch.where(active[t], new, alpha)
        if keep:
            alphas.append(alpha)
    loss = -_final_total(alpha, s_len)
    return (torch.stack(alphas) if keep else None), loss


def ctc_loss(log_probs, labels, frame_lens, label_lens, blank: int = 0):
    """Per-utterance CTC negative log-likelihood (B,) of log_probs (B, T,
    V), log-softmax outputs, for labels (B, U); differentiable through the
    recursion."""
    log_probs = log_probs.float()
    z, can_skip, s_len = _lattice_tables(labels, label_lens, blank)
    B, T, _ = log_probs.shape
    lp_z = torch.gather(log_probs, 2, z[:, None, :].expand(B, T, -1))
    return _alpha_scan(lp_z, can_skip, frame_lens, s_len)[1]


def ctc_loss_from_logits(logits, labels, frame_lens, label_lens,
                         blank: int = 0):
    """Per-utterance CTC loss (B,) on raw logits (B, T, V), with the
    analytic backward (module docstring). The forward value equals
    `ctc_loss(log_softmax(logits), ...)`."""
    if logits.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the CTC occupancy product runs in f32; "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    return _CtcFromLogits.apply(logits.float(), labels, frame_lens,
                                label_lens, blank)


class _CtcFromLogits(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, frame_lens, label_lens, blank):
        B, T, _ = logits.shape
        dev = logits.device
        z, can_skip, s_len = _lattice_tables(labels.to(dev), label_lens,
                                             blank)
        frame_lens = frame_lens.to(device=dev, dtype=torch.int64)
        log_zeta = torch.logsumexp(logits, dim=-1)  # (B, T)
        lp_z = (torch.gather(logits, 2, z[:, None, :].expand(B, T, -1))
                - log_zeta[:, :, None])  # (B, T, S)
        alphas, loss = _alpha_scan(lp_z, can_skip, frame_lens, s_len,
                                   keep=True)
        ctx.save_for_backward(logits, log_zeta, lp_z, alphas, loss, z,
                              can_skip, s_len, frame_lens)
        return loss

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function("ctc_backward"):
            return _ctc_backward(ctx, g)


def _ctc_backward(ctx, g):
    """The analytic backward of `_CtcFromLogits` (JAX `_ctc_bwd`): one
    reverse beta loop (~12 launches a frame, as the forward), then the
    occupancy of every frame at once, then dL/dlogits."""
    (logits, log_zeta, lp_z, alphas, loss, z, can_skip, s_len,
     frame_lens) = ctx.saved_tensors
    B, T, V = logits.shape
    S = z.shape[1]
    dev = logits.device
    s_ids = torch.arange(S, device=dev)[None, :]
    # beta at the last frame: 0 at the two final states
    beta = torch.where((s_ids == s_len[:, None] - 1)
                       | (s_ids == s_len[:, None] - 2), 0.0, NEG_INF)
    # the skip arc s -> s+2 exists where can_skip[s+2]
    bias = _skip_bias(torch.cat([can_skip[:, 2:],
                                 torch.zeros_like(can_skip[:, :2])], dim=1))
    valid = (torch.arange(T, device=dev)[:, None]
             < frame_lens[None, :])[:, :, None]  # (T, B, 1)
    betas = torch.empty((T, B, S), dtype=torch.float32, device=dev)
    betas[T - 1] = beta
    for t in range(T - 2, -1, -1):
        bl = beta + lp_z[:, t + 1]
        p = F.pad(bl, (0, 2), value=NEG_INF)  # p[:, s] = bl[s]
        cand = _lse3(torch.stack((bl, p[:, 1:-1], p[:, 2:] + bias)))
        # steps at and after the end of the utterance are the identity
        beta = torch.where(valid[t + 1], cand, beta)
        betas[t] = beta
    occ = torch.where(valid, torch.exp(torch.clamp(
        alphas + betas + loss[None, :, None], max=0.0)), 0.0)
    occ = occ.permute(1, 0, 2)  # (B, T, S)
    # a dead lattice's loss is ~1e30: its occupancies are zero
    occ = torch.where((loss < -NEG_INF * 0.5)[:, None, None], occ, 0.0)
    # the S -> V scatter of the occupancy as an f32 product with the
    # one-hot of z (JAX: einsum at HIGHEST precision)
    onehot = torch.zeros((B, S, V), dtype=torch.float32, device=dev)
    onehot.scatter_(2, z[:, :, None], 1.0)
    occ_v = torch.bmm(occ, onehot)
    softmax = torch.exp(logits - log_zeta[:, :, None])
    occ_sum = torch.where(valid[:, :, 0].T, occ.sum(dim=2), 0.0)  # (B, T)
    dlogits = (softmax * occ_sum[:, :, None] - occ_v) * g[:, None, None]
    return dlogits, None, None, None, None
