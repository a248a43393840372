"""Pruned RNN-T training (port of `rnn_transducer_tpu/ops/rnnt_pruned.py`).

The k2 recipe (Kuang et al., "Pruned RNN-T for fast, memory-efficient ASR
training") in three steps:

  1. a simple first pass (`simple_lp`): per-frame and per-label
     projections to V combine additively, so its full-lattice loss costs
     O(T U V) with no J factor;
  2. pruning bounds from that lattice's arc posteriors (`prune_bounds`):
     a monotone, jump-limited window start s_begin (B, T), in closed form;
  3. the joint evaluated only on the (T, S) band (`_pruned_lp`, K6 on the
     card) and the loss restricted to paths inside it
     (`rnnt_loss_banded`).

`alignment_bounds` builds the same kind of band around a reference
alignment instead (alignment-restricted RNN-T, `train/loop.py`'s `ar`).

The banded lattice. The JAX package runs it as scans over t in window
coordinates (`_alpha_band`, `_beta_band`). The port scatters the (B, T, S)
band scores into the (B, T, U+1) lattice, NEG_INF off the band, and runs
the full lattice's alpha, beta and occupancies (`ops/rnnt_loss.py`, on the
K3 kernel on the card), then gathers back. That is exact: a cell off the
band has NEG_INF on both of its outgoing arcs, so whatever alpha it gets
from the band it passes on nothing, and its beta and occupancies are zero
-- log Z and every in-band occupancy are the banded scans' up to f32
summation order. One difference remains, at the origin: the banded alpha
starts at u = s_begin[0] with 0, where the full lattice starts at u = 0.
The bounds start the band at 0 unless a frame count too short for the
labels forces them up (`bounds_from_centers`' terminal raise); then the
labels before s_begin[0] get free emission arcs (score 0) in frame 0, so
alpha at the band's first cell is 0 as in JAX.
"""

from __future__ import annotations

import torch

from rnn_transducer_tpu_torch.ops.lstm import _dot
from rnn_transducer_tpu_torch.ops.rnnt_band_fused import band_lp_fused
from rnn_transducer_tpu_torch.ops.rnnt_loss import (
    NEG_INF,
    forward_from_lp_with_alpha,
    occupancies_from_lp,
    rnnt_loss_from_lp,
)

# ------------------------- simple (trivial) joiner ------------------------


def simple_lp(am, lm, labels, blank: int):
    """Blank and label log-probs of the additive joiner, (B, T, U+1) each
    (JAX `simple_lp` :50).

    am (B, T, V) per-frame logits, lm (B, U+1, V) per-label-position
    logits; cell (t, u) scores log_softmax_v(am[t] + lm[u]). The normaliser
    is exp(am - max) . exp(lm - max)^T, a (B, T, V) x (B, U+1, V)^T product,
    so the (B, T, U+1, V) sum is never materialised. The label pick of am
    is an f32 one-hot product, as in JAX: its gradient is another product,
    not a scatter-add (whose atomics change the bits from run to run).
    """
    B, T, V = am.shape
    am_max = am.amax(dim=-1, keepdim=True)
    lm_max = lm.amax(dim=-1, keepdim=True)
    M = torch.matmul(torch.exp(am - am_max),
                     torch.exp(lm - lm_max).transpose(1, 2))
    lse = (torch.log(torch.clamp(M, min=torch.finfo(torch.float32).tiny))
           + am_max + lm_max.transpose(1, 2))
    lp_blank = am[:, :, blank][:, :, None] + lm[:, None, :, blank] - lse
    lab = labels.to(am.device, torch.int64)
    U = lab.shape[1]
    v_ids = torch.arange(V, device=am.device)
    onehot = (lab[..., None] == v_ids).to(torch.float32)   # (B, U, V)
    am_y = torch.matmul(am, onehot.transpose(1, 2))         # (B, T, U)
    zero = torch.zeros((), dtype=lm.dtype, device=lm.device)
    lm_y = torch.where(v_ids == lab[..., None], lm[:, :-1, :], zero).sum(-1)
    lp_y = am_y + lm_y[:, None, :] - lse[:, :, :-1]
    pad = torch.full((B, T, 1), NEG_INF, dtype=lp_y.dtype, device=lp_y.device)
    return lp_blank, torch.cat([lp_y, pad], dim=-1)


# ---------------------------- pruning bounds ------------------------------

def _ceil_to(x, q: int):
    """x rounded up to a multiple of q (x >= 0)."""
    return -torch.div(-x, q, rounding_mode="floor") * q


def prune_bounds(occ, pruned_range: int, frame_lens, label_lens,
                 quantize: int = 1):
    """Window starts s_begin (B, T) int32 from the first pass's total arc
    posterior occ (B, T, U+1) (JAX `prune_bounds` :94): centred on each
    frame's argmax (the earliest on a tie, as jnp.argmax), then made
    feasible by `bounds_from_centers`."""
    center = torch.argmax(occ, dim=-1)
    return bounds_from_centers(center, occ.shape[2], pruned_range,
                               frame_lens, label_lens, quantize,
                               offset=pruned_range // 2)


def bounds_from_centers(center, U1: int, pruned_range: int, frame_lens,
                        label_lens, quantize: int = 1, offset=None):
    """Feasible window starts (B, T) int32 from per-frame band centres
    (JAX `bounds_from_centers` :118): clip, quantize, the monotone running
    max, the jump cap (S - 1, or its largest multiple of `quantize`), and
    the terminal raise that keeps (t_len - 1, u_len) inside the band.
    `offset` shifts the start below the centre (default S // 2)."""
    B, T = center.shape
    dev = center.device
    S = min(pruned_range, U1)
    if offset is None:
        offset = S // 2
    q = quantize
    step = S - 1 if q == 1 else max(1, (S - 1) // q) * q
    # with quantization the start cap rounds up: the window may overhang
    # the top of the lattice, and the banded loss masks the overhang
    hi = U1 - S if q == 1 else -(-(U1 - S) // q) * q
    t_ids = torch.arange(T, device=dev)[None, :]
    t_len = frame_lens.to(dev, torch.int64)[:, None]
    u_len = label_lens.to(dev, torch.int64)[:, None]

    raw = torch.clamp(center.to(torch.int64) - offset, 0, hi)
    if q > 1:
        raw = torch.div(raw, q, rounding_mode="floor") * q
    raw[:, 0] = 0
    # past t_len the centre is garbage: freeze it at the terminal target
    final_lo = torch.clamp(u_len - S + 1, 0, hi)
    if q > 1:
        final_lo = torch.clamp(_ceil_to(final_lo, q), 0, hi)
    raw = torch.where(t_ids < t_len, raw, final_lo)
    m = torch.cummax(raw, dim=1).values
    # jump cap: c[t] = min_{j <= t} (m[j] + (t - j) step)
    c = t_ids * step + torch.cummin(m - t_ids * step, dim=1).values
    # terminal raise: s_begin[t] >= final_lo - (t_len - 1 - t) step
    lo = final_lo - torch.clamp(t_len - 1 - t_ids, min=0) * step
    sb = torch.maximum(c, torch.clamp(lo, min=0))
    return torch.clamp(sb, 0, hi).to(torch.int32)


def alignment_bounds(emit_frames, T: int, pruned_range: int, frame_lens,
                     label_lens, U1: int, quantize: int = 1,
                     left_labels=None):
    """Window starts (B, T) int32 around a per-label alignment (JAX
    `alignment_bounds` :162; alignment-restricted RNN-T, Mahadeokar et
    al. 2021). emit_frames (B, U): the frame at which label u is emitted
    on the reference path (positions >= label_len ignored). The centre at
    frame t is the path's label column after frame t, #{u < label_len :
    emit_frames[u] <= t}; the band keeps `left_labels` positions behind it
    (default S // 2) and the rest ahead."""
    B, U = emit_frames.shape
    dev = emit_frames.device
    S = min(pruned_range, U1)
    if left_labels is None:
        left_labels = S // 2
    t_ids = torch.arange(T, device=dev)[None, :, None]
    u_ids = torch.arange(U, device=dev)[None, None, :]
    valid_u = u_ids < label_lens.to(dev, torch.int64)[:, None, None]
    emitted = (emit_frames.to(torch.int64)[:, None, :] <= t_ids) & valid_u
    center = emitted.to(torch.int64).sum(dim=2)
    return bounds_from_centers(center, U1, pruned_range, frame_lens,
                               label_lens, quantize, offset=left_labels)


# --------------------------- banded lattice -------------------------------

def _band_u(s_begin, S: int):
    """u = s_begin[t] + s, (B, T, S) int64."""
    return (s_begin.to(torch.int64)[:, :, None]
            + torch.arange(S, device=s_begin.device)[None, None, :])


def _scatter_band(x, u, U1: int, fill: float):
    """(B, T, S) band values -> (B, T, U1) lattice, `fill` off the band;
    cells with u >= U1 (a quantized overhang) are dropped."""
    B, T, _ = x.shape
    full = torch.full((B, T, U1 + 1), fill, dtype=x.dtype, device=x.device)
    full.scatter_(2, u.clamp(max=U1), x)  # column U1 collects the overhang
    return full[:, :, :U1].contiguous()


def _gather_band(full, u, U1: int):
    """(B, T, U1) lattice -> (B, T, S) band, 0 past the lattice's top."""
    B, T, _ = full.shape
    pad = torch.zeros((B, T, 1), dtype=full.dtype, device=full.device)
    return torch.gather(torch.cat([full, pad], dim=2), 2, u.clamp(max=U1))


def _band_lattice(lpb_w, lpy_w, s_begin, U1: int):
    """The band scores in lattice coordinates, and the band's u grid."""
    B, T, S = lpb_w.shape
    u = _band_u(s_begin, S)
    lpb = _scatter_band(lpb_w, u, U1, NEG_INF)
    lpy = _scatter_band(lpy_w, u, U1, NEG_INF)
    # free emissions into the band's first cell when it starts above u = 0
    # (see the module docstring)
    below = (torch.arange(U1, device=lpb.device)[None, :]
             < s_begin[:, :1].to(torch.int64))
    lpy[:, 0] = torch.where(below, torch.zeros_like(lpy[:, 0]), lpy[:, 0])
    return lpb, lpy, u


def _band_loss(lpb_w, s_begin, alpha_w, frame_lens, label_lens):
    """-log Z per utterance in window coordinates, as JAX `_band_forward`
    (:281): NEG_INF log Z when the terminal lies outside the band, 0 for
    an utterance with no frames."""
    B, T, S = lpb_w.shape
    dev = lpb_w.device
    b_idx = torch.arange(B, device=dev)
    fl = frame_lens.to(dev, torch.int64)
    valid = fl >= 1
    t_last = torch.clamp(fl, min=1) - 1
    s_last = label_lens.to(dev, torch.int64) - s_begin.to(torch.int64)[
        b_idx, t_last]
    s_ok = (s_last >= 0) & (s_last < S)
    s_c = s_last.clamp(0, S - 1)
    log_z = alpha_w[b_idx, t_last, s_c] + lpb_w[b_idx, t_last, s_c]
    log_z = torch.where(s_ok, log_z, torch.full_like(log_z, NEG_INF))
    return torch.where(valid, -log_z, torch.zeros_like(log_z))


class _RNNTLossBanded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lp_blank_w, lp_y_w, s_begin, frame_lens, label_lens, U1,
                fastemit_lambda):
        lpb_w = lp_blank_w.float().contiguous()
        lpb, lpy, u = _band_lattice(lpb_w, lp_y_w.float(), s_begin, U1)
        _, alpha = forward_from_lp_with_alpha(lpb, lpy, frame_lens,
                                              label_lens)
        loss = _band_loss(lpb_w, s_begin, _gather_band(alpha, u, U1),
                          frame_lens, label_lens)
        ctx.save_for_backward(lpb, lpy, u, frame_lens, label_lens, alpha)
        ctx.U1, ctx.fastemit = U1, fastemit_lambda
        ctx.dtypes = (lp_blank_w.dtype, lp_y_w.dtype)
        return loss

    @staticmethod
    def backward(ctx, g):
        lpb, lpy, u, frame_lens, label_lens, alpha = ctx.saved_tensors
        g_blank, g_y = occupancies_from_lp(lpb, lpy, frame_lens, label_lens,
                                           alpha=alpha)
        g_blank = _gather_band(g_blank, u, ctx.U1)
        g_y = _gather_band(g_y, u, ctx.U1)
        if ctx.fastemit:
            g_y = g_y * (1.0 + ctx.fastemit)
        scale = g.float()[:, None, None]
        return ((-g_blank * scale).to(ctx.dtypes[0]),
                (-g_y * scale).to(ctx.dtypes[1]), None, None, None, None,
                None)


def rnnt_loss_banded(lp_blank_w, lp_y_w, s_begin, frame_lens, label_lens,
                     U1: int, fastemit_lambda: float = 0.0):
    """Per-utterance RNN-T NLL (B,) restricted to the band u in
    [s_begin[t], s_begin[t] + S) (JAX `rnnt_loss_banded` :329).

    lp_blank_w, lp_y_w: (B, T, S) blank and label log-probs in window
    coordinates; U1 the full label axis. An upper bound on the full NLL,
    exact when the band covers the posterior mass. The backward is the
    banded occupancy gradient; fastemit_lambda scales the emit arcs'.
    """
    return _RNNTLossBanded.apply(lp_blank_w, lp_y_w, s_begin, frame_lens,
                                 label_lens, U1, fastemit_lambda)


# --------------------------- pruned joint + loss --------------------------

def _pruned_lp(f, g, w, b, labels, s_begin, S: int, blank: int,
               compute_dtype):
    """The joint on the band only -> (lp_blank_w, lp_y_w), (B, T, S) each
    (JAX `_pruned_lp` :416), through K6 (`band_lp_fused`; its plain
    versions on the CPU).

    f (B, T, J) and g (B, U+1, J) the per-side joint activations. The
    predictor rows are gathered per frame with an f32 one-hot product, as
    JAX does (:454-457): exact, and its transpose gives dg as a product,
    deterministic where a scatter-add is not. lab_w is 0 (the blank id) at
    u = U; lp_y is masked to NEG_INF there after K6, as in JAX, so neither
    the loss nor dlogits sees it.
    """
    B, T, _ = f.shape
    U1 = g.shape[1]
    U = labels.shape[1]
    dev = f.device
    u_c = _band_u(s_begin, S).clamp(0, U1 - 1)
    lab_pad = torch.cat([labels.to(dev, torch.int64),
                         torch.zeros((B, 1), dtype=torch.int64, device=dev)],
                        dim=1)
    lab_w = torch.gather(lab_pad[:, None, :].expand(B, T, U1), 2, u_c)
    onehot_u = (u_c[..., None] == torch.arange(U1, device=dev)).to(
        torch.float32)
    g_w = torch.matmul(onehot_u.reshape(B, T * S, U1), g.float()).reshape(
        B, T, S, -1)
    lpb_w, lpy_w = band_lp_fused(f, g_w, w, b, lab_w.to(torch.int32), blank,
                                 compute_dtype)
    lpy_w = torch.where(u_c < U, lpy_w, torch.full_like(lpy_w, NEG_INF))
    return lpb_w, lpy_w


def rnnt_loss_pruned(f, g, w, b, labels, frame_lens, label_lens, s_begin,
                     pruned_range: int, blank: int = 0,
                     compute_dtype=torch.bfloat16,
                     fastemit_lambda: float = 0.0):
    """Per-utterance pruned RNN-T loss (B,), the second pass (JAX
    `rnnt_loss_pruned` :489). s_begin (B, T) int32 window starts (from
    `prune_bounds` or `alignment_bounds`); no gradient flows into them."""
    U1 = g.shape[1]
    S = min(pruned_range, U1)
    sb = s_begin.detach()
    lpb_w, lpy_w = _pruned_lp(f, g, w, b, labels, sb, S, blank,
                              compute_dtype)
    return rnnt_loss_banded(lpb_w, lpy_w, sb, frame_lens, label_lens, U1,
                            fastemit_lambda)


def pruned_two_pass_loss(params_simple, f, g, w, b, am_in, lm_in, labels,
                         frame_lens, label_lens, pruned_range: int,
                         blank: int = 0, compute_dtype=torch.bfloat16,
                         fastemit_lambda: float = 0.0):
    """The k2 objective's two passes (JAX `pruned_two_pass_loss` :507).

    params_simple {"am": {w, b}, "lm": {w, b}}: the simple heads; am_in
    (B, T, De) the encoder output, lm_in (B, U+1, Dp) the predictor's.
    Returns (simple per utterance, pruned per utterance, s_begin); the
    bounds come from the simple lattice's occupancies on detached scores.
    """
    cd = compute_dtype
    ps = params_simple
    am = _dot(am_in, ps["am"]["w"], cd) + ps["am"]["b"].float()
    lm = _dot(lm_in, ps["lm"]["w"], cd) + ps["lm"]["b"].float()
    lpb_s, lpy_s = simple_lp(am, lm, labels, blank)
    simple_per_utt = rnnt_loss_from_lp(lpb_s, lpy_s, frame_lens, label_lens,
                                       fastemit_lambda)
    gb, gy = occupancies_from_lp(lpb_s.detach(), lpy_s.detach(), frame_lens,
                                 label_lens)
    sb = prune_bounds(gb + gy, pruned_range, frame_lens, label_lens)
    pruned_per_utt = rnnt_loss_pruned(
        f, g, w, b, labels, frame_lens, label_lens, sb, pruned_range, blank,
        compute_dtype, fastemit_lambda)
    return simple_per_utt, pruned_per_utt, sb
