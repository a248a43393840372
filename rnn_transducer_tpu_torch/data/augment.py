"""SpecAugment and speed perturbation on log-mel batches (PyTorch port of
`rnn_transducer_tpu/data/augment.py`).

Each transform is two functions: a draw, which takes every random number
the transform needs from a `torch.Generator` (time-warp anchors and
displacements, mask starts and widths, speed factors), and an apply,
which computes the transform from the draws alone with the JAX
function's arithmetic. `spec_augment` and `speed_perturb` chain the two.
The JAX function given its own draws and the apply given the same draws
agree; the draws themselves come from another generator and differ.

The trainer draws on the CPU (a few numbers a row) and applies on the
batch's device, to the whole batch before it is split over ranks.
"""

from __future__ import annotations

import torch


def _uniform(gen, shape, device):
    return torch.rand(shape, generator=gen, dtype=torch.float32).to(device)


def draw_spec_augment(gen: torch.Generator, B: int, F: int, *,
                      n_time_masks: int = 2, time_mask_frames: int = 20,
                      n_freq_masks: int = 2, freq_mask_bins: int = 15,
                      time_warp_frames: int = 0,
                      device: str | torch.device = "cpu") -> dict:
    """SpecAugment's draws for a batch of B rows of F bins:
    tw (B, n_time_masks) mask widths in [0, time_mask_frames], u (B,
    n_time_masks) uniforms that place each time mask in its row, fw / fs
    (B, n_freq_masks) widths in [0, freq_mask_bins] and starts in [0,
    max(F - freq_mask_bins, 1)); with time_warp_frames = W > 0 also
    warp_u (B,) uniforms for the anchor and warp_d (B,) displacements in
    [-W, W)."""
    d = {"tw": torch.randint(0, time_mask_frames + 1, (B, n_time_masks),
                             generator=gen).to(device),
         "u": _uniform(gen, (B, n_time_masks), device),
         "fw": torch.randint(0, freq_mask_bins + 1, (B, n_freq_masks),
                             generator=gen).to(device),
         "fs": torch.randint(0, max(F - freq_mask_bins, 1),
                             (B, n_freq_masks), generator=gen).to(device)}
    if time_warp_frames > 0:
        W = float(time_warp_frames)
        d["warp_u"] = _uniform(gen, (B,), device)
        d["warp_d"] = _uniform(gen, (B,), device) * (2 * W) - W
    return d


def apply_time_warp(feats, feat_lens, warp_u, warp_d, W: int):
    """Park et al.'s time warp from its draws: the anchor w0 = W + warp_u
    (hi - W), hi = max(len - W, W + 1), moves to w0 + warp_d, and the
    valid frames are warped piecewise linearly around it (frames 0 and
    len - 1 stay). Rows of len <= 2W and the padding stay as they are."""
    B, T, F = feats.shape
    dev = feats.device
    lens = feat_lens.to(device=dev, dtype=torch.float32)
    L1 = lens - 1.0
    lo = torch.full((B,), float(W), device=dev)
    hi = torch.maximum(lens - W, lo + 1.0)
    w0 = lo + warp_u * (hi - lo)
    w1 = torch.clamp(w0 + warp_d, min=1.0)
    w1 = torch.minimum(w1, torch.clamp(L1 - 1.0, min=1.0))
    t = torch.arange(T, dtype=torch.float32, device=dev)[None, :]
    left = t * (w0 / w1)[:, None]
    right = (w0[:, None] + (t - w1[:, None])
             * ((L1 - w0) / torch.clamp(L1 - w1, min=1e-6))[:, None])
    src = torch.where(t <= w1[:, None], left, right)
    src = torch.minimum(torch.clamp(src, min=0.0),
                        torch.clamp(L1[:, None], min=0.0))
    src = torch.where((lens > 2.0 * W)[:, None], src, t)
    i0 = torch.floor(src).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=T - 1)
    frac = (src - i0.to(torch.float32))[:, :, None]
    f0 = torch.take_along_dim(feats, i0[:, :, None], dim=1)
    f1 = torch.take_along_dim(feats, i1[:, :, None], dim=1)
    out = f0 * (1.0 - frac) + f1 * frac
    valid = (t < lens[:, None])[:, :, None]
    return torch.where(valid, out, feats)


def apply_spec_augment(feats, feat_lens, draws: dict,
                       time_warp_frames: int = 0):
    """feats (B, T, F) -> the masked (and, with time_warp_frames > 0 and
    the warp draws, warped) copy. Masks never pass a row's valid frames."""
    B, T, F = feats.shape
    dev = feats.device
    if time_warp_frames > 0:
        feats = apply_time_warp(feats, feat_lens, draws["warp_u"],
                                draws["warp_d"], time_warp_frames)
    t_ids = torch.arange(T, dtype=torch.int32, device=dev)[None, None, :]
    f_ids = torch.arange(F, dtype=torch.int32, device=dev)[None, None, :]
    tw = draws["tw"].to(torch.int32)
    max_start = torch.clamp(feat_lens.to(device=dev, dtype=torch.int32)
                            [:, None] - tw, min=1)
    ts = torch.minimum((draws["u"] * max_start).to(torch.int32),
                       max_start - 1)
    t_masked = ((t_ids >= ts[:, :, None])
                & (t_ids < (ts + tw)[:, :, None])).any(dim=1)
    fw = draws["fw"].to(torch.int32)
    fs = draws["fs"].to(torch.int32)
    f_masked = ((f_ids >= fs[:, :, None])
                & (f_ids < (fs + fw)[:, :, None])).any(dim=1)
    keep = (~t_masked)[:, :, None] & (~f_masked)[:, None, :]
    return torch.where(keep, feats, 0.0)


def spec_augment(gen: torch.Generator, feats, feat_lens, **kw):
    """Draw and apply SpecAugment (keywords of `draw_spec_augment`)."""
    B, _, F = feats.shape
    draws = draw_spec_augment(gen, B, F, device=feats.device, **kw)
    return apply_spec_augment(feats, feat_lens, draws,
                              kw.get("time_warp_frames", 0))


def draw_speed_perturb(gen: torch.Generator, B: int, n_factors: int,
                       device: str | torch.device = "cpu"):
    """Each row's factor index, (B,) in [0, n_factors)."""
    return torch.randint(0, n_factors, (B,), generator=gen).to(device)


def apply_speed_perturb(feats, feat_lens, idx, factors=(0.9, 1.0, 1.1)):
    """Feature-domain speed perturbation from its draws: row b reads input
    position i * f, f = factors[idx[b]], by linear interpolation (f > 1
    is faster speech, fewer frames); its new length ceil(len / f) is
    clipped to T, and frames past it are zero. f = 1 is the identity.
    Returns (feats', feat_lens')."""
    B, T, F = feats.shape
    dev = feats.device
    fac = torch.tensor(factors, dtype=torch.float32, device=dev)
    f = fac[idx.to(dev).long()]
    lens = feat_lens.to(device=dev, dtype=torch.int32)
    pos = torch.arange(T, dtype=torch.float32, device=dev)[None, :] \
        * f[:, None]
    last = torch.clamp(lens - 1, min=0).to(torch.float32)[:, None]
    pos = torch.minimum(pos, last)
    lo = torch.floor(pos).to(torch.int64)
    frac = (pos - lo.to(torch.float32))[:, :, None]
    hi = torch.minimum(lo + 1, torch.clamp(lens - 1, min=0)[:, None].long())

    def take(ix):
        return torch.take_along_dim(feats, ix[:, :, None], dim=1)

    out = (1.0 - frac) * take(lo) + frac * take(hi)
    new_lens = torch.clamp(torch.ceil(lens.to(torch.float32) / f - 1e-6)
                           .to(torch.int32), 0, T)
    new_lens = torch.where(lens == 0, 0, torch.clamp(new_lens, min=1))
    valid = torch.arange(T, dtype=torch.int32, device=dev)[None, :] \
        < new_lens[:, None]
    return torch.where(valid[:, :, None], out, 0.0), \
        new_lens.to(feat_lens.dtype)


def speed_perturb(gen: torch.Generator, feats, feat_lens,
                  factors=(0.9, 1.0, 1.1)):
    """Draw and apply the speed perturbation."""
    idx = draw_speed_perturb(gen, feats.shape[0], len(factors), feats.device)
    return apply_speed_perturb(feats, feat_lens, idx, factors)
