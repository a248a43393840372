"""Fused joint network + RNN-T loss (port of `rnn_transducer_tpu/ops/rnnt_joint_fused.py`).

The lattice logits (B, T, U+1, V) are the largest tensor of RNN-T
training (1.07 GB in f32 at libri100's B=32, T'=200, U+1=41, V=1024).
The fused op never stores them. From the per-side joint activations
f (B, T, J) and g (B, U+1, J) each cell builds

    z = tanh(f[t] + g[u]),   logits = round(z) . W + b

on chip and reduces it at once:

  * `joint_lp_fwd` (K1, `csrc/joint_fwd.cu`) to the three (B, T, U+1)
    arrays the lattice needs: lp_blank, lp_y and base, the log-sum-exp
    that the backward reuses;
  * `joint_lp_bwd` (K2, `csrc/joint_bwd.cu`) from the occupancies to
    df, dg, dW and db: kernel A (df and dg), kernel B (dW and db: with
    bf16 W, round(z) once into a scratch and the ring of
    `csrc/zb_ring.cuh` on the tiles of `rnnt_band_fused.bwd_b_plan`,
    which K6's kernel B shares; with f32 W or other shapes, a CUDA-core
    form), then the ordered sums.

round() is the cast to the compute dtype of W (bf16 or f32) and the
products accumulate in fp32, the JAX package's `preferred_element_type`
semantics. The alpha / beta recursions between the two run on the small
(B, T, U+1) arrays through `ops/rnnt_loss.py`, in the K3 lattice kernel
(`csrc/lattice.cu`) on the card.

Each wrapper launches its kernel for a CUDA tensor and runs its
`*_reference` version, which materialises the logits, for a CPU tensor.
The TPU's padding (U+1 to a multiple of 8, V to 128 lanes, T to a tile)
and its VMEM gates (the backward variant selector) have no counterpart
here; `fused_supported` is the kernels' own limit, J <= MAX_J, and does
not depend on U or V.
"""

from __future__ import annotations

import threading

import torch

from rnn_transducer_tpu_torch.ops.lstm import _dot
from rnn_transducer_tpu_torch.ops.rnnt_band_fused import (_check_sidecars,
                                                          _record,
                                                          device_bwd_b_plan,
                                                          mma_shapes_ok)
from rnn_transducer_tpu_torch.ops.rnnt_loss import (
    NEG_INF,
    forward_from_lp_with_alpha,
    occupancies_from_lp,
)
from rnn_transducer_tpu_torch.utils import build

LAUNCHES_FWD = 0  # joint_lp_fwd calls that launched joint_fwd
LAUNCHES_BWD = 0  # joint_lp_bwd calls that launched joint_bwd
_launches_lock = threading.Lock()

# Cross-block partial sums of the backward (summed by a second, ordered
# pass, so two runs give identical bits): dg over frame tiles of
# FRAMES_PER_TILE frames; dW and db over the ring plan's row splits (8 at
# libri100) or, in kernel B's CUDA-core form, over ROW_SPLITS slices of
# the cells. At libri100 (B=32, T'=200, U+1=41, J=512, V=1024) that is
# 32 * 25 * 41 * 512 * 4 B = 67 MB for dg and 8 * 512 * 1024 * 4 B =
# 16.8 MB for dW, beside the ring's round(z) scratch zb, (N, J + 8) bf16
# for N = B * T * (U+1) cells: 273 MB.
FRAMES_PER_TILE = 8
ROW_SPLITS = 16
MAX_J = 512  # the kernels keep (64, J) tiles of z and dz in shared memory

_W_DTYPES = (torch.float32, torch.bfloat16)


def fused_supported(joint_dim: int) -> bool:
    """Whether joint_fwd and joint_bwd take a joint of this width; the
    port's counterpart of the JAX package's VMEM gate of the same name."""
    return joint_dim <= MAX_J


def _count(name: str) -> None:
    with _launches_lock:
        globals()[name] += 1


def _check(f, g, labels, w, b):
    if f.dim() != 3 or g.dim() != 3 or f.shape[0] != g.shape[0] \
            or f.shape[2] != g.shape[2]:
        raise ValueError(f"f must be (B, T, J) and g (B, U+1, J); got "
                         f"{tuple(f.shape)} and {tuple(g.shape)}")
    B, T, J = f.shape
    U1 = g.shape[1]
    if U1 < 1:
        raise ValueError("g needs at least one label position (U+1 >= 1)")
    if w.dim() != 2 or w.shape[0] != J:
        raise ValueError(f"w must be ({J}, V); got {tuple(w.shape)}")
    V = w.shape[1]
    if tuple(b.shape) != (V,):
        raise ValueError(f"b must be ({V},); got {tuple(b.shape)}")
    if tuple(labels.shape) != (B, U1 - 1):
        raise ValueError(f"labels must be ({B}, {U1 - 1}); got "
                         f"{tuple(labels.shape)}")
    for name, a in (("f", f), ("g", g), ("b", b)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {a.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32; got {labels.dtype}")
    if w.dtype not in _W_DTYPES:
        raise TypeError(f"w must be float32 or bfloat16; got {w.dtype}")
    named = (("f", f), ("g", g), ("labels", labels), ("w", w), ("b", b))
    if len({a.device for _, a in named}) != 1:
        raise ValueError("inputs on different devices")
    for name, a in named:
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# ------------------------------ forward ----------------------------------

def joint_lp_fwd(f, g, labels, w, b, blank: int = 0):
    """-> (lp_blank, lp_y, base), each (B, T, U+1) f32; logits never stored.

    f (B, T, J) f32, g (B, U+1, J) f32, labels (B, U) int32, w (J, V) in
    the compute dtype, b (V,) f32. base is the log-sum-exp of each cell's
    logits, saved for the backward; lp_y is NEG_INF at u = U.
    """
    _check(f, g, labels, w, b)
    dev = f.device
    if dev.type == "cpu":
        return joint_lp_fwd_reference(f, g, labels, w, b, blank)
    if dev.type != "cuda":
        raise ValueError(f"no joint_lp_fwd for device {dev}")
    B, T, J = f.shape
    U1, V = g.shape[1], w.shape[1]
    if J > MAX_J:
        raise ValueError(f"joint_fwd supports J <= {MAX_J}; got J = {J}")
    outs = [torch.empty((B, T, U1), dtype=torch.float32, device=dev)
            for _ in range(3)]
    if B * T == 0:
        return tuple(outs)
    fn = build.load_library()
    err = fn.joint_fwd(
        f.data_ptr(), g.data_ptr(), labels.data_ptr(), w.data_ptr(),
        int(w.dtype == torch.bfloat16), b.data_ptr(),
        *(o.data_ptr() for o in outs), B, T, U1, J, V, blank,
        *build.stream_args(dev))
    build.check_launch(fn, err, "joint_fwd")
    _count("LAUNCHES_FWD")
    return tuple(outs)


def _joint_logits(f, g, w, b):
    """z (B, T, U1, J) f32 and logits (B, T, U1, V) f32, materialised."""
    z = torch.tanh(f[:, :, None, :] + g[:, None, :, :])
    return z, _dot(z, w, w.dtype) + b


def joint_lp_fwd_reference(f, g, labels, w, b, blank: int = 0):
    """Plain version of `joint_lp_fwd`: the logits are materialised."""
    _check(f, g, labels, w, b)
    _, logits = _joint_logits(f, g, w, b)
    base = torch.logsumexp(logits, dim=-1)
    U = labels.shape[1]
    lab = labels.to(torch.int64)[:, None, :, None].expand(
        -1, logits.shape[1], -1, -1)
    sel = torch.gather(logits[:, :, :U], 3, lab)[..., 0]
    lp_y = torch.cat([sel - base[:, :, :U],
                      torch.full_like(base[:, :, :1], NEG_INF)], dim=2)
    return logits[..., blank] - base, lp_y, base


# ------------------------------ backward ---------------------------------

def joint_lp_bwd(f, g, labels, w, b, gb, gy, base, gbar, blank: int = 0,
                 *, events=None):
    """-> (df (B, T, J), dg (B, U+1, J), dw (J, V), db (V,)), all f32.

    gb, gy (B, T, U+1): the blank and emit occupancies (gy already scaled
    by 1 + lambda under FastEmit); base (B, T, U+1) from the forward; gbar
    (B,) the loss cotangent, applied inside:

        dlogits = s (gb + gy) p - s gb [v = blank] - s gy [v = label]
        dz      = round(dlogits) . W^T * (1 - z^2)

    with p = exp(logits - base) and s = gbar[b]. Kernel A gives df and
    dg's partials; kernel B dW and db: for bf16 W with J % 16 == 0 and V
    even, round(z) into a scratch zb once (joint_bwd_b_zb), then
    joint_bwd_b_ring on the tiles of `rnnt_band_fused.device_bwd_b_plan`
    over the B * T * (U+1) cells (ValueError for a shape it cannot place);
    for other W and shapes, the CUDA-core form (joint_bwd_b). Sums across
    blocks go through partial buffers and an ordered second pass, so two
    runs give identical bits. `events`, five CUDA events, are recorded
    before kernel A, after it, after kernel B's zb pass, after its main
    launch and after the ordered sums (the CUDA-core form has no zb pass:
    the second and third are recorded together).
    """
    _check(f, g, labels, w, b)
    B, T, J = f.shape
    U1, V = g.shape[1], w.shape[1]
    dev = f.device
    _check_sidecars((B, T, U1), dev, gb=gb, gy=gy, base=base)
    _check_sidecars((B,), dev, gbar=gbar)
    if dev.type == "cpu":
        return joint_lp_bwd_reference(f, g, labels, w, b, gb, gy, base, gbar,
                                      blank)
    if dev.type != "cuda":
        raise ValueError(f"no joint_lp_bwd for device {dev}")
    if J > MAX_J:
        raise ValueError(f"joint_bwd supports J <= {MAX_J}; got J = {J}")
    df = torch.empty((B, T, J), dtype=torch.float32, device=dev)
    dg = torch.empty((B, U1, J), dtype=torch.float32, device=dev)
    dw = torch.empty((J, V), dtype=torch.float32, device=dev)
    db = torch.empty((V,), dtype=torch.float32, device=dev)
    if B * T == 0:
        for a in (df, dg, dw, db):
            a.zero_()
        return df, dg, dw, db
    ring = w.dtype == torch.bfloat16 and mma_shapes_ok(J, V)
    plan = device_bwd_b_plan(B * T * U1, J, V, dev) if ring else None
    splits = plan.splits if ring else ROW_SPLITS
    n_tiles = -(-T // FRAMES_PER_TILE)
    dg_part = torch.empty((B, n_tiles, U1, J), dtype=torch.float32,
                          device=dev)
    dw_part = db_part = None
    if splits > 1:
        dw_part = torch.empty((splits, J, V), dtype=torch.float32, device=dev)
        db_part = torch.empty((splits, V), dtype=torch.float32, device=dev)
    is_bf16 = int(w.dtype == torch.bfloat16)
    side = (gb.data_ptr(), gy.data_ptr(), base.data_ptr(), gbar.data_ptr())
    stream = build.stream_args(dev)
    ev = events if events is not None else (None,) * 5
    fn = build.load_library()
    _record(ev[0])
    err = fn.joint_bwd_a(f.data_ptr(), g.data_ptr(), labels.data_ptr(),
                         w.data_ptr(), is_bf16, b.data_ptr(), *side,
                         df.data_ptr(), dg_part.data_ptr(), B, T, U1, J, V,
                         blank, FRAMES_PER_TILE, *stream)
    build.check_launch(fn, err, "joint_bwd_a")
    _record(ev[1])
    if ring:
        zb = torch.empty(plan.zb_shape, dtype=torch.bfloat16, device=dev)
        err = fn.joint_bwd_b_zb(f.data_ptr(), g.data_ptr(), zb.data_ptr(), B,
                                T, U1, J, *stream)
        build.check_launch(fn, err, "joint_bwd_b_zb")
        _record(ev[2])
        dwo, dbo = (dw, db) if splits == 1 else (dw_part, db_part)
        err = fn.joint_bwd_b_ring(
            zb.data_ptr(), labels.data_ptr(), w.data_ptr(), b.data_ptr(),
            *side, dwo.data_ptr(), dbo.data_ptr(), B, T, U1, J, V, blank,
            plan.grid[0], splits, plan.split_rows, plan.smem_bytes, *stream)
        build.check_launch(fn, err, "joint_bwd_b_ring")
    else:
        _record(ev[2])
        err = fn.joint_bwd_b(f.data_ptr(), g.data_ptr(), labels.data_ptr(),
                             w.data_ptr(), is_bf16, b.data_ptr(), *side,
                             dw_part.data_ptr(), db_part.data_ptr(), B, T,
                             U1, J, V, blank, splits, *stream)
        build.check_launch(fn, err, "joint_bwd_b")
    _record(ev[3])
    parts = (None, None) if splits == 1 else (dw_part.data_ptr(),
                                              db_part.data_ptr())
    err = fn.joint_bwd_sums(dg_part.data_ptr(), dg.data_ptr(), parts[0],
                            dw.data_ptr(), parts[1], db.data_ptr(), B,
                            n_tiles, U1, J, V, 0 if splits == 1 else splits,
                            *stream)
    build.check_launch(fn, err, "joint_bwd_sums")
    _record(ev[4])
    _count("LAUNCHES_BWD")
    return df, dg, dw, db


def joint_lp_bwd_reference(f, g, labels, w, b, gb, gy, base, gbar,
                           blank: int = 0):
    """Plain version of `joint_lp_bwd`: logits and dlogits materialised."""
    _check(f, g, labels, w, b)
    z, logits = _joint_logits(f, g, w, b)
    probs = torch.exp(logits - base[..., None])
    s = gbar.float()[:, None, None]
    occ_s = ((gb + gy) * s)[..., None]
    gb_s = (gb * s)[..., None]
    gy_s = (gy * s)[..., None]
    V = w.shape[1]
    col = torch.arange(V, device=f.device)
    lab = torch.cat([labels.to(torch.int64),
                     torch.full_like(labels[:, :1], -1, dtype=torch.int64)],
                    dim=1)  # -1 at u = U: no label column
    zero = torch.zeros((), device=f.device)
    dlogits = probs * occ_s
    dlogits = dlogits - torch.where(col == blank, gb_s, zero)
    dlogits = dlogits - torch.where(col == lab[:, None, :, None], gy_s, zero)
    cd = w.dtype
    dz = _dot(dlogits, w.t(), cd) * (1.0 - z * z)
    J = z.shape[-1]
    dw = _dot(z.reshape(-1, J).t(), dlogits.reshape(-1, V), cd)
    return dz.sum(dim=2), dz.sum(dim=1), dw, dlogits.sum(dim=(0, 1, 2))


# ------------------------------ the op -----------------------------------

class _RNNTLossFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, g, w, b, labels, frame_lens, label_lens, blank,
                compute_dtype, fastemit_lambda):
        f32 = f.float().contiguous()
        g32 = g.float().contiguous()
        w_c = w.to(compute_dtype).contiguous()
        b32 = b.float().contiguous()
        lab = labels.to(torch.int32).contiguous()
        lpb, lpy, base = joint_lp_fwd(f32, g32, lab, w_c, b32, blank)
        loss, alpha = forward_from_lp_with_alpha(lpb, lpy, frame_lens,
                                                 label_lens)
        ctx.save_for_backward(f32, g32, w_c, b32, lab, frame_lens,
                              label_lens, lpb, lpy, base, alpha)
        ctx.blank, ctx.fastemit = blank, fastemit_lambda
        ctx.dtypes = (f.dtype, g.dtype, w.dtype, b.dtype)
        return loss

    @staticmethod
    def backward(ctx, gbar):
        (f32, g32, w_c, b32, lab, frame_lens, label_lens, lpb, lpy, base,
         alpha) = ctx.saved_tensors
        g_blank, g_y = occupancies_from_lp(lpb, lpy, frame_lens, label_lens,
                                           alpha=alpha)
        if ctx.fastemit:
            g_y = g_y * (1.0 + ctx.fastemit)
        df, dg, dw, db = joint_lp_bwd(
            f32, g32, lab, w_c, b32, g_blank.contiguous(), g_y.contiguous(),
            base, gbar.float().contiguous(), ctx.blank)
        f_dt, g_dt, w_dt, b_dt = ctx.dtypes
        return (df.to(f_dt), dg.to(g_dt), dw.to(w_dt), db.to(b_dt),
                None, None, None, None, None, None)


def rnnt_loss_fused(f, g, w, b, labels, frame_lens, label_lens,
                    blank: int = 0, compute_dtype=torch.bfloat16,
                    fastemit_lambda: float = 0.0):
    """Per-utterance RNN-T loss (B,) from the joint activations; the
    logits are never stored.

    f (B, T, J): encoder-side joint activation (projection and bias
    applied); g (B, U+1, J): predictor side; w (J, V), b (V,). FastEmit
    scales the emit-arc occupancies fed to the backward by (1 + lambda);
    the loss value is the exact NLL.
    """
    return _RNNTLossFused.apply(f, g, w, b, labels, frame_lens, label_lens,
                                blank, compute_dtype, fastemit_lambda)
