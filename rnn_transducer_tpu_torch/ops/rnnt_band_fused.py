"""Fused band joint of the pruned RNN-T loss (port of `rnn_transducer_tpu/ops/rnnt_band_fused.py`).

The pruned loss evaluates the joint only on a band of S label positions
per frame: N = B * T * S rows, each with its own predictor activation
g_w (B, T, S, J) and label lab_w (B, T, S). The band logits (B, T, S, V),
1.68 GB in f32 at V = 8192, B = 32, T' = 200, S = 8, are never stored:

    z = tanh(f[t] + g_w[t, s]),   logits = round(z) . W + b

is built on chip and reduced at once by K6 (`csrc/band_fused.cu`):

  * `band_lp_fwd` (`band_fwd`, JAX `band_lp_fwd` :95) to lp_blank, lp_y
    and base, the log-sum-exp the backward reuses, each (B, T, S);
  * `band_lp_bwd_a` (`band_bwd_a`, JAX `band_lp_bwd_a` :157) from the loss
    cotangents cb, cy of lp_blank and lp_y to dg_w = dz and df = sum_s dz;
  * `band_lp_bwd_b` (`band_bwd_b`, JAX `band_lp_bwd_b` :238) to dW and db.

round() is the cast to the compute dtype of W (bf16 or f32) and the
products accumulate in fp32, the JAX package's `preferred_element_type`
semantics; dlogits are rounded to W's dtype before both backward products.
`band_lp_fused` is the differentiable op (JAX `band_lp_fused` :283, a
`custom_vjp`) as a `torch.autograd.Function`.

Each wrapper launches its kernel for a CUDA tensor and runs its
`*_reference` version, which materialises the logits as the JAX package's
XLA path `_pruned_lp_chunk` (rnnt_pruned.py:370) does, for a CPU tensor;
it never falls back from one to the other, and counts the calls that
launched its kernel. The TPU's scaffolding has no counterpart here: the
VMEM gate `band_fused_supported` and the time tile `_tile_t`, the padding
of S to a multiple of 8 and of V to 128 lanes, and the T padding.
"""

from __future__ import annotations

import threading

import torch

from rnn_transducer_tpu_torch.ops.lstm import _dot
from rnn_transducer_tpu_torch.ops.rnnt_joint_fused import _check_sidecars
from rnn_transducer_tpu_torch.utils import build

LAUNCHES_FWD = 0    # band_lp_fwd calls that launched band_fwd
LAUNCHES_BWD_A = 0  # band_lp_bwd_a calls that launched band_bwd_a
LAUNCHES_BWD_B = 0  # band_lp_bwd_b calls that launched band_bwd_b
_launches_lock = threading.Lock()

MAX_J = 512  # the kernels keep (64, J) tiles of z and dz in shared memory
# Kernel B's grid is (V / V_TILE_B column tiles, row splits); the rows are
# split so that about TARGET_BLOCKS_B blocks (four per SM of the H100's
# 132) run, and each split's dW and db partials are summed in order by a
# second pass. The split depends on the shapes alone, so the bits do too.
V_TILE_B = 32
TARGET_BLOCKS_B = 528
MAX_SPLITS_B = 16

_W_DTYPES = (torch.float32, torch.bfloat16)


def _count(name: str) -> None:
    with _launches_lock:
        globals()[name] += 1


def row_splits(V: int) -> int:
    """Kernel B's number of row splits for a vocabulary of V columns."""
    tiles = -(-V // V_TILE_B)
    return max(1, min(MAX_SPLITS_B, -(-TARGET_BLOCKS_B // tiles)))


def _check(f, g_w, lab_w, w, b):
    if f.dim() != 3 or g_w.dim() != 4 or tuple(g_w.shape[:2]) != tuple(
            f.shape[:2]) or g_w.shape[3] != f.shape[2]:
        raise ValueError(f"f must be (B, T, J) and g_w (B, T, S, J); got "
                         f"{tuple(f.shape)} and {tuple(g_w.shape)}")
    B, T, S, J = g_w.shape
    if S < 1:
        raise ValueError("the band needs at least one row (S >= 1)")
    if w.dim() != 2 or w.shape[0] != J:
        raise ValueError(f"w must be ({J}, V); got {tuple(w.shape)}")
    V = w.shape[1]
    if tuple(b.shape) != (V,):
        raise ValueError(f"b must be ({V},); got {tuple(b.shape)}")
    if tuple(lab_w.shape) != (B, T, S):
        raise ValueError(f"lab_w must be ({B}, {T}, {S}); got "
                         f"{tuple(lab_w.shape)}")
    for name, a in (("f", f), ("g_w", g_w), ("b", b)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {a.dtype}")
    if lab_w.dtype != torch.int32:
        raise TypeError(f"lab_w must be int32; got {lab_w.dtype}")
    if w.dtype not in _W_DTYPES:
        raise TypeError(f"w must be float32 or bfloat16; got {w.dtype}")
    named = (("f", f), ("g_w", g_w), ("lab_w", lab_w), ("w", w), ("b", b))
    if len({a.device for _, a in named}) != 1:
        raise ValueError("inputs on different devices")
    for name, a in named:
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _require_cuda(f, what: str) -> None:
    dev = f.device
    if dev.type != "cuda":
        raise ValueError(f"no {what} for device {dev}")
    J = f.shape[2]
    if J > MAX_J:
        raise ValueError(f"{what} supports J <= {MAX_J}; got J = {J}")


# ------------------------------ forward ----------------------------------

def band_lp_fwd(f, g_w, lab_w, w, b, blank: int = 0):
    """-> (lp_blank, lp_y, base), each (B, T, S) f32; logits never stored.

    f (B, T, J) f32, g_w (B, T, S, J) f32, lab_w (B, T, S) int32 (any id
    for a row the caller masks: one outside [0, V) gives lp_y = -base), w
    (J, V) in the compute dtype, b (V,) f32.
    """
    _check(f, g_w, lab_w, w, b)
    if f.device.type == "cpu":
        return band_lp_fwd_reference(f, g_w, lab_w, w, b, blank)
    _require_cuda(f, "band_fwd")
    B, T, S, J = g_w.shape
    V = w.shape[1]
    dev = f.device
    outs = [torch.empty((B, T, S), dtype=torch.float32, device=dev)
            for _ in range(3)]
    if B * T == 0:
        return tuple(outs)
    fn = build.load_library()
    err = fn.band_fwd(f.data_ptr(), g_w.data_ptr(), lab_w.data_ptr(),
                      w.data_ptr(), int(w.dtype == torch.bfloat16),
                      b.data_ptr(), *(o.data_ptr() for o in outs), B, T, S, J,
                      V, blank, *build.stream_args(dev))
    build.check_launch(fn, err, "band_fwd")
    _count("LAUNCHES_FWD")
    return tuple(outs)


def _band_logits(f, g_w, w, b):
    """z (B, T, S, J) f32 and the band logits (B, T, S, V) f32, materialised."""
    z = torch.tanh(f[:, :, None, :] + g_w)
    return z, _dot(z, w, w.dtype) + b


def _pick(logits, lab_w):
    """logits[..., lab_w], 0 where lab_w is outside [0, V) (the JAX
    kernels' iota compare)."""
    V = logits.shape[-1]
    lab = lab_w.to(torch.int64)
    ok = (lab >= 0) & (lab < V)
    sel = torch.gather(logits, -1, lab.clamp(0, V - 1)[..., None])[..., 0]
    return torch.where(ok, sel, torch.zeros_like(sel))


def band_lp_fwd_reference(f, g_w, lab_w, w, b, blank: int = 0):
    """Plain version of `band_lp_fwd`: the logits are materialised."""
    _check(f, g_w, lab_w, w, b)
    _, logits = _band_logits(f, g_w, w, b)
    base = torch.logsumexp(logits, dim=-1)
    return logits[..., blank] - base, _pick(logits, lab_w) - base, base


# ------------------------------ backward ---------------------------------

def _check_bwd(f, g_w, lab_w, w, b, base, cb, cy):
    _check(f, g_w, lab_w, w, b)
    _check_sidecars(tuple(lab_w.shape), f.device, base=base, cb=cb, cy=cy)


def band_lp_bwd_a(f, g_w, lab_w, w, b, base, cb, cy, blank: int = 0):
    """-> (df (B, T, J), dg_w (B, T, S, J)), both f32.

    base (B, T, S) from the forward; cb, cy (B, T, S) the loss cotangents
    of lp_blank and lp_y:

        dlogits = cb ([v = blank] - p) + cy ([v = lab_w] - p)
        dg_w    = round(dlogits) . W^T * (1 - z^2),   df = sum_s dg_w

    with p = exp(logits - base); df is summed in s order by a second pass.
    """
    _check_bwd(f, g_w, lab_w, w, b, base, cb, cy)
    if f.device.type == "cpu":
        return band_lp_bwd_a_reference(f, g_w, lab_w, w, b, base, cb, cy,
                                       blank)
    _require_cuda(f, "band_bwd_a")
    B, T, S, J = g_w.shape
    V = w.shape[1]
    dev = f.device
    df = torch.empty((B, T, J), dtype=torch.float32, device=dev)
    dgw = torch.empty((B, T, S, J), dtype=torch.float32, device=dev)
    if B * T == 0:
        return df, dgw
    fn = build.load_library()
    err = fn.band_bwd_a(f.data_ptr(), g_w.data_ptr(), lab_w.data_ptr(),
                        w.data_ptr(), int(w.dtype == torch.bfloat16),
                        b.data_ptr(), base.data_ptr(), cb.data_ptr(),
                        cy.data_ptr(), df.data_ptr(), dgw.data_ptr(), B, T, S,
                        J, V, blank, *build.stream_args(dev))
    build.check_launch(fn, err, "band_bwd_a")
    _count("LAUNCHES_BWD_A")
    return df, dgw


def _dlogits(f, g_w, lab_w, w, b, base, cb, cy, blank):
    """z and dlogits (B, T, S, V) f32 in the order of the JAX kernels."""
    z, logits = _band_logits(f, g_w, w, b)
    probs = torch.exp(logits - base[..., None])
    V = w.shape[1]
    col = torch.arange(V, device=f.device)
    zero = torch.zeros((), device=f.device)
    cb_, cy_ = cb[..., None], cy[..., None]
    dlogits = (cb_ + cy_) * (-probs)
    dlogits = dlogits + torch.where(col == blank, cb_, zero)
    dlogits = dlogits + torch.where(col == lab_w[..., None].to(torch.int64),
                                    cy_, zero)
    return z, dlogits


def band_lp_bwd_a_reference(f, g_w, lab_w, w, b, base, cb, cy,
                            blank: int = 0):
    """Plain version of `band_lp_bwd_a`: logits and dlogits materialised."""
    _check_bwd(f, g_w, lab_w, w, b, base, cb, cy)
    z, dlogits = _dlogits(f, g_w, lab_w, w, b, base, cb, cy, blank)
    dz = _dot(dlogits, w.t(), w.dtype) * (1.0 - z * z)
    return dz.sum(dim=2), dz


def band_lp_bwd_b(f, g_w, lab_w, w, b, base, cb, cy, blank: int = 0):
    """-> (dw (J, V), db (V,)), both f32:

        dw = sum_rows round(z)^T round(dlogits),   db = sum_rows dlogits

    over every (b, t, s), with dlogits as in `band_lp_bwd_a`. The sums
    across blocks go through partial buffers and an ordered second pass,
    so two runs give identical bits.
    """
    _check_bwd(f, g_w, lab_w, w, b, base, cb, cy)
    if f.device.type == "cpu":
        return band_lp_bwd_b_reference(f, g_w, lab_w, w, b, base, cb, cy,
                                       blank)
    _require_cuda(f, "band_bwd_b")
    B, T, S, J = g_w.shape
    V = w.shape[1]
    dev = f.device
    dw = torch.empty((J, V), dtype=torch.float32, device=dev)
    db = torch.empty((V,), dtype=torch.float32, device=dev)
    if B * T == 0:
        return dw.zero_(), db.zero_()
    n_split = row_splits(V)
    dw_part = torch.empty((n_split, J, V), dtype=torch.float32, device=dev)
    db_part = torch.empty((n_split, V), dtype=torch.float32, device=dev)
    fn = build.load_library()
    err = fn.band_bwd_b(f.data_ptr(), g_w.data_ptr(), lab_w.data_ptr(),
                        w.data_ptr(), int(w.dtype == torch.bfloat16),
                        b.data_ptr(), base.data_ptr(), cb.data_ptr(),
                        cy.data_ptr(), dw.data_ptr(), db.data_ptr(),
                        dw_part.data_ptr(), db_part.data_ptr(), B, T, S, J, V,
                        blank, n_split, *build.stream_args(dev))
    build.check_launch(fn, err, "band_bwd_b")
    _count("LAUNCHES_BWD_B")
    return dw, db


def band_lp_bwd_b_reference(f, g_w, lab_w, w, b, base, cb, cy,
                            blank: int = 0):
    """Plain version of `band_lp_bwd_b`: logits and dlogits materialised."""
    _check_bwd(f, g_w, lab_w, w, b, base, cb, cy)
    z, dlogits = _dlogits(f, g_w, lab_w, w, b, base, cb, cy, blank)
    J, V = w.shape
    dw = _dot(z.reshape(-1, J).t(), dlogits.reshape(-1, V), w.dtype)
    return dw, dlogits.sum(dim=(0, 1, 2))


# ------------------------------ the op -----------------------------------

class _BandLpFused(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, g_w, w, b, lab_w, blank, compute_dtype):
        f32 = f.float().contiguous()
        gw32 = g_w.float().contiguous()
        w_c = w.to(compute_dtype).contiguous()
        b32 = b.float().contiguous()
        lab = lab_w.to(torch.int32).contiguous()
        lpb, lpy, base = band_lp_fwd(f32, gw32, lab, w_c, b32, blank)
        ctx.save_for_backward(f32, gw32, w_c, b32, lab, base)
        ctx.blank = blank
        ctx.dtypes = (f.dtype, g_w.dtype, w.dtype, b.dtype)
        return lpb, lpy

    @staticmethod
    def backward(ctx, cb, cy):
        f32, gw32, w_c, b32, lab, base = ctx.saved_tensors
        cb = torch.zeros_like(base) if cb is None else cb.float().contiguous()
        cy = torch.zeros_like(base) if cy is None else cy.float().contiguous()
        args = (f32, gw32, lab, w_c, b32, base, cb, cy, ctx.blank)
        df, dgw = band_lp_bwd_a(*args)
        dw, db = band_lp_bwd_b(*args)
        f_dt, g_dt, w_dt, b_dt = ctx.dtypes
        return (df.to(f_dt), dgw.to(g_dt), dw.to(w_dt), db.to(b_dt), None,
                None, None)


def band_lp_fused(f, g_w, w, b, lab_w, blank: int = 0,
                  compute_dtype=torch.bfloat16):
    """(lp_blank_w, lp_y_w): the (B, T, S) band scores; the logits are never
    stored. f (B, T, J); g_w (B, T, S, J), the predictor rows gathered per
    frame; w (J, V); b (V,); lab_w (B, T, S) the label id at each band
    cell (any id for cells the caller masks). Differentiable in f, g_w, w
    and b; the gradients come back in the inputs' dtypes."""
    return _BandLpFused.apply(f, g_w, w, b, lab_w, blank, compute_dtype)
