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
  * `band_lp_bwd_b` (JAX `band_lp_bwd_b` :238) to dW and db: with bf16 W,
    round(z) once into a scratch (`band_bwd_b_zb`), then `band_bwd_b_ring`
    on the tiles of `bwd_b_plan`; with f32 W or other shapes, the
    CUDA-core `band_bwd_b`.

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

import dataclasses
import threading

import torch

from rnn_transducer_tpu_torch.ops import lstm_cuda
from rnn_transducer_tpu_torch.ops.lstm import _dot
from rnn_transducer_tpu_torch.utils import build

LAUNCHES_FWD = 0    # band_lp_fwd calls that launched band_fwd
LAUNCHES_BWD_A = 0  # band_lp_bwd_a calls that launched band_bwd_a
LAUNCHES_BWD_B = 0  # band_lp_bwd_b calls that launched band_bwd_b
_launches_lock = threading.Lock()

MAX_J = 512  # the kernels keep (64, J) tiles of z and dz in shared memory
# Kernel B's CUDA-core form (f32 W, or J % 16 != 0, or V odd): grid (V /
# V_TILE_B column tiles, row splits); the rows are split so that about
# TARGET_BLOCKS_B blocks (four per SM of the H100's 132) run, and each
# split's dW and db partials are summed in order by a second pass. The
# split depends on the shapes alone, so the bits do too.
V_TILE_B = 32
TARGET_BLOCKS_B = 528
MAX_SPLITS_B = 16
# Its tensor-core form (bf16 W, csrc/band_fused.cu band_bwd_b_zb and
# band_bwd_b_ring, on the ring of csrc/zb_ring.cuh that the fused joint's
# kernel B, csrc/joint_bwd.cu, shares): a block owns BWD_B_V_TILE columns,
# walks the rows in chunks of BWD_B_CHUNK through a two-slot ring of
# round(z), and keeps W[:, tile]^T, dlogits^T (pitch chunk + 8 bf16), the
# f32 dlogits (pitch tile + 4) and two chunks' row sidecars (BWD_B_SIDE
# words a row) in shared memory, with the ring's two mbarriers.
BWD_B_V_TILE = 64
BWD_B_CHUNK = 64
BWD_B_SIDE = 5

_W_DTYPES = (torch.float32, torch.bfloat16)


def _count(name: str) -> None:
    with _launches_lock:
        globals()[name] += 1


def row_splits(V: int) -> int:
    """The CUDA-core kernel B's number of row splits for V columns."""
    tiles = -(-V // V_TILE_B)
    return max(1, min(MAX_SPLITS_B, -(-TARGET_BLOCKS_B // tiles)))


def mma_shapes_ok(J: int, V: int) -> bool:
    """Whether bf16 W of (J, V) takes the tensor-core forms."""
    return J % 16 == 0 and V % 2 == 0


def zb_pitch(J: int) -> int:
    """bf16 row pitch of round(z) in shared memory and in zb: J rounded up
    to 64, plus 8 (4 mod 32 words, so fragment rows miss each other's
    banks)."""
    return -(-J // 64) * 64 + 8


def ring_b_bytes(J: int) -> int:
    """Shared bytes of a ring block (band_bwd_b_ring, joint_bwd_b_ring), as
    the kernel lays them out: ring, W tile, dlogits^T, f32 dlogits, the
    sidecars, two mbarriers."""
    jp = zb_pitch(J)
    return (2 * BWD_B_CHUNK * jp * 2 + BWD_B_V_TILE * jp * 2
            + BWD_B_V_TILE * (BWD_B_CHUNK + 8) * 2
            + BWD_B_CHUNK * (BWD_B_V_TILE + 4) * 4
            + 2 * BWD_B_SIDE * BWD_B_CHUNK * 4 + 16)


@dataclasses.dataclass(frozen=True)
class BwdBPlan:
    """The tiles of one ring launch (band_bwd_b_ring over the band's rows,
    joint_bwd_b_ring over the fused joint's cells). Block (x, y) owns the
    column tiles x, x + grid[0], .. of v_tile columns and split y's rows
    (`owned`); every block walks its rows in the same chunks in the same
    order, so the chunks that the resident blocks read at one time sit in
    L2."""

    rows: int         # N = B * T * S (band), B * T * (U+1) (fused joint)
    J: int
    V: int
    v_tile: int
    splits: int
    split_rows: int   # a multiple of the chunk; every split has rows
    grid: tuple[int, int]
    smem_bytes: int

    @property
    def zb_shape(self) -> tuple[int, int]:
        """(rows padded to a whole chunk, pitch) of the round(z) scratch."""
        return (-(-self.rows // BWD_B_CHUNK) * BWD_B_CHUNK, zb_pitch(self.J))

    def owned(self, x: int, y: int) -> tuple[list[range], range]:
        """(column ranges, rows) of block (x, y), as the kernel maps them;
        columns past V and rows past N are not owned."""
        cols = [range(v0, min(v0 + self.v_tile, self.V)) for v0 in range(
            x * self.v_tile, self.V, self.grid[0] * self.v_tile)]
        return cols, range(y * self.split_rows,
                           min((y + 1) * self.split_rows, self.rows))


def bwd_b_plan(J: int, V: int, n_sm: int, smem_per_block: int,
               rows: int) -> BwdBPlan:
    """Place the ring's kernel B for bf16 W of (J, V) and `rows` rows (the
    band's rows, or the fused joint's cells) on a card of `n_sm` SMs with
    `smem_per_block` bytes of shared memory a block.

    The grid is one wave, one block per SM (a block takes 228,880 bytes
    of shared memory at J = 512): min(column tiles, n_sm) blocks across,
    and as many row splits as the SMs left over allow (at most
    MAX_SPLITS_B, at most one a chunk), so that V = 8192 takes 128 tiles
    and 1 split and V = 1024 16 tiles and 8 splits. More tiles than SMs
    are walked in turn by each block. Raises ValueError for a shape the
    kernel does not take (J > MAX_J, J % 16 != 0, V odd, no rows) or
    shared memory that does not hold its block; the wrappers send f32 W
    and those shapes to the CUDA-core forms before they ask for a plan.
    """
    where = (f"kernel B's ring cannot place J={J}, V={V}, rows={rows} on "
             f"{n_sm} SMs with {smem_per_block} bytes of shared memory a "
             "block")
    if not (16 <= J <= MAX_J) or not mma_shapes_ok(J, V) or V < 2:
        raise ValueError(f"{where}: the tensor-core form needs 16 <= J <= "
                         f"{MAX_J}, J % 16 == 0 and V even")
    if rows < 1 or n_sm < 1:
        raise ValueError(f"{where}: no rows or no SMs")
    smem = ring_b_bytes(J)
    if smem > smem_per_block:
        raise ValueError(f"{where}: a block needs {smem} bytes")
    tiles = -(-V // BWD_B_V_TILE)
    chunks = -(-rows // BWD_B_CHUNK)
    grid_x = min(tiles, n_sm)
    splits = max(1, min(MAX_SPLITS_B, n_sm // grid_x, chunks))
    per = -(-chunks // splits)  # chunks a split
    splits = -(-chunks // per)  # so that no split is empty
    return BwdBPlan(rows, J, V, BWD_B_V_TILE, splits, per * BWD_B_CHUNK,
                    (grid_x, splits), smem)


def device_bwd_b_plan(rows: int, J: int, V: int, device) -> BwdBPlan:
    """`bwd_b_plan` on the limits of the CUDA card `device`."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    n_sm, smem, _ = lstm_cuda.card_limits(index)
    return bwd_b_plan(J, V, n_sm, smem, rows)


def _check_sidecars(shape, device, **named):
    for name, a in named.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(a.shape)}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {a.dtype}")
        if a.device != device:
            raise ValueError(f"{name} is on {a.device}, not {device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


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


def band_lp_bwd_b(f, g_w, lab_w, w, b, base, cb, cy, blank: int = 0, *,
                  events=None):
    """-> (dw (J, V), db (V,)), both f32:

        dw = sum_rows round(z)^T round(dlogits),   db = sum_rows dlogits

    over every (b, t, s), with dlogits as in `band_lp_bwd_a`. bf16 W with
    J % 16 == 0 and V even takes the tensor-core form: round(z) into a
    scratch zb once (band_bwd_b_zb), then band_bwd_b_ring on the tiles of
    `device_bwd_b_plan`; other W and shapes the CUDA-core form
    (band_bwd_b). The sums across blocks go through partial buffers and an
    ordered second pass, so two runs give identical bits. `events`, three
    CUDA events, are recorded before the zb pass, between it and the main
    launch, and after it (the CUDA-core form has no zb pass: the first two
    are recorded together).
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
    fn = build.load_library()
    ev = events if events is not None else (None, None, None)
    if w.dtype == torch.bfloat16 and mma_shapes_ok(J, V):
        plan = device_bwd_b_plan(B * T * S, J, V, dev)
        zb = torch.empty(plan.zb_shape, dtype=torch.bfloat16, device=dev)
        parts = (None, None)
        if plan.splits > 1:
            parts = (torch.empty((plan.splits, J, V), dtype=torch.float32,
                                 device=dev),
                     torch.empty((plan.splits, V), dtype=torch.float32,
                                 device=dev))
        _record(ev[0])
        err = fn.band_bwd_b_zb(f.data_ptr(), g_w.data_ptr(), zb.data_ptr(),
                               B, T, S, J, *build.stream_args(dev))
        build.check_launch(fn, err, "band_bwd_b_zb")
        _record(ev[1])
        err = fn.band_bwd_b_ring(
            zb.data_ptr(), lab_w.data_ptr(), w.data_ptr(), b.data_ptr(),
            base.data_ptr(), cb.data_ptr(), cy.data_ptr(), dw.data_ptr(),
            db.data_ptr(), *(None if p is None else p.data_ptr()
                             for p in parts), B, T, S, J, V, blank,
            plan.grid[0], plan.splits, plan.split_rows, plan.smem_bytes,
            *build.stream_args(dev))
        build.check_launch(fn, err, "band_bwd_b_ring")
    else:
        n_split = row_splits(V)
        dw_part = torch.empty((n_split, J, V), dtype=torch.float32,
                              device=dev)
        db_part = torch.empty((n_split, V), dtype=torch.float32, device=dev)
        _record(ev[0])
        _record(ev[1])
        err = fn.band_bwd_b(f.data_ptr(), g_w.data_ptr(), lab_w.data_ptr(),
                            w.data_ptr(), int(w.dtype == torch.bfloat16),
                            b.data_ptr(), base.data_ptr(), cb.data_ptr(),
                            cy.data_ptr(), dw.data_ptr(), db.data_ptr(),
                            dw_part.data_ptr(), db_part.data_ptr(), B, T, S,
                            J, V, blank, n_split, *build.stream_args(dev))
        build.check_launch(fn, err, "band_bwd_b")
    _record(ev[2])
    _count("LAUNCHES_BWD_B")
    return dw, db


def _record(event) -> None:
    if event is not None:
        event.record()


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
