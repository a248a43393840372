"""LSTM time recurrence: the CUDA kernels and their plain PyTorch versions.

  * `csrc/lstm_fwd.cu` (K4-fwd) replaces the forward of the JAX package's
    Pallas LSTM kernels, `rnn_transducer_tpu/ops/lstm_pallas.py`
    `_lstm_core_fwd` and `_lstm_core_fwd_v2`. `lstm_recurrence` runs it as
    `_lstm_core` does on the primal (serving) path, with_acts=False;
    `lstm_recurrence_with_acts` also writes the gate activations and the
    cell states that the backward reads, as `_core_fwd` does.
  * `csrc/lstm_bwd.cu` (K4-bwd) replaces `_lstm_core_bwd` and
    `_lstm_core_bwd_v2`: `lstm_recurrence_bwd`.

Both kernels, and the W8A8 forward of `ops/lstm_int8_cuda.py` (K7,
`csrc/lstm_fwd_q.cu`), are one persistent cooperative launch per layer
call. Each block keeps its slice of W_hh in shared memory for the whole
launch, as the TPU kernels keep W_hh in VMEM (the forward the 4 gate
columns of its hidden units, the backward the rows of its units), and the
blocks hand each step's values to one another (round(h) forward,
round(dgates) backward, h in f32 and each row's max |h| in int8) through
an exchange buffer in device memory, one grid barrier a step
(`csrc/grid_barrier.cuh`). One planner, `lstm_plan`, plain Python,
places each kernel's tile (`fwd_plan`, `bwd_plan`, `fwd_q_plan`): units
and batch rows a block, the grid (one wave on the card) and the shared
memory of that kernel's layout; a shape it cannot place raises
ValueError, and there is no other route on the card.

The TPU's dispatch gates (`supported`, `_w_hh_fits_vmem`, the batch and
time tiles) are VMEM concerns and have no counterpart: every shape goes
to the kernels.

Each wrapper launches its kernel for a CUDA tensor and runs its
`*_reference` version for a CPU tensor; it never falls back from one to
the other. Each counts the calls that launched its kernel. None of them
records an autograd graph: `ops/lstm.LSTMCore` is the differentiable op,
and the forward wrappers raise when handed a tensor that requires grad
while grad mode is on, rather than return outputs cut from the graph.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import torch

from rnn_transducer_tpu_torch.ops.lstm import _dot, lstm_cell
from rnn_transducer_tpu_torch.utils import build

# Calls that launched a kernel (one call = one layer), per wrapper.
LAUNCHES = 0             # lstm_recurrence: lstm_fwd without activations
LAUNCHES_WITH_ACTS = 0   # lstm_recurrence_with_acts: lstm_fwd with them
LAUNCHES_BWD = 0         # lstm_recurrence_bwd: lstm_bwd
_launches_lock = threading.Lock()

_W_DTYPES = (torch.float32, torch.bfloat16)


def _count(name: str) -> None:
    with _launches_lock:
        globals()[name] += 1


def _check_same_device_contiguous(named):
    devices = {a.device for _, a in named}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")
    for name, a in named:
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(x_proj, w_hh, h0, c0):
    if x_proj.dim() != 3 or x_proj.shape[2] % 4:
        raise ValueError(f"x_proj must be (B, T, 4H); got {tuple(x_proj.shape)}")
    B, _, H4 = x_proj.shape
    H = H4 // 4
    if tuple(w_hh.shape) != (H, H4):
        raise ValueError(f"w_hh must be ({H}, {H4}); got {tuple(w_hh.shape)}")
    for name, s in (("h0", h0), ("c0", c0)):
        if tuple(s.shape) != (B, H):
            raise ValueError(f"{name} must be ({B}, {H}); got {tuple(s.shape)}")
    for name, a in (("x_proj", x_proj), ("h0", h0), ("c0", c0)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {a.dtype}")
    if w_hh.dtype not in _W_DTYPES:
        raise TypeError(f"w_hh must be float32 or bfloat16; got {w_hh.dtype}")
    _check_same_device_contiguous(
        (("x_proj", x_proj), ("w_hh", w_hh), ("h0", h0), ("c0", c0)))
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x_proj, w_hh, h0, c0)):
        raise RuntimeError(
            "lstm_recurrence records no autograd graph, and an input "
            "requires grad: differentiate through ops.lstm.LSTMCore "
            "(lstm_layer routes there) or call this under torch.no_grad()")


def _launch_fwd(x_proj, w_hh, h0, c0, with_acts: bool):
    """lstm_fwd on the card, one cooperative launch on `fwd_plan`'s tile ->
    hs, c_T, and (cs, acts) or (None, None)."""
    dev = x_proj.device
    B, T, H4 = x_proj.shape
    H = H4 // 4
    fn = build.load_library()
    plan = device_fwd_plan(B, H, w_hh.dtype, dev)
    hs = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    c = torch.empty((B, H), dtype=torch.float32, device=dev)
    cs = acts = None
    if with_acts:
        cs = torch.empty((B, T, H), dtype=torch.float32, device=dev)
        acts = torch.empty((B, T, H4), dtype=torch.float32, device=dev)
    xbuf = _exchange_buffer(plan, w_hh.dtype, dev)
    err = fn.lstm_fwd(
        x_proj.data_ptr(), w_hh.data_ptr(), int(w_hh.dtype == torch.bfloat16),
        h0.data_ptr(), c0.data_ptr(), hs.data_ptr(), c.data_ptr(),
        acts.data_ptr() if with_acts else None,
        cs.data_ptr() if with_acts else None, xbuf.data_ptr(), B, T, H,
        plan.units, plan.rows, plan.stage_rows, plan.stage_cols,
        *build.stream_args(dev))
    build.check_launch(fn, err, "lstm_fwd")
    return hs, c, cs, acts


def _require_cuda(dev: torch.device, what: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"no {what} for device {dev}")


def lstm_recurrence(x_proj, w_hh, h0, c0):
    """hs (B, T, H), (h_T, c_T) from x_proj (B, T, 4H) f32, w_hh (H, 4H) in
    the compute dtype (f32 or bf16) and h0, c0 (B, H) f32."""
    _check(x_proj, w_hh, h0, c0)
    dev = x_proj.device
    if dev.type == "cpu":
        return lstm_recurrence_reference(x_proj, w_hh, h0, c0)
    _require_cuda(dev, "LSTM recurrence")
    B, T, H4 = x_proj.shape
    if T == 0:
        return x_proj.new_empty((B, 0, H4 // 4)), (h0, c0)
    hs, c, _, _ = _launch_fwd(x_proj, w_hh, h0, c0, with_acts=False)
    _count("LAUNCHES")
    return hs, (hs[:, T - 1], c)


def lstm_recurrence_reference(x_proj, w_hh, h0, c0):
    """The plain PyTorch step loop: `lstm_cell` over t, with the same
    compute-dtype rounding of h as the kernel."""
    _check(x_proj, w_hh, h0, c0)
    B, T, H4 = x_proj.shape
    params = {"w_hh": w_hh}
    h, c = h0, c0
    hs = x_proj.new_empty((B, T, H4 // 4))
    for t in range(T):
        h, c = lstm_cell(params, x_proj[:, t], h, c, w_hh.dtype)
        hs[:, t] = h
    return hs, (h, c)


def lstm_recurrence_with_acts(x_proj, w_hh, h0, c0):
    """The training forward: hs, cs (B, T, H) and acts (B, T, 4H), all f32.

    acts holds the post-nonlinearity gates sigmoid(i), sigmoid(f), tanh(g),
    sigmoid(o) of every step, as `_fwd_kernel` stores them with
    with_acts=True; cs holds every step's cell state.
    """
    _check(x_proj, w_hh, h0, c0)
    dev = x_proj.device
    if dev.type == "cpu":
        return lstm_recurrence_with_acts_reference(x_proj, w_hh, h0, c0)
    _require_cuda(dev, "LSTM recurrence")
    if x_proj.shape[1] == 0:
        return lstm_recurrence_with_acts_reference(x_proj, w_hh, h0, c0)
    hs, _, cs, acts = _launch_fwd(x_proj, w_hh, h0, c0, with_acts=True)
    _count("LAUNCHES_WITH_ACTS")
    return hs, cs, acts


def lstm_recurrence_with_acts_reference(x_proj, w_hh, h0, c0):
    """Plain step loop of `lstm_recurrence_with_acts`: `lstm_cell`'s math
    with the gates kept."""
    _check(x_proj, w_hh, h0, c0)
    B, T, H4 = x_proj.shape
    H = H4 // 4
    h, c = h0, c0
    hs = x_proj.new_empty((B, T, H))
    cs = x_proj.new_empty((B, T, H))
    acts = x_proj.new_empty((B, T, H4))
    for t in range(T):
        gates = x_proj[:, t] + _dot(h, w_hh, w_hh.dtype)
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs[:, t], cs[:, t] = h, c
        acts[:, t] = torch.cat([i, f, g, o], dim=-1)
    return hs, cs, acts


def _check_bwd(acts, cs_prev, dhs, dcT, w_hh):
    if acts.dim() != 3 or acts.shape[2] % 4:
        raise ValueError(f"acts must be (B, T, 4H); got {tuple(acts.shape)}")
    B, T, H4 = acts.shape
    H = H4 // 4
    for name, a, shape in (("cs_prev", cs_prev, (B, T, H)),
                           ("dhs", dhs, (B, T, H)), ("dcT", dcT, (B, H)),
                           ("w_hh", w_hh, (H, H4))):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(a.shape)}")
    for name, a in (("acts", acts), ("cs_prev", cs_prev), ("dhs", dhs),
                    ("dcT", dcT)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {a.dtype}")
    if w_hh.dtype not in _W_DTYPES:
        raise TypeError(f"w_hh must be float32 or bfloat16; got {w_hh.dtype}")
    _check_same_device_contiguous(
        (("acts", acts), ("cs_prev", cs_prev), ("dhs", dhs), ("dcT", dcT),
         ("w_hh", w_hh)))


# The persistent kernels' fixed shape (csrc/lstm_fwd.cu, csrc/lstm_bwd.cu,
# csrc/lstm_fwd_q.cu): 8 warps a block, each thread owning at most 2 (row,
# unit) pairs; warp tiles of 8 rows by the block's W slice in 16-row mma
# M-tiles (one of 8 rows for the backward's 8 units in f32; bf16:
# mma.sync m16n8k16; int8: m16n8k32; f32: the CUDA cores in the same
# fragment layout); 32 or 16 units a block in bf16 and int8, 16 or 8 in
# f32; the reduction padded to 16 columns a warp (128), int8's to 32 (256);
# 16 bytes of padding on every shared-memory row; 16 static bytes (the
# mbarrier).
LSTM_THREADS = 256
_WARPS = LSTM_THREADS // 32
_PAIRS = 2
_TILE_N = 8
_PAD_BYTES = 16
_STATIC_SMEM = 16
_UNITS = {torch.bfloat16: (32, 16), torch.float32: (16, 8),
          torch.int8: (32, 16)}
# Each kernel's product, as (W slice rows a unit, reduction columns an H,
# the reduction's alignment): the forward's gates = round(h) . W_hh takes
# the 4 gate columns of each unit over H; the backward's dh = round(dgates)
# . W_hh^T takes the unit's row of W_hh over 4H; the int8 forward ("fwd_q")
# takes the forward's slice of int8 Wq against h quantized per batch tile
# (32 columns a warp for the int8 mma's k). The warps' partial sums (f32,
# or int32) have a column for each W slice row.
_SLICES = {"fwd": (4, 1, 128), "bwd": (1, 4, 128), "fwd_q": (4, 1, 256)}
# The int8 forward stages h_{t-1} in f32 (16 floats of padding a row) and
# quantizes it as the warps read their fragments, and keeps each warp's
# max |h| of each batch tile (at most 4 tiles a block's rows meet).
_Q_STAGE_PAD = 16
_Q_TILE_BYTES = _WARPS * 4 * 4


@dataclasses.dataclass(frozen=True)
class LstmPlan:
    """The tile of one `lstm_fwd`, `lstm_bwd` or `lstm_fwd_q` launch
    (`direction` "fwd", "bwd" or "fwd_q"). Block (x, y) of the grid owns
    the hidden units x*units .. and the batch rows y*rows .. (`owned`); it
    keeps its W_hh slice in shared memory and stages the exchanged values
    of its rows (round(h) forward, round(dgates) backward, h in f32 for
    the int8 forward, which quantizes it) `stage_rows` by `stage_cols` at
    a time."""

    direction: str    # "fwd", "bwd" or "fwd_q"
    B: int
    H: int
    units: int        # UB
    rows: int         # RB
    stage_rows: int   # SR, a multiple of 8 dividing rows
    stage_cols: int   # KC, a multiple of 128 (int8: 256) dividing k_pad
    k_pad: int        # the reduction (H or 4H) rounded up to 128 (int8:
                      # 256): the exchange buffer's row
    grid: tuple[int, int]
    smem_bytes: int
    threads: int = LSTM_THREADS

    @property
    def passes(self) -> int:
        """Stage-and-product passes a step."""
        return (self.rows // self.stage_rows) * (self.k_pad // self.stage_cols)

    def owned(self, x: int, y: int) -> tuple[range, range]:
        """(hidden units, batch rows) of block (x, y), as the kernel maps
        them; rows and units past B and H are not owned."""
        return (range(x * self.units, min((x + 1) * self.units, self.H)),
                range(y * self.rows, min((y + 1) * self.rows, self.B)))


def _smem(direction, units, rows, stage_rows, stage_cols, k_pad,
          w_bytes) -> int:
    """Shared bytes of a block: the W_hh slice, the stage and the warps'
    partial sums, as the kernel of `direction` lays them out, and its
    mbarrier (the int8 forward: an f32 stage and the tiles' maxima)."""
    slice_rows = _SLICES[direction][0] * units
    pad = _PAD_BYTES // w_bytes
    if direction == "fwd_q":
        stage = stage_rows * (stage_cols + _Q_STAGE_PAD) * 4 + _Q_TILE_BYTES
    else:
        stage = stage_rows * (stage_cols + pad) * w_bytes
    return (slice_rows * (k_pad + pad) * w_bytes + stage
            + _WARPS * rows * slice_rows * 4 + _STATIC_SMEM)


@functools.lru_cache(maxsize=None)
def lstm_plan(direction: str, B: int, H: int, w_dtype: torch.dtype,
              n_sm: int, smem_per_block: int) -> LstmPlan:
    """Place the tile of the `direction` ("fwd", "bwd", or "fwd_q" with
    int8 W_hh) kernel for B rows, H hidden units and W_hh in `w_dtype` on
    a card of `n_sm` SMs with `smem_per_block` bytes of shared memory a
    block.

    Every block must be resident at once (one block per SM: grid <=
    n_sm), own at most 2 pairs a thread and fit its W slice, one stage and
    its partial sums in shared memory. Among the tiles that fit, the one
    with the fewest rows a block wins: each step a block fetches its rows'
    exchanged values from L2 before its product can start, so fewer rows
    make a shorter step (bench_lstm_bwd.py). Then the least work a block
    (units x rows), then the fewest stage passes. Raises ValueError when
    none fits.
    """
    if (direction == "fwd_q") != (w_dtype == torch.int8) or (
            w_dtype not in _UNITS):
        raise TypeError(f"lstm_{direction} takes no w_hh in {w_dtype}")
    if B < 1 or H < 1:
        raise ValueError(f"lstm_{direction}: empty shape B={B}, H={H}")
    w_bytes = torch.empty((), dtype=w_dtype).element_size()
    _, k_per_h, k_align = _SLICES[direction]
    k_pad = -(-k_per_h * H // k_align) * k_align
    best, best_key = None, None
    for units in _UNITS[w_dtype]:
        rows = _TILE_N
        while True:
            grid = (-(-H // units), -(-B // rows))
            if (grid[0] * grid[1] <= n_sm
                    and rows * units <= _PAIRS * LSTM_THREADS):
                for sr, kc in _stages(rows, k_pad, k_align):
                    smem = _smem(direction, units, rows, sr, kc, k_pad,
                                 w_bytes)
                    if smem > smem_per_block:
                        continue
                    plan = LstmPlan(direction, B, H, units, rows, sr, kc,
                                    k_pad, grid, smem)
                    key = (rows, units * rows, plan.passes)
                    if best_key is None or key < best_key:
                        best, best_key = plan, key
                    break  # _stages lists the fewest passes first
            if rows >= B:
                break
            rows *= 2
    if best is None:
        raise ValueError(
            f"lstm_{direction} cannot place B={B}, H={H} in {w_dtype} on "
            f"{n_sm} SMs with {smem_per_block} bytes of shared memory a "
            "block")
    return best


def fwd_plan(B: int, H: int, w_dtype: torch.dtype, n_sm: int,
             smem_per_block: int) -> LstmPlan:
    """The forward kernel's tile (`lstm_plan`)."""
    return lstm_plan("fwd", B, H, w_dtype, n_sm, smem_per_block)


def bwd_plan(B: int, H: int, w_dtype: torch.dtype, n_sm: int,
             smem_per_block: int) -> LstmPlan:
    """The backward kernel's tile (`lstm_plan`)."""
    return lstm_plan("bwd", B, H, w_dtype, n_sm, smem_per_block)


def fwd_q_plan(B: int, H: int, n_sm: int, smem_per_block: int) -> LstmPlan:
    """The int8 forward kernel's tile (`lstm_plan`), for B rows of whole
    batch tiles (`lstm_int8_cuda.groups` splits a batch that one wave
    cannot hold)."""
    return lstm_plan("fwd_q", B, H, torch.int8, n_sm, smem_per_block)


def _stages(rows: int, k_pad: int, k_align: int) -> list[tuple[int, int]]:
    """(stage rows, stage columns) that tile rows x k_pad, fewest passes
    first, whole rows before split ones."""
    srs = [sr for sr in range(_TILE_N, rows + 1, _TILE_N) if rows % sr == 0]
    kcs = [kc for kc in range(k_align, k_pad + 1, k_align)
           if k_pad % kc == 0]
    return sorted(((sr, kc) for sr in srs for kc in kcs),
                  key=lambda s: ((rows // s[0]) * (k_pad // s[1]), -s[1]))


@functools.lru_cache(maxsize=None)
def card_limits(index: int) -> tuple[int, int, bool]:
    """SMs, opt-in shared bytes a block, and whether card `index` takes a
    cooperative launch."""
    fn = build.load_library()
    n_sm, smem, coop = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    build.check_launch(fn, fn.lstm_bwd_limits(index, ctypes.byref(n_sm),
                                              ctypes.byref(smem),
                                              ctypes.byref(coop)),
                       "lstm_bwd_limits")
    return n_sm.value, smem.value, bool(coop.value)


def device_limits(device, what: str) -> tuple[int, int]:
    """SMs and opt-in shared bytes a block of the CUDA card `device`;
    raises if the card takes no cooperative launch, which `what` needs."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    n_sm, smem, coop = card_limits(index)
    if not coop:
        raise RuntimeError(f"card {index} takes no cooperative launch, "
                           f"which {what} needs")
    return n_sm, smem


def device_plan(direction: str, B: int, H: int, w_dtype: torch.dtype,
                device) -> LstmPlan:
    """`lstm_plan` on the limits of the CUDA card `device`; raises if the
    card takes no cooperative launch."""
    return lstm_plan(direction, B, H, w_dtype,
                     *device_limits(device, f"lstm_{direction}"))


def device_fwd_plan(B: int, H: int, w_dtype: torch.dtype,
                    device) -> LstmPlan:
    """`fwd_plan` on the limits of the CUDA card `device`."""
    return device_plan("fwd", B, H, w_dtype, device)


def device_bwd_plan(B: int, H: int, w_dtype: torch.dtype,
                    device) -> LstmPlan:
    """`bwd_plan` on the limits of the CUDA card `device`."""
    return device_plan("bwd", B, H, w_dtype, device)


def _exchange_buffer(plan: LstmPlan, w_dtype: torch.dtype, dev):
    """The zeroed exchange buffer of a launch on `plan`: the rounded values
    of the last two steps, (2, grid.y * rows, k_pad) in the compute dtype
    (rows past B and columns past the reduction stay zero), then 16 bytes
    for the grid barrier's counter.

    The caller holds the tensor until its launch is enqueued. A temporary
    freed while the launch's arguments are gathered goes back to the
    caching allocator first, and a launch from another thread (two serving
    engines on one card) can take the block, zero it and leave its grid
    barrier's counter in it before this launch runs."""
    elem = torch.empty((), dtype=w_dtype).element_size()
    return torch.zeros(2 * plan.grid[1] * plan.rows * plan.k_pad + 16 // elem,
                       dtype=w_dtype, device=dev)


def lstm_recurrence_bwd(acts, cs_prev, dhs, dcT, w_hh):
    """Time-reversed BPTT from the saved activations (no recompute).

    acts (B, T, 4H) and cs_prev = [c0, cs[:, :-1]] (B, T, H) from the
    forward; dhs (B, T, H) with the final-state cotangent dh_T already
    folded into step T-1; dcT (B, H); w_hh (H, 4H) in the compute dtype.
    Returns dgates (B, T, 4H) f32 (the cotangent of x_proj), dh0 and dc0
    (B, H) f32. The weight gradients are matmuls over dgates, left to the
    caller as the JAX package leaves them to XLA.
    """
    _check_bwd(acts, cs_prev, dhs, dcT, w_hh)
    dev = acts.device
    if dev.type == "cpu":
        return lstm_recurrence_bwd_reference(acts, cs_prev, dhs, dcT, w_hh)
    _require_cuda(dev, "LSTM backward")
    B, T, H4 = acts.shape
    H = H4 // 4
    if T == 0:
        return (acts.new_empty((B, 0, H4)),
                torch.zeros((B, H), dtype=torch.float32, device=dev),
                dcT.clone())
    fn = build.load_library()
    plan = device_bwd_plan(B, H, w_hh.dtype, dev)
    dgates = torch.empty((B, T, H4), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    dc0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    xbuf = _exchange_buffer(plan, w_hh.dtype, dev)
    err = fn.lstm_bwd(
        acts.data_ptr(), cs_prev.data_ptr(), dhs.data_ptr(), dcT.data_ptr(),
        w_hh.data_ptr(), int(w_hh.dtype == torch.bfloat16),
        dgates.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), xbuf.data_ptr(),
        B, T, H, plan.units, plan.rows, plan.stage_rows, plan.stage_cols,
        *build.stream_args(dev))
    build.check_launch(fn, err, "lstm_bwd")
    _count("LAUNCHES_BWD")
    return dgates, dh0, dc0


def lstm_recurrence_bwd_reference(acts, cs_prev, dhs, dcT, w_hh):
    """Plain reversed step loop of `lstm_recurrence_bwd`, the math of the
    JAX package's `_bwd_kernel` (lstm_pallas.py:169-220)."""
    _check_bwd(acts, cs_prev, dhs, dcT, w_hh)
    B, T, H4 = acts.shape
    H = H4 // 4
    dgates = acts.new_empty((B, T, H4))
    dh = torch.zeros((B, H), dtype=torch.float32, device=acts.device)
    dc = dcT
    for t in reversed(range(T)):
        i, f, g, o = acts[:, t].chunk(4, dim=-1)
        cp = cs_prev[:, t]
        tc = torch.tanh(f * cp + i * g)
        dh_tot = dhs[:, t] + dh
        do = dh_tot * tc
        dc = dc + dh_tot * o * (1.0 - tc * tc)
        di, dg, df = dc * g, dc * i, dc * cp
        dgt = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                         dg * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
        dgates[:, t] = dgt
        dc = dc * f
        dh = _dot(dgt, w_hh.t(), w_hh.dtype)
    return dgates, dh, dc
