"""The W8A8 LSTM recurrence: the CUDA kernel and its plain PyTorch version.

`csrc/lstm_fwd_q.cu` (K7) replaces the JAX package's int8 inference core,
`rnn_transducer_tpu/ops/lstm_pallas.py` `_lstm_core_fwd_v2_q` (kernel
`_fwd_kernel_v2_q`), which `lstm_layer_pallas` runs for an int8 QTensor
w_hh. Every step, for each batch tile of BT rows:

    amax  = max(max |h| over the BT x H tile, 1e-6)
    hq    = round(h * (127 / amax))                  int8, half to even
    acc   = hq @ wq                                  int8 x int8 -> int32
    gates = x_proj[:, t] + acc * (scale * (amax / 127))
    c, h  = the i, f, g, o cell in f32

The batch tile is part of the result, not a tile size: the rows of one
tile share one amax. `batch_tile` copies the JAX package's `_tile_bt_v2`
rule, so at serving B = 8 the whole padded batch, pad rows included,
shares one scale, as on the TPU.

The kernel is one persistent cooperative launch a layer on K4-fwd's
design, its tile from `lstm_cuda.fwd_q_plan`: each block keeps its int8
slice of wq in shared memory, and each step the blocks exchange h_t in f32
and each row's max |h_t| over their units, from which every block takes
its batch tiles' amax after the step's grid barrier. A batch tile cannot
be split (its rows share the scale), so where one wave cannot hold the
whole batch, `groups` runs it as the fewest groups of whole batch tiles
that it can: one launch a group, in order.

`lstm_recurrence_int8` launches the kernel for a CUDA tensor and runs
`lstm_recurrence_int8_reference` for a CPU tensor; it never falls back
from one to the other. `LAUNCHES` counts the calls that launched the
kernel. Inference only: nothing here records an autograd graph.
"""

from __future__ import annotations

import functools
import threading

import torch

from rnn_transducer_tpu_torch.ops import lstm_cuda
from rnn_transducer_tpu_torch.utils import build

LAUNCHES = 0  # calls (one per layer) that launched lstm_fwd_q
_launches_lock = threading.Lock()

_X_DTYPES = (torch.float32, torch.bfloat16)


def batch_tile(B: int, H: int) -> int:
    """Rows that share one requantization scale of h: the batch tile of
    the JAX package's `_tile_bt_v2` (lstm_pallas.py:288-304). It is kept
    as semantics: the kernel's own blocks are smaller."""
    if H <= 1024:
        for bt in (64, 32, 16):
            if B % bt == 0:
                return bt
    return min(B, 8)


@functools.lru_cache(maxsize=None)
def groups(B: int, H: int, n_sm: int,
           smem_per_block: int) -> tuple[tuple[int, int, lstm_cuda.LstmPlan],
                                         ...]:
    """The launches of a B-row batch on a card of `n_sm` SMs with
    `smem_per_block` shared bytes a block: (first row, end row, tile)
    each, in order, the fewest groups of whole batch tiles that
    `lstm_cuda.fwd_q_plan` places in one wave (one group where it places
    the batch). Raises ValueError where it cannot place one batch tile."""
    bt = batch_tile(B, H)
    per = B // bt  # batch tiles a group: the most that one wave holds
    while True:
        try:
            lstm_cuda.fwd_q_plan(per * bt, H, n_sm, smem_per_block)
            break
        except ValueError:
            if per <= 1:
                raise
            per -= 1
    rows = per * bt
    return tuple((b, min(B, b + rows),
                  lstm_cuda.fwd_q_plan(min(B, b + rows) - b, H, n_sm,
                                       smem_per_block))
                 for b in range(0, B, rows))


def device_groups(B: int, H: int, device):
    """`groups` on the limits of the CUDA card `device`."""
    return groups(B, H, *lstm_cuda.device_limits(device, "lstm_fwd_q"))


def _exchange_buffer(plan: lstm_cuda.LstmPlan, dev):
    """The zeroed exchange buffer of a launch on `plan`: h of the last two
    steps, (2, grid.y * rows, k_pad) f32 (rows past B and columns past H
    stay zero), the amax slots (2, grid.y * rows, grid.x) f32 (a block's
    max |h| of a row over its units), then 16 bytes for the grid
    barrier's counter. Held by the caller until its launch is enqueued,
    as `lstm_cuda._exchange_buffer`."""
    bp = plan.grid[1] * plan.rows
    return torch.zeros(2 * bp * plan.k_pad + 2 * bp * plan.grid[0] + 4,
                       dtype=torch.float32, device=dev)


def _check(x_proj, wq, scale, h0, c0):
    if x_proj.dim() != 3 or x_proj.shape[2] % 16:
        raise ValueError("x_proj must be (B, T, 4H) with H % 4 == 0; got "
                         f"{tuple(x_proj.shape)}")
    B, _, H4 = x_proj.shape
    H = H4 // 4
    for name, a, shape, dtype in (
            ("wq", wq, (H, H4), torch.int8),
            ("scale", scale, (1, H4), torch.float32),
            ("h0", h0, (B, H), torch.float32),
            ("c0", c0, (B, H), torch.float32)):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(a.shape)}")
        if a.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}; got {a.dtype}")
    if x_proj.dtype not in _X_DTYPES:
        raise TypeError("x_proj must be float32 or bfloat16; got "
                        f"{x_proj.dtype}")
    if B % batch_tile(B, H):
        raise ValueError(f"B = {B} is not a whole number of batch tiles of "
                         f"{batch_tile(B, H)} rows")
    named = (("x_proj", x_proj), ("wq", wq), ("scale", scale), ("h0", h0),
             ("c0", c0))
    if len({a.device for _, a in named}) != 1:
        raise ValueError("inputs on different devices")
    for name, a in named:
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if torch.is_grad_enabled() and any(a.requires_grad for _, a in named):
        raise RuntimeError("the int8 LSTM recurrence is inference-only and "
                           "an input requires grad")


def lstm_recurrence_int8(x_proj, wq, scale, h0, c0):
    """hs (B, T, H) f32 and (h_T, c_T) from x_proj (B, T, 4H) in the
    compute dtype (f32 or bf16), wq (H, 4H) int8, scale (1, 4H) f32 (w ≈
    wq * scale per output channel) and h0, c0 (B, H) f32."""
    global LAUNCHES
    _check(x_proj, wq, scale, h0, c0)
    dev = x_proj.device
    if dev.type == "cpu":
        return lstm_recurrence_int8_reference(x_proj, wq, scale, h0, c0)
    if dev.type != "cuda":
        raise ValueError(f"no int8 LSTM recurrence for device {dev}")
    B, T, H4 = x_proj.shape
    H = H4 // 4
    if T == 0:
        return x_proj.new_empty((B, 0, H), dtype=torch.float32), (h0, c0)
    fn = build.load_library()
    hs = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    c = torch.empty((B, H), dtype=torch.float32, device=dev)
    for b0, b1, plan in device_groups(B, H, dev):
        xbuf = _exchange_buffer(plan, dev)  # held through the launch
        err = fn.lstm_fwd_q(
            x_proj[b0:b1].data_ptr(), int(x_proj.dtype == torch.bfloat16),
            wq.data_ptr(), scale.data_ptr(), h0[b0:b1].data_ptr(),
            c0[b0:b1].data_ptr(), hs[b0:b1].data_ptr(), c[b0:b1].data_ptr(),
            xbuf.data_ptr(), b1 - b0, T, H,
            batch_tile(B, H), plan.units, plan.rows, plan.stage_rows,
            plan.stage_cols, *build.stream_args(dev))
        build.check_launch(fn, err, "lstm_fwd_q")
    with _launches_lock:
        LAUNCHES += 1
    return hs, (hs[:, T - 1], c)


def lstm_recurrence_int8_reference(x_proj, wq, scale, h0, c0):
    """The plain step loop, in the order of the JAX kernel's float
    operations. The int8 product is taken in float64, where every sum of
    products of int8 values is exact, then rounded to f32 as the kernel's
    int32 accumulator is."""
    _check(x_proj, wq, scale, h0, c0)
    B, T, H4 = x_proj.shape
    H = H4 // 4
    bt = batch_tile(B, H)
    nb = B // bt
    w = wq.double()
    h, c = h0, c0
    hs = torch.empty((B, T, H), dtype=torch.float32, device=x_proj.device)
    for t in range(T):
        ht = h.reshape(nb, -1, H)
        amax = tile_amax(h, bt)
        # tensor by tensor: PyTorch turns a division by (or of) a Python
        # scalar into a product with a reciprocal, which rounds otherwise
        c127 = torch.full_like(amax, 127.0)
        hq = torch.round(ht * (c127 / amax)).reshape(B, H)
        acc = (hq.double() @ w).float().reshape(nb, -1, H4)
        gates = (x_proj[:, t].float()
                 + (acc * (scale * (amax / c127))).reshape(B, H4))
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs[:, t] = h
    return hs, (h, c)


def tile_amax(h, bt: int):
    """max(max |h| over each batch tile of `bt` rows and all H units,
    1e-6): (B / bt, 1, 1), the requantization's amax of one step."""
    B, H = h.shape
    return h.reshape(B // bt, bt, H).abs().amax(
        dim=(1, 2), keepdim=True).clamp_min(1e-6)
