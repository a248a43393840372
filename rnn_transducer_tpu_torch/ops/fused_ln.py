"""Fused LayerNorm (± silu): the CUDA kernels and their plain PyTorch
versions (port of `rnn_transducer_tpu/ops/fused_ln.py`).

  * `fln_fwd` launches K8-fwd (`csrc/fused_ln.cu` `fused_ln_fwd`), which
    replaces `_fln_call_fwd`'s Pallas kernel: y, and the row statistics
    mu and rstd that the backward reads.
  * `fln_bwd` launches K8-bwd (`fused_ln_bwd`), which replaces `_fln_bwd`'s
    Pallas kernel: dx, dg and db, with dg and db summed over every row.
  * `fused_layer_norm(x, g, b, act)` is the differentiable op, the JAX
    `custom_vjp` of the same name, as a `torch.autograd.Function`.

The JAX package runs its kernel only on the TPU and only when asked
(`RNNT_FUSED_LN=1`), because there the `pallas_call` boundaries cost XLA
the fusions around each LN. The port has no XLA fusion to lose, and an
unfused LN is four or five eager passes over the rows, so here the kernel
is the conformer's LayerNorm on the card, with no switch. Both forms are
the same function to f32 tolerance (tests/test_fused_ln.py).

Each wrapper launches its kernel for a CUDA tensor and runs its
`*_reference` version for a CPU tensor; it never falls back from one to
the other, and counts the calls that launched its kernel. The TPU
kernel's padding of the rows to a multiple of 256 has no counterpart.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from rnn_transducer_tpu_torch.utils import build

EPS = 1e-6
ACTS = ("none", "silu")
LAUNCHES_FWD = 0  # fln_fwd calls that launched fused_ln_fwd
LAUNCHES_BWD = 0  # fln_bwd calls that launched fused_ln_bwd
_launches_lock = threading.Lock()
# The backward's one launch gives each of its blocks an equal share of the
# rows: one wave, two blocks of eight warps on each of the H100's 132 SMs.
# The blocks add their partial dg / db rows in groups of GROUP, each group
# in block order, then the groups in order. All of it depends on N alone,
# so the order of the dg / db sums, and their bits, are the same on every
# run (and on every card).
TARGET_BLOCKS = 264
WARPS = 8
GROUP = 17  # csrc/fused_ln.cu kGroup
MAX_REG_D = 512  # wider rows loop over the row, with per-warp partial rows
TICKETS = 32  # the groups' tickets and the final one: GROUP + 1 at most
_tickets: dict = {}  # (device index, stream) -> the backward's tickets


def _count(name: str) -> None:
    with _launches_lock:
        globals()[name] += 1


def _layer_norm(x, g, b, act: str):
    """y, mu, rstd over the last axis (mu and rstd with it kept as 1)."""
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + EPS)
    y = xc * rstd * g + b
    return (y * torch.sigmoid(y) if act == "silu" else y), mu, rstd


def layer_norm_reference(x, g, b, act: str = "none"):
    """The plain LayerNorm over the last axis, differentiable by autograd:
    the mean, the mean of the centred squares, `rsqrt(var + 1e-6)`,
    `* g + b`, then silu when act == "silu"; f32, as the JAX package's
    `_fwd_kernel` and the `_ln` of ops/conformer.py."""
    return _layer_norm(x.float(), g.float(), b.float(), act)[0]


def _check(x2, g, b, act: str, **rows) -> None:
    """x2 (N, D) f32, g and b (D,) f32, each of `rows` (name -> (tensor,
    shape)) f32 of its shape; contiguous, on one device."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}; got {act!r}")
    if x2.dim() != 2:
        raise ValueError(f"x must be (N, D); got {tuple(x2.shape)}")
    D = x2.shape[1]
    named = {"x": (x2, tuple(x2.shape)), "g": (g, (D,)), "b": (b, (D,)),
             **rows}
    for name, (a, shape) in named.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(a.shape)}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len({a.device for a, _ in named.values()}) != 1:
        raise ValueError("inputs on different devices")


def _require_cuda(x2, what: str) -> None:
    if x2.device.type != "cuda":
        raise ValueError(f"no {what} for device {x2.device}")
    if x2.shape[1] % 4:
        raise ValueError(f"{what} needs D a multiple of 4; got D = "
                         f"{x2.shape[1]}")


def fln_fwd(x2, g, b, act: str = "none"):
    """-> y (N, D), mu (N,), rstd (N,), all f32, from x2 (N, D) f32 and
    g, b (D,) f32."""
    _check(x2, g, b, act)
    if x2.device.type == "cpu":
        return fln_fwd_reference(x2, g, b, act)
    _require_cuda(x2, "fused_ln_fwd")
    N, D = x2.shape
    y = torch.empty_like(x2)
    mu = torch.empty((N,), dtype=torch.float32, device=x2.device)
    rstd = torch.empty_like(mu)
    if N == 0:
        return y, mu, rstd
    lib = build.load_library()
    err = lib.fused_ln_fwd(x2.data_ptr(), g.data_ptr(), b.data_ptr(),
                           y.data_ptr(), mu.data_ptr(), rstd.data_ptr(), N, D,
                           int(act == "silu"), *build.stream_args(x2.device))
    build.check_launch(lib, err, "fused_ln_fwd")
    _count("LAUNCHES_FWD")
    return y, mu, rstd


def fln_fwd_reference(x2, g, b, act: str = "none"):
    """Plain version of `fln_fwd` (`_fwd_kernel`'s math)."""
    _check(x2, g, b, act)
    y, mu, rstd = _layer_norm(x2, g, b, act)
    return y, mu[:, 0], rstd[:, 0]


def bwd_blocks(n: int) -> int:
    """Blocks of the backward's launch for n rows."""
    return max(1, min(n, TARGET_BLOCKS))


def row_ranges(n: int) -> list[tuple[int, int]]:
    """The rows [start, stop) of each block of the backward's launch: a
    floor or a ceiling of n / blocks each (csrc/fused_ln.cu first_row)."""
    blocks = bwd_blocks(n)
    return [(n * i // blocks, n * (i + 1) // blocks) for i in range(blocks)]


def sum_groups(n: int) -> list[list[int]]:
    """The order of the dg / db sums: the blocks' partial rows in groups of
    GROUP, each added in block order by the group's last block, then the
    group rows added in this order by the last group."""
    blocks = bwd_blocks(n)
    return [list(range(s, min(s + GROUP, blocks)))
            for s in range(0, blocks, GROUP)]


def _ticket_buffer(dev) -> torch.Tensor:
    """Zeroed ticket counters of the backward, one array a (device,
    stream): each launch leaves them zeroed, and launches on one stream
    run one after another."""
    key = build.stream_args(dev)
    with _launches_lock:
        buf = _tickets.get(key)
        if buf is None:
            buf = _tickets[key] = torch.zeros(TICKETS, dtype=torch.int32,
                                              device=dev)
    return buf


def _bwd_rows(x2, mu, rstd, dy2) -> dict:
    """The backward's row inputs with the shapes `_check` holds them to."""
    n = tuple(x2.shape[:1])
    return {"mu": (mu, n), "rstd": (rstd, n), "dy": (dy2, tuple(x2.shape))}


def fln_bwd(x2, g, b, mu, rstd, dy2, act: str = "none"):
    """-> dx (N, D), dg (D,), db (D,), all f32, from the forward's x2, g,
    b, mu, rstd and the cotangent dy2 (N, D) f32."""
    _check(x2, g, b, act, **_bwd_rows(x2, mu, rstd, dy2))
    if x2.device.type == "cpu":
        return fln_bwd_reference(x2, g, b, mu, rstd, dy2, act)
    _require_cuda(x2, "fused_ln_bwd")
    dev = x2.device
    N, D = x2.shape
    lib = build.load_library()
    blocks = bwd_blocks(N)
    groups = len(sum_groups(N))
    dx = torch.empty_like(x2)
    dg = torch.empty((D,), dtype=torch.float32, device=dev)
    db = torch.empty_like(dg)
    parts = torch.empty((blocks + groups, 2 * D), dtype=torch.float32,
                        device=dev)
    wpart = (torch.empty((blocks * WARPS, 2 * D), dtype=torch.float32,
                         device=dev) if D > MAX_REG_D else None)
    tickets = _ticket_buffer(dev)
    err = lib.fused_ln_bwd(x2.data_ptr(), g.data_ptr(), b.data_ptr(),
                           mu.data_ptr(), rstd.data_ptr(), dy2.data_ptr(),
                           dx.data_ptr(), dg.data_ptr(), db.data_ptr(),
                           parts.data_ptr(),
                           wpart.data_ptr() if wpart is not None else None,
                           tickets.data_ptr(), N, D, blocks,
                           int(act == "silu"), *build.stream_args(dev))
    build.check_launch(lib, err, "fused_ln_bwd")
    _count("LAUNCHES_BWD")
    return dx, dg, db


def device_bwd_occupancy(D: int, dev) -> int:
    """Blocks of the backward's kernel one SM of the card holds at rows
    of D floats (its occupancy, by the CUDA runtime)."""
    lib = build.load_library()
    per_sm = ctypes.c_int(0)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = lib.fused_ln_bwd_occupancy(D, index, ctypes.byref(per_sm))
    build.check_launch(lib, err, "fused_ln_bwd_occupancy")
    return per_sm.value


def fln_bwd_reference(x2, g, b, mu, rstd, dy2, act: str = "none"):
    """Plain version of `fln_bwd` (`_bwd_kernel`'s math)."""
    _check(x2, g, b, act, **_bwd_rows(x2, mu, rstd, dy2))
    rstd = rstd[:, None]
    xhat = (x2 - mu[:, None]) * rstd
    dy = dy2
    if act == "silu":  # recompute the pre-activation and chain dsilu(y)
        y = xhat * g + b
        s = torch.sigmoid(y)
        dy = dy * (s * (1.0 + y * (1.0 - s)))
    a = dy * g
    m1 = a.mean(dim=1, keepdim=True)
    m2 = (a * xhat).mean(dim=1, keepdim=True)
    return (rstd * (a - m1 - xhat * m2), (dy * xhat).sum(dim=0),
            dy.sum(dim=0))


class FusedLayerNorm(torch.autograd.Function):
    """LayerNorm over the last axis (± silu) with its gradient: K8-fwd and
    K8-bwd on the card, their plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, g, b, act):
        shape = x.shape
        x2 = x.float().reshape(-1, shape[-1]).contiguous()
        g32, b32 = g.float().contiguous(), b.float().contiguous()
        y, mu, rstd = fln_fwd(x2, g32, b32, act)
        ctx.save_for_backward(x2, g32, b32, mu, rstd)
        ctx.act = act
        ctx.dtypes = (x.dtype, g.dtype, b.dtype)
        return y.reshape(shape)

    @staticmethod
    def backward(ctx, dy):
        x2, g32, b32, mu, rstd = ctx.saved_tensors
        dy2 = dy.float().reshape(x2.shape).contiguous()
        dx, dg, db = fln_bwd(x2, g32, b32, mu, rstd, dy2, ctx.act)
        x_dt, g_dt, b_dt = ctx.dtypes
        # the gradient dtypes of `_fln_bwd`: dg and db in g's and b's
        return (dx.reshape(dy.shape).to(x_dt), dg.to(g_dt), db.to(b_dt),
                None)


def fused_layer_norm(x, g, b, act: str = "none"):
    """LayerNorm over the last axis, optionally fused with silu.

    x (..., D), computed in float32; g and b (D,). Returns f32 of x's
    shape: `(x - mean) * rsqrt(var + 1e-6) * g + b`, then silu when
    act == "silu".
    """
    return FusedLayerNorm.apply(x, g, b, act)
