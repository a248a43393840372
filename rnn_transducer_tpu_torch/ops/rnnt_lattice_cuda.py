"""RNN-T lattice recursions: the CUDA kernel and its plain PyTorch versions.

`csrc/lattice.cu` (K3) replaces the JAX package's Pallas wavefront,
`rnn_transducer_tpu/ops/rnnt_lattice_pallas.py` `wavefront`, which it runs
through `alpha_wavefront` and `beta_wavefront`:

  * `alpha_wavefront` -> alpha (B, T, U+1): one launch of `lattice_alpha`;
  * `beta_wavefront` -> beta, and `beta_occupancies` -> beta with the
    blank and emit occupancies of `occupancies_from_lp` (rnnt_loss.py), both
    from one launch of `lattice_beta`.

Both launches walk each utterance's diagonals with up to four warps, each
over a band of the lattice's columns, on the plan of `walk_plan`: the
warps, the cells a lane, and the ring of staged diagonals in shared
memory. Where a diagonal is too long for that plan (U+1 above 11,136 for
alpha, 7,936 for beta), `tile_plan` cuts the columns into tiles that fit
it, and the kernel walks them one launch a tile, each tile reading its
boundary column from the tile before it; beta_occupancies then adds one
`lattice_occupancy` launch.

All take the masked transition scores of `ops/rnnt_loss._masked_transitions`
(and its `_accept_scores`), (B, T, U+1) f32; the lattice conventions are the
JAX package's (NEG_INF = -1e30, unreachable cells at or below -1e29, an
utterance with no frames has zero occupancies).

The plain versions run along the same anti-diagonals d = t + u: every cell
of a diagonal depends only on the diagonal before it, so each step is one
vectorised update over (B, U+1), and a lattice takes T + U steps of about
ten small launches each. The JAX package runs its default alpha / beta as a
scan over t with a log-depth row solve (`_alpha_scan`, `_beta_scan`); the
two give the same values up to float32 summation order.

Each wrapper launches its kernel for a CUDA tensor and runs its
`*_reference` version for a CPU tensor; it never falls back from one to
the other. Each counts the calls that launched its kernel.
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import torch

from rnn_transducer_tpu_torch.utils import build

NEG_INF = -1.0e30
# The walk's plan (csrc/lattice.cu): up to MAX_WALKERS warps walk a
# lattice, each over a band of 32 k columns; a lane's k cells stay in
# registers up to MAX_REG_CELLS; the scores are staged CHUNK diagonals (at
# most a warp's lanes) at a time into a ring of SLOTS chunks, both cut
# down where a long diagonal leaves the ring no room in a block's
# SMEM_BYTES (the H100's opt-in limit) beside 3 mbarriers a slot,
# HAND_BYTES of handoff words and log_z.
MAX_WALKERS = 4
MAX_REG_CELLS = 8
CHUNK = 32
SLOTS = 4
SMEM_BYTES = 232_448
HAND_BYTES = 8 * 4 * 256

# calls that launched the kernel (once a call, however many column tiles)
LAUNCHES_ALPHA = 0  # alpha_wavefront calls that launched lattice_alpha
LAUNCHES_BETA = 0   # beta_wavefront / beta_occupancies: lattice_beta
_launches_lock = threading.Lock()


def _count(name: str) -> None:
    with _launches_lock:
        globals()[name] += 1


def _logaddexp(a, b):
    """logaddexp that keeps a doubly masked cell at NEG_INF."""
    mx = torch.maximum(a, b)
    mn = torch.minimum(a, b)
    out = mx + torch.log1p(torch.exp(mn - mx))
    return torch.where(mx <= NEG_INF * 0.5,
                       torch.full_like(out, NEG_INF), out)


def _check(**named):
    """Every array (B, T, U+1) f32, contiguous, on one device."""
    shape = tuple(next(iter(named.values())).shape)
    if len(shape) != 3 or shape[2] < 1:
        raise ValueError(f"lattice arrays must be (B, T, U+1); got {shape}")
    for name, a in named.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(a.shape)}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if len({a.device for a in named.values()}) != 1:
        raise ValueError("inputs on different devices")


def _require_cuda(dev: torch.device, what: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"no {what} for device {dev}")


@dataclasses.dataclass(frozen=True)
class WalkPlan:
    """How the walking warps and the staging warps of one lattice launch
    lay out a diagonal of U+1 cells."""
    warps: int        # walker warps: min(4, ceil((U+1) / 32))
    k: int            # cells a lane: ceil((U+1) / (32 warps))
    registers: bool   # a lane's cells in registers (else shared memory)
    chunk: int        # diagonals a staged chunk
    slots: int        # chunks in the ring
    window: int       # diagonals staged ahead of the walk at most
    smem_bytes: int   # dynamic shared memory of a block


def walk_plan(U1: int, beta: bool) -> WalkPlan:
    """The plan of `lattice_alpha` (beta False: lpb and lpy staged) or
    `lattice_beta` (beta True: accept too) for diagonals of U1 cells: the
    largest chunk, then the most slots, whose ring fits SMEM_BYTES beside
    the 3 slots mbarriers, the handoff words, log_z and, for k >
    MAX_REG_CELLS, the cells. Raises ValueError where not even two slots of
    one diagonal fit."""
    if U1 < 1:
        raise ValueError(f"the lattice needs U+1 >= 1; got {U1}")
    warps = min(MAX_WALKERS, -(-U1 // 32))
    k = -(-U1 // (32 * warps))
    pitch = 32 * k * warps
    arrays = 3 if beta else 2
    fixed = HAND_BYTES + 16 + (0 if k <= MAX_REG_CELLS else 4 * pitch)
    chunk = CHUNK
    while chunk >= 1:
        for slots in range(SLOTS, 1, -1):
            smem = slots * chunk * arrays * pitch * 4 + 24 * slots + fixed
            if smem <= SMEM_BYTES:
                return WalkPlan(warps, k, k <= MAX_REG_CELLS, chunk, slots,
                                chunk * slots, smem)
        chunk //= 2
    raise ValueError(
        f"lattice_{'beta' if beta else 'alpha'}: a diagonal of U+1 = {U1} "
        f"cells needs {2 * arrays * pitch * 4 + 48 + fixed} bytes of shared "
        f"memory for two staged diagonals; a block has {SMEM_BYTES}")


@dataclasses.dataclass(frozen=True)
class Tile:
    """One launch of a lattice walked in column tiles: the columns u0 ..
    u0 + width - 1, whether it reads its boundary column (alpha: u0 - 1,
    beta: u0 + width) from the tile launched before it, and its plan."""
    u0: int
    width: int
    edge: bool
    plan: WalkPlan


TILE_COLUMNS = 128  # a tile with an edge spans whole bands of 4 x 32 k


@functools.lru_cache(maxsize=None)
def tile_plan(U1: int, beta: bool) -> tuple[Tile, ...]:
    """The launches of a lattice of U1 columns, in launch order: the whole
    lattice where `walk_plan` takes it; else tiles of the widest multiple
    of TILE_COLUMNS that it takes, each with an edge, and one tile of the
    remaining columns without one, at the end the walk starts from
    (alpha: the first columns, launched first; beta: the last columns,
    launched first, the rest right to left)."""
    try:
        return (Tile(0, U1, False, walk_plan(U1, beta)),)
    except ValueError:
        if U1 < 1:
            raise
    full = U1 // TILE_COLUMNS * TILE_COLUMNS
    while True:
        try:
            plan = walk_plan(full, beta)
            break
        except ValueError:
            full -= TILE_COLUMNS
    n_full = (U1 - 1) // full
    rest = U1 - n_full * full
    if beta:
        tiles = [Tile(n_full * full, rest, False, walk_plan(rest, beta))]
        tiles += [Tile(i * full, full, True, plan)
                  for i in reversed(range(n_full))]
    else:
        tiles = [Tile(0, rest, False, walk_plan(rest, beta))]
        tiles += [Tile(rest + i * full, full, True, plan)
                  for i in range(n_full)]
    return tuple(tiles)


def _at(t: torch.Tensor, u0: int) -> int:
    """Address of column u0 of row 0 of a (B, T, U+1) f32 array."""
    return t.data_ptr() + 4 * u0


def plan_args(plan: WalkPlan) -> tuple:
    """The plan as the C entries take it: warps, k, chunk, slots,
    smem_bytes."""
    return plan.warps, plan.k, plan.chunk, plan.slots, plan.smem_bytes


# ------------------------------- alpha -----------------------------------

def alpha_wavefront(lp_blank_m, lp_y_m):
    """alpha (B, T, U+1) f32: alpha[t, u] = logaddexp(alpha[t-1, u] +
    lp_blank[t-1, u], alpha[t, u-1] + lp_y[t, u-1]), alpha[0, 0] = 0."""
    _check(lp_blank_m=lp_blank_m, lp_y_m=lp_y_m)
    dev = lp_blank_m.device
    if dev.type == "cpu":
        return alpha_wavefront_reference(lp_blank_m, lp_y_m)
    _require_cuda(dev, "lattice_alpha")
    return _launch_alpha(build.load_library(), lp_blank_m, lp_y_m)


def _launch_alpha(fn, lp_blank_m, lp_y_m):
    """lattice_alpha of the library `fn` on the card -> alpha: one launch,
    or one a column tile."""
    dev = lp_blank_m.device
    B, T, U1 = lp_blank_m.shape
    tiles = tile_plan(U1, beta=False)
    alpha = torch.empty((B, T, U1), dtype=torch.float32, device=dev)
    if B * T == 0:
        return alpha
    for tile in tiles:
        err = fn.lattice_alpha(
            _at(lp_blank_m, tile.u0), _at(lp_y_m, tile.u0),
            _at(alpha, tile.u0), B, T, tile.width, U1, int(tile.edge),
            *plan_args(tile.plan), *build.stream_args(dev))
        build.check_launch(fn, err, "lattice_alpha")
    _count("LAUNCHES_ALPHA")
    return alpha


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


def alpha_wavefront_reference(lp_blank_m, lp_y_m):
    """Plain version of `alpha_wavefront`: one (B, U+1) update per
    anti-diagonal."""
    _check(lp_blank_m=lp_blank_m, lp_y_m=lp_y_m)
    B, T, U1 = lp_blank_m.shape
    dev = lp_blank_m.device
    if B * T == 0:
        return lp_blank_m.new_empty((B, T, U1))
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


# ------------------------------- beta ------------------------------------

def _launch_beta(fn, lp_blank_m, lp_y_m, accept, alpha=None,
                 frame_lens=None):
    """lattice_beta of the library `fn` on the card -> beta, and (g_blank,
    g_y) or (None, None): one launch, or one a column tile and then
    lattice_occupancy."""
    dev = lp_blank_m.device
    B, T, U1 = lp_blank_m.shape
    tiles = tile_plan(U1, beta=True)
    beta = torch.empty((B, T, U1), dtype=torch.float32, device=dev)
    occ = alpha is not None
    g_blank = torch.empty_like(beta) if occ else None
    g_y = torch.empty_like(beta) if occ else None
    if B * T == 0:
        return beta, g_blank, g_y
    fl = frame_lens.to(dev, torch.int32).contiguous() if occ else None
    fused = occ and len(tiles) == 1  # the occupancies in the walk's launch
    for tile in tiles:
        err = fn.lattice_beta(
            _at(lp_blank_m, tile.u0), _at(lp_y_m, tile.u0),
            _at(accept, tile.u0), alpha.data_ptr() if fused else None,
            fl.data_ptr() if fused else None, _at(beta, tile.u0),
            g_blank.data_ptr() if fused else None,
            g_y.data_ptr() if fused else None, B, T, tile.width, U1,
            int(tile.edge), *plan_args(tile.plan), *build.stream_args(dev))
        build.check_launch(fn, err, "lattice_beta")
    if occ and not fused:
        err = fn.lattice_occupancy(
            lp_blank_m.data_ptr(), lp_y_m.data_ptr(), accept.data_ptr(),
            alpha.data_ptr(), fl.data_ptr(), beta.data_ptr(),
            g_blank.data_ptr(), g_y.data_ptr(), B, T, U1,
            *build.stream_args(dev))
        build.check_launch(fn, err, "lattice_occupancy")
    _count("LAUNCHES_BETA")
    return beta, g_blank, g_y


def beta_wavefront(lp_blank_m, lp_y_m, accept):
    """beta (B, T, U+1) f32: beta[t, u] = logaddexp(accept[t, u],
    lp_blank[t, u] + beta[t+1, u], lp_y[t, u] + beta[t, u+1])."""
    _check(lp_blank_m=lp_blank_m, lp_y_m=lp_y_m, accept=accept)
    dev = lp_blank_m.device
    if dev.type == "cpu":
        return beta_wavefront_reference(lp_blank_m, lp_y_m, accept)
    _require_cuda(dev, "lattice_beta")
    return _launch_beta(build.load_library(), lp_blank_m, lp_y_m, accept)[0]


def beta_wavefront_reference(lp_blank_m, lp_y_m, accept):
    """Plain version of `beta_wavefront`: the reversed anti-diagonal loop."""
    _check(lp_blank_m=lp_blank_m, lp_y_m=lp_y_m, accept=accept)
    B, T, U1 = lp_blank_m.shape
    dev = lp_blank_m.device
    if B * T == 0:
        return lp_blank_m.new_empty((B, T, U1))
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


def _check_occ(lp_blank_m, lp_y_m, accept, alpha, frame_lens):
    _check(lp_blank_m=lp_blank_m, lp_y_m=lp_y_m, accept=accept, alpha=alpha)
    B = lp_blank_m.shape[0]
    if tuple(frame_lens.shape) != (B,):
        raise ValueError(f"frame_lens must be ({B},); got "
                         f"{tuple(frame_lens.shape)}")


def beta_occupancies(lp_blank_m, lp_y_m, accept, alpha, frame_lens):
    """beta and the blank and emit arc posteriors g_blank, g_y, each
    (B, T, U+1) f32, from one launch:

        g_blank = exp(alpha + logaddexp(lp_blank + beta[t+1], accept) - log_z)
        g_y     = exp(alpha + lp_y + beta[u+1] - log_z)

    with log_z = beta[:, 0, 0]; zeros for a row with frame_lens 0."""
    _check_occ(lp_blank_m, lp_y_m, accept, alpha, frame_lens)
    dev = lp_blank_m.device
    if dev.type == "cpu":
        return beta_occupancies_reference(lp_blank_m, lp_y_m, accept, alpha,
                                          frame_lens)
    _require_cuda(dev, "lattice_beta")
    return _launch_beta(build.load_library(), lp_blank_m, lp_y_m, accept,
                        alpha, frame_lens)


def beta_occupancies_reference(lp_blank_m, lp_y_m, accept, alpha,
                               frame_lens):
    """Plain version of `beta_occupancies`: the plain beta, then the
    occupancy arithmetic of the JAX package's `occupancies_from_lp`."""
    _check_occ(lp_blank_m, lp_y_m, accept, alpha, frame_lens)
    beta = beta_wavefront_reference(lp_blank_m, lp_y_m, accept)
    B, T, U1 = lp_blank_m.shape
    if B * T == 0:
        return beta, torch.zeros_like(beta), torch.zeros_like(beta)
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
    return beta, g_blank, g_y
