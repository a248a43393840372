"""The consumed-frames lattice of the duration families (multi-blank and
TDT), walked by anti-diagonals: the shared core of `ops/rnnt_multiblank.py`
and `ops/rnnt_tdt.py`.

The grid is the JAX package's: row tau in [0, T] is "tau frames consumed",
column u in [0, U] "u labels emitted", alpha(0, 0) = 0, and a path is
accepted by exact consumption at (frame_len, label_len). Every arc goes
from a source cell (tau', u') to (tau' + dtau, u' + du) with a score read
at the source (the family's masked log-probs there); the arcs of a family
are a list of (dtau, du):

  * a blank of duration d: (d, 0);
  * a TDT token of duration d >= 1: (d, 1);
  * a same-frame emission (multi-blank's, or TDT's d = 0): (0, 1).

The JAX package scans the rows with an associative-scan row solve, which
would cost ceil(log2(U+1)) rounds of launches a row here. The port walks
the anti-diagonals k = tau + u instead: every arc comes from an earlier
diagonal (k - dtau - du), so a diagonal is one gather of every arc's
source, one add of the arc scores (skewed into diagonal-major order once,
before the walk), one log-sum-exp over the stacked arcs and one clamp at
NEG_INF, written in place. The diagonals live in one (1 + K·(U+1), B)
buffer whose row 0 is a dead cell: the backward needs every diagonal, so
the ring of the last max(d) + 2 diagonals that the forward alone would
need is the whole buffer. A cell off the grid (tau < 0 or tau > T) takes
dead arcs only and stays NEG_INF.

The backward is analytic (`torch.autograd.Function`): a beta walk over the
same diagonals in reverse (beta = 0 at the accepting cell), then each
arc's occupancy exp(alpha(src) + score + beta(dst) - log Z) at once over
the grid. The walks run under the profiler spans `duration_lattice` and
`duration_lattice_backward` (train/loop.py's SPANS). The JAX conventions
hold: NEG_INF is -1e30, a dead cell is NEG_INF exactly (the clamp after
each log-sum-exp, where JAX clamps after each arrival sum and selects
NEG_INF in `_logaddexp`), an infeasible row
(the accepting cell dead) has loss 1e30 and zero gradient, and a
zero-frame row loss 0 and zero gradient. The walk is plain PyTorch on the
caller's device (~9 launches a diagonal forward, ~10 back); a CUDA call
with TF32 matmuls on is refused, as `ops/ctc_loss.py` does, because the
f32 gates of these losses hold the card to the CPU.
"""

from __future__ import annotations

import torch

NEG_INF = -1.0e30


def check_tf32(x: torch.Tensor, what: str) -> None:
    """Refuse a CUDA tensor while TF32 matmuls are allowed."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"the {what} is held to f32; "
                           "torch.backends.cuda.matmul.allow_tf32 is on")


def _tables(T: int, U1: int, arcs, frame_lens, label_lens, dev):
    """The walk's index tables (int64 on `dev`), for K = T + U1 diagonals
    and A arcs. Cell (k, u) of the buffer is row 1 + k·U1 + u; the score of
    arc a at source (tau, u) is row 1 + (a·T + tau)·U1 + u of the flat
    scores; row 0 of either is dead.

    into (K, A, U1): the source cell of each arc arriving at (k, u);
    score_in (K, A, U1): its score; out (K, A, U1): the destination of
    each arc leaving (k, u); score_out: its score; grid (T+1)·U1: the row
    of every grid cell (tau, u); final (B,): the accepting cell's row."""
    K = T + U1
    k = torch.arange(K, device=dev)[:, None, None]
    u = torch.arange(U1, device=dev)[None, None, :]
    a = torch.arange(len(arcs), device=dev)[None, :, None]
    dt = torch.tensor([d for d, _ in arcs], device=dev)[None, :, None]
    du = torch.tensor([e for _, e in arcs], device=dev)[None, :, None]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    tau = k - u
    # arriving at (tau, u) from (tau - dt, u - du)
    st, su = tau - dt, u - du
    ok = (tau <= T) & (su >= 0) & (st >= 0) & (st < T)
    into = torch.where(ok, 1 + (k - dt - du) * U1 + su, zero)
    score_in = torch.where(ok, 1 + (a * T + st) * U1 + su, zero)
    # leaving (tau, u) for (tau + dt, u + du)
    ok = (tau >= 0) & (tau < T) & (tau + dt <= T) & (u + du < U1)
    out = torch.where(ok, 1 + (k + dt + du) * U1 + u + du, zero)
    score_out = torch.where(ok, 1 + (a * T + tau) * U1 + u, zero)
    t_g = torch.arange(T + 1, device=dev)[:, None]
    u_g = torch.arange(U1, device=dev)[None, :]
    grid = (1 + (t_g + u_g) * U1 + u_g).reshape(-1)
    fl = frame_lens.to(device=dev, dtype=torch.int64)
    ll = label_lens.to(device=dev, dtype=torch.int64)
    final = 1 + (fl + ll) * U1 + ll
    return into, score_in, out, score_out, grid, final


def _skew(scores, idx):
    """scores (A, B, T, U1) -> the (K, A, U1, B) arc scores at `idx`."""
    A, B, T, U1 = scores.shape
    flat = torch.cat([scores.new_full((1, B), NEG_INF),
                      scores.permute(0, 2, 3, 1).reshape(A * T * U1, B)])
    K = idx.shape[0]
    return flat.index_select(0, idx.reshape(-1)).view(K, A, U1, B)


def _walk(buf, idx, skewed, order, U1: int, final_mask=None):
    """Fill buf's diagonals in `order`: each the clamped log-sum-exp over
    arcs of buf[idx[k]] + skewed[k]; with final_mask (K, U1, B), 0 at the
    accepting cells (the beta walk's start)."""
    A = idx.shape[1]
    zero = buf.new_zeros(())
    for k in order:
        x = buf.index_select(0, idx[k].reshape(-1)).view(A, U1, -1)
        x = x + skewed[k]
        m = x.amax(dim=0)
        cell = buf[1 + k * U1:1 + (k + 1) * U1]
        torch.add(torch.log(torch.exp(x - m).sum(dim=0)), m, out=cell)
        if final_mask is not None:
            torch.where(final_mask[k], zero, cell, out=cell)
        cell.clamp_(min=NEG_INF)


class _DurationWalk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scores, frame_lens, label_lens, arcs):
        A, B, T, U1 = scores.shape
        dev = scores.device
        into, score_in, out, score_out, grid, final = _tables(
            T, U1, arcs, frame_lens, label_lens, dev)
        K = T + U1
        alpha = scores.new_full((1 + K * U1, B), NEG_INF)
        alpha[1] = 0.0  # alpha(0, 0)
        with torch.profiler.record_function("duration_lattice"):
            _walk(alpha, into, _skew(scores, score_in), range(1, K), U1)
        rows = torch.arange(B, device=dev)
        log_z = alpha[final, rows]
        fl = frame_lens.to(device=dev, dtype=torch.int64)
        ctx.save_for_backward(scores, alpha, log_z, fl, out, score_out,
                              grid, final)
        ctx.arcs = arcs
        return torch.where(fl == 0, torch.zeros_like(log_z), -log_z)

    @staticmethod
    def backward(ctx, g):
        scores, alpha, log_z, fl, out, score_out, grid, final = \
            ctx.saved_tensors
        A, B, T, U1 = scores.shape
        K = T + U1
        dev = scores.device
        rows = torch.arange(B, device=dev)
        final_mask = torch.zeros((1 + K * U1, B), dtype=torch.bool,
                                 device=dev)
        final_mask[final, rows] = True
        final_mask = final_mask[1:].view(K, U1, B)
        beta = scores.new_full((1 + K * U1, B), NEG_INF)
        with torch.profiler.record_function("duration_lattice_backward"):
            _walk(beta, out, _skew(scores, score_out), range(K - 1, -1, -1),
                  U1, final_mask)
        # (B, T+1, U1) grids, beta padded with dead cells past the grid
        a_g = alpha.index_select(0, grid).view(T + 1, U1, B).permute(2, 0, 1)
        b_g = beta.index_select(0, grid).view(T + 1, U1, B).permute(2, 0, 1)
        d_max = max(d for d, _ in ctx.arcs)
        b_g = torch.nn.functional.pad(b_g, (0, 1, 0, d_max), value=NEG_INF)
        live = (fl > 0) & (log_z > NEG_INF * 0.5)
        z = torch.where(live, log_z, torch.zeros_like(log_z))[:, None, None]
        coef = torch.where(live, -g.to(scores.dtype),
                           torch.zeros_like(log_z))[:, None, None]
        grads = []
        for a, (dt, du) in enumerate(ctx.arcs):
            occ = torch.exp(a_g[:, :T] + scores[a]
                            + b_g[:, dt:dt + T, du:du + U1] - z)
            grads.append(occ * coef)
        return torch.stack(grads), None, None, None


def duration_walk(scores, frame_lens, label_lens, arcs):
    """Per-utterance NLL (B,) of the consumed-frames lattice.

    scores: (A, B, T, U+1) f32, arc a's masked score at each source cell
    (NEG_INF where the arc does not exist); arcs: A pairs (dtau, du), not
    both 0; frame_lens, label_lens: (B,). Differentiable in scores."""
    arcs = tuple((int(d), int(e)) for d, e in arcs)
    if any(d < 0 or e not in (0, 1) or d + e == 0 for d, e in arcs):
        raise ValueError(f"bad arcs {arcs}")
    if scores.shape[0] != len(arcs):
        raise ValueError(f"{scores.shape[0]} score planes for "
                         f"{len(arcs)} arcs")
    return _DurationWalk.apply(scores.float(), frame_lens, label_lens, arcs)
