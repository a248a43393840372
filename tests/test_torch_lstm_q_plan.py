"""The host plan of the W8A8 LSTM recurrence (K7, `csrc/lstm_fwd_q.cu`):
its tile, `lstm_cuda.fwd_q_plan`, a third layout in the one search of
`lstm_cuda.lstm_plan`; the groups of whole batch tiles that
`lstm_int8_cuda.groups` launches one after another where one wave cannot
hold the batch; and a mirror of the kernel's step (a), each batch tile's
amax from the blocks' per-row slots.

All of it is plain Python, so the CPU holds it on an H100's limits (132
SMs, 227 KB of shared memory a block). The kernel runs on the card
(tests/test_torch_kernels.py).
"""

import numpy as np
import pytest
import torch

from rnn_transducer_tpu_torch.ops import lstm_cuda
from rnn_transducer_tpu_torch.ops import lstm_int8_cuda as q8

pytestmark = pytest.mark.quick

N_SM, SMEM = 132, 232_448  # H100 SXM: SMs, opt-in shared bytes a block


def _tiles_met(plan, bt, y):
    """The batch tiles that the rows of block row y meet, as the kernel
    counts them."""
    b0 = y * plan.rows
    first = b0 // bt
    return range(first, (min(b0 + plan.rows, plan.B) - 1) // bt + 1)


@pytest.mark.parametrize("B, H", [(8, 512), (16, 512), (32, 512),
                                  (64, 1024), (8, 2048), (24, 512),
                                  (72, 512), (64, 512), (3, 100), (1, 64),
                                  (128, 512)])
def test_fwd_q_plan_places_every_pair_once_in_one_wave(B, H):
    plan = lstm_cuda.fwd_q_plan(B, H, N_SM, SMEM)
    assert plan.direction == "fwd_q"
    gx, gy = plan.grid
    assert gx * gy <= N_SM  # one block per SM, all resident at once
    assert plan.smem_bytes <= SMEM
    owners = np.zeros((B, H), dtype=np.int64)
    for x in range(gx):
        for y in range(gy):
            units, rows = plan.owned(x, y)
            assert len(units) > 0 and len(rows) > 0, "an idle block"
            owners[rows.start:rows.stop, units.start:units.stop] += 1
    assert (owners == 1).all()
    # the kernel's constraints: pairs a thread, units, k32 mma steps of
    # each warp's slice, passes, and at most 4 batch tiles a block
    assert plan.units * plan.rows <= 2 * plan.threads
    assert plan.units in (32, 16)
    assert plan.rows % plan.stage_rows == 0 and plan.stage_rows % 8 == 0
    assert plan.k_pad >= H and plan.k_pad % 256 == 0
    assert plan.k_pad % plan.stage_cols == 0 and plan.stage_cols % 256 == 0
    bt = q8.batch_tile(B, H)
    assert bt == B or plan.rows % bt == 0 or bt % plan.rows == 0
    assert all(len(_tiles_met(plan, bt, y)) <= 4 for y in range(gy))
    # the layout: 4 UB int8 gate columns over k_pad, the f32 stage, the 8
    # warps' int32 partials and maxima of each of 4 tiles, the mbarrier
    assert plan.smem_bytes == (
        4 * plan.units * (plan.k_pad + 16)
        + plan.stage_rows * (plan.stage_cols + 16) * 4
        + 8 * plan.rows * 4 * plan.units * 4 + 8 * 4 * 4 + 16)


def test_fwd_q_plan_serving_tile():
    """libri100 serving, B=8, H=512: bf16's tile, 16 units by 8 rows on
    32 blocks, one pass of 8 rows by 512 columns a step."""
    plan = lstm_cuda.fwd_q_plan(8, 512, N_SM, SMEM)
    assert (plan.units, plan.rows, plan.grid) == (16, 8, (32, 1))
    assert (plan.stage_rows, plan.stage_cols, plan.k_pad, plan.passes) == (
        8, 512, 512, 1)


def test_fwd_q_plan_tightest_tile():
    """One 64-row batch tile at H=1024 (libri960's width), which cannot be
    split: 32 units by 16 rows on 128 blocks, a 133,120-byte int8 W slice,
    2 passes of 8 rows by 1024 columns, within the 227 KB of a block."""
    plan = lstm_cuda.fwd_q_plan(64, 1024, N_SM, SMEM)
    assert (plan.units, plan.rows, plan.grid) == (32, 16, (32, 4))
    assert (plan.stage_rows, plan.stage_cols, plan.passes) == (8, 1024, 2)
    assert 128 * (1024 + 16) == 133_120 < plan.smem_bytes <= SMEM


@pytest.mark.parametrize("B, H", [(8, 512), (32, 512), (64, 512)])
def test_fwd_q_and_fwd_plans_are_one_search(B, H):
    """The int8 forward is a third layout of `lstm_plan`, beside "fwd" and
    "bwd": the same units and rows a block as bf16's forward at libri100's
    shapes, with a W slice half of bf16's (a byte against two) and the
    stage in f32, quantized as it is read."""
    q = lstm_cuda.lstm_plan("fwd_q", B, H, torch.int8, N_SM, SMEM)
    assert q == lstm_cuda.fwd_q_plan(B, H, N_SM, SMEM)
    f = lstm_cuda.fwd_plan(B, H, torch.bfloat16, N_SM, SMEM)
    assert (q.units, q.rows, q.grid) == (f.units, f.rows, f.grid)
    w_slice = {"fwd_q": 4 * q.units * (q.k_pad + 16),
               "fwd": 4 * f.units * (f.k_pad + 8) * 2}
    assert 2 * w_slice["fwd_q"] == w_slice["fwd"] + 4 * f.units * 16


@pytest.mark.parametrize("direction, dtype", [
    ("fwd_q", torch.bfloat16), ("fwd_q", torch.float32),
    ("fwd", torch.int8), ("bwd", torch.int8)])
def test_plans_refuse_a_mismatched_dtype(direction, dtype):
    with pytest.raises(TypeError):
        lstm_cuda.lstm_plan(direction, 8, 512, dtype, N_SM, SMEM)


@pytest.mark.parametrize("B, H", [(8, 512), (24, 512), (64, 1024),
                                  (16, 2048), (3, 100)])
def test_groups_are_one_launch_where_one_wave_holds_the_batch(B, H):
    (b0, b1, plan), = q8.groups(B, H, N_SM, SMEM)
    assert (b0, b1) == (0, B)
    assert plan == lstm_cuda.fwd_q_plan(B, H, N_SM, SMEM)


@pytest.mark.parametrize("B, H, n_groups", [(256, 512, 2), (48, 2048, 2),
                                            (4096, 1024, 64),
                                            (384, 512, 3)])
def test_groups_cover_whole_batch_tiles_in_order(B, H, n_groups):
    """A batch that one wave cannot hold runs in order as the fewest groups
    of whole batch tiles: each group placed, the first as large as a
    wave allows (one tile more does not place), the last the rest."""
    with pytest.raises(ValueError, match=f"B={B}, H={H}"):
        lstm_cuda.fwd_q_plan(B, H, N_SM, SMEM)
    bt = q8.batch_tile(B, H)
    groups = q8.groups(B, H, N_SM, SMEM)
    assert len(groups) == n_groups
    assert groups[0][0] == 0 and groups[-1][1] == B
    for (_, end, _), (start, _, _) in zip(groups, groups[1:]):
        assert end == start
    for b0, b1, plan in groups:
        assert b0 % bt == 0 and (b1 - b0) % bt == 0
        assert plan == lstm_cuda.fwd_q_plan(b1 - b0, H, N_SM, SMEM)
        gx, gy = plan.grid
        assert gx * gy <= N_SM and plan.smem_bytes <= SMEM
    per = groups[0][1]
    assert all(b1 - b0 == per for b0, b1, _ in groups[:-1])
    with pytest.raises(ValueError):
        lstm_cuda.fwd_q_plan(per + bt, H, N_SM, SMEM)


def test_groups_refuse_a_tile_they_cannot_place():
    """At H=4096 one 8-row tile needs 256 blocks of 16 units: no group."""
    with pytest.raises(ValueError, match="lstm_fwd_q.*B=8, H=4096"):
        q8.groups(8, 4096, N_SM, SMEM)


@pytest.mark.parametrize("B", [8, 24, 64, 72])
def test_tile_amax_from_the_blocks_slots(B):
    """Step (a) of the kernel, mirrored: after step t each block (x, y)
    writes, for each of its rows, the max |h_t| over its units; each block
    then takes every batch tile its rows meet as the max of that tile's
    rows' slots over the grid's x, then 1e-6. It equals the plain
    version's amax of every tile, whichever block reads it."""
    H = 512
    rng = np.random.default_rng(B)
    h = torch.from_numpy(rng.normal(size=(B, H)) * rng.uniform(
        0.01, 2.0, size=(B, 1))).float()
    bt = q8.batch_tile(B, H)
    plan = lstm_cuda.fwd_q_plan(B, H, N_SM, SMEM)
    gx, gy = plan.grid
    slots = torch.zeros(gy * plan.rows, gx)
    for x in range(gx):
        for y in range(gy):
            units, rows = plan.owned(x, y)
            slots[rows.start:rows.stop, x] = h[
                rows.start:rows.stop, units.start:units.stop].abs().amax(1)
    want = q8.tile_amax(h, bt).flatten()
    seen = set()
    for y in range(gy):
        for ti in _tiles_met(plan, bt, y):
            got = slots[ti * bt:(ti + 1) * bt].amax().clamp_min(1e-6)
            assert torch.equal(got, want[ti])
            seen.add(ti)
    assert seen == set(range(B // bt))
