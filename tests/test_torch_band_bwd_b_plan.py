"""The host plan of the band joint's tensor-core kernel B
(`rnnt_band_fused.bwd_b_plan`).

The plan is plain Python, so the CPU holds it: the column tiles cover
[0, V) once, every row belongs to one split, the grid is one wave of an
H100 (132 SMs, 227 KB of shared memory a block), the block's shared
memory fits, no block is idle, and a shape the kernel does not take
raises. The kernel itself runs on the card (tests/test_torch_kernels.py).
"""

import numpy as np
import pytest

from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf

pytestmark = pytest.mark.quick

N_SM, SMEM = 132, 232_448  # H100 SXM: SMs, opt-in shared bytes a block
PRUNED_ROWS = 32 * 200 * 8  # the pruned band: B=32, T'=200, S=8


@pytest.mark.parametrize("rows", [1, 200, PRUNED_ROWS])
@pytest.mark.parametrize("V", [40, 130, 1024, 8192, 100_000])
@pytest.mark.parametrize("J", [64, 256, 512])
def test_bwd_b_plan_covers_every_column_and_row_once_in_one_wave(J, V, rows):
    plan = bf.bwd_b_plan(J, V, N_SM, SMEM, rows)
    gx, gy = plan.grid
    assert gy == plan.splits
    assert gx * gy <= N_SM  # one block per SM, all resident at once
    assert plan.smem_bytes <= SMEM
    assert plan.smem_bytes == bf.ring_b_bytes(J)
    assert plan.split_rows % bf.BWD_B_CHUNK == 0
    cols = np.zeros(V, dtype=np.int64)
    owners = np.zeros(rows, dtype=np.int64)
    for x in range(gx):
        tiles, _ = plan.owned(x, 0)
        assert tiles, "a block with no columns"
        for t in tiles:
            assert 0 < len(t) <= plan.v_tile and t.start % plan.v_tile == 0
            cols[t.start:t.stop] += 1
    for y in range(gy):
        _, r = plan.owned(0, y)
        assert len(r) > 0, "a split with no rows"
        owners[r.start:r.stop] += 1
    assert (cols == 1).all()
    assert (owners == 1).all()
    # zb holds every row, padded to whole chunks, at the kernel's pitch
    zr, zp = plan.zb_shape
    assert zr % bf.BWD_B_CHUNK == 0 and rows <= zr < rows + bf.BWD_B_CHUNK
    assert zp >= J + 8 and zp % 64 == 8


def test_bwd_b_plan_libri100_tiles():
    """The pruned band's V=8192: 128 tiles of 64 columns, one split, one
    wave; the AR step's V=1024: 16 tiles by 8 splits."""
    plan = bf.bwd_b_plan(512, 8192, N_SM, SMEM, PRUNED_ROWS)
    assert (plan.v_tile, plan.splits, plan.grid) == (64, 1, (128, 1))
    assert plan.split_rows >= PRUNED_ROWS
    plan = bf.bwd_b_plan(512, 1024, N_SM, SMEM, 32 * 200 * 8)
    assert (plan.v_tile, plan.splits, plan.grid) == (64, 8, (16, 8))
    assert plan.split_rows == PRUNED_ROWS // 8


def test_bwd_b_plan_shared_memory_at_full_width():
    """At J=512 the ring (2 x 64 rows), the W tile, dlogits^T, the f32
    dlogits and two mbarriers: 226,320 bytes, under the H100's 232,448."""
    assert bf.ring_b_bytes(512) == (2 * 64 * 520 * 2 + 64 * 520 * 2
                                    + 64 * 72 * 2 + 64 * 68 * 4 + 16)
    assert bf.ring_b_bytes(512) == 226_320


def test_bwd_b_plan_never_splits_rows_past_a_chunk():
    """A few rows and many SMs to spare: no more splits than chunks."""
    plan = bf.bwd_b_plan(64, 40, N_SM, SMEM, 9 * 64)
    assert plan.splits <= 9
    assert sum(len(plan.owned(0, y)[1]) for y in range(plan.splits)) == 576


@pytest.mark.parametrize("J, V, n_sm, smem, rows", [
    (1024, 8192, N_SM, SMEM, 100),  # J > 512
    (528, 8192, N_SM, SMEM, 100),   # J > 512 with J % 16 == 0
    (72, 8192, N_SM, SMEM, 100),    # J % 16 != 0
    (96, 1023, N_SM, SMEM, 100),    # V odd
    (512, 8192, N_SM, 48 * 1024, 100),  # too little shared memory
    (512, 8192, N_SM, SMEM, 0),     # no rows
])
def test_bwd_b_plan_refuses_what_it_cannot_place(J, V, n_sm, smem, rows):
    with pytest.raises(ValueError, match=f"J={J}, V={V}"):
        bf.bwd_b_plan(J, V, n_sm, smem, rows)


@pytest.mark.parametrize("J, V, ok", [(512, 8192, True), (96, 130, True),
                                      (24, 40, False), (64, 37, False)])
def test_mma_shapes_ok_routes_the_odd_shapes_to_the_cuda_cores(J, V, ok):
    assert bf.mma_shapes_ok(J, V) is ok
