"""The host plan of the fused joint's tensor-core kernel B (K2-B) on the
ring it shares with the band joint: `rnnt_band_fused.bwd_b_plan` over
N = B * T * (U+1) cells, row r = (b * T + t) * (U+1) + u.

The plan is plain Python, so the CPU holds it at K2's shapes: the column
tiles cover [0, V) once, every cell belongs to one split, the grid is one
wave of an H100 (132 SMs, 227 KB of shared memory a block), zb holds every
cell, and a shape the ring does not take raises. The wrapper builds no
per-cell sidecars in Python (the kernel's row policy reads labels, base,
gb, gy and gbar itself); the kernels run on the card
(tests/test_torch_kernels.py).
"""

import numpy as np
import pytest

from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf

pytestmark = pytest.mark.quick

N_SM, SMEM = 132, 232_448  # H100 SXM: SMs, opt-in shared bytes a block


def _covers_once(plan, V, rows):
    gx, gy = plan.grid
    assert gy == plan.splits and gx * gy <= N_SM
    cols = np.zeros(V, dtype=np.int64)
    cells = np.zeros(rows, dtype=np.int64)
    for x in range(gx):
        for t in plan.owned(x, 0)[0]:
            assert 0 < len(t) <= plan.v_tile and t.start % plan.v_tile == 0
            cols[t.start:t.stop] += 1
    for y in range(gy):
        r = plan.owned(0, y)[1]
        assert len(r) > 0, "a split with no cells"
        cells[r.start:r.stop] += 1
    assert (cols == 1).all() and (cells == 1).all()


@pytest.mark.parametrize("B, T, U1", [(32, 200, 41),   # libri100, T'=200
                                      (64, 100, 41)])  # the conformer
def test_bwd_b_plan_at_the_training_steps_cells(B, T, U1):
    """262,400 cells at V=1024: 16 tiles by 8 splits of 513 chunks, one
    wave; zb (262,400, 520) bf16, 273 MB."""
    rows = B * T * U1
    plan = bf.bwd_b_plan(512, 1024, N_SM, SMEM, rows)
    assert (plan.v_tile, plan.splits, plan.grid) == (64, 8, (16, 8))
    assert plan.split_rows == 513 * 64
    assert plan.zb_shape == (262_400, 520)
    assert plan.zb_shape[0] * plan.zb_shape[1] * 2 == 272_896_000
    assert plan.smem_bytes == bf.ring_b_bytes(512) <= SMEM
    _covers_once(plan, 1024, rows)


@pytest.mark.parametrize("B, T, U1, J, V", [(2, 7, 5, 64, 38),
                                            (3, 9, 41, 512, 1024),
                                            (1, 3, 70, 96, 130),
                                            (1, 1, 1, 16, 2),
                                            (5, 13, 3, 128, 1000),
                                            (2, 50, 41, 512, 8192)])
def test_bwd_b_plan_covers_every_cell_once_at_ragged_shapes(B, T, U1, J, V):
    """Cells not a multiple of the 64-row chunk (70, 1107, 210, 1, 195),
    V not a multiple of the 64-column tile, one split and several."""
    rows = B * T * U1
    plan = bf.bwd_b_plan(J, V, N_SM, SMEM, rows)
    assert plan.split_rows % bf.BWD_B_CHUNK == 0
    assert plan.splits <= -(-rows // bf.BWD_B_CHUNK)
    zr, zp = plan.zb_shape
    assert zr % bf.BWD_B_CHUNK == 0 and rows <= zr < rows + bf.BWD_B_CHUNK
    assert zp == bf.zb_pitch(J) and zp >= J + 8
    _covers_once(plan, V, rows)


def test_bwd_b_plan_takes_one_split_where_the_tiles_fill_the_card():
    """V=8192 at the libri100 cells: 128 tiles, one split, so the ring
    writes dW and db itself and no ordered sum runs for them."""
    plan = bf.bwd_b_plan(512, 8192, N_SM, SMEM, 32 * 200 * 41)
    assert (plan.splits, plan.grid) == (1, (128, 1))
    assert plan.split_rows >= 32 * 200 * 41


@pytest.mark.parametrize("J, V", [(1024, 1024),  # J > 512
                                  (528, 1024),   # J > 512, J % 16 == 0
                                  (72, 1024),    # J % 16 != 0
                                  (8, 1024),     # J < 16
                                  (512, 1023)])  # V odd
def test_bwd_b_plan_refuses_what_the_ring_does_not_take(J, V):
    with pytest.raises(ValueError, match=f"J={J}, V={V}"):
        bf.bwd_b_plan(J, V, N_SM, SMEM, 32 * 200 * 41)
