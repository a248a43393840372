"""The host-side layout of K3's walk (`ops/rnnt_lattice_cuda.walk_plan`):
the walking warps and the cells a lane of each holds, whether they fit in
registers, the ring of staged diagonals in shared memory and its bytes,
and the refusal of a diagonal too long for a block's shared memory; and
the column tiles (`tile_plan`) that walk such a diagonal in several
launches. The kernel itself (csrc/lattice.cu) runs only on the card
(tests/test_torch_kernels.py); these checks need no card."""

import pytest

from rnn_transducer_tpu_torch.ops import rnnt_lattice_cuda as lat

pytestmark = pytest.mark.quick

# U+1 -> (walking warps, cells a lane, in registers): a single cell, the
# training step's lattices (U+1 = 41 fused, 81 two-pass, 101 pruned), two
# and five cells a lane, and a diagonal longer than a block of 1024 threads
CELLS = {1: (1, 1, True), 2: (1, 1, True), 41: (2, 1, True),
         81: (3, 1, True), 101: (4, 1, True), 200: (4, 2, True),
         513: (4, 5, True), 1101: (4, 9, False)}
# the longest diagonal each plan takes: two staged diagonals of lpb, lpy
# (and accept) and the cells of a lane in shared memory fill a block
MAX_U1 = {False: 11_136, True: 7_936}


def _bytes(plan, U1, beta):
    """The kernel's count (csrc/lattice.cu plan_bytes): the ring, three
    mbarriers a slot, the handoff words, log_z, and the cells where
    registers cannot hold them."""
    pitch = 32 * plan.k * plan.warps
    arrays = 3 if beta else 2
    return (plan.slots * plan.chunk * arrays * pitch * 4 + 24 * plan.slots
            + lat.HAND_BYTES + 16 + (0 if plan.registers else 4 * pitch))


@pytest.mark.parametrize("beta", [False, True])
@pytest.mark.parametrize("U1", sorted(CELLS))
def test_walk_plan_lays_out_the_diagonal(U1, beta):
    plan = lat.walk_plan(U1, beta)
    warps, k, registers = CELLS[U1]
    assert (plan.warps, plan.k, plan.registers) == (warps, k, registers)
    # every cell on one lane of one band, no band empty
    assert 32 * plan.k * plan.warps >= U1 > 32 * plan.k * (plan.warps - 1)
    assert plan.warps <= lat.MAX_WALKERS
    assert plan.smem_bytes == _bytes(plan, U1, beta) <= lat.SMEM_BYTES
    assert plan.window == plan.chunk * plan.slots >= 2
    assert plan.slots >= 2  # a chunk is staged while the last one is walked
    if U1 <= 101:  # the training lattices take the whole ring
        assert (plan.chunk, plan.slots) == (lat.CHUNK, lat.SLOTS)
    # the plan is the largest chunk, then the most slots, that fits
    bigger = [(c, s) for c in (plan.chunk * 2,) if c <= lat.CHUNK
              for s in range(2, lat.SLOTS + 1)]
    bigger += [(plan.chunk, s) for s in range(plan.slots + 1, lat.SLOTS + 1)]
    for chunk, slots in bigger:
        grown = lat.WalkPlan(plan.warps, plan.k, plan.registers, chunk,
                             slots, chunk * slots, 0)
        assert _bytes(grown, U1, beta) > lat.SMEM_BYTES
    assert lat.plan_args(plan) == (plan.warps, plan.k, plan.chunk,
                                   plan.slots, plan.smem_bytes)


def test_beta_stages_three_rows_a_diagonal_and_alpha_two():
    a, b = lat.walk_plan(101, False), lat.walk_plan(101, True)
    assert (a.chunk, a.slots) == (b.chunk, b.slots)
    ring = [p.smem_bytes - 24 * p.slots - lat.HAND_BYTES - 16
            for p in (a, b)]
    assert 2 * ring[1] == 3 * ring[0]


@pytest.mark.parametrize("U1, beta", [(20_000, False), (9_000, True),
                                      (0, False)])
def test_walk_plan_refuses_what_a_block_cannot_hold(U1, beta):
    with pytest.raises(ValueError, match="lattice_beta|lattice_alpha|U\\+1"):
        lat.walk_plan(U1, beta)


@pytest.mark.parametrize("beta", [False, True])
def test_walk_plan_takes_diagonals_up_to_its_ceiling(beta):
    top = lat.walk_plan(MAX_U1[beta], beta)
    assert (top.chunk, top.slots, top.registers) == (1, 2, False)
    assert top.smem_bytes <= lat.SMEM_BYTES
    with pytest.raises(ValueError, match="two staged diagonals"):
        lat.walk_plan(MAX_U1[beta] + 1, beta)


@pytest.mark.parametrize("beta", [False, True])
@pytest.mark.parametrize("U1", [1, 101, 1101, 7_936, 7_937, 8_001, 11_136,
                                11_137, 20_000, 50_001])
def test_tile_plan_covers_every_column_with_plans_that_fit(U1, beta):
    tiles = lat.tile_plan(U1, beta)
    if U1 <= MAX_U1[beta]:  # what walk_plan takes stays one launch
        assert tiles == (lat.Tile(0, U1, False, lat.walk_plan(U1, beta)),)
        return
    # every column in exactly one tile
    cols = sorted((t.u0, t.width) for t in tiles)
    assert cols[0][0] == 0
    assert all(a + w == b for (a, w), (b, _) in zip(cols, cols[1:]))
    assert cols[-1][0] + cols[-1][1] == U1
    for t in tiles:
        assert t.plan == lat.walk_plan(t.width, beta)
        assert t.plan.smem_bytes <= lat.SMEM_BYTES
        assert t.plan.smem_bytes == _bytes(t.plan, t.width, beta)
    # one tile without an edge, at the end the walk starts from, launched
    # first; every other tile reads the boundary column of the one
    # launched before it: alpha left to right, beta right to left
    assert [t.edge for t in tiles] == [False] + [True] * (len(tiles) - 1)
    assert tiles[0].u0 == (cols[-1][0] if beta else 0)
    for prev, t in zip(tiles, tiles[1:]):
        if beta:
            assert t.u0 + t.width == prev.u0
        else:
            assert prev.u0 + prev.width == t.u0
    for t in tiles[1:]:
        # edges need the lanes' cells in shared memory, and a beta tile's
        # last column on its last lane
        assert not t.plan.registers and t.width % lat.TILE_COLUMNS == 0
        assert t.width == 32 * t.plan.k * t.plan.warps
        # the widest such tile walk_plan takes
        with pytest.raises(ValueError):
            lat.walk_plan(t.width + lat.TILE_COLUMNS, beta)


def test_tile_plan_refuses_an_empty_lattice():
    with pytest.raises(ValueError, match="U\\+1"):
        lat.tile_plan(0, False)
