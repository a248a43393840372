"""The host-side layout of K3's walk (`ops/rnnt_lattice_cuda.walk_plan`):
the walking warps and the cells a lane of each holds, whether they fit in
registers, the ring of staged diagonals in shared memory and its bytes,
and the refusal of a diagonal too long for a block's shared memory. The
kernel itself (csrc/lattice.cu) runs only on the card
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
