"""The host side of the fused joint's tensor-core kernel A (K2-A) on the
ring it shares with the band joint's kernel A: the layout of
`rnnt_band_fused.bwd_a_layout` over N = B * T * (U+1) cells, row r =
(b * T + t) * (U+1) + u, and the decomposition the kernel relies on: df and
dg are ordered sums of each cell's dz.

All plain Python, so the CPU holds it: at the training cells the layout
gives the kernel's blocks, wt and the dz scratch; shapes the ring does not
take go to the CUDA-core form; and `joint_lp_bwd_reference`'s df and dg are
the u-sum and the t-sum of its per-cell dz, which joint_bwd_sums adds in
order on the card. The kernels themselves run on the card
(tests/test_torch_kernels.py).
"""

import pytest
import torch

from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf
from rnn_transducer_tpu_torch.ops import rnnt_joint_fused as tf
from rnn_transducer_tpu_torch.ops import rnnt_loss as rl

pytestmark = pytest.mark.quick

SMEM = 232_448  # H100 SXM: opt-in shared bytes a block


def test_the_fused_joint_reuses_the_band_layout():
    """joint_lp_bwd asks the band module for its form and layout: one
    layout, which both kernels A check, and no copy of it."""
    assert tf.tensor_core_form is bf.tensor_core_form
    assert tf.device_bwd_a_layout is bf.device_bwd_a_layout


@pytest.mark.parametrize("B, T, U1", [(32, 200, 41),   # libri100, T'=200
                                      (64, 100, 41)])  # the conformer's
def test_ring_a_at_the_training_cells(B, T, U1):
    """262,400 cells: 4,100 blocks of 64 cells, wt (1024, 520) bf16, a
    block's 210,704 shared bytes, and a dz scratch of 262,400 x 512 f32 =
    537,395,200 bytes in place of the CUDA-core form's dg partials."""
    J, V = 512, 1024
    N = B * T * U1
    assert N == 262_400
    assert tf.tensor_core_form(torch.bfloat16, J, V)
    layout = bf.bwd_a_layout(J, V, SMEM)
    assert -(-N // bf.BWD_A_ROWS) == 4_100
    assert layout.wt_shape == (1024, 520)
    assert layout.smem_bytes == 210_704 <= SMEM
    assert N * J * 4 == 537_395_200
    dg_part = B * -(-T // tf.FRAMES_PER_TILE) * U1 * J * 4
    assert dg_part < N * J * 4


@pytest.mark.parametrize("dtype, J, V", [
    (torch.bfloat16, 72, 1024),    # J % 16 != 0
    (torch.bfloat16, 24, 40),      # J % 16 != 0, below 32
    (torch.bfloat16, 512, 1023),   # V odd
    (torch.bfloat16, 96, 37),      # V odd
    (torch.float32, 512, 1024),    # f32 W: the parity path
])
def test_odd_shapes_and_f32_take_the_cuda_core_form(dtype, J, V):
    assert not tf.tensor_core_form(dtype, J, V)


def test_j_above_512_is_refused():
    """J > 512 with J % 16 == 0 passes the form's test, but the layout
    refuses it and joint_lp_bwd takes no joint that wide."""
    assert tf.tensor_core_form(torch.bfloat16, 528, 1024)
    with pytest.raises(ValueError, match="J=528, V=1024"):
        bf.bwd_a_layout(528, 1024, SMEM)
    assert not tf.fused_supported(528)


def _ragged_bwd_args(B, T, U, J, V, seed=5):
    """joint_lp_bwd's arguments with the lattice's occupancies: row 0 full,
    row 1 zero frames, row 2 no labels, the rest ragged."""
    g = torch.Generator().manual_seed(seed)
    f = 0.5 * torch.randn(B, T, J, generator=g)
    gg = 0.5 * torch.randn(B, U + 1, J, generator=g)
    w = (torch.randn(J, V, generator=g) / J ** 0.5).to(torch.bfloat16)
    b = 0.1 * torch.randn(V, generator=g)
    labels = torch.randint(1, V, (B, U), generator=g, dtype=torch.int32)
    fl = torch.randint(T // 2, T + 1, (B,), generator=g, dtype=torch.int32)
    ll = torch.randint(U // 2, U + 1, (B,), generator=g, dtype=torch.int32)
    fl[0], ll[0], fl[1], ll[2] = T, U, 0, 0
    lpb, lpy, base = tf.joint_lp_fwd_reference(f, gg, labels, w, b)
    gb, gy = rl.occupancies_from_lp(lpb, lpy, fl, ll)
    gbar = torch.full((B,), 1.0 / B)
    return (f, gg, labels, w, b, gb.contiguous(), gy.contiguous(), base,
            gbar)


def _ordered_sum(x, dim):
    """The sum over `dim` from index 0 up, one term at a time in f32, as
    joint_bwd_sums adds a part after another."""
    acc = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def test_df_and_dg_are_ordered_sums_of_the_cells_dz():
    """At a small ragged shape, the plain version's df and dg equal the
    u-sum and the t-sum of its per-cell dz taken in order, to f32
    rounding: each of two n-term f32 sums is within (n - 1) 2^-24 sum|x|
    of the exact one. The zero-frame row's cells have zero dz."""
    B, T, U, J, V = 4, 6, 5, 32, 24
    args = _ragged_bwd_args(B, T, U, J, V)
    want_df, want_dg, _, _ = tf.joint_lp_bwd_reference(*args)
    _, _, dz = tf._cells_bwd(*args, blank=0)
    assert dz.shape == (B, T, U + 1, J) and dz.dtype == torch.float32
    assert float(dz[1].abs().max()) == 0.0
    assert float(dz.abs().max()) > 0.0
    for got, want, dim in ((_ordered_sum(dz, 2), want_df, 2),
                           (_ordered_sum(dz, 1), want_dg, 1)):
        n = dz.shape[dim]
        tol = 2 * (n - 1) * 2.0 ** -24 * dz.abs().sum(dim=dim)
        assert got.shape == want.shape
        assert bool(((got - want).abs() <= tol).all())
