"""The host layout of the band joint's tensor-core forward
(`rnnt_band_fused.fwd_layout`, `ring_fwd_bytes`).

The forward's ring is kernel A's: the same scratch wt = W^T, the same
chunks of 64 columns and blocks of 64 rows, with each column half's
partial log-sum-exp and picks in place of A's dlogits tile. The layout is
plain Python, so the CPU holds it: the block's shared memory fits an H100
block (227 KB), every region is whole 16 bytes, and a shape the kernel
does not take raises or goes to the CUDA-core form. The kernels
themselves run on the card (tests/test_torch_kernels.py).
"""

import pytest
import torch

from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf

pytestmark = pytest.mark.quick

SMEM = 232_448  # H100 SXM: opt-in shared bytes a block


def _regions(J):
    """The forward block's shared memory, region by region, as the kernel
    (csrc/wt_ring.cuh `fwd_body`) lays it out."""
    jp = bf.zb_pitch(J)
    rows = bf.BWD_A_ROWS
    return [bf.BWD_A_V_CHUNK * jp * 2, bf.BWD_A_V_CHUNK * jp * 2,  # ring
            rows * jp * 2,                    # round(z)
            2 * bf.FWD_PART * rows * 4,       # the column halves' partials
            rows * 4, 2 * rows * 4,           # labels; f and g rows
            16]                               # two mbarriers


def test_ring_fwd_bytes_at_full_width():
    """At J=512 two wt chunks of 64 rows and round(z) of 64 rows (all at
    pitch 520), two halves' partials of 4 words a row, the labels and the
    f and g rows of 64 rows, two mbarriers: 202,512 bytes, one block an
    SM, under kernel A's 210,704."""
    assert bf.ring_fwd_bytes(512) == (2 * 64 * 520 * 2 + 64 * 520 * 2
                                      + 2 * 4 * 64 * 4 + 3 * 64 * 4 + 16)
    assert bf.ring_fwd_bytes(512) == 202_512
    assert bf.ring_fwd_bytes(512) <= SMEM < 2 * bf.ring_fwd_bytes(512)
    assert bf.ring_fwd_bytes(512) < bf.ring_a_bytes(512)


@pytest.mark.parametrize("J", [16, 64, 96, 256, 512])
def test_ring_fwd_bytes_are_whole_16_byte_regions(J):
    """Every region starts on 16 bytes (the TMA's destinations, the
    fragments' rows and the mbarriers need it): each is a multiple of 16
    bytes, and they add up to the block's bytes."""
    regions = _regions(J)
    assert sum(regions) == bf.ring_fwd_bytes(J)
    assert all(r % 16 == 0 for r in regions)
    assert bf.ring_fwd_bytes(J) <= SMEM


@pytest.mark.parametrize("V", [2, 130, 1000, 1024, 8192, 8704])
@pytest.mark.parametrize("J", [16, 96, 512])
def test_fwd_layout_shares_kernel_a_wt(J, V):
    """The forward reads the same wt as kernel A: V rounded up to whole
    chunks of 64 rows at z's pitch."""
    layout = bf.fwd_layout(J, V, SMEM)
    assert layout.wt_shape == bf.wt_shape(J, V)
    assert layout.wt_shape == bf.bwd_a_layout(J, V, SMEM).wt_shape
    assert layout.smem_bytes == bf.ring_fwd_bytes(J)
    assert (layout.J, layout.V) == (J, V)


def test_fwd_layout_at_the_pruned_band():
    """V=8192, J=512: 128 chunks of 66,560 bytes, wt 8.52 MB."""
    layout = bf.fwd_layout(512, 8192, SMEM)
    assert layout.wt_shape == (8192, 520)
    assert layout.wt_shape[0] // bf.BWD_A_V_CHUNK == 128
    assert layout.wt_shape[0] * layout.wt_shape[1] * 2 == 8_519_680


@pytest.mark.parametrize("J, V, smem", [
    (1024, 8192, SMEM),   # J > 512
    (528, 8192, SMEM),    # J > 512 with J % 16 == 0
    (72, 8192, SMEM),     # J % 16 != 0
    (24, 40, SMEM),       # J % 16 != 0, below 32
    (96, 1023, SMEM),     # V odd
    (512, 8192, 200_000),  # too little shared memory (kernel A's would fit
                           # neither)
])
def test_fwd_layout_refuses_what_it_cannot_take(J, V, smem):
    with pytest.raises(ValueError, match=f"forward's ring cannot take J={J}, "
                                         f"V={V}"):
        bf.fwd_layout(J, V, smem)


@pytest.mark.parametrize("dtype, J, V, ring", [
    (torch.bfloat16, 512, 8192, True), (torch.bfloat16, 96, 130, True),
    (torch.bfloat16, 512, 1023, False), (torch.bfloat16, 72, 1024, False),
    (torch.bfloat16, 24, 40, False), (torch.float32, 512, 8192, False),
    (torch.float32, 96, 130, False)])
def test_odd_shapes_and_f32_take_the_cuda_core_forward(dtype, J, V, ring):
    """The wrapper sends f32 W, odd V and J % 16 != 0 to the CUDA-core
    forward, and asks for a layout only for the shapes it takes."""
    assert bf.tensor_core_form(dtype, J, V) is ring
    if ring:
        assert bf.fwd_layout(J, V, SMEM).smem_bytes == bf.ring_fwd_bytes(J)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_band_lp_fwd_on_the_cpu_is_the_plain_version(dtype):
    """On a CPU tensor the wrapper runs the plain version (events are
    ignored), launches nothing and counts nothing; labels outside [0, V)
    give lp_y = -base."""
    g = torch.Generator().manual_seed(3)
    B, T, S, J, V = 2, 3, 4, 32, 10
    f = torch.randn(B, T, J, generator=g) * 0.5
    g_w = torch.randn(B, T, S, J, generator=g) * 0.5
    lab_w = torch.randint(0, V, (B, T, S), generator=g, dtype=torch.int32)
    lab_w[0, 0, 0], lab_w[1, 2, 3] = -1, V
    w = (torch.randn(J, V, generator=g) / J ** 0.5).to(dtype)
    b = torch.randn(V, generator=g) * 0.1
    before = bf.LAUNCHES_FWD
    got = bf.band_lp_fwd(f, g_w, lab_w, w, b, events=(None, None, None))
    want = bf.band_lp_fwd_reference(f, g_w, lab_w, w, b)
    assert bf.LAUNCHES_FWD == before
    for a, e in zip(got, want):
        assert torch.equal(a, e)
    lp_y, base = got[1], got[2]
    assert lp_y[0, 0, 0] == -base[0, 0, 0] and lp_y[1, 2, 3] == -base[1, 2, 3]
