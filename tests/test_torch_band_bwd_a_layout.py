"""The host layout of the band joint's tensor-core kernel A
(`rnnt_band_fused.bwd_a_layout`, `ring_a_bytes`, `wt_shape`).

The layout is plain Python, so the CPU holds it: the ring block's shared
memory fits an H100 block (227 KB), the scratch wt = W^T holds every
column of W once in whole chunks at z's pitch, and a shape the kernel does
not take raises or goes to the CUDA-core form. The kernels themselves run
on the card (tests/test_torch_kernels.py).
"""

import pytest
import torch

from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf

pytestmark = pytest.mark.quick

SMEM = 232_448  # H100 SXM: opt-in shared bytes a block


def test_ring_a_bytes_at_full_width():
    """At J=512 two wt chunks of 64 rows, round(z) of 64 rows (both at
    pitch 520), round(dlogits) at pitch 72, 5 sidecar words and the f and
    g rows of 64 rows, two mbarriers: 210,704 bytes, under the H100's
    232,448, and under kernel B's 228,880."""
    assert bf.ring_a_bytes(512) == (2 * 64 * 520 * 2 + 64 * 520 * 2
                                    + 64 * 72 * 2 + 5 * 64 * 4 + 2 * 64 * 4
                                    + 16)
    assert bf.ring_a_bytes(512) == 210_704
    assert bf.ring_a_bytes(512) <= SMEM
    assert bf.ring_a_bytes(512) < bf.ring_b_bytes(512)


@pytest.mark.parametrize("J", [16, 64, 96, 256, 512])
def test_ring_a_bytes_are_whole_16_byte_regions(J):
    """Every region starts on 16 bytes (the TMA's destinations, ldmatrix's
    rows and the mbarriers need it): each is a multiple of 16 bytes."""
    jp = bf.zb_pitch(J)
    regions = [bf.BWD_A_V_CHUNK * jp * 2, bf.BWD_A_V_CHUNK * jp * 2,
               bf.BWD_A_ROWS * jp * 2,
               bf.BWD_A_ROWS * (bf.BWD_A_V_CHUNK + 8) * 2,
               bf.BWD_A_SIDE * bf.BWD_A_ROWS * 4, 2 * bf.BWD_A_ROWS * 4, 16]
    assert sum(regions) == bf.ring_a_bytes(J)
    assert all(r % 16 == 0 for r in regions)
    assert bf.ring_a_bytes(J) <= SMEM


@pytest.mark.parametrize("V", [2, 40, 130, 1000, 1024, 8192, 8704])
@pytest.mark.parametrize("J", [16, 96, 512])
def test_wt_covers_every_column_once(J, V):
    """wt's chunks of 64 rows cover [0, V) once, with fewer than one chunk
    of zero rows past V; its pitch is z's, past J + 8 and 8 past a
    multiple of 64 (4 mod 32 words); a chunk is one run of 16-byte
    multiples, as a bulk copy needs."""
    layout = bf.bwd_a_layout(J, V, SMEM)
    rows, pitch = layout.wt_shape
    assert layout.wt_shape == bf.wt_shape(J, V)
    assert rows % bf.BWD_A_V_CHUNK == 0 and V <= rows < V + bf.BWD_A_V_CHUNK
    assert pitch == bf.zb_pitch(J) and pitch >= J + 8 and pitch % 64 == 8
    assert (bf.BWD_A_V_CHUNK * pitch * 2) % 16 == 0
    # wt's row v holds W's column v: the kernel's ceil(V / 64) chunks of 64
    # rows are wt's rows, and the last of them holds a column of W
    n_chunks = -(-V // bf.BWD_A_V_CHUNK)
    assert n_chunks * bf.BWD_A_V_CHUNK == rows
    assert (n_chunks - 1) * bf.BWD_A_V_CHUNK < V
    assert layout.smem_bytes == bf.ring_a_bytes(J)


def test_wt_at_the_pruned_band():
    """V=8192, J=512: 128 chunks of 66,560 bytes, wt 8.52 MB."""
    layout = bf.bwd_a_layout(512, 8192, SMEM)
    assert layout.wt_shape == (8192, 520)
    assert bf.BWD_A_V_CHUNK * 520 * 2 == 66_560
    assert layout.wt_shape[0] * layout.wt_shape[1] * 2 == 8_519_680


@pytest.mark.parametrize("J, V, smem", [
    (1024, 8192, SMEM),   # J > 512
    (528, 8192, SMEM),    # J > 512 with J % 16 == 0
    (72, 8192, SMEM),     # J % 16 != 0
    (24, 40, SMEM),       # J % 16 != 0, below 32
    (96, 1023, SMEM),     # V odd
    (512, 8192, 48 * 1024),  # too little shared memory
])
def test_bwd_a_layout_refuses_what_it_cannot_take(J, V, smem):
    with pytest.raises(ValueError, match=f"J={J}, V={V}"):
        bf.bwd_a_layout(J, V, smem)


@pytest.mark.parametrize("dtype, J, V, ring", [
    (torch.bfloat16, 512, 8192, True), (torch.bfloat16, 96, 130, True),
    (torch.bfloat16, 512, 1023, False), (torch.bfloat16, 72, 1024, False),
    (torch.bfloat16, 24, 40, False), (torch.float32, 512, 8192, False),
    (torch.float32, 96, 130, False)])
def test_odd_shapes_and_f32_take_the_cuda_core_form(dtype, J, V, ring):
    """The wrappers send f32 W, odd V and J % 16 != 0 to the CUDA-core
    forms, and ask for a layout only for the shapes it takes."""
    assert bf.tensor_core_form(dtype, J, V) is ring
    if ring:
        assert bf.bwd_a_layout(J, V, SMEM).wt_shape == bf.wt_shape(J, V)


def test_band_lp_bwd_a_on_the_cpu_is_the_plain_version():
    """On a CPU tensor the wrapper runs the plain version (events are
    ignored), launches nothing and counts nothing."""
    g = torch.Generator().manual_seed(3)
    B, T, S, J, V = 2, 3, 4, 32, 10
    f = torch.randn(B, T, J, generator=g) * 0.5
    g_w = torch.randn(B, T, S, J, generator=g) * 0.5
    lab_w = torch.randint(0, V, (B, T, S), generator=g, dtype=torch.int32)
    w = (torch.randn(J, V, generator=g) / J ** 0.5).to(torch.bfloat16)
    b = torch.randn(V, generator=g) * 0.1
    cb = -torch.rand(B, T, S, generator=g)
    cy = -torch.rand(B, T, S, generator=g)
    base = bf.band_lp_fwd_reference(f, g_w, lab_w, w, b)[2]
    before = bf.LAUNCHES_BWD_A
    got = bf.band_lp_bwd_a(f, g_w, lab_w, w, b, base, cb, cy,
                           events=(None, None, None))
    want = bf.band_lp_bwd_a_reference(f, g_w, lab_w, w, b, base, cb, cy)
    assert bf.LAUNCHES_BWD_A == before
    for a, e in zip(got, want):
        assert torch.equal(a, e)
