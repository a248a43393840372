"""The host side of K9, the greedy decode in one launch
(`csrc/greedy_fused.cu`): its cluster plan, `greedy_fused.cluster_plan`
(which vocab columns, LSTM units and joint units a block of an utterance's
cluster owns, which weight slices stay resident, the ring, the shared
bytes), the block-major pack of the weights that the kernel streams
(`pack_reference`, the plain version of `greedy_pack_kernel`, and its
inverse), and a mirror of the cluster's argmax over its blocks' and warps'
candidates.

All of it is plain Python, so the CPU holds it on an H100's limit of
232,448 shared bytes a block. The kernels run on the card
(tests/test_torch_kernels.py).
"""

import struct

import numpy as np
import pytest
import torch

from rnn_transducer_tpu_torch.decode import greedy_fused as gf
from rnn_transducer_tpu_torch.models import config as port_config

pytestmark = pytest.mark.quick

SMEM = 232_448

# (E, H, J, V): libri100, greedy_smoke, conformer_smoke, the card tests'
# narrow shape (blocks with no vocab column), a ragged vocab, W_out too
# large to stay resident
SHAPES = {"libri100": (512, 512, 512, 1024),
          "greedy_smoke": (256, 256, 256, 64),
          "conformer_smoke": (128, 128, 128, 64),
          "narrow": (128, 256, 128, 11),
          "ragged": (512, 512, 512, 1000),
          "wo_streamed": (512, 512, 1024, 2048)}
# resident W_out, resident W_pred, ring slots
EXPECTED = {"libri100": (True, False, 2),
            "greedy_smoke": (True, True, 6),
            "conformer_smoke": (True, True, 6),
            "narrow": (True, True, 6),
            "ragged": (True, False, 2),
            "wo_streamed": (False, False, 6)}


@pytest.mark.parametrize("name", list(SHAPES))
def test_cluster_plan_fits_a_block_and_owns_every_column_once(name):
    E, H, J, V = SHAPES[name]
    plan = gf.cluster_plan(E, H, J, V)
    assert plan.C == 16 and plan.f_slots == 3
    assert (plan.wo_resident, plan.wp_resident, plan.slots) == EXPECTED[name]
    assert plan.smem_bytes <= SMEM
    assert plan.units * plan.C == H and plan.joint_units * plan.C == J
    owned = [v for r in range(plan.C) for v in plan.vocab(r)]
    assert owned == list(range(V))  # contiguous, in rank order, once each
    assert plan.cand_warps == min(8, -(-plan.vc // 32))
    # a resident segment is one chunk of all its rows; a streamed chunk
    # fits a ring slot; every chunk is whole groups that swizzle
    resident = (False, plan.wp_resident, plan.wo_resident)
    for seg, res in zip(plan.segments, resident):
        assert seg.chunk % 4 == 0
        assert seg.chunk // 4 in (1, 2, 4) or (seg.chunk // 4) % 8 == 0
        if res:
            assert seg.chunk == seg.rows
        else:
            assert seg.cols * seg.chunk * 4 <= plan.slot_bytes
    assert plan.slot_bytes % 16 == 0


def test_cluster_plan_at_libri100_keeps_w_out_resident_beside_the_ring():
    """libri100: 64 vocab columns a block, W_out's slice (128 KB) resident,
    W_pred's (64 KB) streamed with the gates through two 32 KB ring slots:
    32 rows of W_ih's and W_hh's 256 columns a chunk, W_pred 256 rows a
    chunk (the fewer, larger chunks stream an emission faster)."""
    plan = gf.cluster_plan(512, 512, 512, 1024)
    assert (plan.vc, plan.cand_warps) == (64, 2)
    assert plan.J * plan.vc * 4 == 131_072
    assert (plan.g_chunk, plan.p_chunk, plan.o_chunk) == (32, 256, 512)
    assert (plan.slots, plan.slot_bytes) == (2, 32_768)
    assert plan.smem_bytes == 216_032
    assert plan.block_floats == 512 * 256 + 512 * 32 + 512 * 64


def test_cluster_plan_gives_some_blocks_no_vocab_column():
    """V = 11 over 16 blocks: one column each for blocks 0-10, none for
    11-15, which offer (-FLT_MAX, V) to the argmax."""
    plan = gf.cluster_plan(128, 256, 128, 11)
    assert [len(plan.vocab(r)) for r in range(16)] == [1] * 11 + [0] * 5
    assert plan.vocab(15) == range(11, 11)


def test_cluster_plan_streams_w_out_where_its_slice_does_not_fit():
    """J = 1024, V = 2048: 128 columns a block, a 512 KB slice, streams
    through the ring every step; W_pred streams with the gates."""
    plan = gf.cluster_plan(512, 512, 1024, 2048)
    assert plan.J * plan.vc * 4 == 524_288 > SMEM
    assert not plan.wo_resident and not plan.wp_resident
    assert plan.cand_warps == 4


@pytest.mark.parametrize("cfg_name", ["config_greedy_smoke",
                                      "config_libri100",
                                      "config_libri100_conformer",
                                      "config_conformer_smoke"])
def test_cluster_plan_places_every_supported_config(cfg_name):
    cfg = getattr(port_config, cfg_name)()
    assert gf.supported(cfg)
    plan = gf.cluster_plan(cfg.embed_dim, cfg.pred_hidden, cfg.joint_dim,
                           cfg.vocab_size)
    assert plan.smem_bytes <= SMEM and plan.slots >= 2


@pytest.mark.parametrize("E, H, J, V", [(128, 128, 32768, 64),
                                        (128, 128, 128, 2_000_000)])
def test_cluster_plan_refuses_a_shape_no_block_holds(E, H, J, V):
    """J = 32768: z and g alone take 256 KB (the one-block design did not
    place it either); V = 2e6: a chunk of 4 rows of W_out's 125,000
    columns a block is larger than a block."""
    with pytest.raises(ValueError, match=f"E={E}, H={H}, J={J}, V={V}"):
        gf.cluster_plan(E, H, J, V)


def test_cluster_plan_falls_back_to_small_chunks_and_no_f_rows():
    """Where the first plan leaves no room: H = 4096 streams its 2,048
    gate columns 4 rows a chunk (one group, not swizzled); J = 16384 keeps
    no f rows in shared memory (read from global memory, no z a frame
    ahead) and streams W_out."""
    plan = gf.cluster_plan(128, 4096, 128, 64)
    assert (plan.g_chunk, plan.f_slots, plan.wo_resident) == (4, 3, True)
    assert gf.swizzle(5, plan.g_chunk // 4) == 0
    plan = gf.cluster_plan(128, 128, 16384, 64)
    assert (plan.f_slots, plan.wo_resident, plan.wp_resident) == (0, False,
                                                                  False)
    assert plan.smem_bytes <= SMEM


def test_cluster_plan_places_what_the_one_block_design_placed():
    """Every shape with E, H, J up to 8192 and V of 11 or 32768 that the
    one-block design held in a block ((2J + 6H + E) floats) has a cluster
    plan."""
    for E in range(128, 8193, 640):
        for H in range(128, 8193, 640):
            for J in range(128, 8193, 640):
                if (2 * J + 6 * H + E) * 4 > SMEM:
                    continue
                for V in (11, 32768):
                    gf.cluster_plan(E, H, J, V)


def test_cluster_plan_refuses_units_that_do_not_split():
    with pytest.raises(ValueError, match="multiples of 16, E of 4"):
        gf.cluster_plan(128, 120, 128, 64)


def _weights(E, H, J, V, seed=0):
    rng = np.random.default_rng(seed)
    w = [rng.normal(size=s).astype(np.float32)
         for s in ((V, E), (E, 4 * H), (H, 4 * H), (4 * H,), (H, J), (J,),
                   (J, V), (V,))]
    return tuple(torch.from_numpy(a) for a in w)


@pytest.mark.parametrize("name", ["greedy_smoke", "conformer_smoke",
                                  "narrow"])
def test_pack_and_its_inverse_return_the_weights_bit_for_bit(name):
    E, H, J, V = SHAPES[name]
    plan = gf.cluster_plan(E, H, J, V)
    weights = _weights(E, H, J, V)
    packed = gf.pack_weights(weights, plan)  # the plain version on the CPU
    assert packed.shape == (plan.packed_floats,)
    assert packed.dtype == torch.float32
    w_ih, w_hh, wp, wo = gf.unpack_reference(packed, plan)
    for got, want in zip((w_ih, w_hh, wp, wo),
                         (weights[1], weights[2], weights[4], weights[6])):
        assert torch.equal(got, want)


def test_pack_lays_each_block_out_as_the_kernel_reads_it():
    """Block r's run: segment G holds, column n < 4U, W_ih's gate column
    a*H + r*U + n' (a, n' = divmod(n, U)), zero past E, and column 4U + n
    W_hh's; P holds W_pred's columns r*JU ..; O W_out's columns r*vc ..,
    zero past V. Row k of column n lies in chunk k // R at column n,
    position 4 (g ^ swizzle(n, R / 4)) + k % 4 with g = k % R // 4."""
    E, H, J, V = 128, 256, 128, 11
    plan = gf.cluster_plan(E, H, J, V)
    U, JU = plan.units, plan.joint_units
    weights = _weights(E, H, J, V, seed=1)
    _, w_ih, w_hh, _, wp, _, wo, _ = weights
    runs = gf.pack_reference(weights, plan).view(plan.C, plan.block_floats)

    def at(run, seg, k, n):
        R = seg.chunk
        g, e = k % R // 4, k % 4
        c = run.view(seg.chunks, seg.cols, R)
        return c[k // R, n, 4 * (g ^ gf.swizzle(n, R // 4)) + e]

    seg_g, seg_p, seg_o = plan.segments
    for r in (0, 10, 15):
        g_run = runs[r][:seg_g.floats]
        p_run = runs[r][seg_g.floats:seg_g.floats + seg_p.floats]
        o_run = runs[r][seg_g.floats + seg_p.floats:]
        for k, n in ((3, 2 * U + 5), (E - 1, 4 * U - 1), (37, 0)):
            a, j = divmod(n, U)
            assert at(g_run, seg_g, k, n) == w_ih[k, a * H + r * U + j]
        for k, n in ((7, 4 * U + 3 * U), (H - 1, 8 * U - 1)):
            a, j = divmod(n - 4 * U, U)
            assert at(g_run, seg_g, k, n) == w_hh[k, a * H + r * U + j]
        assert at(g_run, seg_g, E + 9, 1) == 0  # W_ih has E rows
        for k, n in ((9, 0), (H - 1, JU - 1)):
            assert at(p_run, seg_p, k, n) == wp[k, r * JU + n]
        cols = plan.vocab(r)
        for n in range(plan.vc):
            want = wo[5, cols.start + n] if n < len(cols) else 0.0
            assert at(o_run, seg_o, 5, n) == want


@pytest.mark.parametrize("groups", [2, 4, 8, 16, 128])
def test_swizzle_spreads_eight_columns_over_eight_bank_quads(groups):
    """8 neighbouring columns (a quarter of a warp's 16-byte loads) reading
    the same group of their column, stored at position g ^ swizzle, start
    in 8 distinct 16-byte quads of a 128-byte line: no bank conflict."""
    pitch = groups * 16  # a column's bytes in a chunk
    for g in range(groups):
        for n0 in range(0, 32, 8):
            quads = {(n * pitch + 16 * (g ^ gf.swizzle(n, groups))) // 16 % 8
                     for n in range(n0, n0 + 8)}
            assert len(quads) == 8


def _key(v: float) -> int:
    """csrc/greedy_fused.cu `order_key`: an unsigned in the floats' order,
    -0 equal to +0, NaN below every float."""
    if v != v:
        return 0
    b = struct.unpack("<I", struct.pack("<f", 0.0 if v == 0 else v))[0]
    return (~b & 0xFFFFFFFF) if b & 0x80000000 else b | 0x80000000


def _better(a, b):
    """The kernel's order on (key, index): the larger key, the smaller
    index on a tie."""
    return b if (b[0] > a[0] or (b[0] == a[0] and b[1] < a[1])) else a


def _first_max(logits, V):
    """The argmax the decoder takes: the first index of the largest logit
    above -FLT_MAX, NaN never; V where none is."""
    best, arg = float(np.finfo(np.float32).min), V
    for v, x in enumerate(logits.tolist()):
        if x > best:
            best, arg = x, v
    return arg


@pytest.mark.parametrize("name", ["libri100", "narrow", "ragged",
                                  "wo_streamed"])
def test_cluster_argmax_over_candidates_is_the_first_index_of_the_max(name):
    """Each warp of each block offers the best (key, index) of its columns
    ((key(-FLT_MAX), V) where it owns none); any order of reducing the
    C * cand_warps candidates gives the first index of the largest logit,
    with ties, +0 against -0, -inf and NaN among them."""
    _, _, _, V = SHAPES[name]
    plan = gf.cluster_plan(*SHAPES[name])
    rng = np.random.default_rng(2)
    none = (_key(float(np.finfo(np.float32).min)), V)
    for trial in range(5):
        logits = rng.integers(-3, 4, V).astype(np.float32)  # many ties
        if trial == 1:
            logits[:] = 0.0
            logits[rng.integers(0, V, V // 2)] = -0.0
        if trial == 2:
            logits[rng.integers(0, V, 3)] = np.nan
            logits[rng.integers(0, V, 3)] = -np.inf
        if trial == 3:
            logits[:] = -np.inf  # no logit beats -FLT_MAX: index V
        if trial == 4:
            logits[:] = np.nan
        cands = []
        for r in range(plan.C):
            for w in range(plan.cand_warps):
                best = none
                for v in plan.vocab(r):
                    if (v - plan.vocab(r).start) // 32 % plan.cand_warps == w:
                        best = _better(best, (_key(float(logits[v])), v))
                cands.append(best)
        want = _first_max(logits, V)
        for order in (cands, cands[::-1],
                      [cands[i] for i in rng.permutation(len(cands))]):
            best = none
            for c in order:
                best = _better(best, c)
            assert best[1] == want
