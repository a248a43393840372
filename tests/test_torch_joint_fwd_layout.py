"""The host side of the fused joint's tensor-core forward (K1): its layout,
its routing and its map from a block's rows to the lattice's cells.

K1 runs on the band joint's forward ring (csrc/wt_ring.cuh `fwd_body`):
the same scratch wt = W^T, the same chunks of 64 columns and blocks of 64
rows, in the layout of `rnnt_band_fused.fwd_layout`, with the row policy
JointRowsF (csrc/joint_fwd.cu) over the B T (U+1) cells, each cell's rows
and label from JointMap (csrc/joint_rows.cuh). The layout and the map are
plain arithmetic, so the CPU holds them: a Python mirror of the map picks
each cell's log-probs from per-cell logits and gives the plain version's
arrays. The kernels themselves run on the card
(tests/test_torch_kernels.py).
"""

import numpy as np
import pytest
import torch

from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf
from rnn_transducer_tpu_torch.ops import rnnt_joint_fused as tf
from rnn_transducer_tpu_torch.ops.lstm import _dot

pytestmark = pytest.mark.quick

SMEM = 232_448  # H100 SXM: opt-in shared bytes a block


def test_the_forward_reuses_the_band_modules_layout():
    """One routing rule and one layout for both joints' forwards: the
    fused joint imports them, it does not copy them."""
    assert tf.tensor_core_form is bf.tensor_core_form
    assert tf.device_fwd_layout is bf.device_fwd_layout


@pytest.mark.parametrize("B, T, U1", [(32, 200, 41),   # libri100
                                      (64, 100, 41)])  # libri100_conformer
def test_layout_at_the_training_cells(B, T, U1):
    """Both training steps give the joint 262,400 cells: 4,100 blocks of
    64, wt (1024, 520) bf16 at J=512, V=1024, and 202,512 shared bytes a
    block, one block an SM."""
    N = B * T * U1
    assert N == 262_400
    assert -(-N // bf.BWD_A_ROWS) == 4_100
    assert bf.tensor_core_form(torch.bfloat16, 512, 1024)
    layout = bf.fwd_layout(512, 1024, SMEM)
    assert layout.wt_shape == (1024, 520)
    assert layout.smem_bytes == bf.ring_fwd_bytes(512) == 202_512
    assert layout.smem_bytes <= SMEM < 2 * layout.smem_bytes


@pytest.mark.parametrize("dtype, J, V, ring", [
    (torch.bfloat16, 512, 1024, True), (torch.bfloat16, 96, 130, True),
    (torch.bfloat16, 72, 1024, False), (torch.bfloat16, 24, 40, False),
    (torch.bfloat16, 512, 1023, False), (torch.bfloat16, 64, 37, False),
    (torch.float32, 512, 1024, False), (torch.float32, 96, 130, False)])
def test_f32_and_odd_shapes_take_the_cuda_core_form(dtype, J, V, ring):
    """f32 W, J % 16 != 0 and odd V go to the CUDA-core joint_fwd; a
    layout is asked for only where the ring runs, and one is refused for
    the odd shapes."""
    assert bf.tensor_core_form(dtype, J, V) is ring
    if ring:
        assert bf.fwd_layout(J, V, SMEM).wt_shape == bf.wt_shape(J, V)
    elif J % 16 or V % 2:
        with pytest.raises(ValueError, match="forward's ring cannot take"):
            bf.fwd_layout(J, V, SMEM)


def _joint_map(r: int, T: int, U1: int) -> tuple[int, int]:
    """JointMap's f and g rows of flat cell r (csrc/joint_rows.cuh)."""
    return r // U1, (r // (T * U1)) * U1 + r % U1


def _joint_label(labels: np.ndarray, r: int, T: int, U1: int) -> int:
    """JointMap's label of flat cell r: labels[b, u], -1 at u = U."""
    u = r % U1
    return int(labels.reshape(-1)[(r // (T * U1)) * (U1 - 1) + u]) \
        if u < U1 - 1 else -1


def test_joint_map_walks_the_cells_t_major():
    """Flat cell r = (b T + t) (U+1) + u maps to f row b T + t, g row
    b (U+1) + u and label labels[b, u] (-1 at u = U), over every cell of a
    ragged shape whose 64-cell blocks span frames and utterances."""
    B, T, U1 = 3, 5, 7
    labels = np.arange(B * (U1 - 1), dtype=np.int32).reshape(B, U1 - 1)
    r = 0
    for b in range(B):
        for t in range(T):
            for u in range(U1):
                assert _joint_map(r, T, U1) == (b * T + t, b * U1 + u)
                want = labels[b, u] if u < U1 - 1 else -1
                assert _joint_label(labels, r, T, U1) == want
                r += 1
    assert r == B * T * U1 and r > bf.BWD_A_ROWS  # blocks span utterances


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, T, U1, J, V, blank", [(3, 5, 7, 32, 21, 0),
                                                   (2, 9, 70, 16, 130, 3)])
def test_the_map_picks_the_plain_versions_log_probs(dtype, B, T, U1, J, V,
                                                    blank):
    """Per-cell logits built through the map's f and g rows, and each
    cell's lp_blank, lp_y (at the map's label; -1e30 where it is -1) and
    base, as JointRowsF stores them, equal joint_lp_fwd_reference's
    arrays: the map is the plain version's t-major flattening."""
    rng = np.random.default_rng(B * T + U1)
    f = torch.from_numpy(rng.normal(size=(B, T, J))).float()
    g = torch.from_numpy(rng.normal(size=(B, U1, J))).float()
    w = torch.from_numpy(rng.normal(size=(J, V)) / J ** 0.5).float().to(dtype)
    b = torch.from_numpy(0.1 * rng.normal(size=V)).float()
    labels = rng.integers(0, V, size=(B, U1 - 1)).astype(np.int32)
    N = B * T * U1
    rows = [_joint_map(r, T, U1) for r in range(N)]
    fr = torch.tensor([x for x, _ in rows])
    gr = torch.tensor([y for _, y in rows])
    z = torch.tanh(f.reshape(-1, J)[fr] + g.reshape(-1, J)[gr])
    logits = _dot(z, w, w.dtype) + b
    base = torch.logsumexp(logits, dim=-1)
    lab = torch.tensor([_joint_label(labels, r, T, U1) for r in range(N)])
    assert int((lab < 0).sum()) == B * T  # one cell at u = U a frame
    picked = logits.gather(1, lab.clamp(min=0)[:, None])[:, 0]
    lp_y = torch.where(lab >= 0, picked - base,
                       torch.full_like(base, -1e30))
    want = tf.joint_lp_fwd_reference(f, g, torch.from_numpy(labels), w, b,
                                     blank)
    for name, got, exp in zip(("lp_blank", "lp_y", "base"),
                              (logits[:, blank] - base, lp_y, base), want):
        assert torch.equal(got, exp.reshape(-1)), name
    assert (want[1][:, :, U1 - 1] == -1e30).all()
