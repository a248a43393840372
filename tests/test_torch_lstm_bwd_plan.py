"""The host plan of the persistent LSTM kernels (`lstm_cuda.lstm_plan`):
the backward's tile (`bwd_plan`) and the forward's (`fwd_plan`), one
search over each direction's shared-memory layout.

The plan is plain Python, so the CPU holds it: every (row, unit) pair has
one owner, the grid is one wave of an H100 (132 SMs, 227 KB of shared
memory a block), the block's shared memory fits, and a shape that cannot
be placed raises. The kernels themselves run on the card
(tests/test_torch_kernels.py).
"""

import numpy as np
import pytest
import torch

from rnn_transducer_tpu_torch.ops import lstm_cuda

pytestmark = pytest.mark.quick

N_SM, SMEM = 132, 232_448  # H100 SXM: SMs, opt-in shared bytes a block


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [64, 320, 512, 1024])
@pytest.mark.parametrize("B", [1, 3, 8, 32, 64])
def test_bwd_plan_places_every_pair_once_in_one_wave(B, H, dtype):
    plan = lstm_cuda.bwd_plan(B, H, dtype, N_SM, SMEM)
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
    # the kernel's constraints: pairs a thread, mma / fragment tiles, passes
    assert plan.units * plan.rows <= 2 * plan.threads
    assert plan.units in ((32, 16) if dtype == torch.bfloat16 else (16, 8))
    assert plan.rows % plan.stage_rows == 0 and plan.stage_rows % 8 == 0
    assert plan.k_pad >= 4 * H and plan.k_pad % 128 == 0
    assert plan.k_pad % plan.stage_cols == 0 and plan.stage_cols % 128 == 0
    w_bytes = 2 if dtype == torch.bfloat16 else 4
    assert plan.smem_bytes >= (plan.units * plan.k_pad
                               + plan.stage_rows * plan.stage_cols) * w_bytes


def test_bwd_plan_libri100_tile():
    """libri100's layer at B=32, H=512: 16 units by 8 rows, 128 blocks, a
    64 KB W slice and a 32 KB stage in bf16 (128 KB and 64 KB in f32)."""
    for dtype, w_bytes in ((torch.bfloat16, 2), (torch.float32, 4)):
        plan = lstm_cuda.bwd_plan(32, 512, dtype, N_SM, SMEM)
        assert (plan.units, plan.rows, plan.grid) == (16, 8, (32, 4))
        assert (plan.stage_rows, plan.stage_cols, plan.passes) == (8, 2048, 1)
        slice_and_stage = (16 + 8) * 2048 * w_bytes
        assert slice_and_stage <= plan.smem_bytes <= slice_and_stage + 9000


def test_bwd_plan_conformer_predictor_tile():
    """The conformer step's predictor, B=64, H=512: in bf16, 32 units by 8
    rows keeps each block's fetch at 8 rows with 128 blocks; f32's 32-unit
    slice does not fit, so 16 units by 16 rows, staged 8 rows a pass."""
    plan = lstm_cuda.bwd_plan(64, 512, torch.bfloat16, N_SM, SMEM)
    assert (plan.units, plan.rows, plan.grid, plan.passes) == (
        32, 8, (16, 8), 1)
    plan = lstm_cuda.bwd_plan(64, 512, torch.float32, N_SM, SMEM)
    assert (plan.units, plan.rows, plan.grid, plan.passes) == (
        16, 16, (32, 4), 2)


@pytest.mark.parametrize("B, H, dtype, n_sm, smem", [
    (4096, 1024, torch.bfloat16, N_SM, SMEM),  # more pairs than threads
    (64, 4096, torch.float32, N_SM, SMEM),     # the W slice does not fit
    (32, 512, torch.bfloat16, 16, SMEM),       # too few SMs for one wave
    (32, 512, torch.float32, N_SM, 48 * 1024),  # too little shared memory
])
def test_bwd_plan_refuses_what_it_cannot_place(B, H, dtype, n_sm, smem):
    with pytest.raises(ValueError, match=f"B={B}, H={H}"):
        lstm_cuda.bwd_plan(B, H, dtype, n_sm, smem)


def test_bwd_plan_refuses_other_dtypes():
    with pytest.raises(TypeError):
        lstm_cuda.bwd_plan(8, 64, torch.float16, N_SM, SMEM)


def _check_placed(plan, B, H):
    """Every pair owned once by a block that owns some, in one wave."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [64, 320, 512, 1024])
@pytest.mark.parametrize("B", [1, 3, 8, 32, 64])
def test_fwd_plan_places_every_pair_once_in_one_wave(B, H, dtype):
    plan = lstm_cuda.fwd_plan(B, H, dtype, N_SM, SMEM)
    assert plan.direction == "fwd"
    _check_placed(plan, B, H)
    # the kernel's constraints: pairs a thread, mma / fragment tiles, passes
    assert plan.units * plan.rows <= 2 * plan.threads
    assert plan.units in ((32, 16) if dtype == torch.bfloat16 else (16, 8))
    assert plan.rows % plan.stage_rows == 0 and plan.stage_rows % 8 == 0
    assert plan.k_pad >= H and plan.k_pad % 128 == 0
    assert plan.k_pad % plan.stage_cols == 0 and plan.stage_cols % 128 == 0
    # the forward's layout: the 4 UB gate columns over k_pad, one stage of
    # round(h), the 8 warps' partials of every (row, gate column)
    w_bytes = 2 if dtype == torch.bfloat16 else 4
    pad = 16 // w_bytes
    assert plan.smem_bytes == (
        (4 * plan.units * (plan.k_pad + pad)
         + plan.stage_rows * (plan.stage_cols + pad)) * w_bytes
        + 8 * plan.rows * 4 * plan.units * 4 + 16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [64, 320, 512, 1024])
@pytest.mark.parametrize("B", [96, 128, 256, 512, 4096])
def test_fwd_plan_places_what_bwd_plan_places(B, H, dtype):
    """Beyond B = 64: the forward places a shape exactly when the backward
    does, so a trained layer never meets a forward it cannot run."""
    try:
        lstm_cuda.bwd_plan(B, H, dtype, N_SM, SMEM)
    except ValueError:
        with pytest.raises(ValueError, match=f"B={B}, H={H}"):
            lstm_cuda.fwd_plan(B, H, dtype, N_SM, SMEM)
        return
    _check_placed(lstm_cuda.fwd_plan(B, H, dtype, N_SM, SMEM), B, H)


def test_fwd_plan_libri100_tiles():
    """libri100's layers, H=512: serving at B=8 in bf16 is 16 units by 8
    rows on 32 blocks (64 in f32, 8 units); training at B=32 is 16 by 8 on
    128 blocks, one pass of 8 rows by 512 columns a step."""
    plan = lstm_cuda.fwd_plan(8, 512, torch.bfloat16, N_SM, SMEM)
    assert (plan.units, plan.rows, plan.grid, plan.passes) == (
        16, 8, (32, 1), 1)
    plan = lstm_cuda.fwd_plan(8, 512, torch.float32, N_SM, SMEM)
    assert (plan.units, plan.rows, plan.grid, plan.passes) == (
        8, 8, (64, 1), 1)
    for dtype in (torch.bfloat16, torch.float32):
        plan = lstm_cuda.fwd_plan(32, 512, dtype, N_SM, SMEM)
        assert (plan.units, plan.rows, plan.grid) == (16, 8, (32, 4))
        assert (plan.stage_rows, plan.stage_cols, plan.k_pad) == (8, 512, 512)


def test_fwd_and_bwd_plans_are_one_search():
    """The two directions share the search and differ in their layout:
    the backward's W slice is UB rows of 4H, the forward's 4 UB columns of
    H, so at B=32, H=512 both take 16 units by 8 rows."""
    f = lstm_cuda.fwd_plan(32, 512, torch.bfloat16, N_SM, SMEM)
    b = lstm_cuda.bwd_plan(32, 512, torch.bfloat16, N_SM, SMEM)
    assert (f.direction, b.direction) == ("fwd", "bwd")
    assert (f.units, f.rows, f.grid) == (b.units, b.rows, b.grid)
    assert (f.k_pad, b.k_pad) == (512, 2048)
    w_and_stage = {"fwd": (64 * (512 + 8) + 8 * (512 + 8)) * 2,
                   "bwd": (16 * (2048 + 8) + 8 * (2048 + 8)) * 2}
    partials = {"fwd": 8 * 8 * 64 * 4, "bwd": 8 * 8 * 16 * 4}
    for p in (f, b):
        assert p.smem_bytes == (w_and_stage[p.direction]
                                + partials[p.direction] + 16)


@pytest.mark.parametrize("B, H, dtype, n_sm, smem", [
    (4096, 1024, torch.bfloat16, N_SM, SMEM),  # more pairs than threads
    (64, 4096, torch.float32, N_SM, SMEM),     # the W slice does not fit
    (32, 512, torch.bfloat16, 16, SMEM),       # too few SMs for one wave
    (32, 512, torch.float32, N_SM, 48 * 1024),  # too little shared memory
    (0, 512, torch.bfloat16, N_SM, SMEM),      # an empty batch
])
def test_fwd_plan_refuses_what_it_cannot_place(B, H, dtype, n_sm, smem):
    with pytest.raises(ValueError, match=f"lstm_fwd.*B={B}, H={H}"):
        lstm_cuda.fwd_plan(B, H, dtype, n_sm, smem)


def test_fwd_plan_refuses_other_dtypes():
    with pytest.raises(TypeError):
        lstm_cuda.fwd_plan(8, 64, torch.float16, N_SM, SMEM)


@pytest.mark.parametrize("module", ["lstm_cuda", "lstm_int8_cuda"])
def test_exchange_buffers_are_held_through_their_launches(module):
    """Every `_exchange_buffer(...)` is bound to a name before its launch.
    A temporary passed as `_exchange_buffer(...).data_ptr()` is freed
    while the launch's arguments are gathered: a launch from another
    thread (the streaming and offline engines on one card) can then take
    the block, and leave its grid barrier's counter in it before this
    launch runs."""
    import ast
    import importlib
    import inspect

    mod = importlib.import_module(f"rnn_transducer_tpu_torch.ops.{module}")
    tree = ast.parse(inspect.getsource(mod))
    parents = {child: node for node in ast.walk(tree)
               for child in ast.iter_child_nodes(node)}
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", None) == "_exchange_buffer"]
    assert calls
    for call in calls:
        assert isinstance(parents[call], ast.Assign), ast.unparse(
            parents[call])
