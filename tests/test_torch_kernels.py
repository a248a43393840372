"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests skip without a CUDA device: a CUDA kernel has no CPU mode.
This file imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

`chip_smoke.py` checks the same kernels at the main paths' shapes.
"""

import pytest
import torch

from rnn_transducer_tpu_torch.ops import lstm_cuda

pytestmark = pytest.mark.quick


def _recurrence_args(B, T, H, dtype):
    g = torch.Generator().manual_seed(0)
    return (torch.randn(B, T, 4 * H, generator=g),
            (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(dtype),
            torch.randn(B, H, generator=g), torch.randn(B, H, generator=g))


def _pad_profiler_window():
    """A spin kernel of ~20 ms, then a synchronise, at each end of a
    torch.profiler window: the profiler drops a kernel whose time, mapped
    from the card's clock onto the host's, falls outside the window, and
    on the H100 that mapping was seen off by up to 3.9 ms, which lost the
    first kernels of a window. The checks below read only the kernels
    between the pads."""
    torch.cuda._sleep(40_000_000)
    torch.cuda.synchronize()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode "
                    "(chip_smoke.py runs it on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-4),
                                         (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B, T, H", [(8, 37, 512), (3, 37, 512), (1, 5, 64)])
def test_cuda_kernel_matches_reference(cuda_device, dtype, atol, B, T, H):
    args = [a.to(cuda_device) for a in _recurrence_args(B, T, H, dtype)]
    before = lstm_cuda.LAUNCHES
    hs, (hT, cT) = lstm_cuda.lstm_recurrence(*args)
    torch.cuda.synchronize()
    assert lstm_cuda.LAUNCHES == before + 1
    hs_r, (hT_r, cT_r) = lstm_cuda.lstm_recurrence_reference(*args)
    for got, want in ((hs, hs_r), (hT, hT_r), (cT, cT_r)):
        torch.testing.assert_close(got, want, rtol=0, atol=atol)


def _rel_err(got, want):
    """max |got - want| over max |want|: one number per output whatever
    its scale (dW sums over every lattice cell, db over fewer)."""
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


# f32: the kernels sum in another order than cuBLAS. bf16: both sides
# round the same operands, but a 1-ulp difference of tanh or of a sum
# before the rounding can flip one bf16 value (2^-8 relative).
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# lp_blank, lp_y and base are log-probabilities of order log V: absolute
# bounds, as the LSTM outputs above.
LP_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


# The backward's card shapes: the small ragged ones, libri100's layer 0
# (B=32, T=400) and its predictor at B=32 and at the conformer's B=64
# (T=U+1=41), each a different tile of lstm_cuda.bwd_plan.
BWD_SHAPES = [(8, 37, 512), (3, 37, 512), (1, 5, 64), (32, 400, 512),
              (32, 41, 512), (64, 41, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, T, H", BWD_SHAPES)
def test_cuda_lstm_with_acts_and_bwd_match_reference(cuda_device, dtype, B,
                                                     T, H):
    x, w, h0, c0 = [a.to(cuda_device)
                    for a in _recurrence_args(B, T, H, dtype)]
    before = (lstm_cuda.LAUNCHES_WITH_ACTS, lstm_cuda.LAUNCHES_BWD)
    got = lstm_cuda.lstm_recurrence_with_acts(x, w, h0, c0)
    want = lstm_cuda.lstm_recurrence_with_acts_reference(x, w, h0, c0)
    for a, e in zip(got, want):
        assert _rel_err(a, e) <= REL_TOL[dtype]
    hs, cs, acts = want
    g = torch.Generator(device=cuda_device).manual_seed(1)
    dhs = torch.randn(B, T, H, generator=g, device=cuda_device)
    dcT = torch.randn(B, H, generator=g, device=cuda_device)
    cs_prev = torch.cat([c0[:, None], cs[:, :-1]], dim=1)
    got = lstm_cuda.lstm_recurrence_bwd(acts, cs_prev, dhs, dcT, w)
    want = lstm_cuda.lstm_recurrence_bwd_reference(acts, cs_prev, dhs, dcT, w)
    torch.cuda.synchronize()
    for a, e in zip(got, want):
        assert _rel_err(a, e) <= REL_TOL[dtype]
    assert (lstm_cuda.LAUNCHES_WITH_ACTS, lstm_cuda.LAUNCHES_BWD) == (
        before[0] + 1, before[1] + 1)


def _bwd_args(B, T, H, dtype, device):
    """Backward inputs from the plain forward: acts, cs_prev, dhs, dcT, w."""
    x, w, h0, c0 = [a.to(device) for a in _recurrence_args(B, T, H, dtype)]
    _, cs, acts = lstm_cuda.lstm_recurrence_with_acts_reference(x, w, h0, c0)
    g = torch.Generator(device=device).manual_seed(1)
    dhs = torch.randn(B, T, H, generator=g, device=device)
    dcT = torch.randn(B, H, generator=g, device=device)
    cs_prev = torch.cat([c0[:, None], cs[:, :-1]], dim=1)
    return acts, cs_prev, dhs, dcT, w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, T, H", [(32, 400, 512), (64, 41, 512),
                                     (3, 37, 512)])
def test_cuda_lstm_bwd_repeats_bit_for_bit(cuda_device, dtype, B, T, H):
    """One writer per output and sums in a fixed order: two launches give
    the same bits."""
    args = _bwd_args(B, T, H, dtype, cuda_device)
    got = lstm_cuda.lstm_recurrence_bwd(*args)
    again = lstm_cuda.lstm_recurrence_bwd(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dgates", "dh0", "dc0"), got, again):
        assert torch.equal(a, b), f"{name} differs between two runs"


@pytest.mark.cuda
def test_cuda_lstm_bwd_refuses_a_shape_it_cannot_place(cuda_device):
    """No tile of B=4096 rows is one wave at H=1024: the wrapper raises,
    with no other route on the card, and launches nothing."""
    args = _bwd_args(4096, 1, 1024, torch.bfloat16, cuda_device)
    before = lstm_cuda.LAUNCHES_BWD
    with pytest.raises(ValueError, match="B=4096, H=1024"):
        lstm_cuda.lstm_recurrence_bwd(*args)
    assert lstm_cuda.LAUNCHES_BWD == before


# The forward's further card shapes: libri100's layer 0 in training (B=32,
# T=400), the conformer's predictor (B=64, T=41), H=1024 and H=320 (its
# reduction padded to 384 columns), each a different tile of
# lstm_cuda.fwd_plan.
FWD_SHAPES = [(32, 400, 512), (64, 41, 512), (4, 9, 1024), (3, 7, 320)]
FWD_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _fwd_outputs(args, with_acts: bool):
    """The forward's outputs as one tuple: hs, cs, acts with activations;
    hs, h_T, c_T without."""
    if with_acts:
        return lstm_cuda.lstm_recurrence_with_acts(*args)
    hs, (hT, cT) = lstm_cuda.lstm_recurrence(*args)
    return hs, hT, cT


def _fwd_reference(args, with_acts: bool):
    if with_acts:
        return lstm_cuda.lstm_recurrence_with_acts_reference(*args)
    hs, (hT, cT) = lstm_cuda.lstm_recurrence_reference(*args)
    return hs, hT, cT


def _fwd_launches():
    return lstm_cuda.LAUNCHES + lstm_cuda.LAUNCHES_WITH_ACTS


@pytest.mark.cuda
@pytest.mark.parametrize("with_acts", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, T, H", FWD_SHAPES)
def test_cuda_lstm_fwd_persistent_matches_reference(cuda_device, dtype,
                                                    with_acts, B, T, H):
    args = [a.to(cuda_device) for a in _recurrence_args(B, T, H, dtype)]
    before = _fwd_launches()
    got = _fwd_outputs(args, with_acts)
    want = _fwd_reference(args, with_acts)
    torch.cuda.synchronize()
    assert _fwd_launches() == before + 1
    for name, a, e in zip(("hs", "cs" if with_acts else "h_T",
                           "acts" if with_acts else "c_T"), got, want):
        assert bool(torch.isfinite(a).all()), name
        torch.testing.assert_close(a, e, rtol=0, atol=FWD_ATOL[dtype],
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("with_acts", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, T, H", [(32, 400, 512), (64, 41, 512)])
def test_cuda_lstm_fwd_repeats_bit_for_bit(cuda_device, dtype, with_acts, B,
                                           T, H):
    """One writer per output and sums in a fixed order: two launches give
    the same bits."""
    args = [a.to(cuda_device) for a in _recurrence_args(B, T, H, dtype)]
    got = _fwd_outputs(args, with_acts)
    again = _fwd_outputs(args, with_acts)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, again)):
        assert torch.equal(a, b), f"output {i} differs between two runs"


@pytest.mark.cuda
@pytest.mark.parametrize("with_acts", [False, True])
def test_cuda_lstm_fwd_is_one_launch_a_call(cuda_device, with_acts):
    """A layer call is one persistent kernel, whatever T: the profiler sees
    one lstm_fwd_persistent_kernel a call and no kernel of a step."""
    from torch.profiler import ProfilerActivity, profile

    args = [a.to(cuda_device)
            for a in _recurrence_args(8, 37, 512, torch.bfloat16)]
    _fwd_outputs(args, with_acts)  # warm: build, plan, caches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad_profiler_window()
        for _ in range(2):
            _fwd_outputs(args, with_acts)
        torch.cuda.synchronize()
        _pad_profiler_window()
    counts = {}
    for e in prof.key_averages():
        if "lstm_" in e.key and "_kernel" in e.key:
            counts[e.key] = counts.get(e.key, 0) + e.count
    assert sum(n for k, n in counts.items()
               if "lstm_fwd_persistent_kernel" in k) == 2, counts
    assert not any("step" in k for k in counts), counts


@pytest.mark.cuda
def test_cuda_lstm_fwd_refuses_a_shape_it_cannot_place(cuda_device):
    """No tile of B=4096 rows is one wave at H=1024: the wrapper raises,
    with no other route on the card, and launches nothing."""
    args = [a.to(cuda_device)
            for a in _recurrence_args(4096, 1, 1024, torch.bfloat16)]
    before = _fwd_launches()
    for with_acts in (False, True):
        with pytest.raises(ValueError, match="lstm_fwd.*B=4096, H=1024"):
            _fwd_outputs(args, with_acts)
    assert _fwd_launches() == before


def _joint_args(B, T, U1, J, V, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    f = torch.randn(B, T, J, generator=g)
    gg = torch.randn(B, U1, J, generator=g)
    w = (torch.randn(J, V, generator=g) / J ** 0.5).to(dtype)
    b = torch.randn(V, generator=g) * 0.1
    labels = torch.randint(1, V, (B, U1 - 1), generator=g, dtype=torch.int32)
    return [a.to(device) for a in (f, gg, labels, w, b)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, T, U1, J, V", [(2, 7, 5, 64, 37),
                                            (3, 9, 41, 512, 1024),
                                            (1, 3, 70, 96, 130)])
def test_cuda_joint_fwd_bwd_match_reference(cuda_device, dtype, B, T, U1, J,
                                            V):
    """Ragged shapes: U+1 above one 64-row block, V not a multiple of the
    column chunk, J not a multiple of 128."""
    f, g, labels, w, b = _joint_args(B, T, U1, J, V, dtype, cuda_device)
    from rnn_transducer_tpu_torch.ops import rnnt_joint_fused as tf
    before = (tf.LAUNCHES_FWD, tf.LAUNCHES_BWD)
    got = tf.joint_lp_fwd(f, g, labels, w, b)
    want = tf.joint_lp_fwd_reference(f, g, labels, w, b)
    for a, e in zip(got, want):
        assert float((a - e).abs().max()) <= LP_ATOL[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    gb = torch.rand(B, T, U1, generator=gen, device=cuda_device)
    gy = torch.rand(B, T, U1, generator=gen, device=cuda_device)
    gbar = torch.randn(B, generator=gen, device=cuda_device)
    args = (f, g, labels, w, b, gb, gy, want[2], gbar)
    got = tf.joint_lp_bwd(*args)
    again = tf.joint_lp_bwd(*args)
    want = tf.joint_lp_bwd_reference(*args)
    torch.cuda.synchronize()
    for name, a, a2, e in zip(("df", "dg", "dw", "db"), got, again, want):
        assert _rel_err(a, e) <= REL_TOL[dtype], name
        assert torch.equal(a, a2), f"{name} differs between two runs"
    assert (tf.LAUNCHES_FWD, tf.LAUNCHES_BWD) == (before[0] + 1,
                                                  before[1] + 2)


# K1 on the ring: libri100's cells (4,100 blocks), 6150 cells (not a
# multiple of 64) at V=8192, and U+1 = 70 > 64 at V=130 (a last chunk of 2
# columns), where blocks span frames and utterances. bf16 W takes the
# ring; f32 W the CUDA-core form.
K1_CASES = [(32, 200, 40, 512, 1024), (3, 50, 40, 512, 8192),
            (2, 7, 69, 96, 130)]


def _joint_fwd_kernels(prof) -> dict:
    """Launches of K1's kernels in a profiled window, by name, and of any
    kernel whose name holds `joint_fwd`."""
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    out = {k: sum(e.count for e in events if k + "_kernel" in e.key)
           for k in ("joint_fwd_wt", "joint_fwd_ring", "joint_fwd")}
    out["any"] = sum(e.count for e in events if "joint_fwd" in e.key)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B, T, U, J, V", K1_CASES)
def test_cuda_joint_fwd_on_the_ring_matches_reference(cuda_device, dtype, B,
                                                      T, U, J, V):
    """K1 against its plain version within LP_ATOL, the same bits twice,
    lp_y exactly -1e30 at u = U; a bf16 call launches the W^T pass and the
    ring kernel once each and no other joint_fwd kernel, an f32 call the
    CUDA-core kernel once."""
    from torch.profiler import ProfilerActivity, profile

    from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf
    from rnn_transducer_tpu_torch.ops import rnnt_joint_fused as tf

    f, g, labels, w, b = _joint_args(B, T, U + 1, J, V, dtype, cuda_device)
    f, g = 0.5 * f, 0.5 * g
    before = tf.LAUNCHES_FWD
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad_profiler_window()
        got = tf.joint_lp_fwd(f, g, labels, w, b)
        torch.cuda.synchronize()
        _pad_profiler_window()
    again = tf.joint_lp_fwd(f, g, labels, w, b)
    want = tf.joint_lp_fwd_reference(f, g, labels, w, b)
    torch.cuda.synchronize()
    for name, a, a2, e in zip(("lp_blank", "lp_y", "base"), got, again, want):
        assert bool(torch.isfinite(a).all()), name
        assert float((a - e).abs().max()) <= LP_ATOL[dtype], name
        assert torch.equal(a, a2), f"{name} differs between two runs"
    assert bool((got[1][:, :, U] == -1e30).all())
    ring = bf.tensor_core_form(dtype, J, V)
    assert _joint_fwd_kernels(prof) == {
        "joint_fwd_wt": int(ring), "joint_fwd_ring": int(ring),
        "joint_fwd": int(not ring), "any": 2 if ring else 1}
    assert tf.LAUNCHES_FWD == before + 2


@pytest.mark.cuda
def test_cuda_joint_fwd_times_its_two_launches(cuda_device):
    """The events of a ring call of K1 bracket the W^T pass and the ring
    kernel, in order."""
    from rnn_transducer_tpu_torch.ops import rnnt_joint_fused as tf

    args = _joint_args(3, 9, 8, 64, 130, torch.bfloat16, cuda_device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    tf.joint_lp_fwd(*args, events=ev)
    torch.cuda.synchronize()
    assert ev[0].elapsed_time(ev[1]) > 0 and ev[1].elapsed_time(ev[2]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [{"wt_shape": (64, 72)},
                                 {"wt_shape": (128, 72)},
                                 {"smem_bytes": 48 * 1024}])
def test_cuda_joint_fwd_refuses_a_bad_layout(cuda_device, monkeypatch, bad):
    """joint_fwd_wt and joint_fwd_ring check the layout they are handed:
    for wt's rows not V's whole chunks (V = 130 takes 192) or shared bytes
    that are not the kernel's, the W^T pass refuses before it launches,
    the wrapper raises and counts nothing, and no K1 kernel runs."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from rnn_transducer_tpu_torch.ops import rnnt_joint_fused as tf

    args = _joint_args(3, 9, 8, 64, 130, torch.bfloat16, cuda_device)
    good = tf.device_fwd_layout(64, 130, cuda_device)
    monkeypatch.setattr(tf, "device_fwd_layout",
                        lambda *a: dataclasses.replace(good, **bad))
    before = tf.LAUNCHES_FWD
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad_profiler_window()
        with pytest.raises(RuntimeError, match="joint_fwd_wt"):
            tf.joint_lp_fwd(*args)
        torch.cuda.synchronize()
        _pad_profiler_window()
    assert tf.LAUNCHES_FWD == before
    assert _joint_fwd_kernels(prof) == {"joint_fwd_wt": 0,
                                        "joint_fwd_ring": 0, "joint_fwd": 0,
                                        "any": 0}


def _lattice_bwd_args(B, T, U, J, V, dtype, device):
    """joint_lp_bwd's arguments with the real lattice's occupancies at
    ragged lengths: row 0 full, row 1 zero frames, row 2 no labels."""
    from rnn_transducer_tpu_torch.ops import rnnt_joint_fused as tf
    from rnn_transducer_tpu_torch.ops import rnnt_loss as rl

    f, g, labels, w, b = _joint_args(B, T, U + 1, J, V, dtype, device,
                                     seed=3)
    f, g = 0.5 * f, 0.5 * g
    gen = torch.Generator().manual_seed(4)
    fl = torch.randint(T // 2, T + 1, (B,), generator=gen, dtype=torch.int32)
    ll = torch.randint(U // 2, U + 1, (B,), generator=gen, dtype=torch.int32)
    fl[0], ll[0], fl[1], ll[2] = T, U, 0, 0
    lpb, lpy, base = tf.joint_lp_fwd_reference(f, g, labels, w, b)
    gb, gy = rl.occupancies_from_lp(lpb, lpy, fl.to(device), ll.to(device))
    gbar = torch.full((B,), 1.0 / B, device=device)
    return (f, g, labels, w, b, gb.contiguous(), gy.contiguous(), base, gbar)


# K2's kernel B: (B, T, U, J, V, splits of the ring's plan, or None for the
# CUDA-core form). libri100's cells (262,400 at V=1024: 16 tiles x 8
# splits), 6150 cells at V=8192 (one split, N not a multiple of 64), V odd.
K2_RING_CASES = [(32, 200, 40, 512, 1024, 8), (3, 50, 40, 512, 8192, 1),
                 (3, 17, 9, 64, 37, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, T, U, J, V, splits", K2_RING_CASES)
def test_cuda_joint_bwd_b_on_the_ring_matches_reference(cuda_device, dtype, B,
                                                        T, U, J, V, splits):
    """joint_lp_bwd against its plain version with the lattice's
    occupancies, a zero-frame row and a row without labels; bf16 W of an
    even V runs kernel B on the ring (zb pass and ring kernel, the plan's
    splits), f32 W and odd V the CUDA-core form; two runs give the same
    bits."""
    from torch.profiler import ProfilerActivity, profile

    from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf
    from rnn_transducer_tpu_torch.ops import rnnt_joint_fused as tf

    args = _lattice_bwd_args(B, T, U, J, V, dtype, cuda_device)
    ring = dtype == torch.bfloat16 and splits is not None
    if ring:
        plan = bf.device_bwd_b_plan(B * T * (U + 1), J, V, cuda_device)
        assert plan.splits == splits
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad_profiler_window()
        got = tf.joint_lp_bwd(*args)
        torch.cuda.synchronize()
        _pad_profiler_window()
    again = tf.joint_lp_bwd(*args)
    want = tf.joint_lp_bwd_reference(*args)
    torch.cuda.synchronize()
    for name, a, a2, e in zip(("df", "dg", "dw", "db"), got, again, want):
        assert bool(torch.isfinite(a).all()), name
        assert _rel_err(a, e) <= REL_TOL[dtype], name
        assert torch.equal(a, a2), f"{name} differs between two runs"
    assert float(got[0][1].abs().max()) == 0.0  # the zero-frame row
    names = {e.key for e in prof.key_averages()}
    ran = {k: any(k + "_kernel" in n for n in names)
           for k in ("joint_bwd_b_zb", "joint_bwd_b_ring", "joint_bwd_b")}
    assert ran == {"joint_bwd_b_zb": ring, "joint_bwd_b_ring": ring,
                   "joint_bwd_b": not ring}, ran
    assert not any("band_bwd" in n for n in names)


# K2's kernel A: (B, T, U, J, V). K2_RING_CASES' shapes, then shapes that
# stress A's ring: 6150 cells (not a multiple of 64 rows) at V=1024, a
# last chunk of 2 columns (V=130) and of 40 (V=1000), J=96 and J=16. bf16
# W of an even V takes the ring; odd V and f32 W the CUDA-core form.
K2_A_CASES = [c[:5] for c in K2_RING_CASES] + [
    (3, 50, 40, 512, 1024), (3, 9, 8, 64, 130), (3, 7, 5, 96, 1000),
    (3, 6, 4, 16, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B, T, U, J, V", K2_A_CASES)
def test_cuda_joint_bwd_a_on_the_ring_matches_reference(cuda_device, dtype, B,
                                                        T, U, J, V):
    """joint_lp_bwd's df and dg against the plain version with the
    lattice's occupancies, a zero-frame row and a row without labels; a
    bf16 call of a shape the ring takes launches the W^T pass and the ring
    kernel once each, any other call the CUDA-core kernel A once; two runs
    give the same bits."""
    from torch.profiler import ProfilerActivity, profile

    from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf
    from rnn_transducer_tpu_torch.ops import rnnt_joint_fused as tf

    args = _lattice_bwd_args(B, T, U, J, V, dtype, cuda_device)
    ring = bf.tensor_core_form(dtype, J, V)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad_profiler_window()
        got = tf.joint_lp_bwd(*args)
        torch.cuda.synchronize()
        _pad_profiler_window()
    again = tf.joint_lp_bwd(*args)
    want = tf.joint_lp_bwd_reference(*args)
    torch.cuda.synchronize()
    for name, a, a2, e in zip(("df", "dg"), got, again, want):
        assert bool(torch.isfinite(a).all()), name
        assert _rel_err(a, e) <= REL_TOL[dtype], name
        assert torch.equal(a, a2), f"{name} differs between two runs"
    assert float(got[0][1].abs().max()) == 0.0  # the zero-frame row
    events = prof.key_averages()
    launched = {k: sum(e.count for e in events if k in e.key)
                for k in ("joint_bwd_a_wt_kernel", "joint_bwd_a_ring_kernel",
                          "joint_bwd_a_kernel")}
    assert launched == {"joint_bwd_a_wt_kernel": int(ring),
                        "joint_bwd_a_ring_kernel": int(ring),
                        "joint_bwd_a_kernel": int(not ring)}, launched


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [{"wt_shape": (128, 72)},
                                 {"wt_shape": (256, 72)},
                                 {"smem_bytes": 48 * 1024}])
def test_cuda_joint_bwd_a_refuses_a_bad_layout(cuda_device, monkeypatch, bad):
    """joint_bwd_a_wt and joint_bwd_a_ring check the layout they are
    handed and the wrapper raises: wt's rows not V's whole chunks (V = 130
    takes 192), shared bytes that are not the kernel's."""
    import dataclasses

    from rnn_transducer_tpu_torch.ops import rnnt_joint_fused as tf

    args = _lattice_bwd_args(3, 9, 8, 64, 130, torch.bfloat16, cuda_device)
    good = tf.device_bwd_a_layout(64, 130, cuda_device)
    monkeypatch.setattr(tf, "device_bwd_a_layout",
                        lambda *a: dataclasses.replace(good, **bad))
    with pytest.raises(RuntimeError, match="joint_bwd_a_"):
        tf.joint_lp_bwd(*args)


@pytest.mark.cuda
def test_cuda_joint_bwd_times_its_launches(cuda_device):
    """The five events of a bf16 call bracket kernel A (its W^T pass and
    ring kernel), the zb pass, the ring kernel of B and the ordered sums,
    in order."""
    from rnn_transducer_tpu_torch.ops import rnnt_joint_fused as tf

    args = _lattice_bwd_args(3, 9, 8, 64, 130, torch.bfloat16, cuda_device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    tf.joint_lp_bwd(*args, events=ev)
    torch.cuda.synchronize()
    spans = [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
    assert all(t > 0 for t in spans), spans


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [{"split_rows": 32},
                                 {"smem_bytes": 48 * 1024},
                                 {"grid": (0, 1)}])
def test_cuda_joint_bwd_b_refuses_a_bad_plan(cuda_device, monkeypatch, bad):
    """joint_bwd_b_ring checks the plan it is handed and the wrapper
    raises; no other kernel B runs in its place."""
    import dataclasses

    from rnn_transducer_tpu_torch.ops import rnnt_joint_fused as tf

    args = _lattice_bwd_args(3, 9, 8, 64, 130, torch.bfloat16, cuda_device)
    good = tf.device_bwd_b_plan(3 * 9 * 9, 64, 130, cuda_device)
    monkeypatch.setattr(tf, "device_bwd_b_plan",
                        lambda *a: dataclasses.replace(good, **bad))
    with pytest.raises(RuntimeError, match="joint_bwd_b_ring"):
        tf.joint_lp_bwd(*args)


@pytest.mark.cuda
def test_cuda_encoder_and_predictor_weights_get_gradients(cuda_device):
    """Through encode / predict on the card every LSTM weight gets a
    gradient, equal to the CPU's (the plain versions) at f32."""
    import dataclasses

    import numpy as np

    from rnn_transducer_tpu_torch.models import transducer as tm
    from rnn_transducer_tpu_torch.models.config import TransducerConfig
    from rnn_transducer_tpu_torch.weights import (params_from_numpy,
                                                  params_to_numpy)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransducerConfig(input_dim=8, enc_layers=2, enc_hidden=64,
                           time_reduction=2, pred_layers=1, pred_hidden=32,
                           embed_dim=16, joint_dim=32, vocab_size=11,
                           compute_dtype="float32")
    rng = np.random.default_rng(0)
    params_np = params_to_numpy(tm.init_params(cfg, rng))
    feats = torch.from_numpy(rng.normal(size=(3, 16, 8)).astype(np.float32))
    lens = torch.tensor([16, 9, 4], dtype=torch.int32)
    labels = torch.randint(1, 11, (3, 4), dtype=torch.int32)
    grads = {}
    for dev in ("cpu", cuda_device):
        params = params_from_numpy(params_np, dev)
        for part in ("encoder", "predictor"):
            for layer in params[part]:
                for leaf in layer.values():
                    leaf.requires_grad_(True)
        enc, _ = tm.encode(params, cfg, feats.to(dev), lens.to(dev))
        pred, _ = tm.predict(params, dataclasses.replace(cfg),
                             labels.to(dev))
        (enc.square().sum() + pred.square().sum()).backward()
        grads[str(dev)] = [leaf.grad for part in ("encoder", "predictor")
                           for layer in params[part] for leaf in
                           layer.values()]
    for a, e in zip(grads[str(cuda_device)], grads["cpu"]):
        assert a is not None
        assert _rel_err(a.cpu(), e) <= 1e-4


def _lattice_args(B, T, U, device, seed=0):
    """Masked scores, acceptance scores and frame lengths of a ragged batch
    with a zero-frame row (b = 1) and a label_len-0 row (b = 2)."""
    from rnn_transducer_tpu_torch.ops import rnnt_loss as rl
    g = torch.Generator().manual_seed(seed)
    lp = torch.log_softmax(torch.randn(B, T, U + 1, 3, generator=g), dim=-1)
    fl = torch.randint(max(T // 2, 1), T + 1, (B,), generator=g,
                       dtype=torch.int32)
    ll = torch.randint(0, U + 1, (B,), generator=g, dtype=torch.int32)
    fl[0], ll[0] = T, U
    fl[1:2], ll[2:3] = 0, 0
    lpb_m, lpy_m = rl._masked_transitions(lp[..., 0], lp[..., 1], fl, ll)
    accept = rl._accept_scores(lp[..., 0].contiguous(), fl, ll)
    return [a.contiguous().to(device) for a in (lpb_m, lpy_m, accept, fl)]


def _assert_lattice_close(got, want):
    """Reachable cells within 1e-5 of max(1, |plain|); unreachable ones at
    or below -1e29 on both sides."""
    reach = want > -1e29
    err = (got - want).abs()
    assert bool((err[reach] <= 1e-5 * want[reach].abs().clamp(min=1)).all())
    assert bool((got[~reach] <= -1e29).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B, T, U", [(3, 7, 4), (32, 200, 40), (32, 200, 80),
                                     (3, 5, 1100)])
def test_cuda_lattice_matches_reference(cuda_device, B, T, U):
    """The training shapes (U+1 = 41 and 81) and U+1 > 1024, where the
    threads stride over the diagonal."""
    from rnn_transducer_tpu_torch.ops import rnnt_lattice_cuda as lat
    lpb_m, lpy_m, accept, fl = _lattice_args(B, T, U, cuda_device)
    before = (lat.LAUNCHES_ALPHA, lat.LAUNCHES_BETA)
    alpha = lat.alpha_wavefront(lpb_m, lpy_m)
    want_a = lat.alpha_wavefront_reference(lpb_m, lpy_m)
    beta, gb, gy = lat.beta_occupancies(lpb_m, lpy_m, accept, want_a, fl)
    want_b, want_gb, want_gy = lat.beta_occupancies_reference(
        lpb_m, lpy_m, accept, want_a, fl)
    beta_only = lat.beta_wavefront(lpb_m, lpy_m, accept)
    torch.cuda.synchronize()
    _assert_lattice_close(alpha, want_a)
    _assert_lattice_close(beta, want_b)
    for got, want in ((gb, want_gb), (gy, want_gy)):
        assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(beta_only, beta)
    assert not gb[1].any() and not gy[1].any()  # the zero-frame row
    assert (lat.LAUNCHES_ALPHA, lat.LAUNCHES_BETA) == (before[0] + 1,
                                                      before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, T, U1, V", [(2, 5, 4, 130), (3, 7, 6, 64),
                                         (32, 200, 81, 1024)])
def test_cuda_loss_rows_match_reference(cuda_device, dtype, B, T, U1, V):
    """V = 130 takes the element-wise path in both dtypes, V = 64 the
    vector path in both; the last shape is the two-pass training step's.
    Labels include blank, where assemble_grad subtracts both terms."""
    from rnn_transducer_tpu_torch.ops import rnnt_loss_cuda as lc
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(B, T, U1, V, generator=g, device=cuda_device).to(dtype)
    labels = torch.randint(0, V, (B, U1 - 1), generator=g,
                           device=cuda_device, dtype=torch.int32)
    gb = torch.rand(B, T, U1, generator=g, device=cuda_device)
    gy = torch.rand(B, T, U1, generator=g, device=cuda_device)
    before = (lc.LAUNCHES_EXTRACT, lc.LAUNCHES_GRAD)
    got = lc.extract_lp(x, labels)
    want = lc.extract_lp_reference(x, labels)
    grad = lc.assemble_grad(x, labels, gb + gy, gb, gy)
    want_g = lc.assemble_grad_reference(x, labels, gb + gy, gb, gy)
    torch.cuda.synchronize()
    for a, e in zip(got, want):
        live = e > -1e29
        assert float((a[live] - e[live]).abs().max()) <= 1e-4
        assert torch.equal(a[~live], e[~live])
    assert grad.dtype == dtype
    assert _rel_err(grad.float(), want_g.float()) <= REL_TOL[dtype]
    assert (lc.LAUNCHES_EXTRACT, lc.LAUNCHES_GRAD) == (before[0] + 1,
                                                      before[1] + 1)


@pytest.mark.cuda
def test_cuda_two_pass_loss_matches_the_cpu(cuda_device):
    """rnnt_loss_twopass through K5 and K3 on the card against its plain
    versions on the CPU: loss and gradient, FastEmit on, a zero-frame
    row. The two devices round log Z differently in its last bits, and
    every gradient element carries that error times its occupancy, so the
    lattice is kept small enough (|log Z| < ~40) for an atol of 1e-5."""
    from rnn_transducer_tpu_torch.ops import rnnt_loss_cuda as lc
    g = torch.Generator().manual_seed(4)
    B, T, U, V = 4, 6, 3, 96
    logits = torch.randn(B, T, U + 1, V, generator=g)
    labels = torch.randint(1, V, (B, U), generator=g, dtype=torch.int32)
    fl = torch.tensor([T, 0, 5, 3], dtype=torch.int32)
    ll = torch.tensor([U, 2, 0, 2], dtype=torch.int32)
    out = {}
    for dev in ("cpu", cuda_device):
        x = logits.detach().to(dev).requires_grad_(True)
        loss = lc.rnnt_loss_twopass(x, labels.to(dev), fl.to(dev),
                                    ll.to(dev), 0, 0.5)
        loss.sum().backward()
        out[str(dev)] = (loss.detach().cpu(), x.grad.cpu())
    (lk, gk), (lp, gp) = out[str(cuda_device)], out["cpu"]
    torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(gk, gp, rtol=1e-5, atol=1e-5)
    assert lk[1] == 0.0 and not gk[1].any()


def _int8_args(B, T, H, dtype, device):
    """x_proj in `dtype`, wq and its scale from quantize_tensor, nonzero
    h0 and c0, on `device`."""
    from rnn_transducer_tpu_torch.ops.quant import quantize_tensor
    g = torch.Generator().manual_seed(B)
    qw = quantize_tensor((torch.rand(H, 4 * H, generator=g) * 2 - 1)
                         / H ** 0.5)
    x = torch.randn(B, T, 4 * H, generator=g).to(dtype)
    h0 = 0.5 * torch.randn(B, H, generator=g)
    c0 = torch.randn(B, H, generator=g)
    return [a.contiguous().to(device) for a in (x, qw.q, qw.scale, h0, c0)]


# (B, T, H, batch tile, groups): batch tiles of 8, 16 and 32 rows; B=24,
# three 8-row tiles; B=72, two 8-row tiles a block of 16 rows; B=64, one
# tile across several row blocks, so the amax crosses blocks; H=1024; T=1;
# B=3 with H % 16 != 0 (one 3-row tile, Wq loaded a byte at a time); and
# B=256, which one wave does not hold: two groups of two 64-row tiles.
INT8_SHAPES = [(8, 37, 512, 8, 1), (16, 37, 512, 16, 1),
               (32, 37, 512, 32, 1), (24, 37, 512, 8, 1),
               (72, 21, 512, 8, 1), (64, 37, 512, 64, 1),
               (8, 37, 1024, 8, 1), (8, 1, 512, 8, 1), (3, 9, 100, 3, 1),
               (256, 5, 512, 64, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-4),
                                         (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B, T, H, bt, n_groups", INT8_SHAPES)
def test_cuda_lstm_int8_matches_reference(cuda_device, dtype, atol, B, T, H,
                                          bt, n_groups):
    """K7 at each batch tile (its own amax), ragged T, nonzero h0/c0, run
    twice for the same bits. Both sides take the same rounded operations,
    so they differ only where CUDA's and PyTorch's expf / tanhf do, and a
    last-bit difference of h flips one requantized int8 value only at a
    .5 boundary."""
    from rnn_transducer_tpu_torch.ops import lstm_int8_cuda as q8
    args = _int8_args(B, T, H, dtype, cuda_device)
    assert q8.batch_tile(B, H) == bt
    assert len(q8.device_groups(B, H, cuda_device)) == n_groups
    before = q8.LAUNCHES
    hs, (hT, cT) = q8.lstm_recurrence_int8(*args)
    again, (_, cT_again) = q8.lstm_recurrence_int8(*args)
    torch.cuda.synchronize()
    assert q8.LAUNCHES == before + 2
    assert torch.equal(hs, again) and torch.equal(cT, cT_again)
    hs_r, (hT_r, cT_r) = q8.lstm_recurrence_int8_reference(*args)
    for got, want in ((hs, hs_r), (hT, hT_r), (cT, cT_r)):
        torch.testing.assert_close(got, want, rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("B, n_groups", [(8, 1), (256, 2)])
def test_cuda_lstm_int8_is_one_launch_a_group(cuda_device, B, n_groups):
    """A layer call is one persistent kernel a group of batch tiles,
    whatever T: the profiler sees one lstm_q_persistent_kernel a group and
    no other kernel of lstm_fwd_q.cu."""
    from torch.profiler import ProfilerActivity, profile

    from rnn_transducer_tpu_torch.ops import lstm_int8_cuda as q8
    args = _int8_args(B, 9, 512, torch.bfloat16, cuda_device)
    q8.lstm_recurrence_int8(*args)  # warm: build, plan, caches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad_profiler_window()
        for _ in range(2):
            q8.lstm_recurrence_int8(*args)
        torch.cuda.synchronize()
        _pad_profiler_window()
    counts = {}
    for e in prof.key_averages():
        if "lstm_q" in e.key:
            counts[e.key] = counts.get(e.key, 0) + e.count
    assert all("lstm_q_persistent_kernel" in k for k in counts), counts
    assert sum(counts.values()) == 2 * n_groups, counts


@pytest.mark.cuda
def test_cuda_lstm_int8_refuses_a_tile_it_cannot_place(cuda_device):
    """At H=4096 one 8-row batch tile needs 256 blocks of 16 units, more
    than one wave: the wrapper raises and launches nothing."""
    from rnn_transducer_tpu_torch.ops import lstm_int8_cuda as q8
    H = 4096
    args = [torch.zeros(8, 1, 4 * H, device=cuda_device),
            torch.zeros(H, 4 * H, dtype=torch.int8, device=cuda_device),
            torch.ones(1, 4 * H, device=cuda_device),
            torch.zeros(8, H, device=cuda_device),
            torch.zeros(8, H, device=cuda_device)]
    before = q8.LAUNCHES
    with pytest.raises(ValueError, match="lstm_fwd_q.*B=8, H=4096"):
        q8.lstm_recurrence_int8(*args)
    assert q8.LAUNCHES == before


def _greedy_inputs(B, T, E, H, J, V, device, seed=0):
    """f, lens (ragged, one zero-length row) and the f32 weights of a
    random one-layer predictor and joint, blank near the top."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *s, k: (torch.rand(*s, generator=g) * 2 - 1) * k  # noqa: E731
    f = 0.5 * torch.randn(B, T, J, generator=g)
    lens = torch.randint(T // 2, T + 1, (B,), generator=g, dtype=torch.int32)
    lens[1] = 0
    bo = u(V, k=J ** -0.5)
    bo[0] += 1.0  # some rows walk frames on blank, some hit the cap
    weights = (torch.randn(V, E, generator=g), u(E, 4 * H, k=H ** -0.5),
               u(H, 4 * H, k=H ** -0.5), u(4 * H, k=H ** -0.5),
               u(H, J, k=H ** -0.5), u(J, k=H ** -0.5), u(J, V, k=J ** -0.5),
               bo)
    return (f.to(device), lens.to(device),
            tuple(w.contiguous().to(device) for w in weights))


@pytest.mark.cuda
@pytest.mark.parametrize("B, T, E, H, J, V", [(3, 60, 512, 512, 512, 1024),
                                              (5, 23, 128, 256, 128, 11)])
def test_cuda_greedy_fused_matches_reference(cuda_device, B, T, E, H, J, V):
    """K9 at libri100 width (B = 3) and at a narrow ragged shape, f32:
    identical tokens and step counts."""
    from rnn_transducer_tpu_torch.decode import greedy_fused as gf
    torch.backends.cuda.matmul.allow_tf32 = False
    f, lens, weights = _greedy_inputs(B, T, E, H, J, V, cuda_device)
    before = gf.LAUNCHES
    toks, steps = gf.greedy_fused_tokens(f, lens, weights, 20, 0,
                                         torch.float32)
    torch.cuda.synchronize()
    assert gf.LAUNCHES == before + 1
    want_t, want_s = gf.greedy_fused_tokens_reference(f, lens, weights, 20, 0,
                                                      torch.float32)
    assert torch.equal(toks, want_t)
    assert torch.equal(steps, want_s)
    assert steps[1] == 0 and (toks[1] == 0).all()


# K8: y within 1e-5 absolute (rows normalised to O(1)); dx within 1e-5 of
# its largest value; dg and db within 1e-4 of theirs (sums over every row
# in another order).
LN_Y_ATOL, LN_DX_RTOL, LN_DGB_RTOL = 1e-5, 1e-5, 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("N, D", [(6400, 512), (1603, 512), (37, 64),
                                  (45, 1028)])
def test_cuda_fused_ln_matches_reference(cuda_device, act, N, D):
    from rnn_transducer_tpu_torch.ops import fused_ln as fl

    g = torch.Generator().manual_seed(N)
    x = (3 * torch.randn(N, D, generator=g) + 1).to(cuda_device)
    w = (1 + 0.5 * torch.randn(D, generator=g)).to(cuda_device)
    b = (0.5 * torch.randn(D, generator=g)).to(cuda_device)
    dy = torch.randn(N, D, generator=g).to(cuda_device)
    before = (fl.LAUNCHES_FWD, fl.LAUNCHES_BWD)
    y, mu, rstd = fl.fln_fwd(x, w, b, act)
    dx, dg, db = fl.fln_bwd(x, w, b, mu, rstd, dy, act)
    again = fl.fln_bwd(x, w, b, mu, rstd, dy, act)
    torch.cuda.synchronize()
    assert (fl.LAUNCHES_FWD, fl.LAUNCHES_BWD) == (before[0] + 1,
                                                  before[1] + 2)
    xs, ws, bs = (a.clone().requires_grad_(True) for a in (x, w, b))
    ref = fl.layer_norm_reference(xs, ws, bs, act)
    want = torch.autograd.grad(ref, (xs, ws, bs), dy)
    torch.testing.assert_close(y, ref.detach(), rtol=0, atol=LN_Y_ATOL)
    assert _rel_err(dx, want[0]) <= LN_DX_RTOL
    assert _rel_err(dg, want[1]) <= LN_DGB_RTOL
    assert _rel_err(db, want[2]) <= LN_DGB_RTOL
    for a, e in zip(again, (dx, dg, db)):
        assert torch.equal(a, e)  # no float atomics: the same bits


@pytest.mark.cuda
def test_cuda_conformer_encode_matches_the_plain_path(cuda_device):
    """Conformer `encode` through K8 on the card against the same encode
    with the plain LayerNorm on the card, at f32."""
    import dataclasses
    from unittest import mock

    import numpy as np

    from rnn_transducer_tpu_torch.models import transducer as tm
    from rnn_transducer_tpu_torch.models.config import config_conformer_smoke
    from rnn_transducer_tpu_torch.ops import fused_ln as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(config_conformer_smoke(),
                              compute_dtype="float32")
    params = tm.init_params(cfg, np.random.default_rng(0), cuda_device)
    g = torch.Generator().manual_seed(0)
    feats = torch.randn(3, 64, cfg.input_dim, generator=g).to(cuda_device)
    lens = torch.tensor([64, 41, 0], dtype=torch.int32, device=cuda_device)
    before = fl.LAUNCHES_FWD
    got, _ = tm.encode(params, cfg, feats, lens)
    assert fl.LAUNCHES_FWD - before == 6 * cfg.enc_layers
    with mock.patch.object(fl, "fln_fwd", fl.fln_fwd_reference):
        want, _ = tm.encode(params, cfg, feats, lens)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def _band_args(B, T, S, J, V, dtype, device):
    g = torch.Generator().manual_seed(4)
    f = torch.randn(B, T, J, generator=g) * 0.5
    g_w = torch.randn(B, T, S, J, generator=g) * 0.5
    lab_w = torch.randint(0, V, (B, T, S), generator=g, dtype=torch.int32)
    lab_w[:, ::2, 0] = 0  # cells whose label is the blank id
    w = (torch.randn(J, V, generator=g) / J ** 0.5).to(dtype)
    b = torch.randn(V, generator=g) * 0.1
    cb = -torch.rand(B, T, S, generator=g) / B
    cy = -torch.rand(B, T, S, generator=g) / B
    return [a.to(device) for a in (f, g_w, lab_w, w, b)], [
        a.to(device) for a in (cb, cy)]


# K6's card shapes (B, T, S, J, V): S not a multiple of 8, rows past one
# 64-row block, V odd (the CUDA-core forms at bf16) and not a multiple of
# the column chunk, J % 16 != 0, the pruned band's V=8192, more column
# tiles than SMs (8704).
BAND_SHAPES = [(2, 7, 3, 64, 37), (3, 9, 8, 512, 1024), (1, 5, 13, 96, 130),
               (2, 4, 5, 24, 40), (1, 7, 9, 128, 1000), (2, 50, 8, 512, 1024),
               (1, 3, 8, 512, 8192), (1, 2, 4, 64, 8704)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, T, S, J, V", BAND_SHAPES)
def test_cuda_band_kernels_match_reference(cuda_device, dtype, B, T, S, J,
                                           V):
    """K6 (band_fwd, band_bwd_a, band_bwd_b) against the plain versions:
    S not a multiple of 8, rows past one 64-row block, V odd (the CUDA-core
    form at bf16) and not a multiple of the column chunk, J % 16 != 0. For
    the tensor-core forms of kernels A and B (bf16, J % 16 == 0, V even):
    V not a multiple of 64 columns (1000, 130, 8704), J below 512 and not
    a multiple of 64 (96), N not a multiple of 64 rows (65, 63, 24, 8);
    for B's, more than one row split (800 rows at V=1024: 8), the pruned
    band's V=8192, and more column tiles than SMs (8704: 136 tiles, walked
    in turn). Kernel A runs its W^T pass and ring kernel where it takes
    the tensor-core form and its CUDA-core kernel elsewhere; both
    backward kernels give the same bits twice."""
    from torch.profiler import ProfilerActivity, profile

    from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf
    (f, g_w, lab_w, w, b), (cb, cy) = _band_args(B, T, S, J, V, dtype,
                                                 cuda_device)
    before = (bf.LAUNCHES_FWD, bf.LAUNCHES_BWD_A, bf.LAUNCHES_BWD_B)
    got = bf.band_lp_fwd(f, g_w, lab_w, w, b)
    want = bf.band_lp_fwd_reference(f, g_w, lab_w, w, b)
    for a, e in zip(got, want):
        assert float((a - e).abs().max()) <= LP_ATOL[dtype]
    args = (f, g_w, lab_w, w, b, want[2], cb, cy)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad_profiler_window()
        got_a = bf.band_lp_bwd_a(*args)
        torch.cuda.synchronize()
        _pad_profiler_window()
    again_a = bf.band_lp_bwd_a(*args)
    got_b = bf.band_lp_bwd_b(*args)
    again = bf.band_lp_bwd_b(*args)
    want_a = bf.band_lp_bwd_a_reference(*args)
    want_b = bf.band_lp_bwd_b_reference(*args)
    torch.cuda.synchronize()
    for name, a, e in zip(("df", "dg_w", "dw", "db"), got_a + got_b,
                          want_a + want_b):
        assert bool(torch.isfinite(a).all()), name
        assert _rel_err(a, e) <= REL_TOL[dtype], name
    for name, a, e in zip(("df", "dg_w"), again_a, got_a):
        assert torch.equal(a, e), f"{name} differs between two runs"
    for a, e in zip(again, got_b):
        assert torch.equal(a, e)  # ordered partials: the same bits
    ring = bf.tensor_core_form(dtype, J, V)
    names = {e.key for e in prof.key_averages()}
    ran = {k: any(k + "_kernel" in n for n in names)
           for k in ("band_bwd_a_wt", "band_bwd_a_ring", "band_bwd_a")}
    assert ran == {"band_bwd_a_wt": ring, "band_bwd_a_ring": ring,
                   "band_bwd_a": not ring}, ran
    assert (bf.LAUNCHES_FWD, bf.LAUNCHES_BWD_A, bf.LAUNCHES_BWD_B) == (
        before[0] + 1, before[1] + 2, before[2] + 2)


def _band_fwd_kernels(prof) -> dict:
    """Launches of K6-fwd's kernels in a profiled window, by name."""
    events = prof.key_averages()
    return {k: sum(e.count for e in events if k + "_kernel" in e.key)
            for k in ("band_fwd_wt", "band_fwd_ring", "band_fwd")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, T, S, J, V", BAND_SHAPES)
def test_cuda_band_fwd_matches_reference(cuda_device, dtype, B, T, S, J, V):
    """K6-fwd against its plain version at K6's card shapes (labels equal
    to the blank id among them), the same bits twice; a bf16 call of a
    shape the ring takes (J % 16 == 0, V even) launches the W^T pass and
    the ring kernel once each, any other call the CUDA-core kernel once."""
    from torch.profiler import ProfilerActivity, profile

    from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf

    (f, g_w, lab_w, w, b), _ = _band_args(B, T, S, J, V, dtype, cuda_device)
    before = bf.LAUNCHES_FWD
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad_profiler_window()
        got = bf.band_lp_fwd(f, g_w, lab_w, w, b)
        torch.cuda.synchronize()
        _pad_profiler_window()
    again = bf.band_lp_fwd(f, g_w, lab_w, w, b)
    want = bf.band_lp_fwd_reference(f, g_w, lab_w, w, b)
    torch.cuda.synchronize()
    for name, a, a2, e in zip(("lp_blank", "lp_y", "base"), got, again, want):
        assert bool(torch.isfinite(a).all()), name
        assert float((a - e).abs().max()) <= LP_ATOL[dtype], name
        assert torch.equal(a, a2), f"{name} differs between two runs"
    ring = bf.tensor_core_form(dtype, J, V)
    assert _band_fwd_kernels(prof) == {
        "band_fwd_wt": int(ring), "band_fwd_ring": int(ring),
        "band_fwd": int(not ring)}
    assert bf.LAUNCHES_FWD == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_band_fwd_picks_edge_labels(cuda_device, dtype):
    """65 rows (one past a 64-row block), a blank id of 3, and labels equal
    to it, outside [0, V) (-1, V, V + 7) and at V - 1: each within LP_ATOL
    of the plain version; a label outside [0, V) picks 0, so lp_y = -base
    exactly, and a label equal to the blank picks the blank's logit, so
    lp_y = lp_blank exactly."""
    from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf

    B, T, S, J, V, blank = 1, 13, 5, 64, 130, 3
    (f, g_w, lab_w, w, b), _ = _band_args(B, T, S, J, V, dtype, cuda_device)
    lab = lab_w.view(-1)
    lab[0::5] = blank
    lab[1::10] = -1
    lab[6::10] = V
    lab[2::5] = V + 7
    lab[3::5] = V - 1
    lpb, lpy, base = bf.band_lp_fwd(f, g_w, lab_w, w, b, blank)
    want = bf.band_lp_fwd_reference(f, g_w, lab_w, w, b, blank)
    torch.cuda.synchronize()
    for name, a, e in zip(("lp_blank", "lp_y", "base"), (lpb, lpy, base),
                          want):
        assert float((a - e).abs().max()) <= LP_ATOL[dtype], name
    out = (lab_w < 0) | (lab_w >= V)
    assert int(out.sum()) == 26
    assert torch.equal(lpy[out], -base[out])
    same = lab_w == blank
    assert torch.equal(lpy[same], lpb[same])


@pytest.mark.cuda
def test_cuda_band_fwd_times_its_two_launches(cuda_device):
    """The events of a tensor-core call of the forward bracket the W^T
    pass and the ring kernel, in order."""
    from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf

    (f, g_w, lab_w, w, b), _ = _band_args(2, 6, 8, 64, 130, torch.bfloat16,
                                          cuda_device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    bf.band_lp_fwd(f, g_w, lab_w, w, b, events=ev)
    torch.cuda.synchronize()
    assert ev[0].elapsed_time(ev[1]) > 0 and ev[1].elapsed_time(ev[2]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [{"wt_shape": (64, 72)},
                                 {"wt_shape": (128, 72)},
                                 {"smem_bytes": 48 * 1024}])
def test_cuda_band_fwd_refuses_a_bad_layout(cuda_device, monkeypatch, bad):
    """band_fwd_wt and band_fwd_ring check the layout they are handed: for
    wt's rows not V's whole chunks (V = 130 takes 192) or shared bytes
    that are not the kernel's, the W^T pass refuses before it launches,
    the wrapper raises and counts nothing, and no K6-fwd kernel runs."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf

    (f, g_w, lab_w, w, b), _ = _band_args(2, 6, 8, 64, 130, torch.bfloat16,
                                          cuda_device)
    good = bf.device_fwd_layout(64, 130, cuda_device)
    monkeypatch.setattr(bf, "device_fwd_layout",
                        lambda *a: dataclasses.replace(good, **bad))
    before = bf.LAUNCHES_FWD
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad_profiler_window()
        with pytest.raises(RuntimeError, match="band_fwd_wt"):
            bf.band_lp_fwd(f, g_w, lab_w, w, b)
        torch.cuda.synchronize()
        _pad_profiler_window()
    assert bf.LAUNCHES_FWD == before
    assert _band_fwd_kernels(prof) == {"band_fwd_wt": 0, "band_fwd_ring": 0,
                                       "band_fwd": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [{"split_rows": 32},
                                 {"smem_bytes": 48 * 1024},
                                 {"grid": (0, 1)}])
def test_cuda_band_bwd_b_refuses_a_bad_plan(cuda_device, monkeypatch, bad):
    """band_bwd_b_ring checks the plan it is handed and the wrapper raises:
    split rows that are not whole chunks, shared bytes that are not the
    kernel's, an empty grid."""
    import dataclasses

    from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf

    (f, g_w, lab_w, w, b), (cb, cy) = _band_args(2, 6, 8, 64, 128,
                                                 torch.bfloat16, cuda_device)
    base = bf.band_lp_fwd(f, g_w, lab_w, w, b)[2]
    good = bf.device_bwd_b_plan(2 * 6 * 8, 64, 128, cuda_device)
    monkeypatch.setattr(bf, "device_bwd_b_plan",
                        lambda *a: dataclasses.replace(good, **bad))
    with pytest.raises(RuntimeError, match="band_bwd_b_ring"):
        bf.band_lp_bwd_b(f, g_w, lab_w, w, b, base, cb, cy)


@pytest.mark.cuda
def test_cuda_band_bwd_b_times_its_two_launches(cuda_device):
    """The events of a tensor-core call bracket the zb pass and the main
    launch, in order."""
    from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf

    (f, g_w, lab_w, w, b), (cb, cy) = _band_args(2, 6, 8, 64, 128,
                                                 torch.bfloat16, cuda_device)
    base = bf.band_lp_fwd(f, g_w, lab_w, w, b)[2]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    bf.band_lp_bwd_b(f, g_w, lab_w, w, b, base, cb, cy, events=ev)
    torch.cuda.synchronize()
    assert ev[0].elapsed_time(ev[1]) > 0 and ev[1].elapsed_time(ev[2]) > 0


@pytest.mark.cuda
def test_cuda_band_bwd_a_times_its_two_launches(cuda_device):
    """The events of a tensor-core call of kernel A bracket the W^T pass
    and the main launch (the ring kernel and the ordered df sum), in
    order."""
    from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf

    (f, g_w, lab_w, w, b), (cb, cy) = _band_args(2, 6, 8, 64, 130,
                                                 torch.bfloat16, cuda_device)
    base = bf.band_lp_fwd(f, g_w, lab_w, w, b)[2]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    bf.band_lp_bwd_a(f, g_w, lab_w, w, b, base, cb, cy, events=ev)
    torch.cuda.synchronize()
    assert ev[0].elapsed_time(ev[1]) > 0 and ev[1].elapsed_time(ev[2]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [{"wt_shape": (64, 72)},
                                 {"wt_shape": (128, 72)},
                                 {"smem_bytes": 48 * 1024}])
def test_cuda_band_bwd_a_refuses_a_bad_layout(cuda_device, monkeypatch, bad):
    """band_bwd_a_wt and band_bwd_a_ring check the layout they are handed
    and the wrapper raises: wt's rows not V's whole chunks (V = 130 takes
    192), shared bytes that are not the kernel's."""
    import dataclasses

    from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf

    (f, g_w, lab_w, w, b), (cb, cy) = _band_args(2, 6, 8, 64, 130,
                                                 torch.bfloat16, cuda_device)
    base = bf.band_lp_fwd(f, g_w, lab_w, w, b)[2]
    good = bf.device_bwd_a_layout(64, 130, cuda_device)
    monkeypatch.setattr(bf, "device_bwd_a_layout",
                        lambda *a: dataclasses.replace(good, **bad))
    with pytest.raises(RuntimeError, match="band_bwd_a_"):
        bf.band_lp_bwd_a(f, g_w, lab_w, w, b, base, cb, cy)


@pytest.mark.cuda
def test_cuda_band_kernel_raises_when_the_library_fails(cuda_device,
                                                        monkeypatch):
    """A CUDA tensor launches K6 or raises: no fallback to the plain
    version when the library cannot be built or loaded."""
    from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf
    from rnn_transducer_tpu_torch.utils import build

    def broken():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(build, "load_library", broken)
    (f, g_w, lab_w, w, b), _ = _band_args(1, 3, 4, 16, 20, torch.float32,
                                          cuda_device)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        bf.band_lp_fwd(f, g_w, lab_w, w, b)


@pytest.mark.cuda
def test_cuda_pruned_loss_matches_the_plain_path(cuda_device):
    """rnnt_loss_pruned through K6 and K3 on the card against the same loss
    through the plain versions on the card, at f32."""
    from unittest import mock

    from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf
    from rnn_transducer_tpu_torch.ops import rnnt_lattice_cuda as lat
    from rnn_transducer_tpu_torch.ops import rnnt_pruned as pr

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(6)
    B, T, U, J, V, S = 3, 11, 6, 32, 50, 3
    f = (torch.randn(B, T, J, generator=g) * 0.5).to(cuda_device)
    gg = (torch.randn(B, U + 1, J, generator=g) * 0.5).to(cuda_device)
    w = (torch.randn(J, V, generator=g) / J ** 0.5).to(cuda_device)
    b = (torch.randn(V, generator=g) * 0.1).to(cuda_device)
    labels = torch.randint(1, V, (B, U), generator=g,
                           dtype=torch.int32).to(cuda_device)
    fl = torch.tensor([T, 7, 0], dtype=torch.int32, device=cuda_device)
    ll = torch.tensor([U, 4, 2], dtype=torch.int32, device=cuda_device)
    occ = torch.rand(B, T, U + 1, generator=g).to(cuda_device)
    sb = pr.prune_bounds(occ, S, fl, ll)

    def run():
        leaves = [a.clone().requires_grad_(True) for a in (f, gg, w, b)]
        loss = pr.rnnt_loss_pruned(*leaves, labels, fl, ll, sb, S, 0,
                                   torch.float32)
        return loss.detach(), torch.autograd.grad(loss.sum(), leaves)

    before = bf.LAUNCHES_FWD
    loss_k, grads_k = run()
    assert bf.LAUNCHES_FWD == before + 1
    plain = [mock.patch.object(mod, name, getattr(mod, name + "_reference"))
             for mod, name in ((bf, "band_lp_fwd"), (bf, "band_lp_bwd_a"),
                               (bf, "band_lp_bwd_b"), (lat, "alpha_wavefront"),
                               (lat, "beta_occupancies"))]
    for p in plain:
        p.start()
    try:
        loss_p, grads_p = run()
    finally:
        for p in plain:
            p.stop()
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=1e-5)
    for a, e in zip(grads_k, grads_p):
        assert _rel_err(a, e) <= 1e-4
