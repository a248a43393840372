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


def _most_of_three_windows(call, count):
    """call() under three padded torch.profiler windows: the first
    window's result, and each key of count(prof) at its most over the
    windows. The profiler on the H100 has lost a kernel from a window
    (one short of a count), and never added one. The lost kernels were
    the first ones of the window: the leading spin kernel, and at times
    the kernel launched after it (a lattice edge tile, or a 46 ms tile
    behind a 100 ms spin), while kernels behind two small marker kernels
    were kept; so each window launches two markers, left out of every
    count, before call()."""
    from torch.profiler import ProfilerActivity, profile

    first, most = None, {}
    for i in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _pad_profiler_window()
            torch.ones(4, device="cuda").add_(1)  # the markers
            out = call()
            torch.cuda.synchronize()
            _pad_profiler_window()
        if i == 0:
            first = out
        for k, n in count(prof).items():
            most[k] = max(most.get(k, 0), n)
    return first, most


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
# (T=U+1=41), TIMIT's BiLSTM layer (B=16, T=300, H=320), libri960's
# layers 1-5 at bench.py's B=64 (T'=200, H=1024: 16 stage passes a step in
# f32) and a ragged H=1024, each a different tile of lstm_cuda.bwd_plan.
BWD_SHAPES = [(8, 37, 512), (3, 37, 512), (1, 5, 64), (32, 400, 512),
              (32, 41, 512), (64, 41, 512), (16, 300, 320),
              (64, 200, 1024), (8, 37, 1024)]


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
                                     (32, 200, 100), (8, 100, 199),
                                     (4, 60, 512), (3, 5, 1100),
                                     (3, 2, 7935)])
def test_cuda_lattice_matches_reference(cuda_device, B, T, U):
    """The training shapes (U+1 = 41 fused, 81 two-pass, 101 pruned), U+1
    = 200 and 513 (two and five cells a lane in registers), U+1 = 1101,
    whose lanes keep their nine cells in shared memory, and U+1 = 7936, the
    longest diagonal beta's plan takes (one diagonal a chunk, two
    slots)."""
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


# sha256 (first 16 hex digits) of alpha, beta, g_blank and g_y from the
# kernel before the band walk (PR 17's lattice.cu) on the runner's
# `lattice_problem` inputs (PERF.md, PR 18): the walk keeps their bits.
LATTICE_DIGESTS = {
    (32, 200, 40): {"alpha": "c2c80f5a3abf6b03", "beta": "44f632845500c8f5",
                    "g_blank": "acb3348f06915f8a", "g_y": "5c2f0f519a318a7a"},
    (32, 200, 80): {"alpha": "0be2b711d2ddb398", "beta": "c0204463d2bdc7eb",
                    "g_blank": "b429255563ae80e7", "g_y": "868617e132dbc0eb"},
    (32, 200, 100): {"alpha": "f6bbeb3de921a0db", "beta": "7b4fc3aefdaf3c50",
                     "g_blank": "ec934d6d1f462504",
                     "g_y": "43227e94dbd18cd0"},
    (8, 100, 199): {"alpha": "f141697f94434c52", "beta": "532c347b57866c82",
                    "g_blank": "77d9c146942f7117", "g_y": "1eb917ff404dd80c"},
    (4, 60, 512): {"alpha": "896d8f8981bc39fa", "beta": "ce89c88088d059be",
                   "g_blank": "a3b428800aa9a257", "g_y": "491fc1b7a6bd72ab"},
    (3, 5, 1100): {"alpha": "bce0ae938de64e3a", "beta": "4b8bbd02465cd312",
                   "g_blank": "b7e2ee7b202e7006", "g_y": "563198a4b84f2ff8"}}


@pytest.mark.cuda
@pytest.mark.parametrize("B, T, U", [(32, 200, 40), (32, 200, 80),
                                     (32, 200, 100), (8, 100, 199),
                                     (4, 60, 512), (3, 5, 1100)])
def test_cuda_lattice_keeps_the_parents_bits(cuda_device, B, T, U):
    import hashlib

    from rnn_transducer_tpu_torch.bench_band_bwd_b import lattice_problem
    from rnn_transducer_tpu_torch.ops import rnnt_lattice_cuda as lat

    lpb_m, lpy_m, accept, fl = lattice_problem(B, T, U, cuda_device)
    alpha = lat.alpha_wavefront(lpb_m, lpy_m)
    outs = (alpha, *lat.beta_occupancies(lpb_m, lpy_m, accept, alpha, fl))
    got = {n: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]
           for n, t in zip(("alpha", "beta", "g_blank", "g_y"), outs)}
    assert got == LATTICE_DIGESTS[(B, T, U)]


@pytest.mark.cuda
def test_cuda_lattice_walk_is_one_kernel_a_call(cuda_device):
    """alpha and beta + occupancies are one launch each, by the profiler,
    on the plan of walk_plan."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rnn_transducer_tpu_torch.ops import rnnt_lattice_cuda as lat

    lpb_m, lpy_m, accept, fl = _lattice_args(32, 200, 100, cuda_device)

    def call():
        alpha = lat.alpha_wavefront(lpb_m, lpy_m)
        return lat.beta_occupancies(lpb_m, lpy_m, accept, alpha, fl)

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad_profiler_window()
        call()
        call()
        torch.cuda.synchronize()
        _pad_profiler_window()
    counts = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and "lattice_" in evt.key:
            name = "alpha" if "lattice_alpha_kernel" in evt.key else "beta"
            counts[name] = counts.get(name, 0) + evt.count
    assert counts == {"alpha": 2, "beta": 2}


def _fma(a, b, c):
    """float32 fma(a, b, c), rounded once: the exact product and sum in
    float64 (the product is exact there), with the one case where rounding
    the float64 sum to float32 again differs from rounding the exact sum
    (a float64 sum exactly halfway between two floats) settled by the sign
    of the float64 sum's error."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bp = s - p
    err = (p - (s - bp)) + (c64 - bp)
    r = s.float()
    other = torch.nextafter(r, torch.where(s > r.double(),
                                           torch.full_like(r, float("inf")),
                                           torch.full_like(r, -float("inf"))))
    halfway = (r.double() + other.double()) / 2 == s
    up = torch.where(other > r, other, r)
    down = torch.where(other > r, r, other)
    fix = torch.where(err > 0, up, down)
    return torch.where(halfway & (err != 0), fix, r)


def _ln_dx_mirror(x, g, b, mu, rstd, dy):
    """dx of K8-bwd (act none), built with the kernel's per-row arithmetic
    as the compiler lays it out (its SASS; D = 128 NV, NV <= 4): lane l of
    a row's warp takes the columns 4 (l + 32 k) + i, in k, i order sums
    a = dy g (one add) and a xhat (one fma), the lanes' sums meet in a xor
    butterfly, the means are true divisions by D, and dx = rstd fma(-xhat,
    m2, a - m1). Under silu the compiler folds `1 + expf(-y)` into the
    last fma of expf's own expansion, which no PyTorch call repeats; the
    silu dx is held to the parent's digest instead."""
    N, D = x.shape
    nv = D // 128

    def lanes(t):  # (N, D) -> (N, 32, nv, 4), [row, lane, k, i]
        return t.reshape(N, nv, 32, 4).transpose(1, 2)

    m = mu[:, None, None, None]
    r = rstd[:, None, None, None]
    xh = (lanes(x) - m) * r
    a = lanes(dy) * lanes(g.expand(N, D))
    s1 = torch.zeros(N, 32, dtype=torch.float32, device=x.device)
    s2 = torch.zeros_like(s1)
    for k in range(nv):
        for i in range(4):
            s1 = s1 + a[:, :, k, i]
            s2 = _fma(a[:, :, k, i], xh[:, :, k, i], s2)
    lane = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        s1 = s1 + s1[:, lane ^ o]
        s2 = s2 + s2[:, lane ^ o]
    dd = torch.full_like(s1[:, :1], float(D))
    m1 = (s1[:, :1] / dd)[:, :, None, None]
    m2 = (s2[:, :1] / dd)[:, :, None, None]
    dx = r * _fma(-xh, m2.expand_as(xh), a - m1)
    return dx.transpose(1, 2).reshape(N, D)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["none", "silu"])
def test_cuda_fused_ln_bwd_keeps_dx_and_repeats_its_sums(cuda_device, act):
    """K8-bwd: dx (act none) bit for bit the per-row arithmetic of the
    design before the one-launch backward (`_ln_dx_mirror`), dg and db
    within LN_DGB_RTOL of the plain version, three calls at each of two Ns
    (interleaved, so the ticket counters are reused) bit for bit, and one
    kernel a call by the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rnn_transducer_tpu_torch.ops import fused_ln as fl

    D = 512
    args, runs = {}, {}
    for N in (6400, 1600):
        g = torch.Generator().manual_seed(N + 1)
        x = (3 * torch.randn(N, D, generator=g) + 1).to(cuda_device)
        w = (1 + 0.5 * torch.randn(D, generator=g)).to(cuda_device)
        b = (0.5 * torch.randn(D, generator=g)).to(cuda_device)
        dy = torch.randn(N, D, generator=g).to(cuda_device)
        _, mu, rstd = fl.fln_fwd(x, w, b, act)
        args[N] = (x, w, b, mu, rstd, dy, act)
    for _ in range(3):
        for N in (6400, 1600):
            runs.setdefault(N, []).append(fl.fln_bwd(*args[N]))
    torch.cuda.synchronize()
    for N, outs in runs.items():
        x, w, b, mu, rstd, dy, _ = args[N]
        for again in outs[1:]:
            assert all(torch.equal(a, e) for a, e in zip(again, outs[0]))
        dx, dg, db = outs[0]
        if act == "none":
            assert torch.equal(dx, _ln_dx_mirror(x, w, b, mu, rstd, dy))
        want = fl.fln_bwd_reference(*args[N])
        assert _rel_err(dx, want[0]) <= LN_DX_RTOL
        assert _rel_err(dg, want[1]) <= LN_DGB_RTOL
        assert _rel_err(db, want[2]) <= LN_DGB_RTOL
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad_profiler_window()
        fl.fln_bwd(*args[6400])
        torch.cuda.synchronize()
        _pad_profiler_window()
    names = [evt.key for evt in prof.key_averages()
             if evt.device_type == DeviceType.CUDA and "ln_" in evt.key]
    assert len(names) == 1 and "ln_bwd_kernel" in names[0]
    assert fl.device_bwd_occupancy(D, cuda_device) >= 2


# sha256 (first 16 hex digits) of dx from the backward before the one
# launch (PR 17's fused_ln.cu) on the runner's `ln_problem` inputs
# (PERF.md, PR 18), by (N, act)
LN_DX_DIGESTS = {(1600, "none"): "6d2c567448e40555",
                 (1600, "silu"): "5adc6d142dca4177",
                 (6400, "none"): "33195860d4e69e9f",
                 (6400, "silu"): "f8cfd085ea40996f"}


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["none", "silu"])
def test_cuda_fused_ln_bwd_keeps_the_parents_dx(cuda_device, act):
    import hashlib

    from rnn_transducer_tpu_torch.bench_band_bwd_b import ln_problem
    from rnn_transducer_tpu_torch.ops import fused_ln as fl

    for N, (x, g, b, dy) in ln_problem(cuda_device).items():
        _, mu, rstd = fl.fln_fwd(x, g, b, act)
        dx = fl.fln_bwd(x, g, b, mu, rstd, dy, act)[0]
        digest = hashlib.sha256(dx.cpu().numpy().tobytes()).hexdigest()[:16]
        assert digest == LN_DX_DIGESTS[(N, act)]


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
# B=3 with H % 16 != 0 (one 3-row tile, Wq loaded a byte at a time);
# B=256, which one wave does not hold: two groups of two 64-row tiles; and
# B=64 at libri960's H=1024 (232,080 shared bytes a block).
INT8_SHAPES = [(8, 37, 512, 8, 1), (16, 37, 512, 16, 1),
               (32, 37, 512, 32, 1), (24, 37, 512, 8, 1),
               (72, 21, 512, 8, 1), (64, 37, 512, 64, 1),
               (8, 37, 1024, 8, 1), (8, 1, 512, 8, 1), (3, 9, 100, 3, 1),
               (256, 5, 512, 64, 2), (64, 37, 1024, 64, 1)]


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
    """f, lens (ragged; row 1, where there is one, of zero length) and the
    f32 weights of a random one-layer predictor and joint, blank near the
    top."""
    g = torch.Generator().manual_seed(seed)
    u = lambda *s, k: (torch.rand(*s, generator=g) * 2 - 1) * k  # noqa: E731
    f = 0.5 * torch.randn(B, T, J, generator=g)
    lens = torch.randint(T // 2, T + 1, (B,), generator=g, dtype=torch.int32)
    if B > 1:
        lens[1] = 0
    bo = u(V, k=J ** -0.5)
    bo[0] += 1.0  # some rows walk frames on blank, some hit the cap
    weights = (torch.randn(V, E, generator=g), u(E, 4 * H, k=H ** -0.5),
               u(H, 4 * H, k=H ** -0.5), u(4 * H, k=H ** -0.5),
               u(H, J, k=H ** -0.5), u(J, k=H ** -0.5), u(J, V, k=J ** -0.5),
               bo)
    return (f.to(device), lens.to(device),
            tuple(w.contiguous().to(device) for w in weights))


# K9 at libri100 width (B = 3), at one utterance, at more clusters than
# one wave holds (B = 17: 16 blocks a cluster, 7 clusters a wave on the
# H100 by cudaOccupancyMaxActiveClusters), at a ragged vocab (V = 1000:
# 63 columns a block, 55 in the last), at a narrow shape whose last 5
# blocks own no vocab column (V = 11), and
# with W_out's slice too large to stay resident (J = 1024, V = 2048: it
# streams through the ring every step), with gate chunks of one group of
# 4 rows (H = 4096), and with no room for f rows in shared memory (J =
# 16384: f read from global memory, no z a frame ahead). Row 1 has no
# frames.
K9_CASES = [(3, 60, 512, 512, 512, 1024), (1, 40, 512, 512, 512, 1024),
            (17, 30, 512, 512, 512, 1024), (4, 40, 512, 512, 512, 1000),
            (5, 23, 128, 256, 128, 11), (3, 30, 512, 512, 1024, 2048),
            (3, 20, 128, 4096, 128, 64), (3, 20, 128, 128, 16384, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("max_symbols", [20, 3])
@pytest.mark.parametrize("B, T, E, H, J, V", K9_CASES)
def test_cuda_greedy_fused_matches_reference(cuda_device, B, T, E, H, J, V,
                                             max_symbols):
    """K9 in f32: tokens and step counts identical to the plain version's,
    the zero-length row empty; at max_symbols 3 some row stops at the cap.
    In bf16 two calls give the same bits."""
    from rnn_transducer_tpu_torch.decode import greedy_fused as gf
    torch.backends.cuda.matmul.allow_tf32 = False
    f, lens, weights = _greedy_inputs(B, T, E, H, J, V, cuda_device)
    before = gf.LAUNCHES
    toks, steps = gf.greedy_fused_tokens(f, lens, weights, max_symbols, 0,
                                         torch.float32)
    torch.cuda.synchronize()
    assert gf.LAUNCHES == before + 1
    want_t, want_s = gf.greedy_fused_tokens_reference(f, lens, weights,
                                                      max_symbols, 0,
                                                      torch.float32)
    assert torch.equal(toks, want_t)
    assert torch.equal(steps, want_s)
    if B > 1:
        assert steps[1] == 0 and (toks[1] == 0).all()
    if max_symbols == 3:
        assert bool((toks != 0).all(1).any()), "no row reached the cap"
    got = gf.greedy_fused_tokens(f, lens, weights, max_symbols, 0,
                                 torch.bfloat16)
    again = gf.greedy_fused_tokens(f, lens, weights, max_symbols, 0,
                                   torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("E, H, J, V", [(512, 512, 512, 1024),
                                        (128, 256, 128, 11),
                                        (512, 512, 1024, 2048)])
def test_cuda_greedy_pack_matches_its_plain_version(cuda_device, E, H, J, V):
    """greedy_pack_kernel writes the block-major scratch of pack_reference,
    bit for bit."""
    from rnn_transducer_tpu_torch.decode import greedy_fused as gf
    _, _, weights = _greedy_inputs(2, 4, E, H, J, V, cuda_device)
    plan = gf.cluster_plan(E, H, J, V)
    got = gf.pack_weights(weights, plan)
    torch.cuda.synchronize()
    want = gf.pack_reference(tuple(w.cpu() for w in weights), plan)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_greedy_fused_is_a_pack_and_one_cluster_launch(cuda_device):
    """A call is one greedy_pack_kernel and one greedy_cluster_kernel, by
    the profiler, and one count in LAUNCHES; the card holds at least one
    cluster of the libri100 plan."""
    from torch.profiler import ProfilerActivity, profile

    from rnn_transducer_tpu_torch.decode import greedy_fused as gf
    f, lens, weights = _greedy_inputs(8, 40, 512, 512, 512, 1024,
                                      cuda_device)
    args = (f, lens, weights, 20, 0, torch.bfloat16)
    assert gf.device_clusters(gf.cluster_plan(512, 512, 512, 1024),
                              cuda_device) >= 1
    gf.greedy_fused_tokens(*args)  # warm: build, plan
    torch.cuda.synchronize()
    before = gf.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad_profiler_window()
        gf.greedy_fused_tokens(*args)
        torch.cuda.synchronize()
        _pad_profiler_window()
    assert gf.LAUNCHES == before + 1
    counts = {}
    for e in prof.key_averages():
        if "greedy" in e.key:
            counts[e.key] = counts.get(e.key, 0) + e.count
    assert sorted(counts.values()) == [1, 1], counts
    assert any("greedy_pack_kernel" in k for k in counts), counts
    assert any("greedy_cluster_kernel" in k for k in counts), counts


@pytest.mark.cuda
def test_cuda_greedy_fused_refuses_a_plan_it_does_not_take(cuda_device,
                                                           monkeypatch):
    """A plan whose shared bytes disagree with the kernel's layout is
    refused by the launch (invalid argument), and a shape no block holds
    by the plan; neither counts a launch."""
    import dataclasses

    from rnn_transducer_tpu_torch.decode import greedy_fused as gf
    f, lens, weights = _greedy_inputs(2, 8, 128, 256, 128, 11, cuda_device)
    plan = gf.cluster_plan(128, 256, 128, 11)
    before = gf.LAUNCHES
    monkeypatch.setattr(gf, "cluster_plan", lambda *a: dataclasses.replace(
        plan, smem_bytes=plan.smem_bytes + 16))
    with pytest.raises(RuntimeError, match="greedy_cluster launch failed"):
        gf.greedy_fused_tokens(f, lens, weights, 8, 0, torch.float32)
    monkeypatch.undo()
    J = 32768
    big = [torch.zeros(2, 4, J, device=cuda_device), lens,
           tuple(torch.zeros(s, device=cuda_device) for s in (
               (11, 128), (128, 512), (128, 512), (512,), (128, J), (J,),
               (J, 11), (11,)))]
    with pytest.raises(ValueError, match="no block holds"):
        gf.greedy_fused_tokens(*big, 8, 0, torch.float32)
    assert gf.LAUNCHES == before


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
    the ring kernel once each, any other call the CUDA-core kernel once
    (the most of three profiled windows)."""
    from rnn_transducer_tpu_torch.ops import rnnt_band_fused as bf

    (f, g_w, lab_w, w, b), _ = _band_args(B, T, S, J, V, dtype, cuda_device)
    before = bf.LAUNCHES_FWD
    got, ran = _most_of_three_windows(
        lambda: bf.band_lp_fwd(f, g_w, lab_w, w, b), _band_fwd_kernels)
    again = bf.band_lp_fwd(f, g_w, lab_w, w, b)
    want = bf.band_lp_fwd_reference(f, g_w, lab_w, w, b)
    torch.cuda.synchronize()
    for name, a, a2, e in zip(("lp_blank", "lp_y", "base"), got, again, want):
        assert bool(torch.isfinite(a).all()), name
        assert float((a - e).abs().max()) <= LP_ATOL[dtype], name
        assert torch.equal(a, a2), f"{name} differs between two runs"
    ring = bf.tensor_core_form(dtype, J, V)
    assert ran == {"band_fwd_wt": int(ring), "band_fwd_ring": int(ring),
                   "band_fwd": int(not ring)}
    assert bf.LAUNCHES_FWD == before + 4


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


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["lstm_fwd", "lstm_fwd_int8"])
def test_cuda_lstm_launches_from_two_threads_keep_their_bits(cuda_device,
                                                            kernel):
    """Two threads launch K4-fwd (or K7) on one card at once, as the
    offline and streaming engines do, each on its own inputs (a streaming
    chunk's nonzero h0 / c0): every call gives the bits of the same call
    made alone. Each launch holds its own exchange buffer, whose grid
    barrier counter another thread's launch must never share."""
    import threading

    from rnn_transducer_tpu_torch.ops import lstm_int8_cuda as q8

    def call_args(seed):
        if kernel == "lstm_fwd_int8":
            return _int8_args(8 + 8 * seed, 32, 512, torch.bfloat16,
                              cuda_device)
        g = torch.Generator().manual_seed(seed)
        return [a.to(cuda_device) for a in (
            torch.randn(8, 32, 2048, generator=g),
            (torch.randn(512, 2048, generator=g) / 512 ** 0.5).to(
                torch.bfloat16),
            0.5 * torch.randn(8, 512, generator=g),
            torch.randn(8, 512, generator=g))]

    run = (q8.lstm_recurrence_int8 if kernel == "lstm_fwd_int8"
           else lstm_cuda.lstm_recurrence)
    args = [call_args(seed) for seed in (0, 1)]
    alone = [run(*a)[0] for a in args]
    torch.cuda.synchronize()
    got = [[], []]

    def worker(i):
        for _ in range(50):
            got[i].append(run(*args[i])[0])

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    torch.cuda.synchronize()
    for i in (0, 1):
        assert len(got[i]) == 50
        assert all(torch.equal(h, alone[i]) for h in got[i])


# ------------------------- audio in: the frontend --------------------------

def _pcm(lengths, seed=0):
    """0.1 * N(0, 1) PCM of the given frame counts (T*160 + 240 samples
    featurize to T frames)."""
    g = torch.Generator().manual_seed(seed)
    return [0.1 * torch.randn(T * 160 + 240, generator=g) for T in lengths]


@pytest.mark.cuda
@pytest.mark.parametrize("cmvn", [False, True])
def test_cuda_log_mel_matches_the_oracle(cuda_device, cmvn):
    """`log_mel` on the card against its float64 plain version (cmvn=False)
    within 1e-3, the JAX package's bound, frame lens equal; with cmvn on the
    card against the CPU within the same bound (the per-utterance
    normalization divides the two FFT libraries' ~1e-5 relative difference
    by a bin's spread: 2.9e-4 seen on the H100); a batch with rows shorter
    than a window; TF32 on for matmuls is refused, not used."""
    import numpy as np

    from rnn_transducer_tpu_torch.ops.logmel import log_mel, log_mel_oracle

    audio = _pcm((800, 151, 37))
    N = max(a.shape[0] for a in audio)
    x = torch.zeros(len(audio) + 1, N)
    for i, a in enumerate(audio):
        x[i, :a.shape[0]] = a
    lens = torch.tensor([a.shape[0] for a in audio] + [300],
                        dtype=torch.int32)  # the last row: no whole window
    got, n = log_mel(x.to(cuda_device), lens.to(cuda_device), cmvn=cmvn)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    if cmvn:
        want, want_n = log_mel(x, lens, cmvn=True)
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-3)
        assert n.cpu().tolist() == want_n.tolist()
    else:
        want, want_n = log_mel_oracle(x.numpy(), lens.numpy())
        assert n.cpu().tolist() == want_n.tolist() == [800, 151, 37, 0]
        assert float(np.abs(got.cpu().numpy() - want).max()) <= 1e-3
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="tf32"):
            log_mel(x.to(cuda_device), lens.to(cuda_device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _audio_model(device):
    """A small LSTM transducer at f32 on the card (K4-fwd at H=128), its
    joint's blank bias lowered so that utterances emit tokens."""
    import numpy as np

    from rnn_transducer_tpu_torch.models import transducer as m
    from rnn_transducer_tpu_torch.models.config import TransducerConfig

    cfg = TransducerConfig(enc_layers=2, enc_hidden=128, pred_layers=1,
                           pred_hidden=64, embed_dim=32, joint_dim=64,
                           vocab_size=16, input_dim=80, time_reduction=2,
                           compute_dtype="float32")
    params = m.init_params(cfg, np.random.default_rng(3), device)
    params["joint"]["pred_proj"]["w"] *= 8.0
    return cfg, params


def _post(url, body):
    import json
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


@pytest.mark.cuda
def test_cuda_audio_body_equals_feats_body(cuda_device):
    """An {"audio"} /recognize to a card engine answers the tokens of the
    same audio's card log_mel sent as {"feats"}: the same function on the
    same device and input, so the same bits; the engine's K4-fwd ran."""
    import threading

    from rnn_transducer_tpu_torch.ops.logmel import log_mel
    from rnn_transducer_tpu_torch.serve import BatchingEngine, http_server

    cfg, params = _audio_model(cuda_device)
    eng = BatchingEngine(params, cfg, max_symbols=20, frame_buckets=(200,),
                         max_batch=4, device=cuda_device)
    srv = http_server("127.0.0.1", 0, eng)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/recognize"
    try:
        before = lstm_cuda.LAUNCHES
        for a in _pcm((200, 63, 120), seed=1):
            f, n = log_mel(a[None].to(cuda_device),
                           torch.tensor([a.shape[0]], device=cuda_device))
            feats = f[0, :int(n[0])].cpu()
            got = _post(url, {"audio": a.tolist()})
            want = _post(url, {"feats": feats.tolist()})
            assert got == want
        assert lstm_cuda.LAUNCHES - before == 2 * 6
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
        eng.close()


@pytest.mark.cuda
def test_cuda_pcm_sessions_beside_recognize_from_two_engine_threads(
        cuda_device):
    """PCM sessions (uneven splits) and /recognize audio requests at once:
    both engines' worker threads launch on one card. Each session's final
    tokens are the offline engine's for the features the session fed."""
    import collections
    import concurrent.futures
    import json
    import threading
    import urllib.request

    import numpy as np

    from rnn_transducer_tpu_torch.serve import (BatchingEngine,
                                                StreamingEngine, http_server)

    cfg, params = _audio_model(cuda_device)
    offline = BatchingEngine(params, cfg, max_symbols=20,
                             frame_buckets=(200,), max_batch=4,
                             device=cuda_device)
    streaming = StreamingEngine(params, cfg, slots=4, chunk_frames=32,
                                max_symbols=20, device=cuda_device)
    fed = collections.defaultdict(list)
    feed_full = streaming.feed_full

    def recording(sid, chunk, last=False):
        fed[sid].append(np.array(chunk, np.float32))
        return feed_full(sid, chunk, last)

    streaming.feed_full = recording
    srv = http_server("127.0.0.1", 0, offline, streaming)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def session(audio, cuts):
        sid = _post(f"{url}/session", {})["sid"]
        parts = np.split(audio.numpy(), cuts)
        for i, p in enumerate(parts):
            _post(f"{url}/session/{sid}", {"audio": p.tolist(),
                                           "last": i == len(parts) - 1})
        req = urllib.request.Request(f"{url}/session/{sid}",
                                     method="DELETE")
        with urllib.request.urlopen(req, timeout=120) as r:
            return sid, json.loads(r.read())["tokens"]

    try:
        audio = _pcm((190, 77, 141, 200), seed=2)
        cuts = [[237, 3001, 3050, 9000], [399, 401, 7000], [5, 12345],
                [160 * 31 + 1, 160 * 64 + 3]]
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            sess = [ex.submit(session, a, c) for a, c in zip(audio, cuts)]
            recs = [ex.submit(_post, f"{url}/recognize",
                              {"audio": a.tolist()}) for a in audio]
            results = [f.result() for f in sess]
            assert all("tokens" in f.result() for f in recs)
        emitted = 0
        for sid, tokens in results:
            want = offline.submit_full(np.concatenate(fed[sid]))
            assert tokens == want["tokens"]
            emitted += len(tokens)
        assert emitted > 0
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
        offline.close()
        streaming.close()


# TIMIT's BiLSTM at full width, shortened: 3 x 320 both ways, T=60 with
# ragged lengths and a row of one frame.
BILSTM_CFG = dict(enc_layers=3, enc_hidden=320, bidirectional=True,
                  pred_layers=1, pred_hidden=320, embed_dim=320,
                  joint_dim=320, vocab_size=63)


@pytest.mark.cuda
@pytest.mark.parametrize("cd, atol", [("float32", 1e-4), ("bfloat16", 6e-2)])
def test_cuda_bilstm_encode_matches_the_plain_path(cuda_device, cd, atol):
    """A bidirectional encode through K4-fwd (one launch a layer and
    direction) against the same encode on the plain recurrences, on the
    card; bf16 within 2e-2 a layer."""
    from unittest import mock

    import numpy as np

    from rnn_transducer_tpu_torch.models import transducer as tm
    from rnn_transducer_tpu_torch.models.config import TransducerConfig

    cfg = TransducerConfig(**BILSTM_CFG, compute_dtype=cd)
    rng = np.random.default_rng(0)
    params = tm.init_params(cfg, rng, cuda_device)
    feats = torch.from_numpy(rng.normal(size=(5, 60, 80)).astype(
        np.float32)).to(cuda_device)
    lens = torch.tensor([60, 1, 33, 59, 17], dtype=torch.int32,
                        device=cuda_device)
    before = lstm_cuda.LAUNCHES
    with torch.inference_mode():
        got, got_lens = tm.encode(params, cfg, feats, lens)
        torch.cuda.synchronize()
        assert lstm_cuda.LAUNCHES == before + 6
        with mock.patch.object(lstm_cuda, "lstm_recurrence",
                               lstm_cuda.lstm_recurrence_reference):
            want, want_lens = tm.encode(params, cfg, feats, lens)
    assert torch.equal(got_lens, want_lens)
    assert got.shape == (5, 60, 640)
    assert float((got - want).abs().max()) <= atol
    assert float(got[1, 1:].abs().max()) == 0.0  # masked past the length


def _gloo_rank(mesh, seed, steps):
    """A rank of a small bf16 model's data-parallel steps: each step's
    params digest of every rank, and rank 0's grad norms."""
    import dataclasses
    import hashlib

    import numpy as np

    from rnn_transducer_tpu_torch.data.synthetic import random_batch
    from rnn_transducer_tpu_torch.models.config import (TrainConfig,
                                                        TransducerConfig)
    from rnn_transducer_tpu_torch.parallel import mesh as meshlib
    from rnn_transducer_tpu_torch.train import loop as tloop

    cfg = TransducerConfig(**BILSTM_CFG)
    tcfg = TrainConfig(batch_size=8, warmup_steps=1, total_steps=100)
    state = tloop.init_train_state(np.random.default_rng(seed + mesh.rank),
                                   cfg, tcfg, mesh.device)
    state = dataclasses.replace(
        state, params=meshlib.replicate(mesh, state.params),
        opt_state=meshlib.replicate(mesh, state.opt_state))
    step = tloop.make_train_step(cfg, tcfg, mesh=mesh)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        batch = meshlib.shard_batch(mesh, random_batch(rng, 8, 50, 10, 80,
                                                       63))
        state, info = step(state, *batch)
        h = hashlib.sha256()
        for leaf in torch.utils._pytree.tree_leaves(state.params):
            h.update(leaf.reshape(-1).view(torch.uint8).cpu().numpy()
                     .tobytes())
        out.append((meshlib.all_gather_objects(mesh, h.hexdigest()),
                    float(info["grad_norm"]),
                    int(info["skipped_nonfinite"])))
    return out


@pytest.mark.cuda
def test_cuda_two_gloo_ranks_on_one_card_stay_bit_equal(cuda_device,
                                                        tmp_path):
    """Two gloo ranks share the card (each its own process: the K4
    cooperative launches time-slice): after every bf16 step of a BiLSTM
    model both ranks hold the same params, bit for bit, though each began
    from params of its own seed (replicate broadcasts rank 0's)."""
    from rnn_transducer_tpu_torch.parallel import mesh as meshlib

    out = meshlib.spawn(_gloo_rank, 2, [str(cuda_device)] * 2, args=(0, 3),
                        init_method=f"file://{tmp_path}/rendezvous",
                        timeout_s=300)
    for digests, gnorm, skipped in out:
        assert len(digests) == 2 and digests[0] == digests[1]
        assert skipped == 0 and gnorm > 0
    assert len({d[0] for d, _, _ in out}) == 3  # the params moved


@pytest.mark.cuda
@pytest.mark.parametrize("U", [8_000, 11_136, 22_400])
def test_cuda_lattice_walks_long_diagonals_in_column_tiles(cuda_device, U):
    """U+1 = 8,001 (beta past its plan's 7,936: two column tiles), 11,137
    (alpha past its 11,136 too) and 22,401 (three tiles both ways: an
    edge tile reads the boundary column another edge tile wrote): alpha
    and beta + occupancies on the card, within the plain versions'
    tolerances, one kernel a tile and one lattice_occ_kernel by the
    profiler (the most of three windows). Last in this file: the plain
    versions' diagonal loops leave the card nearly idle for up to ~20 s,
    and a torch.profiler window after such a stretch misplaces its
    kernels, so a later test that counts kernels by name would fail."""
    from torch.autograd import DeviceType

    from rnn_transducer_tpu_torch.ops import rnnt_lattice_cuda as lat

    lpb_m, lpy_m, accept, fl = _lattice_args(1, 40, U, cuda_device)
    before = (lat.LAUNCHES_ALPHA, lat.LAUNCHES_BETA)

    def walk():
        alpha = lat.alpha_wavefront(lpb_m, lpy_m)
        return (alpha, *lat.beta_occupancies(lpb_m, lpy_m, accept, alpha,
                                             fl))

    def count(prof):
        counts = {}
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA and "lattice_" in evt.key:
                name = ("alpha" if "lattice_alpha_kernel" in evt.key else
                        "occ" if "lattice_occ_kernel" in evt.key else "beta")
                counts[name] = counts.get(name, 0) + evt.count
        return counts

    (alpha, beta, gb, gy), counts = _most_of_three_windows(walk, count)
    assert (lat.LAUNCHES_ALPHA, lat.LAUNCHES_BETA) == (before[0] + 3,
                                                      before[1] + 3)
    want_a = lat.alpha_wavefront_reference(lpb_m, lpy_m)
    want_b, want_gb, want_gy = lat.beta_occupancies_reference(
        lpb_m, lpy_m, accept, want_a, fl)
    _assert_lattice_close(alpha, want_a)
    _assert_lattice_close(beta, want_b)
    for got, want in ((gb, want_gb), (gy, want_gy)):
        assert float((got - want).abs().max()) <= 1e-5
    # the lattice is reachable end to end: log_z finite
    assert float(beta[0, 0, 0]) > -1e29
    assert torch.equal(lat.beta_wavefront(lpb_m, lpy_m, accept), beta)
    assert counts == {"alpha": len(lat.tile_plan(U + 1, False)),
                      "beta": len(lat.tile_plan(U + 1, True)), "occ": 1}


# CTC (plain PyTorch on the caller's device: it has no kernel of its own),
# the stateless predictor and encoder remat on the card.

def _ctc_inputs(device, B=6, T=50, V=40, U=12, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    logits = torch.from_numpy((2 * rng.normal(size=(B, T, V))).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(1, V, size=(B, U)).astype(
        np.int32))
    fl = torch.tensor([50, 41, 3, 0, 33, 12], dtype=torch.int32)[:B]
    ll = torch.tensor([12, 9, 6, 0, 12, 2], dtype=torch.int32)[:B]
    return logits, labels, fl, ll


@pytest.mark.cuda
def test_cuda_ctc_loss_and_decoders_match_the_cpu(cuda_device):
    """ctc_loss_from_logits (loss and dlogits), ctc_greedy_decode and
    ctc_prefix_beam_search on CUDA tensors against the same calls on CPU
    tensors (a dead lattice in row 2: 6 labels in 3 frames; a zero-frame
    row 3)."""
    from rnn_transducer_tpu_torch.decode import ctc as tctc
    from rnn_transducer_tpu_torch.ops import ctc_loss as tloss

    cpu = _ctc_inputs("cpu")
    outs = []
    for dev in ("cpu", cuda_device):
        logits, labels, fl, ll = (a.to(dev) for a in cpu)
        x = logits.clone().requires_grad_(True)
        loss = tloss.ctc_loss_from_logits(x, labels, fl, ll)
        loss.sum().backward()
        greedy = tctc.ctc_greedy_decode(logits, fl, max_symbols=20)
        beam = tctc.ctc_prefix_beam_search(torch.log_softmax(logits, -1), fl,
                                           beam=4, cand=8, max_symbols=20)
        outs.append([t.detach().cpu() for t in (loss, x.grad, *greedy,
                                                *beam)])
    (loss, grad, *rest), (loss_c, grad_c, *rest_c) = outs
    assert float(loss[2]) > 1e29 and float(loss_c[2]) > 1e29
    torch.testing.assert_close(loss_c, loss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grad_c, grad, rtol=1e-5, atol=1e-5)
    g_tok, g_len, g_conf, g_fr, b_tok, b_len, b_sc = rest
    c_tok, c_len, c_conf, c_fr, cb_tok, cb_len, cb_sc = rest_c
    for a, b in ((g_tok, c_tok), (g_len, c_len), (g_fr, c_fr),
                 (b_tok, cb_tok), (b_len, cb_len)):
        assert torch.equal(a, b)
    torch.testing.assert_close(c_conf, g_conf, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cb_sc, b_sc, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_ctc_refuses_tf32(cuda_device, monkeypatch):
    """The occupancy's S -> V product is an f32 product, never TF32."""
    from rnn_transducer_tpu_torch.ops import ctc_loss as tloss

    logits, labels, fl, ll = (a.to(cuda_device)
                              for a in _ctc_inputs(cuda_device))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        tloss.ctc_loss_from_logits(logits, labels, fl, ll)


# libri100's widths at a short shape: 4x512 LSTM (2x stacking), a
# stateless predictor of context 2, joint 512, V=1024, with a CTC head.
STATELESS_CFG = dict(pred_type="stateless", pred_context=2, ctc_head=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["stateless", "ctc", "multitask"])
def test_cuda_stateless_and_ctc_steps_launch_their_kernels(cuda_device,
                                                           kind):
    """One bf16 step at libri100 width: the stateless fused step, the CTC
    pretraining step and the multitask step (ctc_weight 0.3) launch 4
    K4-fwd with activations and 4 K4-bwd (the encoder's layers; the
    stateless predictor has no recurrence), and K1 / K2 / K3 once each
    where an RNN-T loss runs, none in the CTC step."""
    import dataclasses

    import numpy as np

    from rnn_transducer_tpu_torch.data.synthetic import random_batch
    from rnn_transducer_tpu_torch.models.config import (TrainConfig,
                                                        config_libri100)
    from rnn_transducer_tpu_torch.ops import rnnt_joint_fused as jf
    from rnn_transducer_tpu_torch.ops import rnnt_lattice_cuda as lat
    from rnn_transducer_tpu_torch.train import loop as tloop

    cfg = dataclasses.replace(config_libri100(), **STATELESS_CFG)
    tcfg = TrainConfig(batch_size=4, warmup_steps=1, total_steps=10,
                       ctc_weight=0.3 if kind == "multitask" else 0.0)
    state = tloop.init_train_state(0, cfg, tcfg, cuda_device)
    step = tloop.make_train_step(cfg, tcfg, device=cuda_device,
                                 loss_kind="ctc" if kind == "ctc" else "rnnt")
    batch = tuple(torch.from_numpy(a).to(cuda_device) for a in random_batch(
        np.random.default_rng(0), 4, 120, 10, 80, 1024))
    counts = (lambda: (lstm_cuda.LAUNCHES_WITH_ACTS, lstm_cuda.LAUNCHES_BWD,
                       jf.LAUNCHES_FWD, jf.LAUNCHES_BWD,
                       lat.LAUNCHES_ALPHA))
    before = counts()
    state, info = step(state, *batch)
    torch.cuda.synchronize()
    got = tuple(a - b for a, b in zip(counts(), before))
    rnnt = 0 if kind == "ctc" else 1
    assert got == (4, 4, rnnt, rnnt, rnnt)
    assert int(info["skipped_nonfinite"]) == 0
    assert np.isfinite(float(info["loss"]))


@pytest.mark.cuda
@pytest.mark.parametrize("enc", ["lstm", "conformer"])
def test_cuda_remat_recomputes_on_the_kernels(cuda_device, enc):
    """A bf16 step with remat_encoder launches each encoder layer's
    forward kernel twice (K4-fwd with activations: 4 encoder + 1
    predictor -> 9; K8-fwd: 48 -> 96) and each backward kernel once, and
    gives the loss of the step without remat, bit for bit."""
    import dataclasses

    import numpy as np

    from rnn_transducer_tpu_torch.data.synthetic import random_batch
    from rnn_transducer_tpu_torch.models.config import (
        TrainConfig, config_libri100, config_libri100_conformer)
    from rnn_transducer_tpu_torch.ops import fused_ln as fl
    from rnn_transducer_tpu_torch.train import loop as tloop

    base = config_libri100() if enc == "lstm" else config_libri100_conformer()
    batch = tuple(torch.from_numpy(a).to(cuda_device) for a in random_batch(
        np.random.default_rng(0), 4, 160, 10, 80, 1024))
    tcfg = TrainConfig(batch_size=4, warmup_steps=1, total_steps=10)
    seen = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat_encoder=remat)
        state = tloop.init_train_state(0, cfg, tcfg, cuda_device)
        step = tloop.make_train_step(cfg, tcfg, device=cuda_device)
        before = (lstm_cuda.LAUNCHES_WITH_ACTS, lstm_cuda.LAUNCHES_BWD,
                  fl.LAUNCHES_FWD, fl.LAUNCHES_BWD)
        _, info = step(state, *batch)
        torch.cuda.synchronize()
        after = (lstm_cuda.LAUNCHES_WITH_ACTS, lstm_cuda.LAUNCHES_BWD,
                 fl.LAUNCHES_FWD, fl.LAUNCHES_BWD)
        seen[remat] = (tuple(a - b for a, b in zip(after, before)),
                       float(info["loss"]))
    if enc == "lstm":
        assert seen[False][0] == (5, 5, 0, 0)
        assert seen[True][0] == (9, 5, 0, 0)
    else:
        assert seen[False][0] == (1, 1, 48, 48)
        assert seen[True][0] == (1, 1, 96, 48)
    assert seen[True][1] == seen[False][1]


# The duration families (multi-blank and TDT): their lattices are plain
# PyTorch on the caller's device, so the card must give the CPU's losses
# and gradients; their greedy decode runs the encoder through K4-fwd.
DURATION_FAMILIES = {"multiblank": dict(big_blank_durations=(2, 4, 8)),
                     "tdt": dict(tdt_durations=(0, 1, 2, 4)),
                     "tdt_no_zero": dict(tdt_durations=(1, 2))}


def _duration_inputs(family, device):
    """Logits (and TDT duration logits) of (4, 40, 9, C) f32 with ragged
    lengths, a zero-frame row and a row of 8 labels in 5 frames (which a
    TDT set without 0 cannot align)."""
    g = torch.Generator().manual_seed(0)
    B, T, U, V = 4, 40, 8, 32
    durs = DURATION_FAMILIES[family]
    C = V + len(durs.get("big_blank_durations", ()))
    logits = 2 * torch.randn(B, T, U + 1, C, generator=g)
    dur = torch.randn(B, T, U + 1, len(durs.get("tdt_durations", ())),
                      generator=g)
    labels = torch.randint(1, V, (B, U), generator=g, dtype=torch.int32)
    fl = torch.tensor([40, 31, 0, 5], dtype=torch.int32)
    ll = torch.tensor([8, 5, 2, 8], dtype=torch.int32)
    return [a.to(device) for a in (logits, dur, labels, fl, ll)]


def _duration_loss(family, logits, dur, labels, fl, ll):
    from rnn_transducer_tpu_torch.ops import rnnt_multiblank, rnnt_tdt

    durs = DURATION_FAMILIES[family]
    if "tdt_durations" in durs:
        return rnnt_tdt.rnnt_loss_tdt(logits, dur, labels, fl, ll,
                                      durs["tdt_durations"])
    return rnnt_multiblank.rnnt_loss_multiblank(logits, labels, fl, ll,
                                                durs["big_blank_durations"])


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(DURATION_FAMILIES))
def test_cuda_duration_losses_match_the_cpu(cuda_device, family):
    """The multi-blank and TDT losses and their gradients (logits and
    duration logits) on CUDA tensors against the same calls on CPU
    tensors, f32: within 1e-5."""
    outs = []
    for dev in ("cpu", cuda_device):
        logits, dur, labels, fl, ll = _duration_inputs(family, dev)
        x = logits.clone().requires_grad_(True)
        d = dur.clone().requires_grad_(True)
        loss = _duration_loss(family, x, d, labels, fl, ll)
        (loss * torch.arange(1, 5, device=dev)).sum().backward()
        outs.append([t.detach().cpu() for t in (loss, x.grad)]
                    + ([d.grad.cpu()] if d.grad is not None else []))
    (cpu, card) = outs
    assert float(card[0][2]) == 0.0
    assert (float(card[0][3]) > 1e29) == (family == "tdt_no_zero")
    for a, b in zip(card, cpu):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["multiblank", "tdt"])
def test_cuda_duration_losses_refuse_tf32(cuda_device, family, monkeypatch):
    logits, dur, labels, fl, ll = _duration_inputs(family, cuda_device)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        _duration_loss(family, logits, dur, labels, fl, ll)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["multiblank", "tdt"])
def test_cuda_duration_greedy_matches_the_plain_lstm(cuda_device, family):
    """Greedy decode of a duration model at libri100 width, f32: the
    encoder through K4-fwd (4 launches, one a layer) against the same
    decode with the plain LSTM; tokens, lengths, frames and t_over
    equal. The big blanks' (or the durations > 1) biases are raised so
    that jumps win on some frames."""
    import contextlib
    import dataclasses
    from unittest import mock

    import numpy as np

    from rnn_transducer_tpu_torch.decode.greedy import greedy_decode
    from rnn_transducer_tpu_torch.models import transducer as tm
    from rnn_transducer_tpu_torch.models.config import config_libri100

    cfg = dataclasses.replace(config_libri100(), compute_dtype="float32",
                              **DURATION_FAMILIES[family])
    params = tm.init_params(cfg, np.random.default_rng(0), cuda_device)
    if family == "multiblank":
        params["joint"]["out"]["b"][cfg.vocab_size:] += 0.3
    else:
        params["joint"]["dur"]["b"][2:] += 0.3
    g = torch.Generator().manual_seed(1)
    feats = torch.randn(3, 160, cfg.input_dim, generator=g).to(cuda_device)
    lens = torch.tensor([160, 97, 40], dtype=torch.int32,
                        device=cuda_device)
    outs = []
    for plain in (False, True):
        with contextlib.ExitStack() as stack, torch.no_grad():
            if plain:
                stack.enter_context(mock.patch.object(
                    lstm_cuda, "lstm_recurrence",
                    lstm_cuda.lstm_recurrence_reference))
            before = lstm_cuda.LAUNCHES
            enc, enc_lens = tm.encode(params, cfg, feats, lens)
            tok, n, st = greedy_decode(params, cfg, enc, enc_lens,
                                       max_symbols=60)
            outs.append((lstm_cuda.LAUNCHES - before, tok.cpu(), n.cpu(),
                         st[3].cpu(), st[7].cpu()))
    (launches, *got), (plain_launches, *want) = outs
    assert launches == cfg.enc_layers and plain_launches == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


MOE_CUDA = dict(input_dim=80, enc_layers=2, enc_hidden=128, time_reduction=2,
                pred_layers=1, pred_hidden=128, embed_dim=64, joint_dim=128,
                vocab_size=64, compute_dtype="float32", joint_experts=4,
                joint_expert_hidden=256, moe_capacity_factor=1.0)


def _moe_batch(dev, B=4, T=48, U=6):
    import numpy as np

    from rnn_transducer_tpu_torch.data.synthetic import random_batch

    batch = random_batch(np.random.default_rng(5), B, T, U, 80, 64)
    return tuple(torch.from_numpy(a).to(dev) for a in batch)


@pytest.mark.cuda
@pytest.mark.parametrize("loss_impl", ["auto", "pallas"])
def test_cuda_moe_loss_matches_the_cpu(cuda_device, loss_impl):
    """The MoE model's loss_fn (routed joint, capacity 1 so tokens drop)
    and its gradients on the card against the same call on the CPU, f32:
    the routes identical, the loss within 1e-5 relative, every gradient
    leaf within 1e-3 of its largest value; K4 each way a layer, K3's
    alpha and beta once, and K5's two kernels on the two-pass route."""
    import numpy as np

    from rnn_transducer_tpu_torch.models import transducer as tm
    from rnn_transducer_tpu_torch.models.config import TransducerConfig
    from rnn_transducer_tpu_torch.ops import moe as tmoe
    from rnn_transducer_tpu_torch.ops import rnnt_lattice_cuda as lat
    from rnn_transducer_tpu_torch.ops import rnnt_loss_cuda as lc
    from rnn_transducer_tpu_torch.train import loop as tloop

    cfg = TransducerConfig(**MOE_CUDA)
    out = {}
    for dev in ("cpu", cuda_device):
        params = tm.init_params(cfg, np.random.default_rng(0), dev)
        leaves, spec = torch.utils._pytree.tree_flatten(params)
        xs = [x.requires_grad_(True) for x in leaves]
        p = torch.utils._pytree.tree_unflatten(xs, spec)
        batch = _moe_batch(dev)
        counts = (lstm_cuda.LAUNCHES_WITH_ACTS, lstm_cuda.LAUNCHES_BWD,
                  lat.LAUNCHES_ALPHA, lat.LAUNCHES_BETA, lc.LAUNCHES_EXTRACT)
        enc, _ = tm.encode(p, cfg, *batch[:2])
        pred, _ = tm.predict(p, cfg, batch[2])
        f, g, _, _ = tm.joint_activations(p, cfg, enc, pred)
        z = torch.tanh(f[:, :, None] + g[:, None]).reshape(-1, cfg.joint_dim)
        routes = tmoe.router_top1(p["moe"], z)[1].cpu()
        loss, _ = tloop.loss_fn(p, cfg, *batch, loss_impl=loss_impl)
        grads = torch.autograd.grad(loss, xs)
        after = (lstm_cuda.LAUNCHES_WITH_ACTS, lstm_cuda.LAUNCHES_BWD,
                 lat.LAUNCHES_ALPHA, lat.LAUNCHES_BETA, lc.LAUNCHES_EXTRACT)
        out[str(dev)] = (float(loss), [x.cpu() for x in grads], routes,
                         [a - b for a, b in zip(after, counts)])
    loss_c, grads_c, routes_c, _ = out["cpu"]
    loss_k, grads_k, routes_k, launches = out[str(cuda_device)]
    assert int((routes_c != routes_k).sum()) == 0
    assert abs(loss_k - loss_c) <= 1e-5 * abs(loss_c)
    for a, b in zip(grads_k, grads_c):
        assert float((a - b).abs().max()) <= 1e-3 * max(
            float(b.abs().max()), 1e-30)
    # 2 encoder layers + the predictor each way (the routing probe above
    # runs its own encode and predict forward)
    assert launches[0] == 2 * (cfg.enc_layers + 1)
    assert launches[1] == cfg.enc_layers + 1
    assert launches[2] == 1 and launches[3] == 1
    assert launches[4] == (1 if loss_impl == "pallas" else 0)


@pytest.mark.cuda
def test_cuda_moe_greedy_matches_the_plain_lstm(cuda_device):
    """Greedy decode of an MoE model at libri100 width (8 experts of 1024),
    f32: the encoder through K4-fwd (one launch a layer) against the same
    decode with the plain LSTM, tokens and lengths equal; the dense MoE
    residual runs in every joint step."""
    import contextlib
    import dataclasses
    from unittest import mock

    import numpy as np

    from rnn_transducer_tpu_torch.decode.greedy import greedy_decode
    from rnn_transducer_tpu_torch.models import transducer as tm
    from rnn_transducer_tpu_torch.models.config import config_libri100

    cfg = dataclasses.replace(config_libri100(), compute_dtype="float32",
                              joint_experts=8, joint_expert_hidden=1024)
    params = tm.init_params(cfg, np.random.default_rng(0), cuda_device)
    g = torch.Generator().manual_seed(1)
    feats = torch.randn(3, 160, cfg.input_dim, generator=g).to(cuda_device)
    lens = torch.tensor([160, 97, 40], dtype=torch.int32,
                        device=cuda_device)
    outs = []
    for plain in (False, True):
        with contextlib.ExitStack() as stack, torch.no_grad():
            if plain:
                stack.enter_context(mock.patch.object(
                    lstm_cuda, "lstm_recurrence",
                    lstm_cuda.lstm_recurrence_reference))
            before = lstm_cuda.LAUNCHES
            enc, enc_lens = tm.encode(params, cfg, feats, lens)
            tok, n, _ = greedy_decode(params, cfg, enc, enc_lens,
                                      max_symbols=60)
            outs.append((lstm_cuda.LAUNCHES - before, tok.cpu(), n.cpu()))
    (launches, *got), (plain_launches, *want) = outs
    assert launches == cfg.enc_layers and plain_launches == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _ep_card_rank(mesh, mode, params_np):
    from rnn_transducer_tpu_torch.models.config import (TrainConfig,
                                                        TransducerConfig)
    from rnn_transducer_tpu_torch.parallel import mesh as meshlib
    from rnn_transducer_tpu_torch.parallel import tp
    from rnn_transducer_tpu_torch.weights import (params_from_numpy,
                                                  params_to_numpy)

    cfg = TransducerConfig(**dict(MOE_CUDA, moe_capacity_factor=4.0))
    tcfg = TrainConfig(batch_size=4, learning_rate=1e-3, warmup_steps=0,
                       total_steps=10, grad_clip_norm=1e9)
    params = params_from_numpy(params_np, mesh.device)
    if mode == "ep":
        state = tp.init_ep_train_state(None, cfg, tcfg, mesh.n_model,
                                       mesh.model_rank, mesh.device,
                                       params=params)
    else:
        state = tp.init_sp_train_state(None, cfg, tcfg, mesh.device,
                                       params=params)
    step = tp.make_tp_train_step(cfg, tcfg, mesh, mode)
    batch = tuple(a.cpu().numpy() for a in _moe_batch("cpu"))
    state, info = step(state, *meshlib.shard_batch_2d(mesh, batch))
    plain = tp.plain_params(mesh, state.params, mode, cfg)
    return (float(info["loss"]), float(info["grad_norm"]),
            params_to_numpy(plain))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sp", "ep"])
def test_cuda_two_gloo_ranks_match_one_process(cuda_device, mode, tmp_path):
    """sp and ep on two gloo ranks sharing the card (the exchanges and
    gathers through host copies) against the one-process step on the
    card, f32 at ample capacity, one step with no warm-up (so that it
    moves the params): the loss and the gradient norm within 2e-5
    relative, the params within 2e-5."""
    import numpy as np

    from rnn_transducer_tpu_torch.models import transducer as tm
    from rnn_transducer_tpu_torch.models.config import (TrainConfig,
                                                        TransducerConfig)
    from rnn_transducer_tpu_torch.parallel import mesh as meshlib
    from rnn_transducer_tpu_torch.train import loop as tloop
    from rnn_transducer_tpu_torch.weights import params_to_numpy

    cfg = TransducerConfig(**dict(MOE_CUDA, moe_capacity_factor=4.0))
    tcfg = TrainConfig(batch_size=4, learning_rate=1e-3, warmup_steps=0,
                       total_steps=10, grad_clip_norm=1e9)
    params = tm.init_params(cfg, np.random.default_rng(2), cuda_device)
    params_np = params_to_numpy(params)
    state = tloop.init_train_state(None, cfg, tcfg, params=params)
    state, info = tloop.make_train_step(cfg, tcfg)(state,
                                                   *_moe_batch(cuda_device))
    want = params_to_numpy(state.params)
    want_norm = float(info["grad_norm"])
    loss, norm, got = meshlib.spawn(
        _ep_card_rank, 2, [str(cuda_device)] * 2, args=(mode, params_np),
        init_method=f"file://{tmp_path}/rendezvous", timeout_s=300,
        n_model=2)
    assert abs(loss - float(info["loss"])) <= 2e-5 * abs(float(info["loss"]))
    assert abs(norm - want_norm) <= 2e-5 * want_norm
    leaves = torch.utils._pytree.tree_leaves
    for a, b in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    assert max(np.abs(a - b).max() for a, b in zip(
        leaves(want), leaves(params_np))) > 1e-4  # the step moved them
