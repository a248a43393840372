"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests skip without a CUDA device: a CUDA kernel has no CPU mode.
This file imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

`chip_smoke.py` checks the same kernels at the serving path's shapes.
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B, T, H", [(8, 37, 512), (3, 37, 512), (1, 5, 64)])
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
