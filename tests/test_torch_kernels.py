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
