"""LSTM time recurrence: the CUDA kernel (`csrc/lstm_fwd.cu`) and its plain
PyTorch version.

Replaces the inference forward of the JAX package's Pallas LSTM kernels,
`rnn_transducer_tpu/ops/lstm_pallas.py` `_lstm_core_fwd` and
`_lstm_core_fwd_v2`, as `_lstm_core` runs them with `with_acts=False`.
The TPU's dispatch gates (`supported`, `_w_hh_fits_vmem`, the batch and
time tiles) are VMEM concerns and have no counterpart: every shape goes
to the kernel.

`lstm_recurrence` launches the kernel for a CUDA tensor and runs
`lstm_recurrence_reference` for a CPU tensor; it never falls back from
one to the other. `LAUNCHES` counts the calls that launched the kernel.
"""

from __future__ import annotations

import threading

import torch

from rnn_transducer_tpu_torch.ops.lstm import lstm_cell
from rnn_transducer_tpu_torch.utils import build

LAUNCHES = 0  # calls that launched the CUDA kernel (one call = one layer)
_launches_lock = threading.Lock()

_W_DTYPES = (torch.float32, torch.bfloat16)


def _check(x_proj, w_hh, h0, c0):
    if x_proj.dim() != 3 or x_proj.shape[2] % 4:
        raise ValueError(f"x_proj must be (B, T, 4H); got {tuple(x_proj.shape)}")
    B, _, H4 = x_proj.shape
    H = H4 // 4
    if tuple(w_hh.shape) != (H, H4):
        raise ValueError(f"w_hh must be ({H}, {H4}); got {tuple(w_hh.shape)}")
    for name, s in (("h0", h0), ("c0", c0)):
        if tuple(s.shape) != (B, H):
            raise ValueError(f"{name} must be ({B}, {H}); got {tuple(s.shape)}")
    for name, a in (("x_proj", x_proj), ("h0", h0), ("c0", c0)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {a.dtype}")
    if w_hh.dtype not in _W_DTYPES:
        raise TypeError(f"w_hh must be float32 or bfloat16; got {w_hh.dtype}")
    devices = {a.device for a in (x_proj, w_hh, h0, c0)}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")
    if not all(a.is_contiguous() for a in (x_proj, w_hh, h0, c0)):
        raise ValueError("inputs must be contiguous")


def lstm_recurrence(x_proj, w_hh, h0, c0):
    """hs (B, T, H), (h_T, c_T) from x_proj (B, T, 4H) f32, w_hh (H, 4H) in
    the compute dtype (f32 or bf16) and h0, c0 (B, H) f32."""
    global LAUNCHES
    _check(x_proj, w_hh, h0, c0)
    dev = x_proj.device
    if dev.type == "cpu":
        return lstm_recurrence_reference(x_proj, w_hh, h0, c0)
    if dev.type != "cuda":
        raise ValueError(f"no LSTM recurrence for device {dev}")
    B, T, H4 = x_proj.shape
    H = H4 // 4
    if T == 0:
        return x_proj.new_empty((B, 0, H)), (h0, c0)
    fn = build.load_library()
    hs = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    c = torch.empty((B, H), dtype=torch.float32, device=dev)
    err = fn.lstm_fwd(
        x_proj.data_ptr(), w_hh.data_ptr(), int(w_hh.dtype == torch.bfloat16),
        h0.data_ptr(), c0.data_ptr(), hs.data_ptr(), c.data_ptr(),
        B, T, H, dev.index if dev.index is not None else
        torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"lstm_fwd launch failed: "
                           f"{fn.lstm_error_string(err).decode()} ({err})")
    with _launches_lock:
        LAUNCHES += 1
    return hs, (hs[:, T - 1], c)


def lstm_recurrence_reference(x_proj, w_hh, h0, c0):
    """The plain PyTorch step loop: `lstm_cell` over t, with the same
    compute-dtype rounding of h as the kernel."""
    _check(x_proj, w_hh, h0, c0)
    B, T, H4 = x_proj.shape
    params = {"w_hh": w_hh}
    h, c = h0, c0
    hs = x_proj.new_empty((B, T, H4 // 4))
    for t in range(T):
        h, c = lstm_cell(params, x_proj[:, t], h, c, w_hh.dtype)
        hs[:, t] = h
    return hs, (h, c)
