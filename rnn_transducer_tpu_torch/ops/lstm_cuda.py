"""LSTM time recurrence: the CUDA kernels and their plain PyTorch versions.

  * `csrc/lstm_fwd.cu` (K4-fwd) replaces the forward of the JAX package's
    Pallas LSTM kernels, `rnn_transducer_tpu/ops/lstm_pallas.py`
    `_lstm_core_fwd` and `_lstm_core_fwd_v2`. `lstm_recurrence` runs it as
    `_lstm_core` does on the primal (serving) path, with_acts=False;
    `lstm_recurrence_with_acts` also writes the gate activations and the
    cell states that the backward reads, as `_core_fwd` does.
  * `csrc/lstm_bwd.cu` (K4-bwd) replaces `_lstm_core_bwd` and
    `_lstm_core_bwd_v2`: `lstm_recurrence_bwd`.

The TPU's dispatch gates (`supported`, `_w_hh_fits_vmem`, the batch and
time tiles) are VMEM concerns and have no counterpart: every shape goes
to the kernels.

Each wrapper launches its kernel for a CUDA tensor and runs its
`*_reference` version for a CPU tensor; it never falls back from one to
the other. Each counts the calls that launched its kernel. None of them
records an autograd graph: `ops/lstm.LSTMCore` is the differentiable op,
and the forward wrappers raise when handed a tensor that requires grad
while grad mode is on, rather than return outputs cut from the graph.
"""

from __future__ import annotations

import threading

import torch

from rnn_transducer_tpu_torch.ops.lstm import _dot, lstm_cell
from rnn_transducer_tpu_torch.utils import build

# Calls that launched a kernel (one call = one layer), per wrapper.
LAUNCHES = 0             # lstm_recurrence: lstm_fwd without activations
LAUNCHES_WITH_ACTS = 0   # lstm_recurrence_with_acts: lstm_fwd with them
LAUNCHES_BWD = 0         # lstm_recurrence_bwd: lstm_bwd
_launches_lock = threading.Lock()

_W_DTYPES = (torch.float32, torch.bfloat16)


def _count(name: str) -> None:
    with _launches_lock:
        globals()[name] += 1


def _check_same_device_contiguous(named):
    devices = {a.device for _, a in named}
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")
    for name, a in named:
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


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
    _check_same_device_contiguous(
        (("x_proj", x_proj), ("w_hh", w_hh), ("h0", h0), ("c0", c0)))
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x_proj, w_hh, h0, c0)):
        raise RuntimeError(
            "lstm_recurrence records no autograd graph, and an input "
            "requires grad: differentiate through ops.lstm.LSTMCore "
            "(lstm_layer routes there) or call this under torch.no_grad()")


def _launch_fwd(x_proj, w_hh, h0, c0, with_acts: bool):
    """lstm_fwd on the card -> hs, c_T, and (cs, acts) or (None, None)."""
    dev = x_proj.device
    B, T, H4 = x_proj.shape
    H = H4 // 4
    fn = build.load_library()
    hs = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    c = torch.empty((B, H), dtype=torch.float32, device=dev)
    cs = acts = None
    if with_acts:
        cs = torch.empty((B, T, H), dtype=torch.float32, device=dev)
        acts = torch.empty((B, T, H4), dtype=torch.float32, device=dev)
    err = fn.lstm_fwd(
        x_proj.data_ptr(), w_hh.data_ptr(), int(w_hh.dtype == torch.bfloat16),
        h0.data_ptr(), c0.data_ptr(), hs.data_ptr(), c.data_ptr(),
        acts.data_ptr() if with_acts else None,
        cs.data_ptr() if with_acts else None,
        B, T, H, *build.stream_args(dev))
    build.check_launch(fn, err, "lstm_fwd")
    return hs, c, cs, acts


def _require_cuda(dev: torch.device, what: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"no {what} for device {dev}")


def lstm_recurrence(x_proj, w_hh, h0, c0):
    """hs (B, T, H), (h_T, c_T) from x_proj (B, T, 4H) f32, w_hh (H, 4H) in
    the compute dtype (f32 or bf16) and h0, c0 (B, H) f32."""
    _check(x_proj, w_hh, h0, c0)
    dev = x_proj.device
    if dev.type == "cpu":
        return lstm_recurrence_reference(x_proj, w_hh, h0, c0)
    _require_cuda(dev, "LSTM recurrence")
    B, T, H4 = x_proj.shape
    if T == 0:
        return x_proj.new_empty((B, 0, H4 // 4)), (h0, c0)
    hs, c, _, _ = _launch_fwd(x_proj, w_hh, h0, c0, with_acts=False)
    _count("LAUNCHES")
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


def lstm_recurrence_with_acts(x_proj, w_hh, h0, c0):
    """The training forward: hs, cs (B, T, H) and acts (B, T, 4H), all f32.

    acts holds the post-nonlinearity gates sigmoid(i), sigmoid(f), tanh(g),
    sigmoid(o) of every step, as `_fwd_kernel` stores them with
    with_acts=True; cs holds every step's cell state.
    """
    _check(x_proj, w_hh, h0, c0)
    dev = x_proj.device
    if dev.type == "cpu":
        return lstm_recurrence_with_acts_reference(x_proj, w_hh, h0, c0)
    _require_cuda(dev, "LSTM recurrence")
    if x_proj.shape[1] == 0:
        return lstm_recurrence_with_acts_reference(x_proj, w_hh, h0, c0)
    hs, _, cs, acts = _launch_fwd(x_proj, w_hh, h0, c0, with_acts=True)
    _count("LAUNCHES_WITH_ACTS")
    return hs, cs, acts


def lstm_recurrence_with_acts_reference(x_proj, w_hh, h0, c0):
    """Plain step loop of `lstm_recurrence_with_acts`: `lstm_cell`'s math
    with the gates kept."""
    _check(x_proj, w_hh, h0, c0)
    B, T, H4 = x_proj.shape
    H = H4 // 4
    h, c = h0, c0
    hs = x_proj.new_empty((B, T, H))
    cs = x_proj.new_empty((B, T, H))
    acts = x_proj.new_empty((B, T, H4))
    for t in range(T):
        gates = x_proj[:, t] + _dot(h, w_hh, w_hh.dtype)
        i, f, g, o = gates.chunk(4, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs[:, t], cs[:, t] = h, c
        acts[:, t] = torch.cat([i, f, g, o], dim=-1)
    return hs, cs, acts


def _check_bwd(acts, cs_prev, dhs, dcT, w_hh):
    if acts.dim() != 3 or acts.shape[2] % 4:
        raise ValueError(f"acts must be (B, T, 4H); got {tuple(acts.shape)}")
    B, T, H4 = acts.shape
    H = H4 // 4
    for name, a, shape in (("cs_prev", cs_prev, (B, T, H)),
                           ("dhs", dhs, (B, T, H)), ("dcT", dcT, (B, H)),
                           ("w_hh", w_hh, (H, H4))):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(a.shape)}")
    for name, a in (("acts", acts), ("cs_prev", cs_prev), ("dhs", dhs),
                    ("dcT", dcT)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {a.dtype}")
    if w_hh.dtype not in _W_DTYPES:
        raise TypeError(f"w_hh must be float32 or bfloat16; got {w_hh.dtype}")
    _check_same_device_contiguous(
        (("acts", acts), ("cs_prev", cs_prev), ("dhs", dhs), ("dcT", dcT),
         ("w_hh", w_hh)))


def lstm_recurrence_bwd(acts, cs_prev, dhs, dcT, w_hh):
    """Time-reversed BPTT from the saved activations (no recompute).

    acts (B, T, 4H) and cs_prev = [c0, cs[:, :-1]] (B, T, H) from the
    forward; dhs (B, T, H) with the final-state cotangent dh_T already
    folded into step T-1; dcT (B, H); w_hh (H, 4H) in the compute dtype.
    Returns dgates (B, T, 4H) f32 (the cotangent of x_proj), dh0 and dc0
    (B, H) f32. The weight gradients are matmuls over dgates, left to the
    caller as the JAX package leaves them to XLA.
    """
    _check_bwd(acts, cs_prev, dhs, dcT, w_hh)
    dev = acts.device
    if dev.type == "cpu":
        return lstm_recurrence_bwd_reference(acts, cs_prev, dhs, dcT, w_hh)
    _require_cuda(dev, "LSTM backward")
    B, T, H4 = acts.shape
    H = H4 // 4
    if T == 0:
        return (acts.new_empty((B, 0, H4)),
                torch.zeros((B, H), dtype=torch.float32, device=dev),
                dcT.clone())
    fn = build.load_library()
    dgates = torch.empty((B, T, H4), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    dc0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    err = fn.lstm_bwd(
        acts.data_ptr(), cs_prev.data_ptr(), dhs.data_ptr(), dcT.data_ptr(),
        w_hh.data_ptr(), int(w_hh.dtype == torch.bfloat16),
        dgates.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), B, T, H,
        *build.stream_args(dev))
    build.check_launch(fn, err, "lstm_bwd")
    _count("LAUNCHES_BWD")
    return dgates, dh0, dc0


def lstm_recurrence_bwd_reference(acts, cs_prev, dhs, dcT, w_hh):
    """Plain reversed step loop of `lstm_recurrence_bwd`, the math of the
    JAX package's `_bwd_kernel` (lstm_pallas.py:169-220)."""
    _check_bwd(acts, cs_prev, dhs, dcT, w_hh)
    B, T, H4 = acts.shape
    H = H4 // 4
    dgates = acts.new_empty((B, T, H4))
    dh = torch.zeros((B, H), dtype=torch.float32, device=acts.device)
    dc = dcT
    for t in reversed(range(T)):
        i, f, g, o = acts[:, t].chunk(4, dim=-1)
        cp = cs_prev[:, t]
        tc = torch.tanh(f * cp + i * g)
        dh_tot = dhs[:, t] + dh
        do = dh_tot * tc
        dc = dc + dh_tot * o * (1.0 - tc * tc)
        di, dg, df = dc * g, dc * i, dc * cp
        dgt = torch.cat([di * i * (1.0 - i), df * f * (1.0 - f),
                         dg * (1.0 - g * g), do * o * (1.0 - o)], dim=-1)
        dgates[:, t] = dgt
        dc = dc * f
        dh = _dot(dgt, w_hh.t(), w_hh.dtype)
    return dgates, dh, dc
