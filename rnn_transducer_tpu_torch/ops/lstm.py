"""Stacked LSTM ops (PyTorch port of `rnn_transducer_tpu/ops/lstm.py`).

Each layer is a plain function over a parameter dict in the JAX layout:
`w_ih` (I, 4H), `w_hh` (H, 4H), one fused bias `b` (4H,), gate order
i, f, g, o. The input projection for all timesteps is one matmul; the time
recurrence runs in `ops/lstm_cuda.py`: the hand-written CUDA kernel for a
CUDA tensor, its plain PyTorch step loop for a CPU tensor. The cell state
is fp32; matmul operands are rounded to the compute dtype (`_dot`).
"""

from __future__ import annotations

import torch


def _dot(x: torch.Tensor, w: torch.Tensor,
         cdtype: torch.dtype) -> torch.Tensor:
    """x @ w with compute-dtype operands and an fp32 result.

    The counterpart of `jnp.dot(x.astype(cd), w.astype(cd),
    preferred_element_type=jnp.float32)`. The operands are rounded to
    `cdtype` and multiplied in float32: a product of two bf16 values is
    exact in float32, so this is fp32 accumulation of compute-dtype
    operands. `torch.matmul` on bf16 tensors would instead round its result
    to bf16, which the JAX package never does. This is the one place that
    choice is made.
    """
    return torch.matmul(x.to(cdtype).float(), w.to(cdtype).float())


def lstm_cell(params, x_proj, h, c, compute_dtype=torch.bfloat16):
    """One LSTM step. x_proj = x @ w_ih + b precomputed. h:(B,H) c:(B,H) fp32."""
    gates = x_proj + _dot(h, params["w_hh"], compute_dtype)
    i, f, g, o = gates.chunk(4, dim=-1)  # torch gate order: i, f, g, o
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_layer(params, x, h0=None, c0=None, *, compute_dtype=torch.bfloat16):
    """Run one unidirectional LSTM layer over (B, T, I) -> (B, T, H).

    Returns (outputs, (h_T, c_T)), all fp32. x_proj stays fp32, as on the
    JAX scan path (the JAX Pallas path rounds it to the compute dtype,
    `lstm_pallas._proj`; at bf16 the two differ by that rounding).
    """
    from rnn_transducer_tpu_torch.ops import lstm_cuda

    B = x.shape[0]
    H = params["w_hh"].shape[0]
    x_proj = (_dot(x, params["w_ih"], compute_dtype)
              + params["b"].float())  # (B, T, 4H) fp32
    if h0 is None:
        h0 = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    if c0 is None:
        c0 = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    return lstm_cuda.lstm_recurrence(
        x_proj.contiguous(), params["w_hh"].to(compute_dtype).contiguous(),
        h0.float().contiguous(), c0.float().contiguous())


def mask_padding(x, lens):
    """Zero features at padded timesteps. x: (B, T, F), lens: (B,)."""
    t_ids = torch.arange(x.shape[1], device=x.device)[None, :, None]
    return torch.where(t_ids < lens.to(x.device)[:, None, None], x,
                       torch.zeros((), dtype=x.dtype, device=x.device))
