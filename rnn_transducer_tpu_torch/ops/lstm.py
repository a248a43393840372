"""Stacked LSTM ops (PyTorch port of `rnn_transducer_tpu/ops/lstm.py`).

Each layer is a plain function over a parameter dict in the JAX layout:
`w_ih` (I, 4H), `w_hh` (H, 4H), one fused bias `b` (4H,), gate order
i, f, g, o. The input projection for all timesteps is one matmul; the time
recurrence runs in `ops/lstm_cuda.py`: the hand-written CUDA kernels for a
CUDA tensor, their plain PyTorch step loops for a CPU tensor. The cell
state is fp32; matmul operands are rounded to the compute dtype (`_dot`).
`LSTMCore` is the recurrence's autograd op, the counterpart of the JAX
package's `_lstm_core` custom VJP. `bilstm_layer` runs a bidirectional
layer as two `lstm_layer` calls, the second on the time-reversed valid
prefix (`reverse_padded`).

A layer whose `w_hh` is an int8 `QTensor` (serving params, `ops/quant.py`)
takes one of the two routes of the JAX package's TPU dispatch, which
compute different functions: the W8A8 recurrence (`_lstm_layer_int8`) or
the float recurrence on the dequantized weights.
"""

from __future__ import annotations

import torch

from rnn_transducer_tpu_torch.ops.quant import QTensor, dequantize_tensor


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


def _whh(params, compute_dtype):
    """Recurrent weights in the compute dtype, an int8 QTensor dequantized
    (`_whh` of the JAX package)."""
    w = params["w_hh"]
    if isinstance(w, QTensor):
        return dequantize_tensor(w, compute_dtype)
    return w.to(compute_dtype)


def hidden_dim(params) -> int:
    w = params["w_hh"]
    return (w.q if isinstance(w, QTensor) else w).shape[0]


def lstm_cell(params, x_proj, h, c, compute_dtype=torch.bfloat16):
    """One LSTM step. x_proj = x @ w_ih + b precomputed. h:(B,H) c:(B,H) fp32."""
    gates = x_proj + _dot(h, _whh(params, compute_dtype), compute_dtype)
    return cell_update(gates, c)


def cell_update(gates, c):
    """An LSTM step from its gate pre-activations (B, 4H) f32 and c (B, H)
    -> (h', c')."""
    i, f, g, o = gates.chunk(4, dim=-1)  # torch gate order: i, f, g, o
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_layer(params, x, h0=None, c0=None, *, compute_dtype=torch.bfloat16):
    """Run one unidirectional LSTM layer over (B, T, I) -> (B, T, H).

    Returns (outputs, (h_T, c_T)), all fp32. x_proj stays fp32, as on the
    JAX scan path (the JAX Pallas path rounds it to the compute dtype,
    `lstm_pallas._proj`; at bf16 the two differ by that rounding).
    An int8 `w_hh` takes `_lstm_layer_int8`.
    """
    from rnn_transducer_tpu_torch.ops import lstm_cuda

    B = x.shape[0]
    H = hidden_dim(params)
    if h0 is None:
        h0 = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    if c0 is None:
        c0 = torch.zeros((B, H), dtype=torch.float32, device=x.device)
    h0, c0 = h0.float().contiguous(), c0.float().contiguous()
    if isinstance(params["w_hh"], QTensor):
        return _lstm_layer_int8(params, x, h0, c0, compute_dtype)
    x_proj = (_dot(x, params["w_ih"], compute_dtype)
              + params["b"].float()).contiguous()  # (B, T, 4H) fp32
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (x_proj, params["w_hh"], h0, c0)):
        hs, hT, cT = LSTMCore.apply(x_proj, params["w_hh"], h0, c0,
                                    compute_dtype)
        return hs, (hT, cT)
    return lstm_cuda.lstm_recurrence(
        x_proj, params["w_hh"].to(compute_dtype).contiguous(), h0, c0)


def w8a8_supported(B: int, H: int) -> bool:
    """Where the JAX package's TPU dispatch runs the W8A8 kernel
    (`lstm_pallas.supported`); every other shape dequantizes w_hh."""
    return H % 128 == 0 and H <= 2048 and B % 8 == 0


def _lstm_layer_int8(params, x, h0, c0, compute_dtype):
    """`lstm_layer` for an int8 QTensor w_hh: inference only.

    W8A8 route, on `w8a8_supported` shapes (`lstm_layer_pallas`): x_proj is
    rounded to the compute dtype after the bias, as `lstm_pallas._proj`
    does, and the recurrence requantizes h every step
    (`lstm_int8_cuda.lstm_recurrence_int8`, the CUDA kernel K7 on a card).
    Dequantized route, everywhere else (the JAX scan path): w_hh in the
    compute dtype through the float recurrence. The JAX package's 12 MB
    VMEM gate on the W8A8 route is a TPU concern and is left out. Both
    recurrences raise when an input requires grad.
    """
    from rnn_transducer_tpu_torch.ops import lstm_cuda, lstm_int8_cuda

    w_hh, w_ih, b = params["w_hh"], params["w_ih"], params["b"]
    if isinstance(w_ih, QTensor):
        w_ih = dequantize_tensor(w_ih)
    B, H = x.shape[0], w_hh.q.shape[0]
    x_proj = _dot(x, w_ih, compute_dtype) + b.float()
    if w8a8_supported(B, H):
        return lstm_int8_cuda.lstm_recurrence_int8(
            x_proj.to(compute_dtype).contiguous(), w_hh.q.contiguous(),
            w_hh.scale.float().contiguous(), h0, c0)
    return lstm_cuda.lstm_recurrence(x_proj.contiguous(),
                                     _whh(params, compute_dtype).contiguous(),
                                     h0, c0)


class LSTMCore(torch.autograd.Function):
    """The LSTM recurrence with its gradient: hs, h_T, c_T from x_proj
    (B, T, 4H) f32, w_hh (H, 4H) (any float dtype; rounded to the compute
    dtype inside), h0 and c0 (B, H) f32.

    The counterpart of `_lstm_core` with `_core_fwd` / `_core_bwd`
    (rnn_transducer_tpu/ops/lstm_pallas.py:583-613). The forward runs the
    recurrence with its gate activations and cell states saved
    (`lstm_cuda.lstm_recurrence_with_acts`); the backward runs the
    time-reversed recurrence from them (`lstm_cuda.lstm_recurrence_bwd`)
    and takes dW_hh = hs_prev^T . dgates as one matmul with compute-dtype
    operands and an fp32 result, as the JAX package does in XLA.
    """

    @staticmethod
    def forward(ctx, x_proj, w_hh, h0, c0, compute_dtype):
        from rnn_transducer_tpu_torch.ops import lstm_cuda

        w_c = w_hh.to(compute_dtype).contiguous()
        hs, cs, acts = lstm_cuda.lstm_recurrence_with_acts(x_proj, w_c, h0,
                                                           c0)
        ctx.save_for_backward(acts, w_c, h0, c0, hs, cs)
        ctx.w_dtype = w_hh.dtype
        if hs.shape[1] == 0:
            return hs, h0.clone(), c0.clone()
        return hs, hs[:, -1].clone(), cs[:, -1].clone()

    @staticmethod
    def backward(ctx, dhs, dhT, dcT):
        from rnn_transducer_tpu_torch.ops import lstm_cuda

        acts, w_c, h0, c0, hs, cs = ctx.saved_tensors
        B, T, H = hs.shape
        zeros = lambda: torch.zeros((B, H), dtype=torch.float32,  # noqa: E731
                                    device=hs.device)
        # autograd hands None for an output the loss does not use: the
        # encoder's and predictor's final states in training
        dhT = zeros() if dhT is None else dhT.float()
        dcT = zeros() if dcT is None else dcT.float().contiguous()
        if T == 0:
            return (None, torch.zeros(w_c.shape, dtype=ctx.w_dtype,
                                      device=hs.device), dhT, dcT, None)
        dhs = (torch.zeros_like(hs) if dhs is None
               else dhs.float().clone(memory_format=torch.contiguous_format))
        dhs[:, T - 1] += dhT  # fold the final-state cotangent into step T-1
        cs_prev = torch.cat([c0[:, None], cs[:, :-1]], dim=1)
        dgates, dh0, dc0 = lstm_cuda.lstm_recurrence_bwd(acts, cs_prev, dhs,
                                                         dcT, w_c)
        hs_prev = torch.cat([h0[:, None], hs[:, :-1]], dim=1)
        dw_hh = _dot(hs_prev.reshape(B * T, H).t(),
                     dgates.reshape(B * T, 4 * H), w_c.dtype)
        return dgates, dw_hh.to(ctx.w_dtype), dh0, dc0, None


def reverse_padded(x, lens):
    """Reverse the valid prefix of each (T, ...) sequence in a padded batch.

    x (B, T, ...), lens (B,). Position t of row b reads lens[b] - 1 - t;
    where that is below 0 (t >= lens[b]) it reads t itself, so padding
    maps to itself and a zero-length row stays as it was. A gather on
    int64 indices, as JAX's `take_along_axis` (ops/lstm.py:126).
    """
    B, T = x.shape[0], x.shape[1]
    t_ids = torch.arange(T, dtype=torch.int64, device=x.device)[None, :]
    idx = lens.to(device=x.device, dtype=torch.int64)[:, None] - 1 - t_ids
    idx = torch.where(idx >= 0, idx, t_ids)  # padding maps to itself
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)


def bilstm_layer(params_fwd, params_bwd, x, lens, *,
                 compute_dtype=torch.bfloat16):
    """Bidirectional layer: the forward run of `params_fwd` concatenated
    with the backward run of `params_bwd` over the reversed valid prefix,
    reversed back. (B, T, I) -> (B, T, 2H) fp32.

    Both directions are `lstm_layer` calls, so each reaches the same
    kernels as a unidirectional layer: K4-fwd (with activations and
    K4-bwd through `LSTMCore` in training), and K7 for int8 params on
    `w8a8_supported` shapes. At H % 128 != 0 (TIMIT's H = 320) an int8
    w_hh is dequantized instead, as the JAX package does.

    The pad region of x is irrelevant (reverse_padded maps pads to
    themselves, so the reversed pass starts from the true last frame and
    no pad enters a valid position); the pad positions of the output are
    garbage, as in JAX's `bilstm_layer`.
    """
    y_f, _ = lstm_layer(params_fwd, x, compute_dtype=compute_dtype)
    y_b, _ = lstm_layer(params_bwd, reverse_padded(x, lens),
                        compute_dtype=compute_dtype)
    return torch.cat([y_f, reverse_padded(y_b, lens)], dim=-1)


def mask_padding(x, lens):
    """Zero features at padded timesteps. x: (B, T, F), lens: (B,)."""
    t_ids = torch.arange(x.shape[1], device=x.device)[None, :, None]
    return torch.where(t_ids < lens.to(x.device)[:, None, None], x,
                       torch.zeros((), dtype=x.dtype, device=x.device))
