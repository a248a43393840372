"""Conformer encoder blocks (PyTorch port of
`rnn_transducer_tpu/ops/conformer.py`, the offline block).

Per block (macaron order): half-FFN -> MHSA with a learned relative
position bias per head, clipped at +/-`REL_CLIP` frames -> conv module
(pointwise-GLU -> depthwise -> LN -> swish -> pointwise) -> half-FFN ->
final LN. The design notes (T5-style bias, LayerNorm in the conv module)
live in the JAX module.

Every LayerNorm goes through `ops/fused_ln.fused_layer_norm`: the K8
kernels on the card, their plain versions on the CPU. Every product
takes compute-dtype operands and gives an f32 result (`ops/lstm._dot`'s
convention, `preferred_element_type=float32` in JAX); where the JAX
module rounds an activation to the compute dtype at its source (the FFN
hidden, q/k/v, the GLU, the attention output), so does this one, and the
elementwise ops between (silu, the GLU product) run in that dtype.
Masking uses NEG_INF = -1e30, not -inf: a zero-length row masks every
key and gets a uniform softmax, which the output mask then zeroes.

Not ported yet: the chunked streaming functions `init_block_cache` and
`conformer_block_chunk` (ROADMAP queue 1, item 4: streaming).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from rnn_transducer_tpu_torch.ops.fused_ln import fused_layer_norm
from rnn_transducer_tpu_torch.ops.lstm import _dot, mask_padding

NEG_INF = -1.0e30
REL_CLIP = 64  # max relative distance the position bias distinguishes


def _linear(rng: np.random.Generator, din: int, dout: int) -> dict:
    k = 1.0 / math.sqrt(din)
    return {"w": rng.uniform(-k, k, (din, dout)).astype(np.float32),
            "b": rng.uniform(-k, k, (dout,)).astype(np.float32)}


def _ln_params(d: int) -> dict:
    return {"g": np.ones((d,), np.float32), "b": np.zeros((d,), np.float32)}


def init_conformer_block(rng: np.random.Generator, d: int, heads: int,
                         ff_mult: int, conv_kernel: int) -> dict:
    """One block's params as numpy arrays, in the JAX tree and with the
    JAX distributions (numpy draws, so not the JAX values for a seed):
    linears uniform +/-1/sqrt(din), LN ones and zeros, `rel` normal x 0.02
    of shape (heads, 2 * REL_CLIP + 1), `dw_w` normal / sqrt(K), `dw_b`
    zeros."""
    if d % heads:
        raise ValueError(f"d_model {d} % heads {heads} != 0")
    return {
        "ln_ff1": _ln_params(d), "ln_att": _ln_params(d),
        "ln_conv": _ln_params(d), "ln_ff2": _ln_params(d),
        "ln_out": _ln_params(d),
        "ff1": {"in": _linear(rng, d, ff_mult * d),
                "out": _linear(rng, ff_mult * d, d)},
        "ff2": {"in": _linear(rng, d, ff_mult * d),
                "out": _linear(rng, ff_mult * d, d)},
        "att": {"q": _linear(rng, d, d), "k": _linear(rng, d, d),
                "v": _linear(rng, d, d), "o": _linear(rng, d, d),
                "rel": (rng.standard_normal((heads, 2 * REL_CLIP + 1))
                        * 0.02).astype(np.float32)},
        "conv": {"pw1": _linear(rng, d, 2 * d),  # GLU halves it back
                 "dw_w": (rng.standard_normal((conv_kernel, d))
                          / math.sqrt(conv_kernel)).astype(np.float32),
                 "dw_b": np.zeros((d,), np.float32),
                 "ln": _ln_params(d),
                 "pw2": _linear(rng, d, d)},
    }


def _ln(p, x):
    return fused_layer_norm(x, p["g"], p["b"])


def _ln_silu(p, x):
    """silu(LayerNorm(x)), one K8 launch on the card."""
    return fused_layer_norm(x, p["g"], p["b"], "silu")


def _sigmoid(x):
    """jax.nn.sigmoid as XLA computes it. At bf16 it lowers to 1 / (1 +
    exp(-x)) with each of the three ops rounding to bf16; torch.sigmoid
    rounds once, and differs from it on a third of bf16 inputs by up to an
    ulp, enough to flip a random model's near-tie greedy decisions. At f32
    torch.sigmoid is within an ulp of XLA's."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def _silu(x):
    """jax.nn.silu: x * sigmoid(x), each op in x's dtype."""
    return x * _sigmoid(x)


def _dense(p, x, cd, out_dtype=None):
    """Compute-dtype product with an f32 result, plus the f32 bias;
    out_dtype=cd rounds the result to the compute dtype at the source, as
    the JAX module does for activations whose only consumer casts them."""
    y = _dot(x, p["w"], cd) + p["b"].float()
    return y.to(out_dtype) if out_dtype is not None else y


def _ffn(p, x, cd):
    return _dense(p["out"], _silu(_dense(p["in"], x, cd, out_dtype=cd)), cd)


def _attend(p, q_in, kv_in, ages, key_ok, heads: int, cd):
    """Shared attention core. q_in (B, Tq, D); kv_in (B, Tk, D); ages
    (Tq, Tk) signed query-key distance; key_ok (B, Tq, Tk) or (B, 1, Tk)
    validity mask."""
    B, Tq, D = q_in.shape
    Tk = kv_in.shape[1]
    dh = D // heads
    q = _dense(p["q"], q_in, cd, out_dtype=cd).reshape(B, Tq, heads, dh)
    k = _dense(p["k"], kv_in, cd, out_dtype=cd).reshape(B, Tk, heads, dh)
    v = _dense(p["v"], kv_in, cd, out_dtype=cd).reshape(B, Tk, heads, dh)
    # compute-dtype operands, f32 products (the einsums'
    # preferred_element_type)
    logits = torch.matmul(q.permute(0, 2, 1, 3).float(),
                          k.permute(0, 2, 3, 1).float())  # (B, H, Tq, Tk)
    logits = logits * (1.0 / math.sqrt(dh))
    rel = torch.clamp(ages, -REL_CLIP, REL_CLIP) + REL_CLIP
    logits = logits + p["rel"].float()[:, rel][None]  # (1, H, Tq, Tk)
    logits = logits.masked_fill(~key_ok[:, None], NEG_INF)
    w = torch.softmax(logits, dim=-1)  # f32
    out = torch.matmul(w.to(cd).float(),
                       v.permute(0, 2, 1, 3).float()).to(cd)  # (B, H, Tq, dh)
    return _dense(p["o"], out.permute(0, 2, 1, 3).reshape(B, Tq, D), cd)


def _mhsa(p, x, lens, heads: int, cd, att_left: int = 0,
          chunk_att: int = 0):
    """Self-attention; padded keys are masked before the softmax.
    att_left > 0: each query sees the causal window [t - att_left, t].
    chunk_att = S > 0: query t sees its whole S-frame chunk plus att_left
    frames left of the chunk start."""
    B, T, _ = x.shape
    t_ids = torch.arange(T, device=x.device)
    ages = t_ids[:, None] - t_ids[None, :]  # (T, T)
    key_ok = (t_ids[None, :] < lens.to(x.device).long()[:, None])[:, None, :]
    if chunk_att > 0:
        cs = (t_ids // chunk_att) * chunk_att  # chunk start per query
        win = ((t_ids[None, :] >= (cs - att_left)[:, None])
               & (t_ids[None, :] < (cs + chunk_att)[:, None]))
        key_ok = key_ok & win[None]
    elif att_left > 0:
        key_ok = key_ok & ((ages >= 0) & (ages <= att_left))[None]
    return _attend(p, x, x, ages, key_ok, heads, cd)


def _conv_module(p, x, lens, cd, causal: bool = False):
    """Pointwise-GLU -> depthwise conv -> LN -> swish -> pointwise. The GLU
    output is masked right before the depthwise conv, the one op whose
    window crosses frames (the pointwise bias makes pad rows nonzero)."""
    D = x.shape[-1]
    h = _dense(p["pw1"], x, cd, out_dtype=cd)  # (B, T, 2D)
    h = h[..., :D] * _sigmoid(h[..., D:])  # GLU, in cd
    h = mask_padding(h, lens)
    return _dw_and_out(p, h, cd, causal=causal)


def _dw_and_out(p, h, cd, causal: bool):
    """Depthwise conv + LN + swish + pointwise-out over GLU activations.

    The depthwise conv is the JAX module's K shifted multiply-adds in f32,
    added in tap order k = 0 ... K-1 and then to dw_b (Python's `sum`),
    so the result is the JAX one bit for bit at f32; F.conv1d would let
    cuDNN reorder the sum. causal pads K-1 zeros on the left only."""
    kern = p["dw_w"].float()  # (K, D)
    K = kern.shape[0]
    T = h.shape[1]
    lpad = K - 1 if causal else (K - 1) // 2
    hp = F.pad(h.float(), (0, 0, lpad, K - 1 - lpad))
    acc = 0
    for k in range(K):
        acc = acc + hp[:, k:k + T] * kern[k]
    h = p["dw_b"].float() + acc
    return _dense(p["pw2"], _ln_silu(p["ln"], h), cd)


def conformer_block(p, x, lens, heads: int, cd, att_left: int = 0,
                    chunk_att: int = 0):
    """One offline block over x (B, T, D) f32 with valid lengths lens (B,).
    att_left > 0 selects the causal form (left-only attention window and
    causal depthwise conv); chunk_att > 0 chunked attention with the
    causal conv."""
    x = x + 0.5 * _ffn(p["ff1"], _ln(p["ln_ff1"], x), cd)
    x = x + _mhsa(p["att"], _ln(p["ln_att"], x), lens, heads, cd,
                  att_left=att_left, chunk_att=chunk_att)
    x = x + _conv_module(p["conv"], _ln(p["ln_conv"], x), lens, cd,
                         causal=att_left > 0 or chunk_att > 0)
    x = x + 0.5 * _ffn(p["ff2"], _ln(p["ln_ff2"], x), cd)
    return _ln(p["ln_out"], x)
