"""Decoder-only transformer language model for shallow fusion and N-best
rescoring (PyTorch port of `rnn_transducer_tpu/models/lm_transformer.py`).

The same consumer contract as the LSTM LM: `models.lm.lm_step`,
`init_lm_state` and `lm_forward` dispatch here when given a
`TransformerLMConfig`, so beam fusion and rescoring take either LM.

  * Scoring is one full causal-attention pass.
  * The step-decode state is a fixed-size KV cache a layer, (B, max_len,
    H, Dh), plus a position a row: static shapes, so the beam search moves
    it around like any other state leaf. A step writes its key and value
    at the row's position through a one-hot select, not a scatter.
  * Pre-LN blocks: x + MHSA(LN(x)), x + FFN(LN(x)), final LN -> logits.
    Learned absolute positions; a position past max_len - 1 clamps.

The arithmetic is the JAX module's, op for op: the attention is explicit
matmuls and a softmax in its order (not a fused attention call, whose
rounding differs), LayerNorm uses the population variance, the FFN's
GELU is the tanh form (`jax.nn.gelu`'s default), and the products follow
the port's `_dot` convention (compute-dtype operands, f32 result). A
bf16 `cache_dtype` rounds only the stored keys and values.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from rnn_transducer_tpu_torch.models.config import _DTYPES
from rnn_transducer_tpu_torch.ops.lstm import _dot

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerLMConfig:
    """Field for field the JAX package's; documented there."""
    vocab_size: int = 32
    d_model: int = 128
    heads: int = 4
    layers: int = 2
    ff_mult: int = 4
    max_len: int = 512
    compute_dtype: str = "bfloat16"
    cache_dtype: str = "float32"

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def cache_dt(self) -> torch.dtype:
        return _DTYPES[self.cache_dtype]

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.heads == 0
        return self.d_model // self.heads


def _init_linear(rng: np.random.Generator, n_in: int, n_out: int) -> dict:
    s = 1.0 / math.sqrt(n_in)
    return {"w": rng.uniform(-s, s, (n_in, n_out)).astype(np.float32),
            "b": rng.uniform(-s, s, (n_out,)).astype(np.float32)}


def _init_ln(d: int) -> dict:
    return {"g": np.ones((d,), np.float32), "b": np.zeros((d,), np.float32)}


def init_transformer_lm_params(cfg: TransformerLMConfig,
                               rng: np.random.Generator,
                               device: str | torch.device = "cuda") -> Params:
    """Fresh params with the JAX init's distributions, drawn from a numpy
    Generator, on `device`."""
    from rnn_transducer_tpu_torch.weights import params_from_numpy

    d, ff = cfg.d_model, cfg.d_model * cfg.ff_mult
    blocks = [{"ln1": _init_ln(d), "qkv": _init_linear(rng, d, 3 * d),
               "att_out": _init_linear(rng, d, d),
               "ln2": _init_ln(d), "ff1": _init_linear(rng, d, ff),
               "ff2": _init_linear(rng, ff, d)}
              for _ in range(cfg.layers)]
    params = {
        "embed": (rng.standard_normal((cfg.vocab_size, d), dtype=np.float32)
                  * np.float32(1.0 / math.sqrt(d))),
        "pos": (rng.standard_normal((cfg.max_len, d), dtype=np.float32)
                * np.float32(0.02)),
        "blocks": blocks,
        "ln_f": _init_ln(d),
        "out": _init_linear(rng, d, cfg.vocab_size),
    }
    return params_from_numpy(params, device)


def _ln(p, x):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)  # population variance
    return (x - mu) * torch.rsqrt(var + 1e-6) * p["g"] + p["b"]


def _linear(p, x, cd):
    return _dot(x, p["w"], cd) + p["b"].float()


def _ffn(blk, x, cd):
    h = _ln(blk["ln2"], x)
    return x + _linear(blk["ff2"],
                       F.gelu(_linear(blk["ff1"], h, cd), approximate="tanh"),
                       cd)


def transformer_lm_forward(params: Params, cfg: TransformerLMConfig,
                           tokens_in):
    """tokens_in: (B, U) input ids (already BOS-shifted) -> next-token
    logits (B, U, V) from one full causal-attention pass."""
    B, U = tokens_in.shape
    cd, H, Dh = cfg.cdtype, cfg.heads, cfg.head_dim
    x = params["embed"][tokens_in.long()] + params["pos"][:U]
    causal = torch.tril(torch.ones((U, U), dtype=torch.bool,
                                   device=x.device))
    for blk in params["blocks"]:
        h = _ln(blk["ln1"], x)
        qkv = _linear(blk["qkv"], h, cd).reshape(B, U, 3, H, Dh)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh)
        scores = torch.where(causal[None, None], scores,
                             torch.full_like(scores, -1e30))
        att = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(B, U, -1)
        x = x + _linear(blk["att_out"], ctx, cd)
        x = _ffn(blk, x, cd)
    return _linear(params["out"], _ln(params["ln_f"], x), cd)


def init_transformer_lm_state(cfg: TransformerLMConfig, batch: int,
                              device: str | torch.device = "cuda"):
    """Step-decode carry: the KV caches of every layer and a position a
    row."""
    H, Dh = cfg.heads, cfg.head_dim
    shape = (batch, cfg.max_len, H, Dh)
    return {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "kv": [{"k": torch.zeros(shape, dtype=cfg.cache_dt, device=device),
                "v": torch.zeros(shape, dtype=cfg.cache_dt, device=device)}
               for _ in range(cfg.layers)],
    }


def transformer_lm_step(params: Params, cfg: TransformerLMConfig, token,
                        state):
    """One decode step: token (B,) -> (next-token log-probs (B, V),
    state'), position by position `transformer_lm_forward`'s."""
    B = token.shape[0]
    cd, H, Dh = cfg.cdtype, cfg.heads, cfg.head_dim
    pos = torch.clamp(state["pos"], max=cfg.max_len - 1).long()  # (B,)
    x = params["embed"][token.long()] + params["pos"][pos]  # (B, d)
    slots = torch.arange(cfg.max_len, device=x.device)
    write = (slots[None, :] == pos[:, None])[:, :, None, None]  # (B, L, 1, 1)
    # key j is attendable iff j <= pos (self included after the write)
    attend = slots[None, :] <= pos[:, None]  # (B, L)
    new_kv = []
    for blk, cache in zip(params["blocks"], state["kv"]):
        h = _ln(blk["ln1"], x)
        qkv = _linear(blk["qkv"], h, cd).reshape(B, 3, H, Dh)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        cdt = cache["k"].dtype
        kc = torch.where(write, k[:, None].to(cdt), cache["k"])
        vc = torch.where(write, v[:, None].to(cdt), cache["v"])
        new_kv.append({"k": kc, "v": vc})
        scores = torch.einsum("bhd,bkhd->bhk", q, kc.float()) / math.sqrt(Dh)
        scores = torch.where(attend[:, None], scores,
                             torch.full_like(scores, -1e30))
        att = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhk,bkhd->bhd", att, vc.float()).reshape(B, -1)
        x = x + _linear(blk["att_out"], ctx, cd)
        x = _ffn(blk, x, cd)
    logits = _linear(params["out"], _ln(params["ln_f"], x), cd)
    new_state = {"pos": state["pos"] + 1, "kv": new_kv}
    return torch.log_softmax(logits, dim=-1), new_state
