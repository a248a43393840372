"""LSTM language model over the output token vocabulary, for shallow
fusion with beam-search decoding and N-best rescoring (PyTorch port of
`rnn_transducer_tpu/models/lm.py`).

Embedding -> stacked LSTM -> vocab logits, over a parameter dict in the
JAX layout ({"embed", "lstm": [layer, ...], "out": {"w", "b"}}). BOS is
`BOS_ID` (the blank id, which never appears inside label sequences); the
scoring pass, the fusion step and rescoring all feed it. `lm_forward`
runs each layer through the port's `lstm_layer`, so on a card the
recurrence is the CUDA kernel of `csrc/lstm_fwd.cu`; `lm_step` is one
cell step. Every entry point dispatches to the transformer LM
(models/lm_transformer.py) when given a `TransformerLMConfig`.

Training an LM (`lm_loss`) and reading a checkpoint (`load_lm`, orbax)
are not ported yet (ROADMAP queue 1, item 18).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from rnn_transducer_tpu_torch.models.config import _DTYPES
from rnn_transducer_tpu_torch.models.lm_transformer import (
    TransformerLMConfig,
    init_transformer_lm_params,
    init_transformer_lm_state,
    transformer_lm_forward,
    transformer_lm_step,
)
from rnn_transducer_tpu_torch.ops.lstm import _dot, lstm_cell, lstm_layer

Params = dict[str, Any]

# The LM's beginning-of-sequence token, shared by every consumer.
BOS_ID = 0


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Field for field the JAX package's."""
    vocab_size: int = 32
    embed_dim: int = 128
    hidden: int = 256
    layers: int = 1
    compute_dtype: str = "bfloat16"

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


def init_lm_params(cfg, rng: np.random.Generator,
                   device: str | torch.device = "cuda") -> Params:
    """Fresh params with the JAX init's distributions, drawn from a numpy
    Generator (not the JAX package's values for a seed), on `device`."""
    if isinstance(cfg, TransformerLMConfig):
        return init_transformer_lm_params(cfg, rng, device)
    from rnn_transducer_tpu_torch.models.transducer import _init_lstm
    from rnn_transducer_tpu_torch.weights import params_from_numpy

    embed = rng.standard_normal((cfg.vocab_size, cfg.embed_dim),
                                dtype=np.float32)
    layers = []
    in_dim = cfg.embed_dim
    for _ in range(cfg.layers):
        layers.append(_init_lstm(rng, in_dim, cfg.hidden))
        in_dim = cfg.hidden
    s = 1.0 / math.sqrt(cfg.hidden)
    out = {"w": rng.uniform(-s, s, (cfg.hidden, cfg.vocab_size)
                            ).astype(np.float32),
           "b": rng.uniform(-s, s, (cfg.vocab_size,)).astype(np.float32)}
    return params_from_numpy({"embed": embed, "lstm": layers, "out": out},
                             device)


def init_lm_state(cfg, batch: int, device: str | torch.device = "cuda"):
    if isinstance(cfg, TransformerLMConfig):
        return init_transformer_lm_state(cfg, batch, device)
    return [(torch.zeros((batch, cfg.hidden), dtype=torch.float32,
                         device=device),
             torch.zeros((batch, cfg.hidden), dtype=torch.float32,
                         device=device))
            for _ in range(cfg.layers)]


def _out_logits(params: Params, cfg: LMConfig, x):
    return _dot(x, params["out"]["w"], cfg.cdtype) + params["out"]["b"].float()


def lm_forward(params: Params, cfg, labels):
    """Next-token logits over blank-prefixed labels.

    labels: (B, U) -> logits (B, U, V): position u predicts labels[:, u]
    from the prefix labels[:, :u] (u = 0 conditions on BOS only).
    """
    B = labels.shape[0]
    labels = labels.long()
    bos = torch.full((B, 1), BOS_ID, dtype=torch.long, device=labels.device)
    tokens_in = torch.cat([bos, labels[:, :-1]], dim=1)
    if isinstance(cfg, TransformerLMConfig):
        return transformer_lm_forward(params, cfg, tokens_in)
    x = params["embed"][tokens_in]
    for layer in params["lstm"]:
        x, _ = lstm_layer(layer, x, compute_dtype=cfg.cdtype)
    return _out_logits(params, cfg, x)


def lm_step(params: Params, cfg, token, states):
    """One decode step: token (B,) -> (next-token log-probs (B, V), new
    states). Feed `BOS_ID` for the first step."""
    if isinstance(cfg, TransformerLMConfig):
        return transformer_lm_step(params, cfg, token, states)
    x = params["embed"][token.long()]
    new_states = []
    for layer, (h, c) in zip(params["lstm"], states):
        x_proj = _dot(x, layer["w_ih"], cfg.cdtype) + layer["b"].float()
        h, c = lstm_cell(layer, x_proj, h, c, cfg.cdtype)
        new_states.append((h, c))
        x = h
    return torch.log_softmax(_out_logits(params, cfg, x), dim=-1), new_states


def lm_sequence_logprob(params: Params, cfg, labels, label_lens):
    """Total log P_lm of each label sequence: (B, U), (B,) -> (B,)."""
    logits = lm_forward(params, cfg, labels)
    lp = torch.log_softmax(logits, dim=-1)
    tok_lp = lp.gather(-1, labels.long()[..., None])[..., 0]  # (B, U)
    U = labels.shape[1]
    valid = (torch.arange(U, device=labels.device)[None, :]
             < label_lens.to(labels.device)[:, None])
    return torch.where(valid, tok_lp, torch.zeros_like(tok_lp)).sum(-1)


def rescore_nbest(lm_params, cfg, tokens, lens, am_scores, *,
                  weight: float, length_bonus: float = 0.0, extras=()):
    """Rerank an N-best list with one batched LM pass.

    tokens (B, K, U), lens (B, K), am_scores (B, K) -> (tokens, lens,
    scores) reordered by am + weight * log P_lm + length_bonus * len, best
    first (a stable sort, as `jnp.argsort`); `extras`, further (B, K, ...)
    beam-aligned arrays, are reordered the same way and appended.
    """
    B, K, U = tokens.shape
    lm_lp = lm_sequence_logprob(lm_params, cfg, tokens.reshape(B * K, U),
                                lens.reshape(B * K)).reshape(B, K)
    total = am_scores + weight * lm_lp + length_bonus * lens
    order = torch.argsort(-total, dim=-1, stable=True)

    def gather(a):
        idx = order.reshape(order.shape + (1,) * (a.dim() - 2))
        return a.gather(1, idx.expand((B, K) + a.shape[2:]))

    return (gather(tokens), lens.gather(1, order), total.gather(1, order),
            *(gather(e) for e in extras))
