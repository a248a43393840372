"""The Transducer model, LSTM family (PyTorch port of
`rnn_transducer_tpu/models/transducer.py`).

Plain functions on tensors over a parameter dict in the JAX layout:
{"encoder": [lstm layer, ...], "embed": (V, E), "predictor": [lstm layer,
...], "joint": {"enc_proj", "pred_proj", "out": {"w": (in, out), "b"}}}.
This slice covers the inference path of greedy serving: `encode`,
`predict_step` and `joint_step`. Configurations outside it raise
NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from rnn_transducer_tpu_torch.models.config import TransducerConfig
from rnn_transducer_tpu_torch.ops.lstm import (
    _dot,
    lstm_cell,
    lstm_layer,
    mask_padding,
)

Params = dict[str, Any]


def check_supported(cfg: TransducerConfig) -> None:
    """Raise NotImplementedError for a config this port cannot run yet."""
    todo = []
    if cfg.enc_type != "lstm":
        todo.append(f"enc_type={cfg.enc_type!r} (ROADMAP queue 1, item 9: "
                    "conformer)")
    if cfg.bidirectional:
        todo.append("bidirectional (ROADMAP queue 1, item 6: BiLSTM)")
    if cfg.pred_type != "lstm":
        todo.append(f"pred_type={cfg.pred_type!r} (ROADMAP queue 1, item "
                    "12: stateless predictor)")
    if cfg.big_blank_durations:
        todo.append("big_blank_durations (ROADMAP queue 1, item 11: "
                    "duration families)")
    if cfg.tdt_durations:
        todo.append("tdt_durations (ROADMAP queue 1, item 11: duration "
                    "families)")
    if cfg.joint_experts > 0:
        todo.append("joint_experts (ROADMAP queue 1, item 16: MoE joint)")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))


def _uniform(rng: np.random.Generator, shape, k: float) -> np.ndarray:
    return rng.uniform(-k, k, size=shape).astype(np.float32)


def _init_lstm(rng, input_dim: int, hidden: int) -> dict[str, np.ndarray]:
    """Uniform(-1/sqrt(H), 1/sqrt(H)), as `init_lstm_params` (torch.nn.LSTM)."""
    k = 1.0 / math.sqrt(hidden)
    return {"w_ih": _uniform(rng, (input_dim, 4 * hidden), k),
            "w_hh": _uniform(rng, (hidden, 4 * hidden), k),
            "b": (_uniform(rng, (4 * hidden,), k)
                  + _uniform(rng, (4 * hidden,), k))}


def _init_linear(rng, in_dim: int, out_dim: int) -> dict[str, np.ndarray]:
    k = 1.0 / math.sqrt(in_dim)
    return {"w": _uniform(rng, (in_dim, out_dim), k),
            "b": _uniform(rng, (out_dim,), k)}


def init_params(cfg: TransducerConfig, rng: np.random.Generator,
                device: str | torch.device = "cpu") -> Params:
    """Fresh params with the JAX `init_params` distributions (LSTM family).

    The draws come from a numpy Generator, so they are not the JAX
    package's values for the same seed, only the same distributions.
    """
    from rnn_transducer_tpu_torch.weights import params_from_numpy

    check_supported(cfg)
    enc = []
    in_dim = cfg.input_dim
    for i in range(cfg.enc_layers):
        enc.append(_init_lstm(rng, in_dim, cfg.enc_hidden))
        in_dim = cfg.enc_hidden
        if i == 0 and cfg.time_reduction > 1:
            in_dim *= cfg.time_reduction
    embed = rng.standard_normal((cfg.vocab_size, cfg.embed_dim),
                                dtype=np.float32)
    pred = []
    pin = cfg.embed_dim
    for _ in range(cfg.pred_layers):
        pred.append(_init_lstm(rng, pin, cfg.pred_hidden))
        pin = cfg.pred_hidden
    joint = {
        "enc_proj": _init_linear(rng, cfg.enc_out_dim, cfg.joint_dim),
        "pred_proj": _init_linear(rng, cfg.pred_hidden, cfg.joint_dim),
        "out": _init_linear(rng, cfg.joint_dim, cfg.n_classes),
    }
    params = {"encoder": enc, "embed": embed, "predictor": pred,
              "joint": joint}
    if cfg.ctc_head:
        params["ctc_head"] = _init_linear(rng, cfg.enc_out_dim,
                                          cfg.vocab_size)
    if cfg.pruned_range > 0:
        params["simple"] = {
            "am": _init_linear(rng, cfg.enc_out_dim, cfg.vocab_size),
            "lm": _init_linear(rng, cfg.pred_hidden, cfg.vocab_size),
        }
    return params_from_numpy(params, device)


def _time_reduce(x, lens, factor: int):
    """Stack `factor` consecutive frames: (B, T, F) -> (B, T//factor, F*factor)."""
    B, T, F = x.shape
    T2 = T // factor
    x = x[:, : T2 * factor, :].reshape(B, T2, F * factor)
    lens = torch.clamp((lens.to(torch.int32) + factor - 1) // factor, max=T2)
    return x, lens


def encode(params: Params, cfg: TransducerConfig, feats, feat_lens):
    """feats: (B, T, input_dim) -> (enc_out (B, T', enc_out_dim), enc_lens).

    As in JAX, pad-region values between layers are garbage that stays in
    the pad region; the input to frame stacking and the output are masked.
    """
    check_supported(cfg)
    x = mask_padding(feats.float(), feat_lens)
    lens = feat_lens.to(torch.int32)
    cd = cfg.cdtype
    for i, layer in enumerate(params["encoder"]):
        x = lstm_layer(layer, x, compute_dtype=cd)[0]
        if i == 0 and cfg.time_reduction > 1:
            x = mask_padding(x, lens)
            x, lens = _time_reduce(x, lens, cfg.time_reduction)
    return mask_padding(x, lens), lens


def predict_step(params: Params, cfg: TransducerConfig, label, states):
    """Single step of the prediction network (for decoding).

    label: (B,) int (the last emitted label; blank id = start symbol).
    states: list per layer of (h, c) each (B, H). Returns (out (B, H), states').
    """
    check_supported(cfg)
    x = params["embed"][label]  # (B, E)
    new_states = []
    for layer, (h, c) in zip(params["predictor"], states):
        x_proj = _dot(x, layer["w_ih"], cfg.cdtype) + layer["b"].float()
        h, c = lstm_cell(layer, x_proj, h, c, cfg.cdtype)
        new_states.append((h, c))
        x = h
    return x, new_states


def init_pred_state(cfg: TransducerConfig, batch: int,
                    device: str | torch.device = "cpu"):
    check_supported(cfg)
    return [
        (torch.zeros((batch, cfg.pred_hidden), dtype=torch.float32,
                     device=device),
         torch.zeros((batch, cfg.pred_hidden), dtype=torch.float32,
                     device=device))
        for _ in range(cfg.pred_layers)
    ]


def joint_step(params: Params, cfg: TransducerConfig, enc_t, pred_u):
    """Joint for single (t, u) positions: enc_t (B, De), pred_u (B, Dp) -> (B, V) fp32."""
    jp = params["joint"]
    cd = cfg.cdtype
    f = _dot(enc_t, jp["enc_proj"]["w"], cd) + jp["enc_proj"]["b"].float()
    g = _dot(pred_u, jp["pred_proj"]["w"], cd) + jp["pred_proj"]["b"].float()
    z = torch.tanh(f + g)
    return _dot(z, jp["out"]["w"], cd) + jp["out"]["b"].float()
