"""Weight bridge between the JAX package's params and the port's.

The port keeps the JAX params layout (a tree of dicts and lists), so the
bridge is leaf by leaf:

  * `params_from_numpy(tree, device)` takes the JAX params pytree with numpy
    leaves (`jax.tree.map(np.asarray, params)`) and returns the same tree of
    torch tensors on `device`; `params_to_numpy` is its inverse. Every
    branch of the tree crosses alike: the LSTM or stateless predictor, the
    CTC head, the pruned loss's simple heads, the TDT duration head. An int8
    leaf of a quantized tree (the JAX package's `QTensor`, a NamedTuple
    with fields `q` and `scale`) becomes the port's `ops.quant.QTensor`
    and back, bit for bit.
  * `load_state_dict(path, cfg, device)` reads the torch-layout `.pt` file
    that `tools/export_torch_ckpt.py` writes (nn.LSTM / nn.Linear naming)
    and undoes its transposes, so the port serves a trained model without
    jax; a BiLSTM layer's `_reverse` keys become its "bwd" dict. A
    multi-blank joint's `out` is n_classes wide there too; a TDT model and
    an MoE joint are refused, as the exporter writes neither the duration
    head nor the experts.

The fusion LMs' params (the LSTM LM's {"embed", "lstm", "out"}, the
transformer LM's {"embed", "pos", "blocks", "ln_f", "out"}) are trees of
the same kind and cross with `params_from_numpy` too. The n-gram and
context-biasing tables cross with `ngram_from_numpy` and
`context_from_numpy`: any object with the JAX NamedTuples' fields and
array-like tables (`jax.tree.map(np.asarray, ...)` of them, or the
JAX NamedTuples themselves) becomes the port's NamedTuple on `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from rnn_transducer_tpu_torch.models.config import TransducerConfig
from rnn_transducer_tpu_torch.models.transducer import check_supported
from rnn_transducer_tpu_torch.ops.quant import QTensor


def _is_qtensor(tree) -> bool:
    """A QTensor of either package: a NamedTuple with fields q, scale."""
    return getattr(tree, "_fields", None) == QTensor._fields


def params_from_numpy(tree, device: str | torch.device = "cpu"):
    """JAX params pytree with numpy leaves -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if _is_qtensor(tree):
        return QTensor(*(params_from_numpy(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(tree, copy=True, order="C")).to(
            device)
    raise TypeError(f"unexpected params leaf {type(tree).__name__}")


def params_to_numpy(tree):
    """Inverse of `params_from_numpy`."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if _is_qtensor(tree):
        return QTensor(*(params_to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    raise TypeError(f"unexpected params leaf {type(tree).__name__}")


def _take(sd: dict, key: str, shape: tuple) -> np.ndarray:
    if key not in sd:
        raise KeyError(f"state dict has no {key!r}")
    a = sd[key].detach().cpu().float().numpy()
    if a.shape != shape:
        raise ValueError(f"{key}: shape {a.shape}, config wants {shape}")
    return a


def _lstm_from_torch(sd, prefix: str, in_dim: int, H: int,
                     suffix: str = "") -> dict:
    """Undo `_t_lstm`: w = weight.T, b = bias_ih + bias_hh; suffix
    "_reverse" reads a BiLSTM layer's backward direction, as nn.LSTM
    names it."""
    return {
        "w_ih": _take(sd, f"{prefix}.weight_ih_l0{suffix}",
                      (4 * H, in_dim)).T,
        "w_hh": _take(sd, f"{prefix}.weight_hh_l0{suffix}", (4 * H, H)).T,
        "b": (_take(sd, f"{prefix}.bias_ih_l0{suffix}", (4 * H,))
              + _take(sd, f"{prefix}.bias_hh_l0{suffix}", (4 * H,))),
    }


def _linear_from_torch(sd, prefix: str, in_dim: int, out_dim: int) -> dict:
    return {"w": _take(sd, f"{prefix}.weight", (out_dim, in_dim)).T,
            "b": _take(sd, f"{prefix}.bias", (out_dim,))}


def load_state_dict(path: str, cfg: TransducerConfig,
                    device: str | torch.device = "cuda"):
    """Read a `tools/export_torch_ckpt.py` state dict into port params on
    `device`, checking every tensor's shape against `cfg`."""
    check_supported(cfg)
    if cfg.enc_type != "lstm":
        raise NotImplementedError(
            f"enc_type={cfg.enc_type!r}: tools/export_torch_ckpt.py writes "
            "only LSTM encoders, so there is no torch-layout state dict of "
            "one to read; carry JAX params over with params_from_numpy")
    if cfg.pred_type != "lstm":
        raise NotImplementedError(
            f"pred_type={cfg.pred_type!r}: tools/export_torch_ckpt.py:57-59 "
            "writes only LSTM predictors, so there is no torch-layout state "
            "dict of one to read; carry JAX params over with "
            "params_from_numpy")
    if cfg.tdt_durations:
        raise NotImplementedError(
            "tdt_durations: tools/export_torch_ckpt.py writes no TDT "
            "duration head (joint.dur), so there is no torch-layout state "
            "dict of one to read (ROADMAP queue 1, item 18: tools); carry "
            "JAX params over with params_from_numpy")
    if cfg.joint_experts > 0:
        raise NotImplementedError(
            "joint_experts: tools/export_torch_ckpt.py writes no MoE "
            "leaves (moe), so there is no torch-layout state dict of one "
            "to read (ROADMAP queue 1, item 18: tools); carry JAX params "
            "over with params_from_numpy")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    enc = []
    in_dim = cfg.input_dim
    for i in range(cfg.enc_layers):
        layer = [_lstm_from_torch(sd, f"enc_layers.{i}", in_dim,
                                  cfg.enc_hidden, sfx)
                 for sfx in (("", "_reverse") if cfg.bidirectional
                             else ("",))]
        enc.append(dict(zip(("fwd", "bwd"), layer)) if cfg.bidirectional
                   else layer[0])
        # the next layer reads H, or 2H from a BiLSTM, stacked after
        # layer 0
        in_dim = cfg.enc_out_dim * (cfg.time_reduction
                                    if i == 0 and cfg.time_reduction > 1
                                    else 1)
    pred = []
    pin = cfg.embed_dim
    for i in range(cfg.pred_layers):
        pred.append(_lstm_from_torch(sd, f"pred_layers.{i}", pin,
                                     cfg.pred_hidden))
        pin = cfg.pred_hidden
    params = {
        "encoder": enc,
        "embed": _take(sd, "embed.weight", (cfg.vocab_size, cfg.embed_dim)),
        "predictor": pred,
        "joint": {
            "enc_proj": _linear_from_torch(sd, "enc_proj", cfg.enc_out_dim,
                                           cfg.joint_dim),
            "pred_proj": _linear_from_torch(sd, "pred_proj", cfg.pred_hidden,
                                            cfg.joint_dim),
            "out": _linear_from_torch(sd, "out", cfg.joint_dim,
                                      cfg.n_classes),
        },
    }
    return params_from_numpy(params, device)


def ngram_from_numpy(lm, device: str | torch.device = "cpu"):
    """A JAX package NgramLM (lp, next_state, start) -> the port's."""
    from rnn_transducer_tpu_torch.models.ngram import NgramLM

    return NgramLM(torch.from_numpy(np.array(lm.lp, np.float32)),
                   torch.from_numpy(np.array(lm.next_state, np.int32)),
                   int(lm.start)).to(device)


def context_from_numpy(bias, device: str | torch.device = "cpu"):
    """A JAX package ContextBias (next_node, delta, accum) -> the port's."""
    from rnn_transducer_tpu_torch.decode.context import ContextBias

    return ContextBias(torch.from_numpy(np.array(bias.next_node, np.int32)),
                       torch.from_numpy(np.array(bias.delta, np.float32)),
                       torch.from_numpy(np.array(bias.accum, np.float32))
                       ).to(device)
