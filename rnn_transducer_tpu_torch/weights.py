"""Weight bridge between the JAX package's params and the port's.

The port keeps the JAX params layout (a tree of dicts and lists), so the
bridge is leaf by leaf:

  * `params_from_numpy(tree, device)` takes the JAX params pytree with numpy
    leaves (`jax.tree.map(np.asarray, params)`) and returns the same tree of
    torch tensors on `device`; `params_to_numpy` is its inverse.
  * `load_state_dict(path, cfg, device)` reads the torch-layout `.pt` file
    that `tools/export_torch_ckpt.py` writes (nn.LSTM / nn.Linear naming)
    and undoes its transposes, so the port serves a trained model without
    jax.
"""

from __future__ import annotations

import numpy as np
import torch

from rnn_transducer_tpu_torch.models.config import TransducerConfig
from rnn_transducer_tpu_torch.models.transducer import check_supported


def params_from_numpy(tree, device: str | torch.device = "cpu"):
    """JAX params pytree with numpy leaves -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if type(tree).__name__ == "QTensor":
        raise NotImplementedError(
            "int8 params are not ported yet (ROADMAP queue 1, item 15: "
            "int8 serving)")
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


def _lstm_from_torch(sd, prefix: str, in_dim: int, H: int) -> dict:
    """Undo `_t_lstm`: w = weight.T, b = bias_ih + bias_hh."""
    return {
        "w_ih": _take(sd, f"{prefix}.weight_ih_l0", (4 * H, in_dim)).T,
        "w_hh": _take(sd, f"{prefix}.weight_hh_l0", (4 * H, H)).T,
        "b": (_take(sd, f"{prefix}.bias_ih_l0", (4 * H,))
              + _take(sd, f"{prefix}.bias_hh_l0", (4 * H,))),
    }


def _linear_from_torch(sd, prefix: str, in_dim: int, out_dim: int) -> dict:
    return {"w": _take(sd, f"{prefix}.weight", (out_dim, in_dim)).T,
            "b": _take(sd, f"{prefix}.bias", (out_dim,))}


def load_state_dict(path: str, cfg: TransducerConfig,
                    device: str | torch.device = "cpu"):
    """Read a `tools/export_torch_ckpt.py` state dict into port params,
    checking every tensor's shape against `cfg`."""
    check_supported(cfg)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    enc = []
    in_dim = cfg.input_dim
    for i in range(cfg.enc_layers):
        enc.append(_lstm_from_torch(sd, f"enc_layers.{i}", in_dim,
                                    cfg.enc_hidden))
        in_dim = cfg.enc_hidden * (cfg.time_reduction
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
