"""Post-training int8 weight quantization for serving (PyTorch port of
`rnn_transducer_tpu/ops/quant.py`).

Symmetric per-channel int8 storage, a load-time transform (`serve.py
--quantize int8`); checkpoints stay fp32 and training never sees it:

    w ≈ q * scale,   q int8,  scale = amax(|w|, channel) / 127

A quantized tree swaps every 2-D float leaf for a `QTensor(q, scale)`.
`models/transducer.py` dequantizes at its entry points
(`maybe_dequant_tree`); `encode` keeps `w_hh` quantized so that the
encoder's LSTM layers can run the W8A8 recurrence (`ops/lstm.py`, the CUDA
kernel `csrc/lstm_fwd_q.cu`).

Channel axes: matmul weights (in, out) scale per OUTPUT channel (axis -1);
a leaf whose key contains "embed" (the (V, E) table) per ROW (axis 0).
1-D leaves (biases) stay fp32. The rounding is round half to even, as
`jnp.round`, so `q` and `scale` are bit-equal to the JAX package's on the
same weights.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QTensor(NamedTuple):
    """Symmetric per-channel int8 tensor: ``w ≈ q * scale`` (scale is
    broadcast-shaped float32, 1 everywhere except the channel axis)."""
    q: torch.Tensor      # int8, w.shape
    scale: torch.Tensor  # float32


def quantize_tensor(w: torch.Tensor, channel_axis: int = -1) -> QTensor:
    """Symmetric int8 quantization with a scale per `channel_axis` slice."""
    w32 = w.float()
    axes = tuple(a for a in range(w32.dim()) if a != channel_axis % w32.dim())
    amax = w32.abs().amax(dim=axes, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127)
    return QTensor(q=q.to(torch.int8), scale=scale)


def dequantize_tensor(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    return (qt.q.float() * qt.scale).to(dtype)


def _map(fn, tree, key: str = ""):
    """fn(key, leaf) over a tree of dicts and lists; `key` is the name of
    the leaf's own dict key (a list index for list items), as
    `keystr(path[-1:])` in the JAX package. QTensors are leaves."""
    if isinstance(tree, QTensor):
        return fn(key, tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, str(i)) for i, v in enumerate(tree))
    return fn(key, tree)


def _leaves(tree) -> list:
    out = []
    _map(lambda _, leaf: out.append(leaf), tree)
    return out


def quantize_params(params, *, min_size: int = 0):
    """Quantize every 2-D floating weight leaf of a model params tree.

    min_size: skip leaves with fewer elements (0 quantizes everything).
    """
    def walk(key, leaf):
        if (not isinstance(leaf, torch.Tensor) or leaf.dim() != 2
                or not leaf.is_floating_point() or leaf.numel() < min_size):
            return leaf
        # embedding tables are row-gathered: scale per vocab row
        return quantize_tensor(leaf, channel_axis=0 if "embed" in key else -1)

    return _map(walk, params)


def maybe_dequant_tree(params, dtype=torch.float32, *, keep=()):
    """Dequantize every QTensor leaf; the same tree when none is quantized.

    keep: leaf names (dict keys) whose QTensors stay quantized; `encode`
    keeps "w_hh" for the W8A8 recurrence.
    """
    if not any(isinstance(x, QTensor) for x in _leaves(params)):
        return params

    def walk(key, x):
        if not isinstance(x, QTensor) or any(k in key for k in keep):
            return x
        return dequantize_tensor(x, dtype)

    return _map(walk, params)


def quantized_bytes(params) -> tuple[int, int]:
    """(bytes of the quantized tree, bytes of the same tree in fp32)."""
    qb = fb = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QTensor):
            qb += leaf.q.numel() + leaf.scale.numel() * 4
            fb += leaf.q.numel() * 4
        else:
            qb += leaf.numel() * leaf.element_size()
            fb += leaf.numel() * 4
    return qb, fb
