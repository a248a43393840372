"""Two-pass RNN-T loss over materialised logits (port of `rnn_transducer_tpu/ops/rnnt_loss_pallas.py`).

The `loss_impl="pallas"` path: `m.joint` materialises the logits
(B, T, U+1, V), and two streaming passes over them do the rest:

  * `extract_lp` (K5, `csrc/loss_rows.cu`) reads every row of V logits
    once and writes only lp_blank and lp_y, (B, T, U+1) f32 each, where
    the xla path materialises a second lattice-sized log-softmax;
  * the alpha / beta recursions and the occupancies run on those small
    arrays through `ops/rnnt_loss.py` (the K3 lattice kernel on the card);
  * `assemble_grad` (K5) reads the logits once more and writes the
    gradient row by row, p occ - [v = blank] g_blank - [v = label] g_y,
    in the logits' dtype.

Each wrapper launches its kernel for a CUDA tensor and runs its
`*_reference` version, which materialises the log-softmax, for a CPU
tensor; it never falls back from one to the other, and counts the calls
that launched its kernel. The TPU version's row tiles and the padding of V
to 128 lanes have no counterpart: any V goes to the kernels.
"""

from __future__ import annotations

import threading

import torch

from rnn_transducer_tpu_torch.ops.rnnt_loss import (
    _gather_label_logprobs,
    _grad_from_occupancies,
    forward_from_lp_with_alpha,
    occupancies_from_lp,
)
from rnn_transducer_tpu_torch.utils import build

LAUNCHES_EXTRACT = 0  # extract_lp calls that launched extract_lp
LAUNCHES_GRAD = 0     # assemble_grad calls that launched assemble_grad
_launches_lock = threading.Lock()

_X_DTYPES = (torch.float32, torch.bfloat16)


def _count(name: str) -> None:
    with _launches_lock:
        globals()[name] += 1


def _check(logits, labels, blank: int, **rows):
    """logits (B, T, U+1, V) f32 or bf16, labels (B, U) int32, each of
    `rows` (B, T, U+1) f32; contiguous, on one device."""
    if logits.dim() != 4:
        raise ValueError(f"logits must be (B, T, U+1, V); got "
                         f"{tuple(logits.shape)}")
    B, T, U1, V = logits.shape
    if U1 < 1:
        raise ValueError("logits need at least one label position (U+1 >= 1)")
    if logits.dtype not in _X_DTYPES:
        raise TypeError(f"logits must be float32 or bfloat16; got "
                        f"{logits.dtype}")
    if tuple(labels.shape) != (B, U1 - 1):
        raise ValueError(f"labels must be ({B}, {U1 - 1}); got "
                         f"{tuple(labels.shape)}")
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be int32; got {labels.dtype}")
    if not 0 <= blank < V:
        raise ValueError(f"blank {blank} outside the vocabulary of {V}")
    for name, a in rows.items():
        if tuple(a.shape) != (B, T, U1):
            raise ValueError(f"{name} must be {(B, T, U1)}; got "
                             f"{tuple(a.shape)}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {a.dtype}")
    named = {"logits": logits, "labels": labels, **rows}
    if len({a.device for a in named.values()}) != 1:
        raise ValueError("inputs on different devices")
    for name, a in named.items():
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _require_cuda(dev: torch.device, what: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"no {what} for device {dev}")


def extract_lp(logits, labels, blank: int = 0):
    """-> (lp_blank, lp_y), each (B, T, U+1) f32, from logits (B, T, U+1, V)
    in f32 or bf16 and labels (B, U) int32 in [0, V); lp_y is NEG_INF at
    u = U."""
    _check(logits, labels, blank)
    dev = logits.device
    if dev.type == "cpu":
        return extract_lp_reference(logits, labels, blank)
    _require_cuda(dev, "extract_lp")
    B, T, U1, V = logits.shape
    lp_blank = torch.empty((B, T, U1), dtype=torch.float32, device=dev)
    lp_y = torch.empty_like(lp_blank)
    if lp_blank.numel() == 0:
        return lp_blank, lp_y
    fn = build.load_library()
    err = fn.extract_lp(logits.data_ptr(),
                        int(logits.dtype == torch.bfloat16),
                        labels.data_ptr(), lp_blank.data_ptr(),
                        lp_y.data_ptr(), B, T, U1, V, blank,
                        *build.stream_args(dev))
    build.check_launch(fn, err, "extract_lp")
    _count("LAUNCHES_EXTRACT")
    return lp_blank, lp_y


def extract_lp_reference(logits, labels, blank: int = 0):
    """Plain version of `extract_lp`: the log-softmax materialised, then
    two gathers."""
    _check(logits, labels, blank)
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    return (log_probs[..., blank].contiguous(),
            _gather_label_logprobs(log_probs, labels))


def assemble_grad(logits, labels, occ, g_blank, g_y, blank: int = 0):
    """d loss / d logits (B, T, U+1, V) in the logits' dtype, one pass:

        grad = softmax(logits) occ - [v = blank] g_blank - [v = label] g_y

    occ, g_blank, g_y (B, T, U+1) f32, already scaled by the loss cotangent
    (and g_y by 1 + lambda under FastEmit); occ = g_blank + g_y."""
    _check(logits, labels, blank, occ=occ, g_blank=g_blank, g_y=g_y)
    dev = logits.device
    if dev.type == "cpu":
        return assemble_grad_reference(logits, labels, occ, g_blank, g_y,
                                       blank)
    _require_cuda(dev, "assemble_grad")
    B, T, U1, V = logits.shape
    grad = torch.empty_like(logits)
    if grad.numel() == 0:
        return grad
    fn = build.load_library()
    err = fn.assemble_grad(logits.data_ptr(),
                           int(logits.dtype == torch.bfloat16),
                           labels.data_ptr(), occ.data_ptr(),
                           g_blank.data_ptr(), g_y.data_ptr(),
                           grad.data_ptr(), B, T, U1, V, blank,
                           *build.stream_args(dev))
    build.check_launch(fn, err, "assemble_grad")
    _count("LAUNCHES_GRAD")
    return grad


def assemble_grad_reference(logits, labels, occ, g_blank, g_y,
                            blank: int = 0):
    """Plain version of `assemble_grad`: the xla path's materialised
    formula (`_RNNTLoss.backward`)."""
    _check(logits, labels, blank, occ=occ, g_blank=g_blank, g_y=g_y)
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    return _grad_from_occupancies(log_probs, labels, occ, g_blank, g_y,
                                  blank).to(logits.dtype)


class _RNNTLossTwoPass(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, frame_lens, label_lens, blank,
                fastemit_lambda):
        x = logits.contiguous()
        lab = labels.to(torch.int32).contiguous()
        lpb, lpy = extract_lp(x, lab, blank)
        loss, alpha = forward_from_lp_with_alpha(lpb, lpy, frame_lens,
                                                 label_lens)
        ctx.save_for_backward(x, lab, frame_lens, label_lens, lpb, lpy, alpha)
        ctx.blank, ctx.fastemit = blank, fastemit_lambda
        return loss

    @staticmethod
    def backward(ctx, g):
        x, lab, frame_lens, label_lens, lpb, lpy, alpha = ctx.saved_tensors
        g_blank, g_y = occupancies_from_lp(lpb, lpy, frame_lens, label_lens,
                                           alpha=alpha)
        if ctx.fastemit:
            g_y = g_y * (1.0 + ctx.fastemit)
        s = g.float()[:, None, None]
        grad = assemble_grad(x, lab, ((g_blank + g_y) * s).contiguous(),
                             (g_blank * s).contiguous(),
                             (g_y * s).contiguous(), ctx.blank)
        return grad, None, None, None, None, None


def rnnt_loss_twopass(logits, labels, frame_lens, label_lens, blank: int = 0,
                      fastemit_lambda: float = 0.0):
    """Per-utterance RNN-T loss (B,) over materialised logits (B, T, U+1, V)
    in f32 or bf16, in two streaming passes over them (the JAX package's
    `rnnt_loss_pallas`). FastEmit scales the emit-arc occupancies of the
    gradient by (1 + lambda); the loss value is the exact NLL. The gradient
    is in the logits' dtype. alpha is saved for the backward, as the fused
    op does; the JAX version recomputes it, to the same values."""
    return _RNNTLossTwoPass.apply(logits, labels, frame_lens, label_lens,
                                  blank, fastemit_lambda)


def rnnt_loss_twopass_mean(logits, labels, frame_lens, label_lens,
                           blank: int = 0, fastemit_lambda: float = 0.0):
    """Batch-mean of `rnnt_loss_twopass` (the training objective)."""
    return rnnt_loss_twopass(logits, labels, frame_lens, label_lens, blank,
                             fastemit_lambda).mean()
