"""Training step (PyTorch port of `rnn_transducer_tpu/train/loop.py`).

The JAX package's training step: forward, RNN-T loss (`fused`, `pallas`
or `xla` over the full lattice; `pruned`, the k2 two-pass objective; and
`ar`, the alignment-restricted band, routed by `TrainConfig.ar_range`),
backward, the non-finite guard, the clip by the guard's global norm and
AdamW as `optax.adamw` with the repo's learning rate schedules, with
optional gradient accumulation as `optax.MultiSteps`.

The optimizer is written out here rather than taken from `torch.optim`,
so that it follows optax step for step: the schedule is evaluated at the
count before the update (the first update under warmup_cosine has
learning rate schedule(0) = 0), and a skipped non-finite update advances
`TrainState.step` but neither Adam's count nor the schedule's.

The options not ported yet (CTC multitask, the regularizers, data
parallelism) raise NotImplementedError naming their ROADMAP item. The
step is functional: it returns a new TrainState and leaves the one it was
given as it was.

The step's phases run under `torch.profiler.record_function` spans
(SPANS), which cost nothing measurable outside a profiler; a profile of a
step reads its host time per phase from them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

from rnn_transducer_tpu_torch.models import transducer as m
from rnn_transducer_tpu_torch.models.config import TrainConfig, TransducerConfig
from rnn_transducer_tpu_torch.ops.rnnt_align import (emit_frames_device,
                                                     rnnt_viterbi)
from rnn_transducer_tpu_torch.ops.rnnt_joint_fused import (fused_supported,
                                                          rnnt_loss_fused)
from rnn_transducer_tpu_torch.ops.rnnt_loss import (_gather_label_logprobs,
                                                   rnnt_loss)
from rnn_transducer_tpu_torch.ops.rnnt_loss_cuda import rnnt_loss_twopass
from rnn_transducer_tpu_torch.ops.rnnt_pruned import (alignment_bounds,
                                                      pruned_two_pass_loss,
                                                      rnnt_loss_pruned)

# optax.adamw's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
SPANS = ("encode", "predict", "align", "joint_loss", "backward", "optimizer")
# the CLI's choices, train.py's; "ar" is set by TrainConfig.ar_range
LOSS_IMPLS = ("auto", "fused", "pallas", "xla", "pruned")
_span = torch.profiler.record_function


@dataclasses.dataclass
class TrainState:
    """params: the model's tree of tensors. opt_state: {"count", "mu",
    "nu"} as optax's ScaleByAdamState (the schedule's count equals
    Adam's), wrapped as {"mini_step", "gradient_step", "acc_grads",
    "inner"} when grad_accum > 1, as optax.MultiStepsState. step: every
    call of the training step, skipped or not."""
    params: Any
    opt_state: Any
    step: int


def check_train_supported(tcfg: TrainConfig) -> None:
    """Raise NotImplementedError for a TrainConfig outside the port."""
    todo = []
    for field, item in (("dropout", "dropout"),
                        ("embed_dropout", "dropout"),
                        ("ema_decay", "EMA"),
                        ("weight_noise_std", "weight noise"),
                        ("distill_weight", "distillation")):
        if getattr(tcfg, field):
            todo.append(f"{field} (ROADMAP queue 1, item 13: training "
                        f"regularizers, {item})")
    if tcfg.ctc_weight:
        todo.append("ctc_weight (ROADMAP queue 1, item 8: CTC multitask)")
    if tcfg.loss_impl not in LOSS_IMPLS + ("ar",):
        raise ValueError(f"unknown loss_impl {tcfg.loss_impl!r}")
    if tcfg.data_parallel > 1:
        todo.append("data_parallel > 1 (ROADMAP queue 1, item 6: "
                    "data-parallel training)")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))


# ------------------------------ schedules --------------------------------

def make_lr_schedule(tcfg: TrainConfig):
    """count (int) -> learning rate, per TrainConfig.lr_schedule; the
    formulas of the JAX package's `make_lr_schedule` and of optax's
    warmup_cosine_decay_schedule."""
    peak, warm = tcfg.learning_rate, max(tcfg.warmup_steps, 1)
    if tcfg.lr_schedule == "warmup_cosine":
        wsteps = tcfg.warmup_steps
        decay = max(tcfg.total_steps, wsteps + 1) - wsteps
        alpha = 0.0 if peak == 0.0 else (peak * 0.05) / peak

        def warmup_cosine(count):
            if count < wsteps:  # optax linear_schedule from 0 to peak
                c = min(max(count, 0), wsteps)
                return (0.0 - peak) * (1 - c / wsteps) + peak
            c = min(float(count - wsteps), float(decay))
            cosine = 0.5 * (1 + math.cos(math.pi * c / decay))
            return peak * ((1 - alpha) * cosine + alpha)
        return warmup_cosine
    if tcfg.lr_schedule == "noam":
        def noam(count):
            s = max(float(count), 1.0)
            return peak * min(s / warm, math.sqrt(warm / s))
        return noam
    if tcfg.lr_schedule == "step_decay":
        def step_decay(count):
            s = float(count)
            return (peak * min(s / warm, 1.0)
                    * tcfg.decay_rate ** math.floor(s / tcfg.decay_every))
        return step_decay
    if tcfg.lr_schedule == "constant":
        return lambda count: peak * min(float(count) / warm, 1.0)
    raise ValueError(f"unknown lr_schedule {tcfg.lr_schedule!r}")


# ------------------------------ optimizer --------------------------------

def _zeros_like_tree(tree):
    return pytree.tree_map(torch.zeros_like, tree)


def init_opt_state(params, tcfg: TrainConfig):
    adam = {"count": 0, "mu": _zeros_like_tree(params),
            "nu": _zeros_like_tree(params)}
    if tcfg.grad_accum > 1:
        return {"mini_step": 0, "gradient_step": 0,
                "acc_grads": _zeros_like_tree(params), "inner": adam}
    return adam


def global_norm(leaves) -> torch.Tensor:
    """sqrt(sum of squares) over all leaves, as optax.global_norm."""
    return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in leaves))


def _clip(leaves, gnorm, c: float):
    """optax.clip_by_global_norm's arithmetic with a given norm."""
    trigger = gnorm < c
    return [torch.where(trigger, g, (g / gnorm.to(g.dtype)) * c)
            for g in leaves]


def _adamw(p_leaves, g_leaves, adam, tcfg: TrainConfig, schedule):
    """One optax.adamw update -> (new param leaves, new adam state)."""
    count = adam["count"] + 1
    bc1 = 1 - ADAM_B1 ** count
    bc2 = 1 - ADAM_B2 ** count
    lr = schedule(adam["count"])  # the schedule's count before the update
    mu_l = pytree.tree_leaves(adam["mu"])
    nu_l = pytree.tree_leaves(adam["nu"])
    new_p, new_mu, new_nu = [], [], []
    for p, g, mu, nu in zip(p_leaves, g_leaves, mu_l, nu_l):
        mu = (1 - ADAM_B1) * g + ADAM_B1 * mu
        nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
        if tcfg.weight_decay:
            upd = upd + tcfg.weight_decay * p
        new_p.append(p + (-lr) * upd)
        new_mu.append(mu)
        new_nu.append(nu)
    spec = pytree.tree_structure(adam["mu"])
    return new_p, {"count": count,
                   "mu": pytree.tree_unflatten(new_mu, spec),
                   "nu": pytree.tree_unflatten(new_nu, spec)}


def init_train_state(rng, cfg: TransducerConfig, tcfg: TrainConfig,
                     device: str | torch.device = "cuda",
                     params=None) -> TrainState:
    """Fresh TrainState: params from `m.init_params` with the numpy
    Generator `rng` (or the given tree of tensors), zero Adam moments."""
    check_train_supported(tcfg)
    if params is None:
        if not isinstance(rng, np.random.Generator):
            rng = np.random.default_rng(rng)
        params = m.init_params(cfg, rng, device)
    return TrainState(params=params, opt_state=init_opt_state(params, tcfg),
                      step=0)


# -------------------------------- loss -----------------------------------

def _resolve_loss_impl(loss_impl: str, device: torch.device,
                       cfg: TransducerConfig) -> str:
    """auto -> on CUDA fused where the fused kernels take the joint width,
    else the two-pass pallas loss; xla on the CPU. The JAX package picks
    the same by backend and its own gate (train/loop.py:276-283)."""
    if loss_impl != "auto":
        return loss_impl
    if device.type != "cuda":
        return "xla"
    return "fused" if fused_supported(cfg.joint_dim) else "pallas"


def loss_fn(params, cfg: TransducerConfig, feats, feat_lens, labels,
            label_lens, loss_impl: str = "auto", fastemit: float = 0.0,
            simple_loss_scale: float = 0.5, ar_range: int = 0,
            ar_left: int = -1, align_cfg=None, teacher_params=None):
    """Batch-mean RNN-T loss and the per-utterance losses (B,).

    "fused" never materialises the (B, T, U+1, V) logits (joint + loss in
    the K1 / K2 kernels, `ops/rnnt_joint_fused.py`); "pallas" materialises
    them and makes two streaming passes over them (the K5 kernels,
    `ops/rnnt_loss_cuda.py`); "xla" materialises them and their log-softmax
    (`ops/rnnt_loss.rnnt_loss`). "pruned" is the k2 objective, mean(pruned)
    + simple_loss_scale * mean(simple), with the joint on the band only
    (K6, `ops/rnnt_pruned.py`); the per-utterance losses are the pruned
    ones. "ar" is the banded loss around a Viterbi alignment of the
    aligner: `teacher_params` (of `align_cfg`) or, when None, the live
    model without gradient; the band keeps `ar_left` positions behind the
    aligned path (-1: centred) and spans ar_range. Every route runs its
    alpha / beta through the K3 lattice kernel on the card.
    """
    m.check_supported(cfg)
    impl = _resolve_loss_impl(loss_impl, feats.device, cfg)
    if impl not in ("fused", "pallas", "xla", "pruned", "ar"):
        raise ValueError(f"unknown loss_impl {loss_impl!r}")
    if impl == "ar" and ar_range <= 0:
        raise ValueError("loss_impl='ar' requires TrainConfig.ar_range > 0")
    if impl == "pruned" and cfg.pruned_range <= 0:
        raise ValueError("loss_impl='pruned' requires "
                         "TransducerConfig.pruned_range > 0")
    with _span("encode"):
        enc_out, enc_lens = m.encode(params, cfg, feats, feat_lens)
    with _span("predict"):
        pred_out, _ = m.predict(params, cfg, labels)
    if impl == "ar":
        with _span("align"), torch.no_grad():
            sb = _alignment_band(params if teacher_params is None
                                 else teacher_params,
                                 cfg if teacher_params is None else align_cfg,
                                 feats, feat_lens, labels, label_lens,
                                 enc_out.shape[1], enc_lens, ar_range,
                                 ar_left)
    with _span("joint_loss"):
        if impl in ("fused", "pruned", "ar"):
            f, g, w, b = m.joint_activations(params, cfg, enc_out, pred_out)
        if impl == "fused":
            per_utt = rnnt_loss_fused(f, g, w, b, labels, enc_lens,
                                      label_lens, cfg.blank, cfg.cdtype,
                                      fastemit)
        elif impl == "ar":
            per_utt = rnnt_loss_pruned(f, g, w, b, labels, enc_lens,
                                       label_lens, sb, ar_range, cfg.blank,
                                       cfg.cdtype, fastemit)
        elif impl == "pruned":
            simple_pu, per_utt, _ = pruned_two_pass_loss(
                params["simple"], f, g, w, b, enc_out, pred_out, labels,
                enc_lens, label_lens, cfg.pruned_range, cfg.blank,
                cfg.cdtype, fastemit)
            return (per_utt.mean() + simple_loss_scale * simple_pu.mean(),
                    per_utt)
        else:
            logits = m.joint(params, cfg, enc_out, pred_out)
            loss_op = rnnt_loss_twopass if impl == "pallas" else rnnt_loss
            per_utt = loss_op(logits, labels, enc_lens, label_lens,
                              cfg.blank, fastemit)
    return per_utt.mean(), per_utt


def _alignment_band(a_params, a_cfg, feats, feat_lens, labels, label_lens,
                    T: int, enc_lens, ar_range: int, ar_left: int):
    """The AR band's window starts (B, T) from the aligner's Viterbi path
    over its materialised lattice (JAX loss_fn :233-249); the aligner runs
    without dropout, so the band does not jitter."""
    a_logits, a_lens = m.forward(a_params, a_cfg, feats, feat_lens, labels)
    lp = torch.log_softmax(a_logits.float(), dim=-1)
    _, K = rnnt_viterbi(lp[..., a_cfg.blank],
                        _gather_label_logprobs(lp, labels), a_lens,
                        label_lens)
    emit = emit_frames_device(K, a_lens, label_lens)
    return alignment_bounds(emit, T, ar_range, enc_lens, label_lens,
                            labels.shape[1] + 1,
                            left_labels=None if ar_left < 0 else ar_left)


def check_ar_compat(cfg: TransducerConfig, align_cfg: TransducerConfig):
    """Raise unless the aligner's lattice grid matches the student's: its
    Viterbi emit frames index the student's encoder frames directly (JAX
    `check_ar_compat` :390)."""
    for field in ("vocab_size", "blank", "time_reduction"):
        a, b = getattr(cfg, field), getattr(align_cfg, field)
        if a != b:
            raise ValueError(f"ar alignment needs aligner {field} == "
                             f"student {field} (aligner {b}, student {a})")
    if cfg.tdt_durations or cfg.big_blank_durations or \
            align_cfg.tdt_durations or align_cfg.big_blank_durations:
        raise ValueError("alignment-restricted training supports standard "
                         "transducers (no TDT / multi-blank joint grids)")


# -------------------------------- steps ----------------------------------

def make_train_step(cfg: TransducerConfig, tcfg: TrainConfig, mesh=None,
                    teacher_cfg=None):
    """Build the training step:
    step(state, feats, feat_lens, labels, label_lens) -> (state', metrics)
    with metrics {"loss", "grad_norm", "skipped_nonfinite"} as tensors.

    With ar_range > 0 the loss is the alignment-restricted band (JAX
    make_train_step :441-456); given `teacher_cfg`, the aligner is a
    checkpoint of that config and the step takes its params as a sixth
    argument, `teacher_params`, else the live model aligns itself."""
    if mesh is not None:
        raise NotImplementedError("not ported yet: mesh (ROADMAP queue 1, "
                                  "item 6: data-parallel training)")
    ar = tcfg.ar_range > 0
    if ar:
        if tcfg.distill_weight > 0.0:
            raise ValueError("ar_range and distill_weight are mutually "
                             "exclusive (one teacher slot)")
        if tcfg.loss_impl not in ("auto", "ar"):
            raise ValueError("ar_range > 0 trains with loss_impl='auto'|"
                             f"'ar' (got {tcfg.loss_impl!r})")
        if teacher_cfg is not None:
            check_ar_compat(cfg, teacher_cfg)
    check_train_supported(tcfg)
    m.check_supported(cfg)
    schedule = make_lr_schedule(tcfg)
    k = tcfg.grad_accum
    loss_kw = dict(loss_impl=tcfg.loss_impl, fastemit=tcfg.fastemit_lambda,
                   simple_loss_scale=tcfg.simple_loss_scale)
    if ar:
        loss_kw.update(loss_impl="ar", ar_range=tcfg.ar_range,
                       ar_left=tcfg.ar_left, align_cfg=teacher_cfg)
    uses_teacher = ar and teacher_cfg is not None

    def step_fn(state: TrainState, feats, feat_lens, labels, label_lens,
                teacher_params=None):
        if uses_teacher and teacher_params is None:
            raise ValueError("this step aligns with a checkpoint: pass its "
                             "params as teacher_params")
        p_leaves, spec = pytree.tree_flatten(state.params)
        leaves = [p.detach().requires_grad_(True) for p in p_leaves]
        loss, _ = loss_fn(pytree.tree_unflatten(leaves, spec), cfg, feats,
                          feat_lens, labels, label_lens,
                          teacher_params=(teacher_params if uses_teacher
                                          else None), **loss_kw)
        with _span("backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if gr is None else gr
                 for p, gr in zip(p_leaves, grads)]
        loss = loss.detach()
        gnorm = global_norm(grads)
        ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "skipped_nonfinite": torch.tensor(int(not ok))}
        if not ok:  # skip: params and opt_state (Adam's count) unchanged
            return dataclasses.replace(state, step=state.step + 1), metrics
        with torch.no_grad(), _span("optimizer"):
            if k == 1:
                new_p, opt_state = _adamw(
                    p_leaves, _clip(grads, gnorm, tcfg.grad_clip_norm),
                    state.opt_state, tcfg, schedule)
            else:
                new_p, opt_state = _multi_steps(p_leaves, grads,
                                                state.opt_state, tcfg,
                                                schedule)
        return TrainState(params=pytree.tree_unflatten(new_p, spec),
                          opt_state=opt_state, step=state.step + 1), metrics

    return step_fn


def _multi_steps(p_leaves, grads, ms, tcfg: TrainConfig, schedule):
    """optax.MultiSteps over chain(clip_by_global_norm, adamw): the running
    mean of the gradients (Welford); on every k-th call the clip of the
    mean and one AdamW update, else the params stay."""
    n = ms["mini_step"]
    acc_spec = pytree.tree_structure(ms["acc_grads"])
    acc = [a + (g - a) / (n + 1)
           for a, g in zip(pytree.tree_leaves(ms["acc_grads"]), grads)]
    if n < tcfg.grad_accum - 1:
        return p_leaves, {**ms, "mini_step": n + 1,
                          "acc_grads": pytree.tree_unflatten(acc, acc_spec)}
    clipped = _clip(acc, global_norm(acc), tcfg.grad_clip_norm)
    new_p, inner = _adamw(p_leaves, clipped, ms["inner"], tcfg, schedule)
    return new_p, {"mini_step": 0, "gradient_step": ms["gradient_step"] + 1,
                   "acc_grads": _zeros_like_tree(ms["acc_grads"]),
                   "inner": inner}


def make_eval_step(cfg: TransducerConfig):
    """eval(params, feats, feat_lens, labels, label_lens) -> (loss, per_utt)
    without gradients."""
    def eval_fn(params, feats, feat_lens, labels, label_lens):
        with torch.no_grad():
            return loss_fn(params, cfg, feats, feat_lens, labels, label_lens)
    return eval_fn
