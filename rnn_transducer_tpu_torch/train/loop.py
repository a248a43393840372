"""Training step (PyTorch port of `rnn_transducer_tpu/train/loop.py`).

The JAX package's training step: forward, RNN-T loss (`fused`, `pallas`
or `xla` over the full lattice; `pruned`, the k2 two-pass objective; and
`ar`, the alignment-restricted band, routed by `TrainConfig.ar_range`),
backward, the non-finite guard, the clip by the guard's global norm and
AdamW as `optax.adamw` with the repo's learning rate schedules, with
optional gradient accumulation as `optax.MultiSteps`; and the training
regularizers: dropout between the LSTM layers and on the label
embeddings, Graves weight noise (gradients taken at params + noise, the
update applied to the clean params) and a Polyak average of the params
(`TrainState.ema`), whose draws come from train/regularizers.py.

The optimizer is written out here rather than taken from `torch.optim`,
so that it follows optax step for step: the schedule is evaluated at the
count before the update (the first update under warmup_cosine has
learning rate schedule(0) = 0), and a skipped non-finite update advances
`TrainState.step` but neither Adam's count nor the schedule's.

The duration families (multi-blank, TDT) train on the `xla` route alone,
over their consumed-frames lattices (`ops/rnnt_multiblank.py`,
`ops/rnnt_tdt.py`), whatever `auto` picks for the standard model. An
MoE joint (`ops/moe.py`) trains over the routed joint's materialised
logits, `pallas` on the two-pass loss and every other route on the xla
loss (`moe_route`), with the router's load-balance loss added; the
model-parallel sp and ep steps are parallel/tp.py's.

Three more objectives share the step: CTC on the encoder's auxiliary
head (`make_train_step(loss_kind="ctc")`, `ctc_loss_fn`: the
pretraining phase of the CLI's --ctc-pretrain-steps), lattice distillation
(`distill_loss_fn`, TrainConfig.distill_weight: the RNN-T loss plus a
KL(teacher || student) of the temperature-softened joint posteriors,
from a teacher checkpoint's forward under no_grad, always over
materialised logits at the `xla` tier) and MWER fine-tuning
(`make_train_step(loss_kind="mwer")`, train/mwer.py: the expected edit
count over the live beam N-best). TrainConfig.ctc_weight adds that
weight times the CTC loss to the RNN-T loss of every route (`loss_fn`'s
with_ctc, on the one encoder pass): the per-utterance losses are the
combined ones.

Under a data-parallel mesh (`parallel/mesh.py`) each rank computes the
loss and gradients of its shard, and one all-reduce of a flat f32 buffer
averages them (JAX's `pmean` in its `shard_map` step); the guard, clip
and AdamW then run on every rank alike, so the ranks keep equal params.
The fused, pruned and AR losses on the card above the rings' joint width
raise NotImplementedError naming their ROADMAP item (6(b)). The step is
functional: it returns a new TrainState and leaves the one it was given
as it was.

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
import torch.distributed as dist
from torch.utils import _pytree as pytree

from rnn_transducer_tpu_torch.models import transducer as m
from rnn_transducer_tpu_torch.models.config import TrainConfig, TransducerConfig
from rnn_transducer_tpu_torch.ops import moe
from rnn_transducer_tpu_torch.ops.ctc_loss import ctc_loss_from_logits
from rnn_transducer_tpu_torch.ops.rnnt_align import (emit_frames_device,
                                                     rnnt_viterbi)
from rnn_transducer_tpu_torch.ops.rnnt_joint_fused import (MAX_J,
                                                          fused_supported,
                                                          rnnt_loss_fused)
from rnn_transducer_tpu_torch.ops.rnnt_loss import (_gather_label_logprobs,
                                                   rnnt_loss)
from rnn_transducer_tpu_torch.ops.rnnt_loss_cuda import rnnt_loss_twopass
from rnn_transducer_tpu_torch.ops.rnnt_pruned import (alignment_bounds,
                                                      pruned_two_pass_loss,
                                                      rnnt_loss_pruned)
from rnn_transducer_tpu_torch.train.mwer import (mwer_loss_fn,
                                                 sequence_nll)
from rnn_transducer_tpu_torch.train.regularizers import (DropoutMasks,
                                                         leaf_paths,
                                                         weight_noise)

# optax.adamw's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
SPANS = ("encode", "predict", "align", "teacher", "joint_loss", "ctc",
         "duration_lattice", "backward", "ctc_backward",
         "duration_lattice_backward", "all_reduce",
         "optimizer") + moe.SPANS
# the CLI's choices, train.py's; "ar" is set by TrainConfig.ar_range
LOSS_IMPLS = ("auto", "fused", "pallas", "xla", "pruned")
_span = torch.profiler.record_function


@dataclasses.dataclass
class TrainState:
    """params: the model's tree of tensors. opt_state: {"count", "mu",
    "nu"} as optax's ScaleByAdamState (the schedule's count equals
    Adam's), wrapped as {"mini_step", "gradient_step", "acc_grads",
    "inner"} when grad_accum > 1, as optax.MultiStepsState. step: every
    call of the training step, skipped or not. ema: the Polyak average of
    the params when TrainConfig.ema_decay > 0, else None."""
    params: Any
    opt_state: Any
    step: int
    ema: Any = None


def check_train_supported(tcfg: TrainConfig) -> None:
    """Raise ValueError for a TrainConfig the step does not know."""
    if tcfg.loss_impl not in LOSS_IMPLS + ("ar",):
        raise ValueError(f"unknown loss_impl {tcfg.loss_impl!r}")


def _check_ctc_weight(cfg: TransducerConfig, ctc_weight: float) -> None:
    """JAX loss_fn :138-139."""
    if ctc_weight and cfg.joint_experts > 0:
        raise ValueError("ctc_weight with an MoE joint is not supported")


def check_moe(cfg: TransducerConfig, loss_impl: str) -> None:
    """An MoE joint trains on the routed joint's materialised logits: the
    alignment-restricted band refuses it (JAX loss_fn :197-199), and so
    does a duration family (multi-blank; TDT is refused at init), whose
    lattices the port does not run through the experts."""
    if cfg.joint_experts <= 0:
        return
    if loss_impl == "ar":
        raise ValueError("alignment-restricted training (ar_range) does "
                         "not support an MoE joint")
    if cfg.big_blank_durations or cfg.tdt_durations:
        raise ValueError("an MoE joint with the duration families "
                         "(big_blank_durations, tdt_durations) is not "
                         "supported")


def moe_route(loss_impl: str) -> str:
    """The loss route of an MoE model (JAX loss_fn :204-206): the routed
    joint's logits are materialised, so `pallas` takes the two-pass loss
    and every other route (auto, fused, pruned, xla) the xla loss; off
    the TPU, JAX's `select_rnnt_loss` resolves pruned to xla too."""
    return "pallas" if loss_impl == "pallas" else "xla"


def check_duration_route(cfg: TransducerConfig, loss_impl: str,
                         fastemit: float) -> None:
    """The duration families train at the xla tier only (JAX loss_fn
    :163-169, :182-188): the fused, two-pass, pruned and AR routes and
    FastEmit do not model the jump arcs."""
    what = ("TDT" if cfg.tdt_durations else "multi-blank"
            if cfg.big_blank_durations else None)
    if what is None:
        return
    if loss_impl not in ("auto", "xla"):
        raise ValueError(f"{what} models train with loss_impl='auto'|'xla' "
                         f"(got {loss_impl!r})")
    if fastemit:
        raise ValueError(f"fastemit_lambda is not supported with {what} "
                         "models")


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
    Generator `rng` (or the given tree of tensors), zero Adam moments, and
    with ema_decay > 0 an EMA that starts as a copy of the params."""
    check_train_supported(tcfg)
    if params is None:
        if not isinstance(rng, np.random.Generator):
            rng = np.random.default_rng(rng)
        params = m.init_params(cfg, rng, device)
    ema = (pytree.tree_map(torch.clone, params) if tcfg.ema_decay > 0
           else None)
    return TrainState(params=params, opt_state=init_opt_state(params, tcfg),
                      step=0, ema=ema)


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
            ar_left: int = -1, align_cfg=None, teacher_params=None,
            dropout: float = 0.0, embed_dropout: float = 0.0, drop=None,
            ctc_weight: float = 0.0):
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
    alpha / beta through the K3 lattice kernel on the card. dropout and
    embed_dropout act when a mask source `drop` is given
    (regularizers.DropoutMasks); the AR aligner runs without them.
    ctc_weight > 0 (with cfg.ctc_head) adds ctc_weight times the CTC loss
    of the encoder's auxiliary head, on the same encoder output, to every
    route's per-utterance losses (JAX `with_ctc`, :141-150). A duration
    family (multi-blank or TDT) takes the xla route whatever `auto` would
    pick: its materialised logits (`joint`, or `joint_tdt` with the
    duration logits) and its loss on the consumed-frames lattice
    (train/mwer.sequence_nll); any other loss_impl, and fastemit, raise.
    An MoE joint (cfg.joint_experts > 0) materialises the routed joint's
    logits (`m.joint(with_aux=True)`) on the route of `moe_route`, and the
    loss is mean(per_utt) + cfg.moe_aux_weight * aux, the router's
    load-balance term (JAX :196-210); ar and ctc_weight refuse it.
    """
    _check_ctc_weight(cfg, ctc_weight)
    m.check_supported(cfg)
    check_moe(cfg, loss_impl)
    duration = bool(cfg.tdt_durations or cfg.big_blank_durations)
    if duration:  # before any route is chosen: auto is xla here
        check_duration_route(cfg, loss_impl, fastemit)
        loss_impl = "xla"
    experts = cfg.joint_experts > 0
    if experts:
        loss_impl = moe_route(loss_impl)
    impl = _resolve_loss_impl(loss_impl, feats.device, cfg)
    if impl not in ("fused", "pallas", "xla", "pruned", "ar"):
        raise ValueError(f"unknown loss_impl {loss_impl!r}")
    if impl == "ar" and ar_range <= 0:
        raise ValueError("loss_impl='ar' requires TrainConfig.ar_range > 0")
    if impl == "pruned" and cfg.pruned_range <= 0:
        raise ValueError("loss_impl='pruned' requires "
                         "TransducerConfig.pruned_range > 0")
    with _span("encode"):
        enc_out, enc_lens = m.encode(params, cfg, feats, feat_lens,
                                     dropout=dropout, drop=drop)
    with _span("predict"):
        pred_out, _ = m.predict(params, cfg, labels, dropout=dropout,
                                embed_dropout=embed_dropout, drop=drop)
    if impl == "ar":
        with _span("align"), torch.no_grad():
            sb = _alignment_band(params if teacher_params is None
                                 else teacher_params,
                                 cfg if teacher_params is None else align_cfg,
                                 feats, feat_lens, labels, label_lens,
                                 enc_out.shape[1], enc_lens, ar_range,
                                 ar_left)

    def with_ctc(per_utt):
        if not ctc_weight:
            return per_utt
        with _span("ctc"):
            return per_utt + ctc_weight * ctc_loss_from_logits(
                m.ctc_logits(params, cfg, enc_out), labels, enc_lens,
                label_lens, cfg.blank)

    with _span("joint_loss"):
        if impl in ("fused", "pruned", "ar"):
            f, g, w, b = m.joint_activations(params, cfg, enc_out, pred_out)
        if duration:
            per_utt = sequence_nll(params, cfg, enc_out, pred_out, labels,
                                   enc_lens, label_lens)
        elif impl == "fused":
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
        else:
            logits, aux = m.joint(params, cfg, enc_out, pred_out,
                                  with_aux=True)
            loss_op = rnnt_loss_twopass if impl == "pallas" else rnnt_loss
            per_utt = loss_op(logits, labels, enc_lens, label_lens,
                              cfg.blank, fastemit)
    per_utt = with_ctc(per_utt)
    if impl == "pruned":
        return (per_utt.mean() + simple_loss_scale * simple_pu.mean(),
                per_utt)
    if experts:
        return per_utt.mean() + cfg.moe_aux_weight * aux, per_utt
    return per_utt.mean(), per_utt


def ctc_loss_fn(params, cfg: TransducerConfig, feats, feat_lens, labels,
                label_lens):
    """Batch-mean CTC loss of the encoder's auxiliary head and the
    per-utterance losses (JAX `ctc_loss_fn` :306): the pretraining
    objective, with neither the predictor nor the joint."""
    m.check_supported(cfg)
    with _span("encode"):
        enc_out, enc_lens = m.encode(params, cfg, feats, feat_lens)
    with _span("ctc"):
        per_utt = ctc_loss_from_logits(m.ctc_logits(params, cfg, enc_out),
                                       labels, enc_lens, label_lens,
                                       cfg.blank)
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


def distill_loss_fn(params, teacher_params, cfg: TransducerConfig,
                    teacher_cfg: TransducerConfig, feats, feat_lens, labels,
                    label_lens, distill_weight: float,
                    distill_temp: float = 1.0, dropout: float = 0.0,
                    embed_dropout: float = 0.0, drop=None):
    """RNN-T NLL + distill_weight * lattice KD, batch mean and per
    utterance (JAX `distill_loss_fn` :317-361).

    The KD term is KL(p_teacher || p_student) of the temperature-softened
    joint posteriors, averaged over the valid lattice cells (t < enc_len,
    u <= label_len) and scaled by tau^2, so that its gradient does not
    scale with the temperature. The teacher (any config whose lattice grid
    matches: `check_distill_compat`) runs its forward under no_grad and
    without dropout. The student's loss is always the `xla` route,
    `rnnt_loss` over the materialised logits (K3 on the card), whatever
    `auto` would pick: the KD term needs the logits, which the fused
    kernels never form."""
    with _span("encode"):
        enc_out, enc_lens = m.encode(params, cfg, feats, feat_lens,
                                     dropout=dropout, drop=drop)
    with _span("predict"):
        pred_out, _ = m.predict(params, cfg, labels, dropout=dropout,
                                embed_dropout=embed_dropout, drop=drop)
    with _span("teacher"), torch.no_grad():
        t_logits, _ = m.forward(teacher_params, teacher_cfg, feats,
                                feat_lens, labels)
    with _span("joint_loss"):
        logits = m.joint(params, cfg, enc_out, pred_out)
        per_utt = rnnt_loss(logits, labels, enc_lens, label_lens, cfg.blank)
        tau = distill_temp
        lp_s = torch.log_softmax(logits.float() / tau, dim=-1)
        lp_t = torch.log_softmax(t_logits.float() / tau, dim=-1)
        kl = torch.sum(torch.exp(lp_t) * (lp_t - lp_s), dim=-1)  # (B,T,U+1)
        B, T, U1 = kl.shape
        dev = kl.device
        tmask = (torch.arange(T, device=dev)[None, :, None]
                 < enc_lens.to(dev)[:, None, None])
        umask = (torch.arange(U1, device=dev)[None, None, :]
                 <= label_lens.to(dev)[:, None, None])
        mask = (tmask & umask).to(kl.dtype)
        kd_pu = (torch.sum(kl * mask, dim=(1, 2))
                 / torch.clamp(torch.sum(mask, dim=(1, 2)), min=1.0)
                 ) * tau * tau
        per_utt = per_utt + distill_weight * kd_pu
    return per_utt.mean(), per_utt


def check_distill_compat(cfg: TransducerConfig,
                         teacher_cfg: TransducerConfig, tcfg: TrainConfig):
    """Raise unless the teacher's lattice grid matches the student's and
    the TrainConfig composes with the KD term (JAX :364-388)."""
    for field in ("vocab_size", "blank", "time_reduction"):
        a, b = getattr(cfg, field), getattr(teacher_cfg, field)
        if a != b:
            raise ValueError(f"distillation needs teacher {field} == "
                             f"student {field} (teacher {b}, student {a})")
    if cfg.tdt_durations or cfg.big_blank_durations or \
            teacher_cfg.tdt_durations or teacher_cfg.big_blank_durations:
        raise ValueError("distillation supports standard transducers "
                         "(no TDT / multi-blank joint grids)")
    if cfg.joint_experts > 0:
        raise ValueError("distillation with an MoE student joint is not "
                         "supported")
    if tcfg.loss_impl not in ("auto", "xla"):
        raise ValueError("distillation trains at the xla loss tier "
                         f"(loss_impl {tcfg.loss_impl!r}); the KD term "
                         "needs materialized joint logits")
    if tcfg.ctc_weight or tcfg.fastemit_lambda:
        raise ValueError("distillation does not compose with ctc_weight/"
                         "fastemit_lambda")


# -------------------------------- steps ----------------------------------

def check_ring_width(cfg: TransducerConfig, loss_impl: str,
                     device) -> None:
    """Refuse, before a step is built, a loss whose kernels on the card
    keep (64, J) rows of the joint in shared memory (the fused joint K1 /
    K2, the band K6 of the pruned and AR losses) at J > MAX_J; the kernel
    wrappers would raise mid-step. `auto` takes the two-pass loss there."""
    if (torch.device(device).type == "cuda" and cfg.joint_dim > MAX_J
            and loss_impl in ("fused", "pruned", "ar")):
        raise NotImplementedError(
            f"not ported yet: loss_impl={loss_impl!r} at joint_dim "
            f"{cfg.joint_dim} on the card (ROADMAP queue 1, item 6(b): J > "
            f"{MAX_J} in the ring kernels); loss_impl='auto' or 'pallas' "
            "takes the two-pass loss")


def loss_and_grads(p_leaves, spec, cfg: TransducerConfig, feats, feat_lens,
                   labels, label_lens, batch_loss=None, **loss_kw):
    """The batch-mean loss (detached) and its gradient for every leaf of
    the flattened params (zeros for a leaf the loss does not reach).
    batch_loss(params, cfg, feats, feat_lens, labels, label_lens,
    **loss_kw) -> (loss, per_utt) is `loss_fn` unless given."""
    leaves = [p.detach().requires_grad_(True) for p in p_leaves]
    loss, _ = (batch_loss or loss_fn)(
        pytree.tree_unflatten(leaves, spec), cfg, feats, feat_lens, labels,
        label_lens, **loss_kw)
    with _span("backward"):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if gr is None else gr
             for p, gr in zip(p_leaves, grads)]
    return loss.detach(), grads


def pmean(mesh, loss, grads):
    """The mean over the mesh's ranks of the loss and every gradient, as
    JAX's `lax.pmean`: one all-reduce (SUM) of a flat f32 buffer, then a
    division by the world size as a tensor (a Python-scalar divide would
    be a product with its reciprocal). Every rank gets the same bits."""
    if mesh is None or mesh.size == 1:
        return loss, grads
    with _span("all_reduce"):
        flat = torch.cat([loss.float().reshape(1)]
                         + [g.float().reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        flat = flat / torch.tensor(float(mesh.size), dtype=torch.float32,
                                   device=flat.device)
        pieces = flat[1:].split([g.numel() for g in grads])
        return (flat[0].to(loss.dtype),
                [p.view(g.shape).to(g.dtype) for p, g in zip(pieces, grads)])


def make_train_step(cfg: TransducerConfig, tcfg: TrainConfig, mesh=None,
                    teacher_cfg=None, device: str | torch.device = "cuda",
                    noise_fn=None, loss_kind: str = "rnnt"):
    """Build the training step:
    step(state, feats, feat_lens, labels, label_lens) -> (state', metrics)
    with metrics {"loss", "grad_norm", "skipped_nonfinite"} as tensors.

    With dropout or embed_dropout, every step draws fresh masks
    (regularizers.DropoutMasks on TrainConfig.seed and the step) for this
    rank's rows of the global batch. With weight_noise_std, the gradients are
    taken at params + std * noise_fn(step, paths, leaves) (default
    regularizers.weight_noise; paths as regularizers.leaf_paths) and the
    update is applied to the clean params. With ema_decay d, every update
    (each of grad_accum's mini-steps too) sets ema = d ema + (1 - d)
    params; a skipped step leaves it. `step` is the state's count before
    the call, so a resumed run draws what an uninterrupted one would.

    With ar_range > 0 the loss is the alignment-restricted band (JAX
    make_train_step :441-456); given `teacher_cfg`, the aligner is a
    checkpoint of that config and the step takes its params as a sixth
    argument, `teacher_params`, else the live model aligns itself. With
    distill_weight > 0 the loss is `distill_loss_fn` and the teacher, a
    checkpoint of `teacher_cfg`, rides the same sixth argument (JAX
    :426-440); ar_range and distill_weight are mutually exclusive.
    loss_kind="mwer" makes the step minimize train/mwer.py's expected
    edit count over the beam N-best of the live params (TrainConfig's
    mwer_beam, mwer_expansions, mwer_max_symbols, mwer_nll_weight; JAX
    :419-425), without dropout and without a teacher. loss_kind="ctc"
    makes it minimize `ctc_loss_fn`, the CTC loss of the encoder's
    auxiliary head (JAX :417-418), without dropout and without a teacher.
    TrainConfig.ctc_weight joins the RNN-T loss of every route but
    distillation, which refuses it (`check_distill_compat`).

    With a `mesh` of several ranks (`parallel/mesh.make_mesh`), each rank
    calls the step with its shard of the batch (`shard_batch`) and the
    replicated state and teacher (`replicate`); the loss and gradients
    are averaged over the ranks (`pmean`) before the guard, as in JAX's
    `shard_map` step (:548-588). `device` (the mesh's, when given) is
    where the step will run; it decides only the refusal of
    `check_ring_width`."""
    dev = mesh.device if mesh is not None else torch.device(device)
    if loss_kind not in ("rnnt", "mwer", "ctc"):
        raise ValueError(f"unknown loss_kind {loss_kind!r}")
    rnnt = loss_kind == "rnnt"
    if rnnt and tcfg.ar_range > 0 and tcfg.distill_weight > 0.0:
        raise ValueError("ar_range and distill_weight are mutually "
                         "exclusive (one teacher slot)")
    ar = rnnt and tcfg.ar_range > 0
    distilling = rnnt and tcfg.distill_weight > 0.0
    if ar:
        if tcfg.loss_impl not in ("auto", "ar"):
            raise ValueError("ar_range > 0 trains with loss_impl='auto'|"
                             f"'ar' (got {tcfg.loss_impl!r})")
        if teacher_cfg is not None:
            check_ar_compat(cfg, teacher_cfg)
    if distilling:
        if teacher_cfg is None:
            raise ValueError("distill_weight > 0 needs teacher_cfg (and "
                             "the step must be called with teacher_params)")
        check_distill_compat(cfg, teacher_cfg, tcfg)
    check_train_supported(tcfg)
    check_moe(cfg, "ar" if ar else tcfg.loss_impl)
    if rnnt:
        _check_ctc_weight(cfg, tcfg.ctc_weight)
        check_duration_route(cfg, "ar" if ar else tcfg.loss_impl,
                             tcfg.fastemit_lambda)
    m.check_supported(cfg)
    route = "ar" if ar else tcfg.loss_impl if rnnt and not distilling \
        else "xla"
    check_ring_width(cfg, moe_route(route) if cfg.joint_experts > 0
                     else route, dev)
    schedule = make_lr_schedule(tcfg)
    k = tcfg.grad_accum
    loss_kw = dict(loss_impl=tcfg.loss_impl, fastemit=tcfg.fastemit_lambda,
                   simple_loss_scale=tcfg.simple_loss_scale,
                   ctc_weight=tcfg.ctc_weight)
    batch_loss = loss_fn
    if ar:
        loss_kw.update(loss_impl="ar", ar_range=tcfg.ar_range,
                       ar_left=tcfg.ar_left, align_cfg=teacher_cfg)
    elif distilling:
        loss_kw = dict(distill_weight=tcfg.distill_weight,
                       distill_temp=tcfg.distill_temp)

        def batch_loss(params, cfg, *batch, teacher_params, **kw):
            return distill_loss_fn(params, teacher_params, cfg, teacher_cfg,
                                   *batch, **kw)
    elif loss_kind == "ctc":
        loss_kw = {}
        batch_loss = ctc_loss_fn
    elif not rnnt:
        loss_kw = dict(beam=tcfg.mwer_beam, expansions=tcfg.mwer_expansions,
                       max_symbols=tcfg.mwer_max_symbols,
                       nll_weight=tcfg.mwer_nll_weight)
        batch_loss = mwer_loss_fn
    uses_teacher = (ar or distilling) and teacher_cfg is not None
    has_dropout = rnnt and (tcfg.dropout > 0.0 or tcfg.embed_dropout > 0.0)
    if has_dropout:
        loss_kw.update(dropout=tcfg.dropout, embed_dropout=tcfg.embed_dropout)
    noise_fn = noise_fn or (lambda step, paths, leaves: weight_noise(
        tcfg.seed, step, paths, leaves))
    n_ranks, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)

    def step_fn(state: TrainState, feats, feat_lens, labels, label_lens,
                teacher_params=None):
        if uses_teacher and teacher_params is None:
            raise ValueError("this step's teacher or aligner is a "
                             "checkpoint: pass its params as teacher_params")
        p_leaves, spec = pytree.tree_flatten(state.params)
        at = p_leaves
        if tcfg.weight_noise_std > 0.0:  # gradients at params + noise
            noise = noise_fn(state.step, list(leaf_paths(state.params)),
                             p_leaves)
            at = [p + tcfg.weight_noise_std * z
                  for p, z in zip(p_leaves, noise)]
        kw = dict(loss_kw)
        if has_dropout:
            B = feats.shape[0]
            kw["drop"] = DropoutMasks(tcfg.seed, state.step, rank * B,
                                      n_ranks * B)
        if rnnt:
            kw["teacher_params"] = teacher_params if uses_teacher else None
        loss, grads = loss_and_grads(
            at, spec, cfg, feats, feat_lens, labels, label_lens,
            batch_loss=batch_loss, **kw)
        loss, grads = pmean(mesh, loss, grads)
        gnorm = global_norm(grads)
        ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "skipped_nonfinite": torch.tensor(int(not ok))}
        if not ok:  # skip: params, opt_state (Adam's count) and ema stay
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
            ema = state.ema
            if tcfg.ema_decay > 0:
                d = tcfg.ema_decay
                ema = pytree.tree_unflatten(
                    [d * e + (1.0 - d) * p for e, p in
                     zip(pytree.tree_leaves(state.ema), new_p)], spec)
        return TrainState(params=pytree.tree_unflatten(new_p, spec),
                          opt_state=opt_state, step=state.step + 1,
                          ema=ema), metrics

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
