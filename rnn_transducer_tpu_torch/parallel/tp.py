"""Sequence- and expert-parallel training over a (data, model) mesh
(PyTorch port of the sp and ep modes of `rnn_transducer_tpu/parallel/tp.py`).

Both modes keep the encoder and the predictor replicated on every rank of
a model group and shard the joint + loss lattice's encoder frames over
it (docs/PARALLELISM.md:153-166):

  * **sp** (sequence parallel): plain replicated params. Each rank pads
    the encoder output to a multiple of the model group's size M, builds
    the logits of its T/M frames (the whole vocabulary), takes their
    blank and label log-probs (the duration families' streams too), and
    the (B, T, U+1) streams are gathered over the model group for the
    replicated lattice (`rnnt_loss_from_lp` and the duration families'
    `_from_lp` losses, K3 on the card). An MoE joint routes each rank's
    frames through the replicated experts; JAX's sp leaves the experts
    out (ROADMAP §3).
  * **ep** (expert parallel): sp's lattice, and the MoE joint's experts
    sharded over the model group (`TPParams`: `rep` replicated, `shd`
    the experts, the router replicated as `rep["moe_router"]`); tokens
    reach their experts through two all-to-alls (`ops/moe.moe_top1_ep`),
    capacity per rank and expert as in JAX.

Batches are sharded over the data group and replicated over the model
group (`parallel/mesh.shard_batch_2d`).

**The gradient rule.** JAX differentiates each shard's copy of the
replicated loss through `all_gather`'s transpose, so its per-shard
gradients are M times the true partials and it divides by M. The port
differentiates no collective that way; each rank's backward gives its
share of the one loss, and the shares add up:

  * `gather_frames` (the all-gather of the lattice's streams) keeps, in
    its backward, the rank's own frames of the cotangent. The lattice and
    everything after it are computed alike on every rank of the group, so
    that cotangent is the same on each, and a rank's parameters get the
    loss's partials through its own frames alone.
  * A term that every rank of the group computes in full from replicated
    values (the CTC term, the MoE load-balance loss, the whole loss of
    the CTC and MWER phases) passes through `split_grad`: the identity
    forward, its gradient divided by M backward.
  * The all-to-all's backward is the reverse all-to-all; the mean of the
    load-balance statistics (f, P) over the whole mesh has the mean of
    its cotangents as its backward (the exact adjoint).

So the replicated leaves' gradients are summed over the model group and
the experts' (owned by one rank of each group) are taken as they are;
then both, and the loss, are averaged over the data group. One all-reduce
over every rank does the first with the third for the replicated leaves,
one over the data group the experts'. tests/test_torch_model_parallel.py
holds the steps to the one-process step and to JAX's.

The step (`make_tp_train_step`) does JAX's manual clip (grads times
min(1, clip / max(norm, 1e-12)), the norm over the model group's shards
of the experts), the non-finite guard (a skipped step advances
`TrainState.step` alone), AdamW and the EMA, as loop.py's step. Dropout
masks are keyed by the global example (`regularizers.DropoutMasks` at
the rank's offset in the global batch, as JAX's `dropout_rngs` :1500),
so the ranks of a model group draw the same ones; weight noise is drawn as one process
draws it, an expert shard's the rows of the whole leaf's draw that it
holds (`weight_noise_tp`).

Tensor parallelism (item 16(b): the gate-sharded LSTM, the vocab-parallel
loss, and with it sp's pruned, distillation and AR losses) and pipeline
parallelism (item 16(c)) are not ported; their modes raise
NotImplementedError naming the item.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

from rnn_transducer_tpu_torch.models import transducer as m
from rnn_transducer_tpu_torch.models.config import TrainConfig, TransducerConfig
from rnn_transducer_tpu_torch.ops.ctc_loss import ctc_loss_from_logits
from rnn_transducer_tpu_torch.ops.lstm import _dot
from rnn_transducer_tpu_torch.ops.moe import moe_top1_ep
from rnn_transducer_tpu_torch.ops.rnnt_loss import (_gather_label_logprobs,
                                                   rnnt_loss_from_lp)
from rnn_transducer_tpu_torch.ops.rnnt_multiblank import \
    rnnt_loss_multiblank_from_lp
from rnn_transducer_tpu_torch.ops.rnnt_tdt import rnnt_loss_tdt_from_lp
from rnn_transducer_tpu_torch.parallel import mesh as meshlib
from rnn_transducer_tpu_torch.train.loop import (TrainState, _adamw,
                                                 _span, check_moe,
                                                 init_opt_state,
                                                 make_lr_schedule)
from rnn_transducer_tpu_torch.train.mwer import mwer_loss_fn
from rnn_transducer_tpu_torch.train.regularizers import (DropoutMasks,
                                                         leaf_paths,
                                                         weight_noise)

# JAX's mesh axes: the model group and the data group of `Mesh2D`
MODEL_AXIS = "model"
DATA_AXIS = "data"
MODES = ("tp", "sp", "pp", "ep")
_EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


def check_mode(mode: str) -> None:
    """tp and pp are item 16(b) and 16(c); sp and ep run here."""
    if mode == "tp":
        raise NotImplementedError(
            "not ported yet: --parallel-mode tp (ROADMAP queue 1, item "
            "16(b): tensor parallelism, the gate-sharded LSTM and the "
            "vocab-parallel loss)")
    if mode == "pp":
        raise NotImplementedError(
            "not ported yet: --parallel-mode pp (ROADMAP queue 1, item "
            "16(c): pipeline parallelism)")
    if mode not in MODES:
        raise ValueError(f"unknown parallel mode {mode!r}")


# --------------------------------------------------------------------------
# The ep params layout: TPParams = replicated subtree + expert shards
# --------------------------------------------------------------------------

@dataclasses.dataclass
class TPParams:
    """rep: the replicated leaves (the model's params but "moe", and the
    router as "moe_router"); shd: {"moe": {"w1", "b1", "w2", "b2"}}, a
    rank's own experts (E / M of them) in a live state, or stacked with a
    leading M axis (JAX's layout, the checkpoint's) by `split_params_ep`
    and `stack_shards`."""

    rep: Any
    shd: Any


pytree.register_pytree_node(
    TPParams, lambda t: ([t.rep, t.shd], None),
    lambda values, _: TPParams(*values),
    serialized_type_name="rnn_transducer_tpu_torch.parallel.tp.TPParams")


def split_params_ep(params, cfg: TransducerConfig, mp: int) -> TPParams:
    """Plain params -> TPParams with the experts stacked (mp, E / mp, ...)
    (JAX :1369-1378)."""
    E = cfg.joint_experts
    if E <= 0:
        raise ValueError("ep mode needs cfg.joint_experts > 0")
    if E % mp:
        raise ValueError(f"experts {E} not divisible by model parallel {mp}")
    moe = params["moe"]
    shd = {"moe": {k: moe[k].reshape((mp, E // mp) + tuple(moe[k].shape[1:]))
                   for k in _EXPERT_LEAVES}}
    rep = {k: v for k, v in params.items() if k != "moe"}
    rep["moe_router"] = moe["router"]  # replicated: it needs all E columns
    return TPParams(rep=rep, shd=shd)


def merge_params_ep(tpp, cfg: TransducerConfig | None = None) -> dict:
    """Stacked TPParams (or its checkpoint dict {"rep", "shd"}) -> plain
    params (JAX :1381-1387)."""
    rep, shd = ((tpp.rep, tpp.shd) if isinstance(tpp, TPParams)
                else (tpp["rep"], tpp["shd"]))
    params = {k: v for k, v in rep.items() if k != "moe_router"}
    moe = {"router": rep["moe_router"]}
    for k, v in shd["moe"].items():
        moe[k] = v.reshape((-1,) + tuple(v.shape[2:]))
    params["moe"] = moe
    return params


def shard_of(tpp: TPParams, model_rank: int) -> TPParams:
    """A rank's live view of stacked TPParams: its own expert shard."""
    return TPParams(rep=tpp.rep, shd=pytree.tree_map(
        lambda x: x[model_rank].clone(), tpp.shd))


def stack_shards(mesh, tpp: TPParams) -> TPParams:
    """A rank's live TPParams -> the stacked layout, every rank's experts
    gathered over the model group (a collective: every rank calls it)."""
    return TPParams(rep=tpp.rep, shd=pytree.tree_map(
        lambda x: meshlib.gather_cat(mesh, x[None], mesh.model_group,
                                     mesh.n_model, 0), tpp.shd))


def _tp_leaves(params) -> tuple[list, list, list[bool]]:
    """(leaves, their '/'-joined paths, whether each is an expert shard)
    of plain params or TPParams, in torch's flatten order."""
    leaves = pytree.tree_leaves(params)
    if isinstance(params, TPParams):
        tree = {"rep": params.rep, "shd": params.shd}
        paths = list(leaf_paths(tree))
        shd = [p.startswith("/shd/") for p in paths]
    else:
        paths = list(leaf_paths(params))
        shd = [False] * len(leaves)
    return leaves, paths, shd


def _map_state(state: TrainState, fn) -> TrainState:
    """fn over the params-shaped trees of a TrainState: params, Adam's
    mu and nu, the EMA."""
    opt = dict(state.opt_state)
    opt["mu"], opt["nu"] = fn(opt["mu"]), fn(opt["nu"])
    return TrainState(params=fn(state.params), opt_state=opt,
                      step=state.step,
                      ema=None if state.ema is None else fn(state.ema))


def ep_checkpoint_state(mesh, state: TrainState) -> TrainState:
    """A rank's live ep state -> the checkpoint's: every TPParams stacked
    over the model group and written as the dict {"rep", "shd"} (a
    collective: every rank calls it; rank 0 saves)."""
    def stacked(t):
        s = stack_shards(mesh, t)
        return {"rep": s.rep, "shd": s.shd}
    return _map_state(state, stacked)


def ep_state_from_checkpoint(state: TrainState,
                             model_rank: int) -> TrainState:
    """A restored ep checkpoint's state -> this rank's live state."""
    return _map_state(state, lambda t: shard_of(
        TPParams(rep=t["rep"], shd=t["shd"]), model_rank))


# --------------------------------------------------------------------------
# Differentiable collectives, under the module docstring's rule
# --------------------------------------------------------------------------

class _GatherFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.lo, ctx.n = mesh.model_rank * x.shape[1], x.shape[1]
        return meshlib.gather_cat(mesh, x, mesh.model_group, mesh.n_model,
                                  1)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.lo:ctx.lo + ctx.n], None


def gather_frames(mesh, x):
    """x (B, T/M, ...) of every rank of the model group -> (B, T, ...);
    backward: this rank's frames of the cotangent."""
    return x if mesh.n_model == 1 else _GatherFrames.apply(x, mesh)


class _SplitGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / torch.tensor(float(ctx.n), dtype=g.dtype,
                                device=g.device), None


def split_grad(x, n: int):
    """x, with its gradient divided by n: a term that each of the n ranks
    of a model group computes whole."""
    return x if n == 1 else _SplitGrad.apply(x, n)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return meshlib.all_to_all(mesh, x, mesh.model_group, mesh.n_model)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return meshlib.all_to_all(mesh, g, mesh.model_group,
                                  mesh.n_model), None


class _MeshMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = meshlib.all_reduce_sum(x.detach().clone(), mesh.group)
        return y / torch.tensor(float(mesh.size), dtype=y.dtype,
                                device=y.device)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = meshlib.all_reduce_sum(g.detach().clone(), mesh.group)
        return g / torch.tensor(float(mesh.size), dtype=g.dtype,
                                device=g.device), None


def mesh_mean(mesh, x):
    """The mean of x over every rank of the mesh (the model and the data
    groups), differentiable."""
    return x if mesh.size == 1 else _MeshMean.apply(x, mesh)


def _moe_fn(mesh, cfg: TransducerConfig, moe_params, n_shards: int):
    """The routed MoE of a rank's lattice tokens: over the model group's
    experts by two all-to-alls (ep, n_shards = M), or over all of them
    here (sp, n_shards = 1); the statistics averaged over the mesh."""
    def exchange(t):
        return t if n_shards == 1 else _Exchange.apply(t, mesh)

    def fn(x):
        return moe_top1_ep(moe_params, x, exchange=exchange,
                           n_shards=n_shards,
                           capacity_factor=cfg.moe_capacity_factor,
                           compute_dtype=cfg.cdtype,
                           stats_mean=lambda t: mesh_mean(mesh, t))
    return fn


# --------------------------------------------------------------------------
# The losses
# --------------------------------------------------------------------------

def _frame_slice(mesh, enc_out):
    """enc_out padded to a multiple of M frames, this rank's T/M of them,
    and the unpadded T."""
    M = mesh.n_model
    B, T, _ = enc_out.shape
    Tp = -(-T // M) * M
    if Tp != T:
        enc_out = torch.nn.functional.pad(enc_out, (0, 0, 0, Tp - T))
    Tl = Tp // M
    t0 = mesh.model_rank * Tl
    return enc_out[:, t0:t0 + Tl], T


def _with_ctc(per_utt, params, cfg, enc_out, enc_lens, labels, label_lens,
              ctc_weight: float, mesh):
    """per_utt + ctc_weight * the CTC loss of the replicated encoder
    output (JAX `_with_ctc` :295), its gradient split over the model
    group."""
    if not ctc_weight:
        return per_utt
    with _span("ctc"):
        ctc_pu = ctc_loss_from_logits(m.ctc_logits(params, cfg, enc_out),
                                      labels, enc_lens, label_lens,
                                      cfg.blank)
    return per_utt + ctc_weight * split_grad(ctc_pu, mesh.n_model)


def sp_joint_loss(params, cfg: TransducerConfig, enc_out, enc_lens,
                  pred_out, labels, label_lens, *, mesh, fastemit=0.0,
                  moe_fn=None):
    """Frame-sharded joint + loss (JAX :773-832) -> (per_utt (B,), aux).

    The rank's frames' logits (with the MoE residual through `moe_fn`
    when the joint has experts), their log-softmax and the streams of the
    family's lattice, gathered over the model group: the standard blank
    and label scores, the multi-blank's blank columns, or TDT's scores
    with its duration log-probs. Padded frames lie past enc_lens. aux is
    the MoE load-balance loss (0 without experts)."""
    enc_l, T = _frame_slice(mesh, enc_out)
    f, g, w, b = m.joint_activations(params, cfg, enc_l, pred_out)
    z = torch.tanh(f[:, :, None, :] + g[:, None, :, :])  # (B, Tl, U1, J)
    aux = torch.zeros((), dtype=torch.float32, device=z.device)
    if cfg.joint_experts > 0:
        y, aux = moe_fn(z.reshape(-1, z.shape[-1]))
        z = z + y.reshape(z.shape)
    cd = cfg.cdtype
    lp = torch.log_softmax(_dot(z, w, cd) + b.float(), dim=-1)

    def gather_t(a):
        return gather_frames(mesh, a)[:, :T]

    lp_y = gather_t(_gather_label_logprobs(lp, labels))
    if cfg.tdt_durations:
        if fastemit:
            raise ValueError("fastemit_lambda is not supported with TDT "
                             "models")
        dur = params["joint"]["dur"]
        lp_dur = gather_t(torch.log_softmax(
            _dot(z, dur["w"], cd) + dur["b"].float(), dim=-1))
        per_utt = rnnt_loss_tdt_from_lp(gather_t(lp[..., cfg.blank]), lp_y,
                                        lp_dur, enc_lens, label_lens,
                                        cfg.tdt_durations)
    elif cfg.big_blank_durations:
        if fastemit:
            raise ValueError("fastemit_lambda is not supported with "
                             "multi-blank models")
        cols = [cfg.blank] + [cfg.vocab_size + k for k in
                              range(len(cfg.big_blank_durations))]
        per_utt = rnnt_loss_multiblank_from_lp(
            gather_t(lp[..., cols]), lp_y, enc_lens, label_lens,
            cfg.big_blank_durations)
    else:
        per_utt = rnnt_loss_from_lp(gather_t(lp[..., cfg.blank]), lp_y,
                                    enc_lens, label_lens, fastemit)
    return per_utt, aux


def _encode_predict(params, cfg, feats, feat_lens, labels, dropout,
                    embed_dropout, drop):
    with _span("encode"):
        enc_out, enc_lens = m.encode(params, cfg, feats, feat_lens,
                                     dropout=dropout, drop=drop)
    with _span("predict"):
        pred_out, _ = m.predict(params, cfg, labels, dropout=dropout,
                                embed_dropout=embed_dropout, drop=drop)
    return enc_out, enc_lens, pred_out


def sp_loss_fn(params, cfg: TransducerConfig, feats, feat_lens, labels,
               label_lens, *, mesh, fastemit=0.0, dropout=0.0,
               embed_dropout=0.0, drop=None, ctc_weight=0.0):
    """The sp objective on replicated params (JAX `sp_loss_fn` :835):
    (loss, per_utt); with experts mean(per_utt) + moe_aux_weight * aux."""
    enc_out, enc_lens, pred_out = _encode_predict(
        params, cfg, feats, feat_lens, labels, dropout, embed_dropout, drop)
    moe_fn = (_moe_fn(mesh, cfg, params["moe"], 1)
              if cfg.joint_experts > 0 else None)
    with _span("joint_loss"):
        per_utt, aux = sp_joint_loss(params, cfg, enc_out, enc_lens,
                                     pred_out, labels, label_lens,
                                     mesh=mesh, fastemit=fastemit,
                                     moe_fn=moe_fn)
    per_utt = _with_ctc(per_utt, params, cfg, enc_out, enc_lens, labels,
                        label_lens, ctc_weight, mesh)
    return _with_aux(per_utt, aux, cfg, mesh), per_utt


def _with_aux(per_utt, aux, cfg, mesh):
    if cfg.joint_experts <= 0:
        return per_utt.mean()
    return per_utt.mean() + cfg.moe_aux_weight * split_grad(aux,
                                                            mesh.n_model)


def ep_loss_fn(local: TPParams, cfg: TransducerConfig, feats, feat_lens,
               labels, label_lens, *, mesh, fastemit=0.0, dropout=0.0,
               embed_dropout=0.0, drop=None, ctc_weight=0.0):
    """The ep objective (JAX `ep_loss_fn` :1399-1449): sp's lattice with
    the experts sharded over the model group -> (mean(per_utt) +
    moe_aux_weight * aux, per_utt)."""
    rep = {k: v for k, v in local.rep.items() if k != "moe_router"}
    moe_local = dict(local.shd["moe"])
    moe_local["router"] = local.rep["moe_router"]
    enc_out, enc_lens, pred_out = _encode_predict(
        rep, cfg, feats, feat_lens, labels, dropout, embed_dropout, drop)
    with _span("joint_loss"):
        per_utt, aux = sp_joint_loss(
            rep, cfg, enc_out, enc_lens, pred_out, labels, label_lens,
            mesh=mesh, fastemit=fastemit,
            moe_fn=_moe_fn(mesh, cfg, moe_local, mesh.n_model))
    per_utt = _with_ctc(per_utt, rep, cfg, enc_out, enc_lens, labels,
                        label_lens, ctc_weight, mesh)
    return _with_aux(per_utt, aux, cfg, mesh), per_utt


def rep_ctc_loss_fn(params, cfg: TransducerConfig, feats, feat_lens,
                    labels, label_lens, *, mesh):
    """The CTC pretraining loss on replicated params (JAX :741), whole on
    every rank of the model group, its gradient split over it."""
    with _span("encode"):
        enc_out, enc_lens = m.encode(params, cfg, feats, feat_lens)
    with _span("ctc"):
        per_utt = ctc_loss_from_logits(m.ctc_logits(params, cfg, enc_out),
                                       labels, enc_lens, label_lens,
                                       cfg.blank)
    return split_grad(per_utt.mean(), mesh.n_model), per_utt


# --------------------------------------------------------------------------
# The training step over the 2-D mesh
# --------------------------------------------------------------------------

def _combine_model_grads(mesh, loss, grads, shd: list[bool]):
    """(loss, grads) of the rank's share -> the step's: the replicated
    leaves summed over the model group, the expert shards as they are,
    then everything averaged over the data group. One all-reduce (SUM)
    over the mesh of [loss, replicated leaves], divided by n_data (the
    loss by the mesh's size: each model rank carries it once), and one
    over the data group of the expert shards, divided by n_data."""
    if mesh.size == 1:
        return loss, grads
    with _span("all_reduce"):
        dev = loss.device
        rep = [g for g, s in zip(grads, shd) if not s]
        flat = torch.cat([loss.float().reshape(1)]
                         + [g.float().reshape(-1) for g in rep])
        meshlib.all_reduce_sum(flat, mesh.group)
        n_data = torch.tensor(float(mesh.n_data), dtype=torch.float32,
                              device=dev)
        loss = (flat[0] / torch.tensor(float(mesh.size), dtype=torch.float32,
                                       device=dev)).to(loss.dtype)
        rep_out = iter(flat[1:].div(n_data).split([g.numel() for g in rep]))
        out = [None if s else next(rep_out).view(g.shape).to(g.dtype)
               for g, s in zip(grads, shd)]
        own = [g for g, s in zip(grads, shd) if s]
        if own:
            flat = torch.cat([g.float().reshape(-1) for g in own])
            meshlib.all_reduce_sum(flat, mesh.data_group)
            pieces = iter(flat.div(n_data).split([g.numel() for g in own]))
            out = [next(pieces).view(g.shape).to(g.dtype) if s else o
                   for g, o, s in zip(grads, out, shd)]
    return loss, out


def _tp_global_norm(mesh, grads, shd: list[bool]) -> torch.Tensor:
    """The global norm of the step's gradients: the expert shards' sums
    of squares added over the model group (JAX :1466)."""
    sq_rep = sum(torch.sum(g.float() * g.float())
                 for g, s in zip(grads, shd) if not s)
    own = [torch.sum(g.float() * g.float()) for g, s in zip(grads, shd)
           if s]
    if own:
        sq = torch.stack(own).sum().reshape(1)
        meshlib.all_reduce_sum(sq, mesh.model_group)
        sq_rep = sq_rep + sq[0]
    return torch.sqrt(sq_rep)


def weight_noise_tp(seed: int, step: int, paths, leaves, n_model: int,
                    model_rank: int) -> list:
    """Standard normal noise for the step's leaves as one process draws
    it (`regularizers.weight_noise`, keyed by the plain params' paths: a
    TPParams "/rep/x" is "/x", "/rep/moe_router" is "/moe/router"), an
    expert shard's the rows of its whole leaf's draw that it holds (JAX's
    `apply_weight_noise` :1476 draws a shard's own noise too)."""
    out = []
    for path, p in zip(paths, leaves):
        if path.startswith("/shd/"):
            full = weight_noise(seed, step, [path[4:]],
                                [p.new_empty((n_model * p.shape[0],)
                                             + tuple(p.shape[1:]))])[0]
            E = p.shape[0]
            out.append(full[model_rank * E:(model_rank + 1) * E])
            continue
        if path == "/rep/moe_router":
            path = "/moe/router"
        elif path.startswith("/rep/"):
            path = path[4:]
        out.append(weight_noise(seed, step, [path], [p])[0])
    return out


def init_opt_state_noclip(params):
    """AdamW's state without the clip (JAX's `make_optimizer_noclip`
    :1515): the clip is the step's own, over the mesh's norm."""
    return init_opt_state(params, TrainConfig(grad_accum=1))


def _init_ema(params, tcfg: TrainConfig):
    return (pytree.tree_map(torch.clone, params) if tcfg.ema_decay > 0
            else None)


def init_sp_train_state(rng, cfg: TransducerConfig, tcfg: TrainConfig,
                        device: str | torch.device = "cuda",
                        params=None) -> TrainState:
    """The replicated state of mode sp: the params from `m.init_params`
    with the numpy Generator `rng` (or the given tree)."""
    if params is None:
        params = m.init_params(cfg, _as_rng(rng), device)
    return TrainState(params=params,
                      opt_state=init_opt_state_noclip(params), step=0,
                      ema=_init_ema(params, tcfg))


def init_ep_train_state(rng, cfg: TransducerConfig, tcfg: TrainConfig,
                        mp: int, model_rank: int,
                        device: str | torch.device = "cuda",
                        params=None) -> TrainState:
    """The ep state of the rank at `model_rank` of a model group of mp:
    the replicated leaves and its expert shard of the plain params."""
    if params is None:
        params = m.init_params(cfg, _as_rng(rng), device)
    local = shard_of(split_params_ep(params, cfg, mp), model_rank)
    return TrainState(params=local, opt_state=init_opt_state_noclip(local),
                      step=0, ema=_init_ema(local, tcfg))


def _as_rng(rng):
    return (rng if isinstance(rng, np.random.Generator)
            else np.random.default_rng(rng))


def _refuse(mode: str, what: str, ep_message: str):
    """A loss that ep refuses in JAX's words and sp has not ported."""
    if mode == "ep":
        raise ValueError(ep_message)
    raise NotImplementedError(f"not ported yet: {what} under mode='sp' "
                              "(ROADMAP queue 1, item 16(b))")


def check_tp_step(cfg: TransducerConfig, tcfg: TrainConfig, mode: str,
                  loss_kind: str) -> None:
    """The refusals of JAX's `make_tp_train_step` (:1575-1612) for sp and
    ep; sp's pruned, distillation and AR losses are item 16(b)."""
    check_mode(mode)
    if loss_kind not in ("rnnt", "ctc", "mwer"):
        raise ValueError(f"unknown loss_kind {loss_kind!r}")
    if tcfg.grad_accum > 1:
        raise ValueError("grad_accum > 1 is not supported by the "
                         "model-parallel train steps; grow the data axis "
                         "or the per-shard batch instead")
    if loss_kind == "mwer" and mode != "sp":
        raise ValueError("MWER needs replicated params (mode='sp')")
    rnnt = loss_kind == "rnnt"
    if rnnt and tcfg.loss_impl == "pruned":
        _refuse(mode, "the pruned loss", "the pruned loss under model "
                "parallelism requires mode='sp' (frame-sharded band) or "
                "mode='tp' (vocab-sharded band)")
    if rnnt and tcfg.distill_weight > 0.0:
        _refuse(mode, "distillation", "distillation under model "
                "parallelism requires mode='sp' or 'tp'")
    if rnnt and tcfg.ar_range > 0:
        _refuse(mode, "alignment-restricted training", "alignment-"
                "restricted training under model parallelism requires "
                "mode='sp' or 'tp'")
    if mode == "ep":
        if cfg.joint_experts <= 0:
            raise ValueError("ep mode needs cfg.joint_experts > 0")
        if cfg.big_blank_durations or cfg.tdt_durations:
            raise ValueError("the duration families do not run under "
                             "mode='ep' (no MoE joint)")
    check_moe(cfg, tcfg.loss_impl)
    m.check_supported(cfg)


def make_tp_train_step(cfg: TransducerConfig, tcfg: TrainConfig, mesh,
                       mode: str = "sp", loss_kind: str = "rnnt",
                       noise_fn=None, masks_fn=None):
    """The training step of one rank of a `parallel/mesh.Mesh2D`:
    step(state, feats, feat_lens, labels, label_lens) -> (state',
    metrics) with metrics {"loss", "grad_norm", "skipped_nonfinite"}, as
    JAX's `make_tp_train_step` (:1547-1760) for modes sp and ep.

    Each rank calls it with its data row's shard of the batch
    (`mesh.shard_batch_2d`): mode sp with `init_sp_train_state`'s
    replicated state, mode ep with `init_ep_train_state`'s for its model
    rank. loss_kind "ctc" is the CTC pretraining phase (`rep_ctc_loss_fn`;
    same state), "mwer" the MWER phase (train/mwer.py, sp only: the beam
    runs whole on every rank of the model group). The loss routes of
    TrainConfig.loss_impl do not apply: sp and ep always build the
    rank's log-probs and gather them for the lattice. With weight noise,
    noise_fn(step, paths, leaves) gives the noise of each leaf (default
    `weight_noise_tp`); with dropout, masks_fn(step, offset,
    global_batch) the mask source of the rank's rows (default
    `DropoutMasks` of TrainConfig.seed and the step)."""
    check_tp_step(cfg, tcfg, mode, loss_kind)
    schedule = make_lr_schedule(tcfg)
    M = mesh.n_model
    has_dropout = (loss_kind == "rnnt"
                   and (tcfg.dropout > 0.0 or tcfg.embed_dropout > 0.0))
    noise_fn = noise_fn or (lambda step, paths, leaves: weight_noise_tp(
        tcfg.seed, step, paths, leaves, M, mesh.model_rank))
    masks_fn = masks_fn or (lambda step, offset, n: DropoutMasks(
        tcfg.seed, step, offset, n))
    if loss_kind == "ctc":
        def batch_loss(p, batch, kw):
            rep = ({k: v for k, v in p.rep.items() if k != "moe_router"}
                   if mode == "ep" else p)
            return rep_ctc_loss_fn(rep, cfg, *batch, mesh=mesh)
    elif loss_kind == "mwer":
        def batch_loss(p, batch, kw):
            loss, per_utt = mwer_loss_fn(
                p, cfg, *batch, beam=tcfg.mwer_beam,
                expansions=tcfg.mwer_expansions,
                max_symbols=tcfg.mwer_max_symbols,
                nll_weight=tcfg.mwer_nll_weight)
            return split_grad(loss, M), per_utt
    else:
        fn = ep_loss_fn if mode == "ep" else sp_loss_fn

        def batch_loss(p, batch, kw):
            return fn(p, cfg, *batch, mesh=mesh,
                      fastemit=tcfg.fastemit_lambda,
                      ctc_weight=tcfg.ctc_weight, **kw)

    def step_fn(state: TrainState, feats, feat_lens, labels, label_lens):
        p_leaves, paths, shd = _tp_leaves(state.params)
        spec = pytree.tree_structure(state.params)
        at = p_leaves
        if tcfg.weight_noise_std > 0.0:  # gradients at params + noise
            noise = noise_fn(state.step, paths, p_leaves)
            at = [p + tcfg.weight_noise_std * z
                  for p, z in zip(p_leaves, noise)]
        kw = {}
        if has_dropout:
            B = feats.shape[0]
            kw = dict(dropout=tcfg.dropout, embed_dropout=tcfg.embed_dropout,
                      drop=masks_fn(state.step, mesh.data_rank * B,
                                    mesh.n_data * B))
        xs = [p.detach().requires_grad_(True) for p in at]
        loss, _ = batch_loss(pytree.tree_unflatten(xs, spec),
                             (feats, feat_lens, labels, label_lens), kw)
        with _span("backward"):
            grads = torch.autograd.grad(loss, xs, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(p_leaves, grads)]
        loss, grads = _combine_model_grads(mesh, loss.detach(), grads, shd)
        gnorm = _tp_global_norm(mesh, grads, shd)
        ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "skipped_nonfinite": torch.tensor(int(not ok))}
        if not ok:  # skip: params, opt_state (Adam's count) and ema stay
            return dataclasses.replace(state, step=state.step + 1), metrics
        with torch.no_grad(), _span("optimizer"):
            one = torch.ones((), dtype=torch.float32, device=gnorm.device)
            scale = torch.minimum(one, torch.tensor(
                tcfg.grad_clip_norm, dtype=torch.float32,
                device=gnorm.device) / torch.clamp(gnorm, min=1e-12))
            new_p, opt_state = _adamw(p_leaves, [g * scale for g in grads],
                                      state.opt_state, tcfg, schedule)
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


def plain_params(mesh, params, mode: str, cfg: TransducerConfig):
    """The plain params of a rank's live ones: ep's experts gathered over
    the model group and merged (a collective: every rank calls it); sp's
    as they are."""
    if mode == "ep":
        return merge_params_ep(stack_shards(mesh, params), cfg)
    return params
