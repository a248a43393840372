"""The Transducer model (PyTorch port of
`rnn_transducer_tpu/models/transducer.py`): the LSTM encoder (one
direction or both) and the conformer encoder, offline and chunk by chunk
with a carried state, the LSTM or stateless predictor, the joint and the
CTC head.

Plain functions on tensors over a parameter dict in the JAX layout:
{"encoder": [lstm layer, ...], [{"fwd": lstm layer, "bwd": lstm layer},
...] or [{"in_proj"}, conformer block, ...],
"embed": (V, E), "predictor": [lstm layer, ...] or, for
pred_type="stateless", [{"w": (pred_context * E, pred_hidden), "b"}],
"joint": {"enc_proj", "pred_proj", "out": {"w": (in, out), "b"}[,
"dur": the TDT duration head]}[, "ctc_head": {"w": (enc_out_dim, V),
"b"}][, "moe": {"router": (J, E), "w1": (E, J, H), "b1": (E, H), "w2":
(E, H, J), "b2": (E, J)}]}; a multi-blank joint's "out" has V +
len(big_blank_durations) columns (`n_classes`). With joint_experts > 0
a residual top-1 MoE FFN (`ops/moe.py`) runs on the joint's activation:
routed through the capacity buffer on the lattice (`joint`, which can
also return the load-balance aux loss), dense in the decode steps
(`DecodeWeights.joint`, `joint_step`), as in JAX.
It covers serving (`encode`, `predict_step`, `joint_step`,
`joint_step_tdt`, `ctc_logits`), streaming (`init_enc_state`,
`encode_chunk`) and the training forward (`predict`, `joint`,
`joint_tdt`, `joint_activations`, `forward`), with the JAX
package's dropout sites in `encode` and `predict`. With remat_encoder,
`encode` recomputes each conformer block or LSTM layer in the backward
(`torch.utils.checkpoint`, as JAX's `jax.checkpoint`), its dropout left
outside the recomputed function. Every entry point takes
int8 serving params (`ops/quant.py`) and dequantizes them as the JAX
package does; `encode` keeps `w_hh` int8 for the W8A8 recurrence.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from rnn_transducer_tpu_torch.models.config import TransducerConfig
from rnn_transducer_tpu_torch.ops.conformer import (conformer_block,
                                                    conformer_block_chunk,
                                                    init_block_cache,
                                                    init_conformer_block)
from rnn_transducer_tpu_torch.ops.lstm import (
    _dot,
    bilstm_layer,
    cell_update,
    lstm_layer,
    mask_padding,
)
from rnn_transducer_tpu_torch.ops.moe import (init_moe_params, moe_dense,
                                             moe_top1)
from rnn_transducer_tpu_torch.ops.quant import maybe_dequant_tree

Params = dict[str, Any]


def check_supported(cfg: TransducerConfig) -> None:
    """Raise ValueError for an encoder or predictor type the model does
    not know."""
    if cfg.enc_type not in ("lstm", "conformer"):
        raise ValueError(f"unknown enc_type {cfg.enc_type!r}")
    if cfg.pred_type not in ("lstm", "stateless"):
        raise ValueError(f"unknown pred_type {cfg.pred_type!r}")


def _check_families(cfg: TransducerConfig) -> None:
    """The JAX `init_params` refusals of the duration families (:102-106)."""
    if cfg.tdt_durations:
        if cfg.big_blank_durations:
            raise ValueError("tdt_durations and big_blank_durations are "
                             "mutually exclusive")
        if cfg.joint_experts > 0:
            raise ValueError("TDT with an MoE joint is not supported")


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
                device: str | torch.device = "cuda") -> Params:
    """Fresh params with the JAX `init_params` distributions, on `device`.

    The draws come from a numpy Generator, so they are not the JAX
    package's values for the same seed, only the same distributions.
    """
    from rnn_transducer_tpu_torch.weights import params_from_numpy

    _check_families(cfg)
    check_supported(cfg)
    enc = []
    if cfg.enc_type == "conformer":
        # frame-stacked input projection + enc_layers conformer blocks
        enc.append({"in_proj": _init_linear(
            rng, cfg.input_dim * max(cfg.time_reduction, 1), cfg.enc_hidden)})
        for _ in range(cfg.enc_layers):
            enc.append(init_conformer_block(rng, cfg.enc_hidden,
                                            cfg.enc_heads, cfg.enc_ff_mult,
                                            cfg.enc_conv_kernel))
    else:
        # a BiLSTM layer is {"fwd", "bwd"}, each over the same input, and
        # feeds 2H to the next
        in_dim = cfg.input_dim
        for i in range(cfg.enc_layers):
            if cfg.bidirectional:
                enc.append({"fwd": _init_lstm(rng, in_dim, cfg.enc_hidden),
                            "bwd": _init_lstm(rng, in_dim, cfg.enc_hidden)})
            else:
                enc.append(_init_lstm(rng, in_dim, cfg.enc_hidden))
            in_dim = cfg.enc_out_dim
            if i == 0 and cfg.time_reduction > 1:
                in_dim *= cfg.time_reduction
    embed = rng.standard_normal((cfg.vocab_size, cfg.embed_dim),
                                dtype=np.float32)
    pred = []
    if cfg.pred_type == "stateless":
        # one projection of the window of the last pred_context embeddings
        pred.append(_init_linear(rng, cfg.pred_context * cfg.embed_dim,
                                 cfg.pred_hidden))
    else:
        pin = cfg.embed_dim
        for _ in range(cfg.pred_layers):
            pred.append(_init_lstm(rng, pin, cfg.pred_hidden))
            pin = cfg.pred_hidden
    joint = {
        "enc_proj": _init_linear(rng, cfg.enc_out_dim, cfg.joint_dim),
        "pred_proj": _init_linear(rng, cfg.pred_hidden, cfg.joint_dim),
        "out": _init_linear(rng, cfg.joint_dim, cfg.n_classes),
    }
    if cfg.tdt_durations:  # the TDT duration head, off the same activation
        joint["dur"] = _init_linear(rng, cfg.joint_dim,
                                    len(cfg.tdt_durations))
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
    if cfg.joint_experts > 0:  # the residual MoE on the joint activation
        params["moe"] = init_moe_params(rng, cfg.joint_experts,
                                        cfg.joint_dim, cfg.moe_hidden)
    return params_from_numpy(params, device)


def _time_reduce(x, lens, factor: int):
    """Stack `factor` consecutive frames: (B, T, F) -> (B, T//factor, F*factor)."""
    B, T, F = x.shape
    T2 = T // factor
    x = x[:, : T2 * factor, :].reshape(B, T2, F * factor)
    lens = torch.clamp((lens.to(torch.int32) + factor - 1) // factor, max=T2)
    return x, lens


def _dropout(x, rate: float, drop, site: int):
    """Inverted dropout (train time): `drop(site, x, keep)` gives the keep
    mask of x's shape, one mask a row, drawn per global row so that a
    data-parallel shard keeps what one process keeps
    (train/regularizers.py `DropoutMasks`). `site` separates the mask
    streams of the dropout sites, as in JAX's `_dropout`: encoder layer i
    (or conformer block i) is site i, the label embeddings 1000, predictor
    layer i 1001 + i."""
    keep = 1.0 - rate
    return torch.where(drop(site, x, keep), x / keep, 0.0)


def encode(params: Params, cfg: TransducerConfig, feats, feat_lens, *,
           dropout: float = 0.0, drop=None):
    """feats: (B, T, input_dim) -> (enc_out (B, T', enc_out_dim), enc_lens).

    As in JAX, pad-region values between layers are garbage that stays in
    the pad region; the input to frame stacking and the output are masked.
    A bidirectional encoder runs `bilstm_layer` on each layer's
    {"fwd", "bwd"} params. dropout (with a mask source `drop`): on every
    layer's output but the last, before layer 0's masking and frame
    stacking, as JAX's stacked-LSTM dropout. With cfg.remat_encoder each
    conformer block or LSTM (BiLSTM) layer is recomputed in the backward
    instead of keeping its activations; the dropout after it is not.
    """
    dropping = dropout > 0.0 and drop is not None
    check_supported(cfg)
    params = maybe_dequant_tree(params, keep=("w_hh",))
    x = mask_padding(feats.float(), feat_lens)
    lens = feat_lens.to(torch.int32)
    cd = cfg.cdtype
    if cfg.enc_type == "conformer":
        # frame stacking at the input, one projection to d_model, blocks
        if cfg.time_reduction > 1:
            x, lens = _time_reduce(x, lens, cfg.time_reduction)
        proj = params["encoder"][0]["in_proj"]
        x = _dot(x, proj["w"], cd) + proj["b"].float()

        def blk(block, x):
            return conformer_block(block, x, lens, cfg.enc_heads, cd,
                                   att_left=cfg.enc_att_left,
                                   chunk_att=cfg.enc_chunk_att)

        n = cfg.enc_layers
        for i, block in enumerate(params["encoder"][1:]):
            x = _remat(cfg, blk, block, x)
            if dropping and i < n - 1:
                x = _dropout(x, dropout, drop, site=i)
        return mask_padding(x, lens), lens

    def run_layer(layer, x, lens):
        if cfg.bidirectional:
            return bilstm_layer(layer["fwd"], layer["bwd"], x, lens,
                                compute_dtype=cd)
        return lstm_layer(layer, x, compute_dtype=cd)[0]

    n = len(params["encoder"])
    for i, layer in enumerate(params["encoder"]):
        x = _remat(cfg, run_layer, layer, x, lens)
        if dropping and i < n - 1:
            x = _dropout(x, dropout, drop, site=i)
        if i == 0 and cfg.time_reduction > 1:
            x = mask_padding(x, lens)
            x, lens = _time_reduce(x, lens, cfg.time_reduction)
    return mask_padding(x, lens), lens


def _remat(cfg: TransducerConfig, fn, *args):
    """fn(*args), recomputed in the backward under cfg.remat_encoder
    (JAX's `jax.checkpoint` of an encoder block or layer); a plain call
    when nothing needs a gradient."""
    if cfg.remat_encoder and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _check_streamable(cfg: TransducerConfig) -> None:
    """The JAX package's refusals of an encoder that cannot stream."""
    if not cfg.streamable:
        raise ValueError(
            "streaming a conformer requires enc_att_left > 0 (causal/"
            "windowed) or enc_chunk_att > 0 (chunked lookahead); full "
            "attention needs the whole utterance"
            if cfg.enc_type == "conformer"
            else "streaming requires a unidirectional encoder")
    check_supported(cfg)


def init_enc_state(cfg: TransducerConfig, batch: int,
                   device: str | torch.device = "cuda"):
    """Streaming encoder carry: per-layer (h, c) f32 for the
    unidirectional LSTM, or {"n_seen": (B,) frames consumed, "blocks":
    per-block attention / conv caches} for the causal or chunked
    conformer."""
    _check_streamable(cfg)
    if cfg.enc_type == "conformer":
        return {"n_seen": torch.zeros((batch,), dtype=torch.int32,
                                      device=device),
                "blocks": [init_block_cache(batch, cfg.enc_hidden,
                                            cfg.enc_att_left,
                                            cfg.enc_conv_kernel, device)
                           for _ in range(cfg.enc_layers)]}
    return [(torch.zeros((batch, cfg.enc_hidden), dtype=torch.float32,
                         device=device),
             torch.zeros((batch, cfg.enc_hidden), dtype=torch.float32,
                         device=device))
            for _ in range(cfg.enc_layers)]


def encode_chunk(params: Params, cfg: TransducerConfig, feats, chunk_lens,
                 enc_state):
    """Streaming encoder step: one chunk of frames with the carried state.

    feats (B, C, input_dim) with C % time_reduction == 0. Only an
    utterance's last chunk may be partly valid (chunk_lens < C): the
    carried state past chunk_lens is garbage, harmless once the stream
    ends there. Unlike `encode`, the LSTM branch zeroes the pad rows after
    every layer, as the JAX function does. Returns (enc_out (B, C', De),
    enc_lens (B,), new_enc_state).
    """
    _check_streamable(cfg)
    params = maybe_dequant_tree(params, keep=("w_hh",))  # see encode()
    C = feats.shape[1]
    if cfg.time_reduction > 1 and C % cfg.time_reduction:
        raise ValueError(f"chunk frames {C} must be divisible by "
                         f"time_reduction {cfg.time_reduction}")
    x = mask_padding(feats.float(), chunk_lens)
    lens = chunk_lens.to(device=x.device, dtype=torch.int32)
    cd = cfg.cdtype
    if cfg.enc_type == "conformer":
        if cfg.time_reduction > 1:
            x, lens = _time_reduce(x, lens, cfg.time_reduction)
        if cfg.enc_chunk_att > 0 and x.shape[1] % cfg.enc_chunk_att:
            raise ValueError(
                f"chunked attention: encoded chunk {x.shape[1]} must be a "
                f"multiple of enc_chunk_att {cfg.enc_chunk_att} (chunk "
                "starts must align across streaming and offline)")
        proj = params["encoder"][0]["in_proj"]
        x = _dot(x, proj["w"], cd) + proj["b"].float()
        n_seen = enc_state["n_seen"]
        blocks = []
        for block, cache in zip(params["encoder"][1:], enc_state["blocks"]):
            x, cache = conformer_block_chunk(
                block, x, cache, n_seen, lens, cfg.enc_heads, cd,
                cfg.enc_att_left, chunk_att=cfg.enc_chunk_att)
            blocks.append(cache)
        return mask_padding(x, lens), lens, {"n_seen": n_seen + lens,
                                             "blocks": blocks}
    new_state = []
    for i, (layer, (h0, c0)) in enumerate(zip(params["encoder"],
                                              enc_state)):
        x, (h, c) = lstm_layer(layer, x, h0, c0, compute_dtype=cd)
        new_state.append((h, c))
        x = mask_padding(x, lens)
        if i == 0 and cfg.time_reduction > 1:
            x, lens = _time_reduce(x, lens, cfg.time_reduction)
    return x, lens, new_state


def predict_step(params: Params, cfg: TransducerConfig, label, states):
    """Single step of the prediction network (for decoding).

    label: (B,) int (the last emitted label; blank id = start symbol).
    states: for the LSTM predictor a list per layer of (h, c) each (B, H);
    for pred_type="stateless" the (B, pred_context - 1) int32 buffer of
    the most recently consumed label ids. Returns (out (B, H), states').
    A decode loop builds `DecodeWeights` once and steps that instead.
    """
    check_supported(cfg)
    return DecodeWeights(params, cfg).predict_step(label, states)


def init_pred_state(cfg: TransducerConfig, batch: int,
                    device: str | torch.device = "cuda"):
    """The predictor's decode state before any label: per-layer zero (h, c)
    f32 for the LSTM predictor; for pred_type="stateless" a (batch,
    pred_context - 1) int32 buffer of blanks ((batch, 0) at context 1)."""
    check_supported(cfg)
    if cfg.pred_type == "stateless":
        return torch.full((batch, cfg.pred_context - 1), cfg.blank,
                          dtype=torch.int32, device=device)
    return [
        (torch.zeros((batch, cfg.pred_hidden), dtype=torch.float32,
                     device=device),
         torch.zeros((batch, cfg.pred_hidden), dtype=torch.float32,
                     device=device))
        for _ in range(cfg.pred_layers)
    ]


def joint_step(params: Params, cfg: TransducerConfig, enc_t, pred_u):
    """Joint for single (t, u) positions: enc_t (B, De), pred_u (B, Dp) -> (B, V) fp32."""
    dw = DecodeWeights(params, cfg)
    return dw.joint(dw.enc_proj(enc_t), dw.pred_proj(pred_u))


def joint_step_tdt(params: Params, cfg: TransducerConfig, enc_t, pred_u):
    """TDT joint for single positions: enc_t (B, De), pred_u (B, Dp) ->
    (logits (B, V), dur_logits (B, D)), both fp32."""
    dw = DecodeWeights(params, cfg)
    return dw.joint_tdt(dw.enc_proj(enc_t), dw.pred_proj(pred_u))


class DecodeWeights:
    """The predictor's and the joint's weights rounded to the compute dtype
    once, and the one body of `predict_step` and `joint_step`: a decode
    loop builds it once a call, so that its products round only their
    activations (`_dot`'s rounding, without a weight cast a step) and int8
    params are dequantized once. The joint is split, `joint(enc_proj(enc),
    pred_proj(pred))`, so that a loop can project the encoder output once
    for all frames and share the predictor side between two joints.
    `predict_step(label, states)` takes the LSTM predictor's list of (h, c)
    a layer or the stateless predictor's (B, pred_context - 1) int32 label
    buffer, as `init_pred_state` makes them."""

    def __init__(self, params: Params, cfg: TransducerConfig):
        params = maybe_dequant_tree(params)
        cd = self.cd = cfg.cdtype

        def r(w):
            return w.to(cd).float()

        self.embed = params["embed"]
        self.stateless = cfg.pred_type == "stateless"
        if self.stateless:  # one projection of the label window
            lay = params["predictor"][0]
            self.win_w, self.win_b = r(lay["w"]), lay["b"].float()
        else:
            self.layers = [(r(lay["w_ih"]), lay["b"].float(),
                            r(lay["w_hh"]))
                           for lay in params["predictor"]]
        jp = params["joint"]
        self.enc_w, self.enc_b = (r(jp["enc_proj"]["w"]),
                                  jp["enc_proj"]["b"].float())
        self.pred_w, self.pred_b = (r(jp["pred_proj"]["w"]),
                                    jp["pred_proj"]["b"].float())
        self.out_w, self.out_b = r(jp["out"]["w"]), jp["out"]["b"].float()
        if "dur" in jp:  # the TDT duration head
            self.dur_w, self.dur_b = r(jp["dur"]["w"]), jp["dur"]["b"].float()
        self.moe = None
        if cfg.joint_experts > 0:  # the dense residual MoE, w1 / w2 rounded
            mp = params["moe"]
            self.moe = {"router": mp["router"].float(), "w1": r(mp["w1"]),
                        "b1": mp["b1"].float(), "w2": r(mp["w2"]),
                        "b2": mp["b2"].float()}

    def _mm(self, x, w):
        return torch.matmul(x.to(self.cd).float(), w)

    def predict_step(self, label, states):
        if self.stateless:
            # the window: the buffered ids, then this label (JAX :362-373)
            win = torch.cat([states.to(torch.int32),
                             label.to(torch.int32)[:, None]], dim=1)
            x = self.embed[win.long()].reshape(win.shape[0], -1)
            return self._mm(x, self.win_w) + self.win_b, win[:, 1:]
        x = self.embed[label]
        new_states = []
        for (w_ih, b, w_hh), (h, c) in zip(self.layers, states):
            gates = (self._mm(x, w_ih) + b) + self._mm(h, w_hh)
            h, c = cell_update(gates, c)
            new_states.append((h, c))
            x = h
        return x, new_states

    def enc_proj(self, enc):
        return self._mm(enc, self.enc_w) + self.enc_b

    def pred_proj(self, pred):
        return self._mm(pred, self.pred_w) + self.pred_b

    def joint(self, f, g):
        z = torch.tanh(f + g)
        if self.moe is not None:  # JAX joint_step's dense residual
            shape = z.shape
            y, _ = moe_dense(self.moe, z.reshape(-1, shape[-1]),
                             compute_dtype=self.cd, rounded=True)
            z = z + y.reshape(shape)
        return self._mm(z, self.out_w) + self.out_b

    def joint_tdt(self, f, g):
        """(token logits, duration logits) off one activation."""
        z = torch.tanh(f + g)
        return (self._mm(z, self.out_w) + self.out_b,
                self._mm(z, self.dur_w) + self.dur_b)


def predict(params: Params, cfg: TransducerConfig, labels, *,
            dropout: float = 0.0, embed_dropout: float = 0.0, drop=None):
    """Prediction network over blank-prefixed labels.

    labels (B, U) -> (outputs (B, U+1, pred_hidden), final states): position
    u conditions on labels[:u]; u = 0 is the start symbol, the blank
    embedding. The final states are a list of (h, c) per layer, or for the
    stateless predictor the (B, pred_context - 1) int32 ids of the last
    inputs, as `predict_step` leaves them. The stateless output at u is
    one projection of the window of the last pred_context input
    embeddings, blank-padded before the start (JAX :323-342).
    dropout / embed_dropout (with a mask source `drop`, see `_dropout`):
    between the LSTM layers and on the label embeddings.
    """
    check_supported(cfg)
    params = maybe_dequant_tree(params)
    B = labels.shape[0]
    labels = labels.to(torch.int64)
    bos = torch.full((B, 1), cfg.blank, dtype=torch.int64,
                     device=labels.device)
    inp = torch.cat([bos, labels], dim=1)  # (B, U+1)
    x = params["embed"][inp]  # (B, U+1, E)
    if embed_dropout > 0.0 and drop is not None:
        x = _dropout(x, embed_dropout, drop, site=1000)
    if cfg.pred_type == "stateless":
        C, U1 = cfg.pred_context, inp.shape[1]
        pad = torch.full((B, C - 1), cfg.blank, dtype=torch.int64,
                         device=inp.device)
        xp = torch.cat([params["embed"][pad], x], dim=1)  # (B, U+C, E)
        win = torch.cat([xp[:, c:c + U1] for c in range(C)], dim=-1)
        layer = params["predictor"][0]
        out = _dot(win, layer["w"], cfg.cdtype) + layer["b"].float()
        ids = torch.cat([pad, inp], dim=1)[:, U1:].to(torch.int32)
        return out, ids
    states = []
    n = len(params["predictor"])
    for i, layer in enumerate(params["predictor"]):
        x, st = lstm_layer(layer, x, compute_dtype=cfg.cdtype)
        if dropout > 0.0 and drop is not None and i < n - 1:
            x = _dropout(x, dropout, drop, site=1001 + i)
        states.append(st)
    return x, states


def joint_activations(params: Params, cfg: TransducerConfig, enc_out,
                      pred_out):
    """Per-side joint activations for the fused joint + loss op:
    f = enc_proj(enc_out) (B, T, J), g = pred_proj(pred_out) (B, U+1, J),
    both fp32, and the output layer's w (J, V) and b (V,)."""
    params = maybe_dequant_tree(params)
    jp = params["joint"]
    cd = cfg.cdtype
    f = _dot(enc_out, jp["enc_proj"]["w"], cd) + jp["enc_proj"]["b"].float()
    g = _dot(pred_out, jp["pred_proj"]["w"], cd) + jp["pred_proj"]["b"].float()
    return f, g, jp["out"]["w"], jp["out"]["b"]


def _moe_residual(params: Params, cfg: TransducerConfig, z):
    """Residual top-1 MoE on the lattice's joint activations z (..., J)
    through the capacity buffer (`moe_top1`) -> (z', aux) (JAX
    `_moe_residual`; its dense form is `DecodeWeights.joint`'s)."""
    shape = z.shape
    y, aux = moe_top1(params["moe"], z.reshape(-1, shape[-1]),
                      capacity_factor=cfg.moe_capacity_factor,
                      compute_dtype=cfg.cdtype)
    return z + y.reshape(shape), aux


def joint(params: Params, cfg: TransducerConfig, enc_out, pred_out,
          with_aux: bool = False):
    """Joint network over the lattice: enc_out (B, T, De), pred_out
    (B, U+1, Dp) -> fp32 logits (B, T, U+1, V), materialised. With
    cfg.joint_experts > 0 the routed MoE residual runs on the lattice's
    activations; with_aux=True returns (logits, its load-balance loss),
    0 without experts."""
    check_supported(cfg)
    params = maybe_dequant_tree(params)
    f, g, w, b = joint_activations(params, cfg, enc_out, pred_out)
    z = torch.tanh(f[:, :, None, :] + g[:, None, :, :])
    aux = torch.zeros((), dtype=torch.float32, device=z.device)
    if cfg.joint_experts > 0:
        z, aux = _moe_residual(params, cfg, z)
    logits = _dot(z, w, cfg.cdtype) + b.float()
    return (logits, aux) if with_aux else logits


def joint_tdt(params: Params, cfg: TransducerConfig, enc_out, pred_out):
    """TDT joint over the lattice: (token logits (B, T, U+1, V), duration
    logits (B, T, U+1, D)), both fp32 and materialised, off one shared
    activation."""
    check_supported(cfg)
    params = maybe_dequant_tree(params)
    f, g, w, b = joint_activations(params, cfg, enc_out, pred_out)
    z = torch.tanh(f[:, :, None, :] + g[:, None, :, :])
    dur = params["joint"]["dur"]
    return (_dot(z, w, cfg.cdtype) + b.float(),
            _dot(z, dur["w"], cfg.cdtype) + dur["b"].float())


def ctc_logits(params: Params, cfg: TransducerConfig, enc_out):
    """CTC head: encoder output (B, T', De) -> (B, T', V) fp32 logits."""
    head = maybe_dequant_tree(params)["ctc_head"]
    return _dot(enc_out, head["w"], cfg.cdtype) + head["b"].float()


def forward(params: Params, cfg: TransducerConfig, feats, feat_lens,
            labels, with_aux: bool = False):
    """features + labels -> (logits (B, T', U+1, V), enc_lens (B,));
    with_aux=True gives ((logits, moe aux), enc_lens)."""
    enc_out, enc_lens = encode(params, cfg, feats, feat_lens)
    pred_out, _ = predict(params, cfg, labels)
    return joint(params, cfg, enc_out, pred_out,
                 with_aux=with_aux), enc_lens
