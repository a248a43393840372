"""Greedy RNN-T decoding in one program per utterance (PyTorch port of
`rnn_transducer_tpu/decode/greedy_pallas.py`).

The whole greedy loop of an utterance runs inside one kernel launch,
`csrc/greedy_fused.cu` (K9, replacing `greedy_decode_fused`'s Pallas
kernel), with no host sync per step; the lock-step decoder
(`decode/greedy.py`) syncs the host once per step. The encoder side of the
joint, f = enc_out @ enc_proj + b, is one matmul before the loop.

Dtypes follow the JAX kernel: the activations (embedding rows, h, z) are
rounded to the compute dtype, the weights stay f32 (`jnp.dot(bf16, f32)`
promotes to f32), so the products are `_act_dot`, not the port's `_dot`,
which rounds both operands.

`greedy_fused_tokens` launches the kernel for CUDA tensors and runs
`greedy_fused_tokens_reference` for CPU tensors; it never falls back from
one to the other. `LAUNCHES` counts the calls that launched the kernel.
Outputs carry tokens and lengths only (no confidences or timestamps), so
the serving engine keeps the lock-step decoder.
"""

from __future__ import annotations

import threading

import torch

from rnn_transducer_tpu_torch.models import transducer as m
from rnn_transducer_tpu_torch.models.config import TransducerConfig
from rnn_transducer_tpu_torch.ops.lstm import _dot
from rnn_transducer_tpu_torch.ops.quant import maybe_dequant_tree
from rnn_transducer_tpu_torch.utils import build

LANE = 128
LAUNCHES = 0  # calls that launched greedy_fused
_launches_lock = threading.Lock()


def supported(cfg: TransducerConfig) -> bool:
    """The JAX kernel's predicate: one predictor layer, E, H and J
    multiples of 128."""
    return (cfg.pred_layers == 1
            and cfg.embed_dim % LANE == 0
            and cfg.pred_hidden % LANE == 0
            and cfg.joint_dim % LANE == 0)


def _act_dot(x: torch.Tensor, w: torch.Tensor,
             cdtype: torch.dtype) -> torch.Tensor:
    """x @ w with x rounded to `cdtype` and w kept f32, an f32 result."""
    return torch.matmul(x.to(cdtype).float(), w.float())


def _check(f, lens, weights, max_symbols: int, blank: int):
    if f.dim() != 3:
        raise ValueError(f"f must be (B, T, J); got {tuple(f.shape)}")
    B, _, J = f.shape
    embed, w_ih, w_hh, b, wp, bp, wo, bo = weights
    V, E = embed.shape
    H = w_hh.shape[0]
    shapes = {"lens": (lens, (B,)), "embed": (embed, (V, E)),
              "w_ih": (w_ih, (E, 4 * H)), "w_hh": (w_hh, (H, 4 * H)),
              "b": (b, (4 * H,)), "wp": (wp, (H, J)), "bp": (bp, (J,)),
              "wo": (wo, (J, V)), "bo": (bo, (V,))}
    for name, (a, shape) in shapes.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}; got {tuple(a.shape)}")
        want = torch.int32 if name == "lens" else torch.float32
        if a.dtype != want:
            raise TypeError(f"{name} must be {want}; got {a.dtype}")
    if f.dtype != torch.float32:
        raise TypeError(f"f must be float32; got {f.dtype}")
    if max_symbols < 1 or not 0 <= blank < V:
        raise ValueError(f"max_symbols {max_symbols} or blank {blank} out of "
                         "range")
    named = [("f", f), *((n, a) for n, (a, _) in shapes.items())]
    if len({a.device for _, a in named}) != 1:
        raise ValueError("inputs on different devices")
    for name, a in named:
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def greedy_fused_tokens(f, lens, weights, max_symbols: int, blank: int,
                        cdtype: torch.dtype):
    """tokens (B, max_symbols) int32, blank-padded, and steps (B,) int32,
    the loop iterations each utterance ran.

    f (B, T, J) f32 is the encoder side of the joint, lens (B,) int32 the
    valid frames; weights = (embed (V, E), w_ih (E, 4H), w_hh (H, 4H),
    b (4H,), pred_proj w (H, J), pred_proj b (J,), out w (J, V),
    out b (V,)), all f32.
    """
    global LAUNCHES
    _check(f, lens, weights, max_symbols, blank)
    dev = f.device
    if dev.type == "cpu":
        return greedy_fused_tokens_reference(f, lens, weights, max_symbols,
                                             blank, cdtype)
    if dev.type != "cuda":
        raise ValueError(f"no fused greedy decode for device {dev}")
    B, T, J = f.shape
    embed, w_hh = weights[0], weights[2]
    fn = build.load_library()
    tokens = torch.empty((B, max_symbols), dtype=torch.int32, device=dev)
    steps = torch.empty((B,), dtype=torch.int32, device=dev)
    err = fn.greedy_fused(
        f.data_ptr(), lens.data_ptr(), *(w.data_ptr() for w in weights),
        tokens.data_ptr(), steps.data_ptr(), B, T, embed.shape[1],
        w_hh.shape[0], J, embed.shape[0], max_symbols, blank,
        int(cdtype == torch.bfloat16), *build.stream_args(dev))
    build.check_launch(fn, err, "greedy_fused")
    with _launches_lock:
        LAUNCHES += 1
    return tokens, steps


def greedy_fused_tokens_reference(f, lens, weights, max_symbols: int,
                                  blank: int, cdtype: torch.dtype):
    """The plain version: the JAX kernel's loop for all utterances at once,
    the prediction network computed every step and selected where a row
    emits, until every row is done."""
    _check(f, lens, weights, max_symbols, blank)
    embed, w_ih, w_hh, b, wp, bp, wo, bo = weights
    B, _, J = f.shape
    H = w_hh.shape[0]
    dev = f.device
    rows = torch.arange(B, device=dev)

    def pred_step(k, h, c):
        gates = (_act_dot(embed[k], w_ih, cdtype) + _act_dot(h, w_hh, cdtype)
                 + b)
        i, fg, gg, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(fg) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        return _act_dot(h, wp, cdtype) + bp, h, c

    zeros = torch.zeros((B, H), dtype=torch.float32, device=dev)
    g, h, c = pred_step(torch.full((B,), blank, device=dev), zeros, zeros)
    lens = lens.long()
    t = torch.zeros(B, dtype=torch.long, device=dev)
    u = torch.zeros(B, dtype=torch.long, device=dev)
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    tokens = torch.full((B, max_symbols), blank, dtype=torch.int32,
                        device=dev)
    done = (t >= lens) | (u >= max_symbols)
    while not bool(done.all()):
        t_safe = torch.minimum(t, (lens - 1).clamp(min=0))
        z = torch.tanh(f[rows, t_safe] + g)
        k = torch.argmax(_act_dot(z, wo, cdtype) + bo, dim=-1)
        emit = (k != blank) & ~done
        tokens[rows[emit], u[emit]] = k[emit].to(torch.int32)
        g2, h2, c2 = pred_step(torch.where(emit, k, blank), h, c)
        e = emit[:, None]
        g, h, c = (torch.where(e, g2, g), torch.where(e, h2, h),
                   torch.where(e, c2, c))
        steps += (~done).to(torch.int32)
        u = u + emit.long()
        t = t + ((k == blank) & ~done).long()
        done = (t >= lens) | (u >= max_symbols)
    return tokens, steps


def greedy_decode_fused(params, cfg: TransducerConfig, enc_out, enc_lens,
                        max_symbols: int = 200):
    """Greedy decode of a batch of encoded utterances, one program each.

    Returns tokens (B, max_symbols) int32, blank-padded, and lengths (B,)
    int32, the count of non-blank tokens: the first two results of
    `greedy.greedy_decode`. Raises ValueError for a config outside
    `supported()`; it never falls back to the lock-step decoder.
    """
    f, lens, weights = fused_inputs(params, cfg, enc_out, enc_lens)
    tokens, _ = greedy_fused_tokens(f, lens, weights, max_symbols, cfg.blank,
                                    cfg.cdtype)
    lengths = (tokens != cfg.blank).sum(dim=1, dtype=torch.int32)
    return tokens, lengths


def fused_inputs(params, cfg: TransducerConfig, enc_out, enc_lens):
    """The arguments of `greedy_fused_tokens` for an encoded batch: f (the
    encoder side of the joint, one matmul), int32 lengths and the f32
    weights. Raises ValueError for a config outside `supported()`."""
    m.check_supported(cfg)
    if not supported(cfg):
        raise ValueError("greedy_decode_fused needs one predictor layer and "
                         "E, H, J multiples of 128; use decode.greedy")
    params = maybe_dequant_tree(params)  # int8 serving params
    jp = params["joint"]
    f = (_dot(enc_out, jp["enc_proj"]["w"], cfg.cdtype)
         + jp["enc_proj"]["b"].float()).contiguous()  # (B, T, J)
    layer = params["predictor"][0]
    weights = tuple(w.float().contiguous() for w in (
        params["embed"], layer["w_ih"], layer["w_hh"], layer["b"],
        jp["pred_proj"]["w"], jp["pred_proj"]["b"], jp["out"]["w"],
        jp["out"]["b"]))
    lens = enc_lens.to(device=f.device, dtype=torch.int32).contiguous()
    return f, lens, weights


def recognize_greedy_fused(params, cfg: TransducerConfig, feats, feat_lens,
                           max_symbols: int = 200):
    """Features -> (tokens, lengths) through `encode` and the fused loop."""
    enc_out, enc_lens = m.encode(params, cfg, feats, feat_lens)
    return greedy_decode_fused(params, cfg, enc_out, enc_lens, max_symbols)
