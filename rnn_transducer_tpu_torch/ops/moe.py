"""Mixture-of-Experts FFN over lattice tokens, top-1 (Switch) routing
(PyTorch port of `rnn_transducer_tpu/ops/moe.py`).

A residual capacity extension of the joint: every (t, u) lattice cell's
joint activation is routed to one of E expert FFNs (relu, hidden H), so
the parameter count grows with E while a token's operations stay those
of one expert. Three forms, as in JAX:

  * `moe_dense`   every expert on every token, combined by the gate mask:
                  E times the operations; the decode steps' form (a few
                  tokens, never a dropped one) and the tests' anchor.
  * `moe_top1`    dispatch into a static (E, C, D) capacity buffer and
                  combine from it; a token past its expert's capacity
                  contributes 0 (the joint adds the MoE residually, so a
                  dropped token passes through). Equal to `moe_dense`
                  when C >= N.
  * `moe_top1_ep` `moe_top1` with the experts sharded over the model
                  group of a 2-D mesh (parallel/tp.py's "ep" mode): each
                  rank builds the (E, C, D) buffer of its own tokens, one
                  all-to-all sends every expert's slots to the rank that
                  holds it, the local experts run, a second all-to-all
                  sends the results back.

Routing is deterministic top-1 (`argmax`, the first of equal maxima) with
the Switch load-balance loss E * sum_e f_e P_e; the gate probability
scales the expert's output, so the router gets a gradient. The router
runs in f32; the expert products keep `_dot`'s contract (operands rounded
to the compute dtype, f32 products and sums), as batched `torch.matmul`:
JAX computes them as XLA einsums outside any Pallas kernel. A token's
queue position is the cumulative count over the flattened token order,
so a batch's (B, T, U+1) order decides who overflows, as in JAX.

The phases run under `torch.profiler.record_function` spans (SPANS).
"""

from __future__ import annotations

import math

import numpy as np
import torch

SPANS = ("moe_router", "moe_dispatch", "moe_experts", "moe_combine")
_span = torch.profiler.record_function


def init_moe_params(rng: np.random.Generator, n_experts: int, d_model: int,
                    d_hidden: int) -> dict[str, np.ndarray]:
    """The JAX `init_moe_params` shapes and distributions as numpy draws:
    router (D, E) and w1 (E, D, H) uniform(+-1/sqrt(D)), w2 (E, H, D)
    uniform(+-1/sqrt(H)), zero biases b1 (E, H) and b2 (E, D)."""
    s0 = 1.0 / math.sqrt(d_model)
    s1 = 1.0 / math.sqrt(d_hidden)

    def uni(shape, k):
        return rng.uniform(-k, k, size=shape).astype(np.float32)

    return {"router": uni((d_model, n_experts), s0),
            "w1": uni((n_experts, d_model, d_hidden), s0),
            "b1": np.zeros((n_experts, d_hidden), np.float32),
            "w2": uni((n_experts, d_hidden, d_model), s1),
            "b2": np.zeros((n_experts, d_model), np.float32)}


def _router(params, x):
    """x (N, D) -> (gate (N,), idx (N,), f (E,), P (E,)): f the fraction
    of tokens routed to each expert, P the mean router probability, the
    Switch statistics. Router math in f32."""
    logits = torch.matmul(x.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)  # (N, E)
    idx = torch.argmax(probs, dim=-1)  # the first of equal maxima
    gate = probs.gather(1, idx[:, None])[:, 0]
    E = probs.shape[-1]
    onehot = torch.nn.functional.one_hot(idx, E).to(torch.float32)
    return gate, idx, onehot.mean(dim=0), probs.mean(dim=0)


def router_top1(params, x):
    """x (N, D) -> (gate (N,), idx (N,), aux): aux = E * sum(f * P), 1.0
    at perfect balance."""
    gate, idx, f, P = _router(params, x)
    return gate, idx, f.shape[0] * torch.sum(f * P)


def _r(w, cd, rounded: bool):
    return w.float() if rounded else w.to(cd).float()


def _expert_ffn(params, buf, cd, rounded: bool = False):
    """buf (E, C, D) -> (E, C, D): each expert's relu FFN on its slots."""
    h = torch.relu(torch.matmul(buf.to(cd).float(),
                                _r(params["w1"], cd, rounded))
                   + params["b1"].float()[:, None, :])
    return (torch.matmul(h.to(cd).float(), _r(params["w2"], cd, rounded))
            + params["b2"].float()[:, None, :])


def moe_dense(params, x, *, compute_dtype=torch.bfloat16,
              rounded: bool = False):
    """Every expert on every token, combined by the gate mask: x (N, D) ->
    ((N, D), aux). rounded: w1 and w2 are already rounded to the compute
    dtype (`DecodeWeights` rounds them once), so they are not cast again."""
    cd = compute_dtype
    gate, idx, aux = router_top1(params, x)
    h = torch.relu(torch.einsum("nd,edm->nem", x.to(cd).float(),
                                _r(params["w1"], cd, rounded))
                   + params["b1"].float()[None])
    y = (torch.einsum("nem,emd->ned", h.to(cd).float(),
                      _r(params["w2"], cd, rounded))
         + params["b2"].float()[None])  # (N, E, D)
    E = params["b1"].shape[0]
    pick = (torch.nn.functional.one_hot(idx, E).to(torch.float32)
            * gate[:, None])
    return torch.einsum("ned,ne->nd", y, pick), aux


def capacity(n_tokens: int, n_experts: int, capacity_factor: float) -> int:
    """Slots an expert: C = max(1, ceil(N * capacity_factor / E))."""
    return max(1, math.ceil(n_tokens * capacity_factor / n_experts))


def _dispatch(x, idx, E: int, C: int):
    """Scatter tokens into a (E, C, D) capacity buffer -> (buf, slot,
    keep): slot the token's place in its expert's queue (0 when dropped),
    keep whether it made the capacity."""
    onehot = torch.nn.functional.one_hot(idx, E).to(torch.int32)  # (N, E)
    pos = (torch.cumsum(onehot, dim=0) - 1).gather(1, idx[:, None])[:, 0]
    keep = pos < C
    slot = torch.where(keep, pos, torch.zeros_like(pos)).to(torch.int64)
    contrib = torch.where(keep[:, None], x, torch.zeros_like(x))
    buf = torch.zeros((E, C, x.shape[1]), dtype=x.dtype, device=x.device)
    buf = buf.index_put((idx, slot), contrib, accumulate=True)
    return buf, slot, keep


def moe_top1(params, x, *, capacity_factor: float = 1.25,
             compute_dtype=torch.bfloat16):
    """Top-1 routed MoE through a static capacity buffer: x (N, D) ->
    ((N, D), aux), with C = `capacity(N, E, capacity_factor)` slots an
    expert; an overflowing token's output is 0. `moe_top1_ep` on one
    shard: the exchange is the identity and the statistics stay local."""
    return moe_top1_ep(params, x, exchange=lambda t: t, n_shards=1,
                       capacity_factor=capacity_factor,
                       compute_dtype=compute_dtype)


def moe_top1_ep(params_local, x, *, exchange, n_shards: int,
                capacity_factor: float = 1.25, compute_dtype=torch.bfloat16,
                stats_mean=None):
    """Expert-parallel `moe_top1` on one rank of a model group of
    n_shards ranks.

    params_local: the rank's E_loc = E / n_shards experts (w1, b1, w2, b2
    with E_loc leading) and the whole router (D, E). x (N_loc, D): the
    rank's tokens. exchange(t): the model group's all-to-all of t
    (n_shards, ...) along dim 0 (row s to rank s, row s of the result
    from rank s), differentiable with the reverse exchange as its
    backward (parallel/tp.py). stats_mean(t): the mean of t over the
    ranks that share the load-balance statistics (differentiable), so
    that aux is the one-process value over the union of their tokens;
    None keeps them local. Capacity is per rank and expert: C =
    `capacity(N_loc, E, capacity_factor)`, as JAX's."""
    N, D = x.shape
    E_loc = params_local["b1"].shape[0]
    E = E_loc * n_shards
    C = capacity(N, E, capacity_factor)
    with _span("moe_router"):
        gate, idx, f, P = _router(params_local, x)
        if stats_mean is not None:
            f, P = stats_mean(f), stats_mean(P)
        aux = E * torch.sum(f * P)
    with _span("moe_dispatch"):
        buf, slot, keep = _dispatch(x, idx, E, C)  # (E, C, D)
        recv = exchange(buf.reshape(n_shards, E_loc, C, D))
    with _span("moe_experts"):
        flat = recv.transpose(0, 1).reshape(E_loc, n_shards * C, D)
        yb = _expert_ffn(params_local, flat, compute_dtype)
        yb = yb.reshape(E_loc, n_shards, C, D).transpose(0, 1).contiguous()
    with _span("moe_combine"):
        yb = exchange(yb).reshape(E, C, D)
        y = yb[idx, slot] * (gate * keep)[:, None]
    return y, aux
