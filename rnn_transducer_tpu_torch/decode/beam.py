"""Batched RNN-T beam search with prefix merging (PyTorch port of
`rnn_transducer_tpu/decode/beam.py`).

All B utterances and K beams advance frame-synchronously with static
shapes. Per frame t, up to `expansions` label-emission rounds:
  * every live hypothesis deposits its blank transition ("move to frame
    t+1") into a fixed-size candidate pool;
  * label extensions are scored for all (beam, vocab) pairs at once and
    pruned to K with one selection over K*V;
after the rounds, the remaining live hypotheses are force-blanked into the
pool. The pool is then prefix-merged: candidates with identical label
sequences have their scores log-add-exp combined and one representative
kept (the prediction-network state is a function of the prefix alone, so
the merge is exact). Prefix equality is decided by a rolling hash (two
32-bit lanes + length) kept up to date on every append. The top K merged
candidates become the next frame's beams.

The JAX `lax.fori_loop` over frames becomes a Python loop over every frame
of the bucket, with frames past a row's length masked (`pick`), not
branched on: no tensor value reaches the host inside the loop, so the
loop runs without host syncs. What JAX's jit hoists out of its loop is
done once a call: int8 params dequantized, the weights rounded to the
compute dtype (`models/transducer.DecodeWeights`) and the joint's
encoder side projected for every frame. The carry keeps every field of
the JAX carry (`pred`, `conf`, `frame`, `foff`, `wake`, and the fusion
fields).

Three of JAX's primitives have no exact torch twin, and each is written
out: `lax.top_k` (the lower index first among equal values, which decides
the pool among the many dead beams at exactly -1e30) is a stable
descending sort (`_top_k`); the uint32 hash lanes are int64 lanes masked
to 32 bits, with the multiply split so that no int64 product overflows
(`_hash_append`); the merge's log-sum-exp is JAX's expression (max, then
log of the sum of exponentials, then the clamp), not `torch.logsumexp`.

Shallow fusion, as in JAX: `lm=(params, LMConfig or TransformerLMConfig,
weight[, ilm_weight])` adds weight * log P_lm(label | prefix) to label
emissions (the LM's next-token log-probs and state ride in the carry), a
nonzero ilm_weight subtracts the internal-LM estimate (the joint with the
encoder output zeroed, renormalised over labels); `context` (a
decode/context.py ContextBias) adds the trie's boost and advances each
beam's trie node; `ngram=(NgramLM, weight)` adds weight * lp[state,
label] and advances each beam's n-gram state. Their tables must lie on the
decode's device.

Multi-blank and TDT models (duration jumps), as in JAX: a transition that
consumes d > 1 frames (a big blank, or a TDT emission of duration d) sets
the beam's `wake` to t + d, and the beam sleeps: at frames before its wake
it enters the pool unchanged and pays nothing. A multi-blank model's
blank arcs are (V + k, durations[k]) beside the standard blank's (blank,
1). A TDT model's blank arcs are one a duration d > 0 (a blank of
duration 0 is skipped), each adding the duration head's log-prob; each of
the top K label extensions forks over the duration set, d > 0 asleep in
the pool, d = 0 live at this frame (the selection is over the token
scores before the fork: the duration log-probs are shared by a beam's
labels). The merge asks for equal wake as well as equal prefixes.
"""

from __future__ import annotations

import dataclasses

import torch

from rnn_transducer_tpu_torch.models import transducer as m
from rnn_transducer_tpu_torch.models.config import TransducerConfig

NEG_INF = -1.0e30

# Rolling-hash multipliers (odd -> bijective mod 2^32) for the two prefix
# hash lanes; a collision needs both lanes and the length to collide.
HASH_MULT = (1000003, 2654435761)
_MASK32 = 0xFFFFFFFF


def _hash_mult(device):
    """HASH_MULT's 16-bit halves, (2,) int64 each, on `device`."""
    mult = torch.tensor(HASH_MULT, dtype=torch.int64).to(device)
    return mult & 0xFFFF, mult >> 16


def _hash_append(h, lab, mult=None):
    """h: (..., 2) int64 lanes in [0, 2^32); lab: (...) int label ->
    h * HASH_MULT + (lab + 1), each lane mod 2^32: JAX's uint32 lanes bit
    for bit. The multiplier is split into 16-bit halves (`mult`, from
    `_hash_mult`) so that no product leaves int64."""
    lo, hi = _hash_mult(h.device) if mult is None else mult
    prod = (h * lo + (((h * hi) & 0xFFFF) << 16)) & _MASK32
    return (prod + (lab.to(torch.int64) + 1)[..., None]) & _MASK32


def _top_k(x, k: int):
    """`jax.lax.top_k` over the last dim: the k largest values, the lower
    index first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _pad_cols(x, n):
    """Zero-pad the last dim of (B, K, V) to n columns (multi-blank joints;
    a no-op for the standard model)."""
    if x.shape[-1] >= n:
        return x
    return torch.nn.functional.pad(x, (0, n - x.shape[-1]))


def _cap_lm_cache(lm, max_symbols: int):
    """Cap a transformer fusion LM's KV-cache length at max_symbols + 1.

    The decode emits at most max_symbols labels, so the LM consumes at most
    BOS + max_symbols positions and the cap is exact; without it every
    beam's caches ride the carry at the config's full max_len."""
    if lm is None:
        return lm
    from rnn_transducer_tpu_torch.models.lm_transformer import \
        TransformerLMConfig
    if isinstance(lm[1], TransformerLMConfig) and \
            lm[1].max_len > max_symbols + 1:
        return (lm[0], dataclasses.replace(lm[1], max_len=max_symbols + 1)) \
            + tuple(lm[2:])
    return lm


# ------------------------------ tree helpers -----------------------------

def _tree_map(fn, tree, *rest):
    """fn over the tensor leaves of dicts, lists and tuples of tensors."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_tree_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        # a NamedTuple takes its fields as arguments
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return fn(tree, *rest)


def _tree_cat(trees):
    """Concatenate same-structured trees of (B, n, ...) along dim 1."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_cat([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_cat([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.cat(trees, dim=1)


def _rows_taker(idx, N: int):
    """The gather x[b, idx[b, j], ...] of every x (B, N, ...) by one idx
    (B, M): JAX's take_along_axis over axis 1 with idx broadcast over the
    trailing dims, as one index_select over the flattened (B*N) rows; the
    flat row ids are formed once for all the leaves it gathers."""
    B, M = idx.shape
    rows = (idx.long() + N * torch.arange(B, device=idx.device)[:, None]
            ).reshape(-1)

    def take(x):
        tail = tuple(x.shape[2:])
        return x.reshape((B * N,) + tail).index_select(0, rows).reshape(
            (B, M) + tail)

    return take


def _take(x, idx):
    """x[b, idx[b, j], ...] for x (B, N, ...) and idx (B, M)."""
    return _rows_taker(idx, x.shape[1])(x)


# ------------------------------- the search ------------------------------

def init_beam_state(params, cfg: TransducerConfig, batch: int, *,
                    beam: int = 8, max_symbols: int = 200, lm=None,
                    context=None, ngram=None,
                    device: str | torch.device = "cuda",
                    decode_weights=None):
    """Initial beam carry: beam 0 = empty prefix, the others dead.

    (tokens (B, K, U) int32, lens (B, K) int32, scores (B, K) f32, hashes
    (B, K, 2) int64 32-bit lanes, outs, states) as in JAX: outs holds
    "pred", "conf" (each token's acoustic log-prob), "frame" (its global
    encoder frame), "foff" (frames consumed by earlier chunks), "wake"
    (the frame a beam next consumes: t for the standard model), and with
    fusion "lm_lp", "cb_node", "ng_state"; states holds "pred" (and "lm").
    `decode_weights`, a `DecodeWeights` of `params`, spares building it.
    """
    m.check_supported(cfg)
    dw = decode_weights or m.DecodeWeights(params, cfg)
    lm = _cap_lm_cache(lm, max_symbols)
    B, K, U = batch, beam, max_symbols
    dev = torch.device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    tokens0 = torch.full((B, K, U), cfg.blank, **i32)
    lens0 = torch.zeros((B, K), **i32)
    scores0 = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    scores0[:, 0] = 0.0
    hash0 = torch.zeros((B, K, 2), dtype=torch.int64, device=dev)
    pred0, states0 = dw.predict_step(
        torch.full((B * K,), cfg.blank, dtype=torch.int64, device=dev),
        m.init_pred_state(cfg, B * K, dev))

    def unflat(x):
        return x.reshape((B, K) + tuple(x.shape[1:]))

    outs = {"pred": unflat(pred0),
            "conf": torch.zeros((B, K, U), dtype=torch.float32, device=dev),
            "frame": torch.zeros((B, K, U), **i32),
            "foff": torch.zeros((B, K), **i32),
            "wake": torch.zeros((B, K), **i32)}
    states = {"pred": _tree_map(unflat, states0)}
    if lm is not None:
        from rnn_transducer_tpu_torch.models.lm import (BOS_ID,
                                                        init_lm_state,
                                                        lm_step)
        lm_params, lm_cfg = lm[0], lm[1]
        lm_lp0, lm_st0 = lm_step(
            lm_params, lm_cfg,
            torch.full((B * K,), BOS_ID, dtype=torch.int64, device=dev),
            init_lm_state(lm_cfg, B * K, dev))
        outs["lm_lp"] = unflat(lm_lp0)
        states["lm"] = _tree_map(unflat, lm_st0)
    if context is not None:  # every beam starts at the trie's root
        outs["cb_node"] = torch.zeros((B, K), **i32)
    if ngram is not None:  # (NgramLM, weight)
        outs["ng_state"] = torch.full((B, K), ngram[0].start, **i32)
    return (tokens0, lens0, scores0, hash0, outs, states)


def beam_search(params, cfg: TransducerConfig, enc_out, enc_lens, *,
                beam: int = 8, max_symbols: int = 200, expansions: int = 3,
                beam_state=None, lm=None, context=None, ngram=None,
                decode_weights=None):
    """Beam-search decode a batch of encoded utterances.

    Args:
      enc_out: (B, T, De); enc_lens: (B,).
      beam: beam width K. max_symbols: static cap on emitted labels.
      expansions: max label emissions per frame before a forced blank.
      beam_state: a carry from `init_beam_state` or an earlier call; None
        starts fresh utterances.
      lm, context, ngram: shallow fusion (module docstring).
      decode_weights: a `DecodeWeights` of `params` built by the caller
        (a stream builds it once, not once a chunk); None builds it here.

    Returns:
      tokens: (B, K, max_symbols) int32 blank-padded, best beam first.
      lengths: (B, K) int32.
      scores: (B, K) f32 merged (fused) log-probabilities.
      beam_state: the carry (unsorted).
    """
    m.check_supported(cfg)
    # int8 params dequantized and weights rounded to the compute dtype once
    # here, not in every step (the JAX package's jit hoists them out of its
    # loop); the encoder side of the joint is projected once for all frames
    dw = decode_weights or m.DecodeWeights(params, cfg)
    B, T, _ = enc_out.shape
    K, U = beam, max_symbols
    dev = enc_out.device
    enc_lens = enc_lens.to(device=dev, dtype=torch.int32)
    if lm is not None:
        from rnn_transducer_tpu_torch.models.lm import lm_step
        # the same cap as init_beam_state: the carried KV caches and the
        # step's config must agree on max_len (exact, see _cap_lm_cache)
        lm = _cap_lm_cache(lm, max_symbols)
        lm_params, lm_cfg, lm_w, *_rest = lm
        ilm_w = _rest[0] if _rest else 0.0
    V = cfg.vocab_size

    def flat(x):  # (B, K, ...) -> (B*K, ...)
        return x.reshape((B * K,) + tuple(x.shape[2:]))

    def unflat(x):
        return x.reshape((B, K) + tuple(x.shape[1:]))

    if beam_state is None:
        beam_state = init_beam_state(params, cfg, B, beam=K, max_symbols=U,
                                     lm=lm, context=context, ngram=ngram,
                                     device=dev, decode_weights=dw)
    # made once: a host-to-device copy inside the loop would sync
    neg = torch.tensor(NEG_INF, dtype=torch.float32).to(dev)
    mult = _hash_mult(dev)
    rows = torch.arange(B, device=dev)
    u_idx = torch.arange(U, device=dev)
    f_all = dw.enc_proj(enc_out)  # (B, T, J)
    # the internal LM's joint sees a zero encoder output: its projection
    # is the bias (JAX: joint_step on zeros_like(enc))
    f_ilm = (dw.enc_proj(torch.zeros((1, enc_out.shape[2]), device=dev))
             if lm is not None and ilm_w else None)
    C = cfg.n_classes
    col = torch.arange(C, device=dev)
    nonlabel = (col == cfg.blank) | (col >= V)  # blank, big blanks
    tdt = bool(cfg.tdt_durations)
    dvals = tuple(int(d) for d in cfg.tdt_durations)
    # (joint column, frames consumed) of each blank class: the standard
    # blank, and a multi-blank model's big blanks
    blank_arcs = [(cfg.blank, 1)] + [
        (V + k, int(d)) for k, d in enumerate(cfg.big_blank_durations)]
    carry = beam_state
    for t in range(T):
        tokens, lens, scores, hashes, outs, states = carry
        # the row's frame t; a zero-length row (inactive, its result
        # discarded by `pick`) gathers frame 0
        t_row = torch.clamp(torch.clamp(enc_lens - 1, max=t), min=0)
        f_t = f_all[rows, t_row.long()]  # (B, J), each row K times:
        f_tk = f_t[:, None].expand(B, K, f_t.shape[1]).reshape(B * K, -1)

        # Candidate pool: block 0 is the self-deposit of sleeping beams
        # (wake > t); for the standard model it is all NEG_INF.
        asleep = outs["wake"] > t  # (B, K)
        cand = [(tokens, lens, torch.where(asleep, scores, neg), hashes,
                 outs, states)]

        def with_wake(outs_d, lens_like, d):
            """outs with wake = t + d (this candidate sleeps d frames)."""
            o = dict(outs_d)
            o["wake"] = torch.full_like(lens_like, t + d)
            return o

        live = (tokens, lens, torch.where(asleep, neg, scores), hashes,
                outs, states)

        for e in range(expansions + 1):
            tokens, lens, scores, hashes, outs, states = live
            g = dw.pred_proj(flat(outs["pred"]))
            if tdt:
                logits, dur_logits = dw.joint_tdt(f_tk, g)
                dlp = unflat(torch.log_softmax(dur_logits, dim=-1))
            else:
                logits = dw.joint(f_tk, g)
            lp = unflat(torch.log_softmax(logits, dim=-1))
            # --- blank transitions: consume d frames, asleep until t+d ----
            if tdt:
                for i, d in enumerate(dvals):
                    if d:  # a blank of duration 0 would self-loop
                        cand.append((tokens, lens, scores + lp[:, :, cfg.blank]
                                     + dlp[:, :, i], hashes,
                                     with_wake(outs, lens, d), states))
            else:
                for c, d in blank_arcs:
                    cand.append((tokens, lens, scores + lp[:, :, c], hashes,
                                 with_wake(outs, lens, d), states))
            if e == expansions:
                break  # final round: forced blank only
            # --- label extensions, one selection over K*C an utterance ----
            ext = scores[:, :, None] + lp  # (B, K, C)
            if lm is not None:  # shallow fusion on label emissions
                ext = ext + lm_w * _pad_cols(outs["lm_lp"], C)
                if ilm_w:
                    # internal-LM estimate: the joint with the encoder
                    # output zeroed, renormalised over non-blank labels; a
                    # function of the prefix alone
                    masked = torch.where(nonlabel, neg,
                                         unflat(dw.joint(f_ilm, g)))
                    ilm_lp = torch.log_softmax(masked, dim=-1)
                    ext = ext - ilm_w * torch.where(nonlabel, 0.0, ilm_lp)
            if context is not None:  # phrase boosting on label emissions
                ext = ext + _pad_cols(context.delta[outs["cb_node"].long()],
                                      C)
            if ngram is not None:  # n-gram shallow fusion
                ext = ext + ngram[1] * _pad_cols(
                    ngram[0].lp[outs["ng_state"].long()], C)
            ext = torch.where(nonlabel | (lens >= U)[:, :, None], neg, ext)
            top_sc, top_idx = _top_k(ext.reshape(B, K * C), K)
            src = top_idx // C  # (B, K) source beam
            lab64 = top_idx % C
            lab = lab64.to(torch.int32)
            take = _rows_taker(src, K)
            g_tok = take(tokens)
            g_len = take(lens)
            # append the label at position g_len (nothing where g_len == U)
            write = u_idx == g_len[:, :, None]  # (B, K, U)
            g_tok = torch.where(write, lab[:, :, None], g_tok)
            g_hash = _hash_append(take(hashes), lab64, mult)
            g_states = _tree_map(take, states)
            # per-token confidence: the emission's acoustic log-prob
            conf_val = lp.reshape(B, K * C).gather(1, top_idx)  # (B, K)
            g_conf = torch.where(write, conf_val[:, :, None],
                                 take(outs["conf"]))
            # emission timestamp: the current global frame foff + t
            g_foff = take(outs["foff"])
            g_frame = torch.where(write, (g_foff + t)[:, :, None],
                                  take(outs["frame"]))
            new_pred, new_pred_states = dw.predict_step(
                flat(lab64), _tree_map(flat, g_states["pred"]))
            new_outs = {"pred": unflat(new_pred), "conf": g_conf,
                        "frame": g_frame, "foff": g_foff,
                        "wake": take(outs["wake"])}
            if context is not None:  # consume the label in the boost trie
                new_outs["cb_node"] = context.next_node[
                    take(outs["cb_node"]).long(), lab64]
            if ngram is not None:  # advance the n-gram context state
                new_outs["ng_state"] = ngram[0].next_state[
                    take(outs["ng_state"]).long(), lab64]
            new_states = {"pred": _tree_map(unflat, new_pred_states)}
            if lm is not None:
                new_lm_lp, new_lm_st = lm_step(
                    lm_params, lm_cfg, flat(lab64),
                    _tree_map(flat, g_states["lm"]))
                new_outs["lm_lp"] = unflat(new_lm_lp)
                new_states["lm"] = _tree_map(unflat, new_lm_st)
            g_len1 = torch.clamp(g_len + 1, max=U)
            if tdt:
                # every TDT emission consumes its duration: the top K fork
                # over the duration set, d > 0 into the pool (asleep until
                # t+d), d = 0 live, free to emit again at this frame
                dsel = take(dlp)
                for i, d in enumerate(dvals):
                    if d:
                        cand.append((g_tok, g_len1, top_sc + dsel[:, :, i],
                                     g_hash, with_wake(new_outs, g_len1, d),
                                     new_states))
                top_sc = (top_sc + dsel[:, :, dvals.index(0)] if 0 in dvals
                          else torch.full_like(top_sc, NEG_INF))
            live = (g_tok, g_len1, top_sc, g_hash, new_outs, new_states)

        # --- prefix merge over the pool -------------------------------------
        p_tok = torch.cat([c[0] for c in cand], dim=1)
        p_len = torch.cat([c[1] for c in cand], dim=1)
        p_sc = torch.cat([c[2] for c in cand], dim=1)
        p_h = torch.cat([c[3] for c in cand], dim=1)
        p_pr = _tree_cat([c[4] for c in cand])
        p_st = _tree_cat([c[5] for c in cand])
        P = p_sc.shape[1]
        same_len = p_len[:, :, None] == p_len[:, None, :]
        same_hash = (p_h[:, :, None, :] == p_h[:, None, :, :]).all(dim=-1)
        same_wake = p_pr["wake"][:, :, None] == p_pr["wake"][:, None, :]
        eq = same_len & same_hash & same_wake  # (B, P, P)
        # log-sum-exp of the scores over each equivalence class, as JAX
        sc_b = torch.where(eq, p_sc[:, None, :], neg)  # (B, P, P)
        mx = sc_b.max(dim=-1).values
        merged = mx + torch.log(torch.exp(sc_b - mx[:, :, None]).sum(dim=-1))
        merged = torch.where(mx <= NEG_INF * 0.5, neg, merged)
        # keep one representative per class: the lowest index
        idx = torch.arange(P, device=dev)
        first = torch.where(eq, idx, P).min(dim=-1).values
        merged = torch.where(first == idx, merged, neg)

        top_sc, top_i = _top_k(merged, K)  # (B, K)
        take = _rows_taker(top_i, P)
        new = (take(p_tok), take(p_len), top_sc, take(p_h),
               _tree_map(take, p_pr), _tree_map(take, p_st))

        # frames past a row's length leave its carry untouched
        active = t < enc_lens  # (B,)
        masks = {}

        def pick(n, o):
            if n.dim() not in masks:
                masks[n.dim()] = active.reshape((B,) + (1,) * (n.dim() - 1))
            return torch.where(masks[n.dim()], n, o)

        carry = _tree_map(pick, new, carry)

    # advance the global frame offset past this call's frames, and re-base
    # wake to the next call's frame numbering (0 for the standard model;
    # the clamp only touches dead beams)
    outs_f = dict(carry[4])
    outs_f["foff"] = outs_f["foff"] + enc_lens[:, None]
    outs_f["wake"] = torch.clamp(outs_f["wake"] - enc_lens[:, None], min=0)
    carry = carry[:4] + (outs_f,) + carry[5:]
    # beams by REPORTED score, best first (a stable sort, as jnp.argsort)
    scores = _reported_scores(carry, context)
    order = torch.argsort(-scores, dim=-1, stable=True)
    return (_take(carry[0], order), _take(carry[1], order),
            _take(scores, order), carry)


def _reported_scores(beam_state, context=None):
    """Carried scores adjusted for reporting: with contextual biasing, less
    the unlocked (dangling partial-match) boost. The carry keeps the raw
    score."""
    scores, outs = beam_state[2], beam_state[4]
    if context is not None:
        scores = scores - context.accum[outs["cb_node"].long()]
    return scores


def sorted_confidence(beam_state, context=None):
    """Per-token acoustic emission log-probs of each beam, in the best-first
    order of beam_search's returned tokens. Pass the same `context`."""
    order = torch.argsort(-_reported_scores(beam_state, context), dim=-1,
                          stable=True)
    return _take(beam_state[4]["conf"], order)


def sorted_frames(beam_state, context=None):
    """Per-token global encoder-frame emission indices of each beam, in the
    best-first order of the returned tokens. Pass the same `context`."""
    order = torch.argsort(-_reported_scores(beam_state, context), dim=-1,
                          stable=True)
    return _take(beam_state[4]["frame"], order)


def recognize_beam(params, cfg: TransducerConfig, feats, feat_lens, *,
                   beam: int = 8, max_symbols: int = 200,
                   expansions: int = 3, lm=None, context=None, ngram=None,
                   with_confidence: bool = False,
                   with_timestamps: bool = False):
    """Features -> N-best label sequences (tokens, lengths, scores).

    with_confidence=True appends (B, K, max_symbols) per-token acoustic
    emission log-probs; with_timestamps=True appends (B, K, max_symbols)
    int32 encoder-frame emission indices.
    """
    enc_out, enc_lens = m.encode(params, cfg, feats, feat_lens)
    tokens, lens, scores, carry = beam_search(
        params, cfg, enc_out, enc_lens, beam=beam,
        max_symbols=max_symbols, expansions=expansions, lm=lm,
        context=context, ngram=ngram)
    out = (tokens, lens, scores)
    if with_confidence:
        out = out + (sorted_confidence(carry, context),)
    if with_timestamps:
        out = out + (sorted_frames(carry, context),)
    return out
