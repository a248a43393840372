"""CTC decoding: batched greedy collapse and prefix beam search (PyTorch
port of `rnn_transducer_tpu/decode/ctc.py`).

The CTC head (`models/transducer.ctc_logits`, trained by the CLI's
--ctc-pretrain-steps or --ctc-weight) decodes without the prediction
network:

* `ctc_greedy_decode`: the argmax a frame, repeats collapsed, blanks
  dropped, the kept tokens compacted by a cumsum into `max_symbols`
  columns. JAX's `mode="drop"` scatter becomes a scatter into one spare
  column past the end, which is then cut off. No loop over frames.

* `ctc_prefix_beam_search`: Hannun et al.'s prefix search, batch-
  synchronous with static shapes. Every prefix carries its (p_blank,
  p_nonblank) mass; each frame builds a pool of K * (1 + C) candidates
  (the K prefixes themselves, and each extended by one of the frame's
  top C labels), merges equal prefixes by log-sum-exp (the rolling hash
  of decode/beam.py, `_hash_append`, decides equality) and keeps the top
  K (`_top_k`, ties as `lax.top_k`). The JAX `fori_loop` becomes a Python
  loop over the bucket's frames, frames past a row's length masked, with
  no host sync inside. Shallow fusion as in JAX: `lm=(params, LMConfig or
  TransformerLMConfig, weight)` and `ngram=(NgramLM, weight)` add their
  weighted log-prob to every extension, their state riding the carry;
  `length_bonus` adds a constant an extension.

`recognize_ctc` runs the encoder and the head and one of the two.
"""

from __future__ import annotations

import torch

from rnn_transducer_tpu_torch.decode.beam import (_cap_lm_cache,
                                                  _hash_append, _hash_mult,
                                                  _take, _top_k, _tree_map)

NEG_INF = -1.0e30


def _logaddexp(a, b):
    """log(e^a + e^b) with the JAX package's NEG_INF clamp."""
    m = torch.maximum(a, b)
    m_safe = torch.clamp(m, min=NEG_INF)
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe))
    return torch.where(m <= NEG_INF * 0.5, NEG_INF, out)


def ctc_greedy_decode(logits, frame_lens, *, blank: int = 0,
                      max_symbols: int = 200):
    """Best-path CTC decode of logits (B, T, V) (or log-probs) over
    frame_lens (B,) valid frames.

    Returns tokens (B, max_symbols) int32 blank-padded; lengths (B,) int32
    (tokens past max_symbols are dropped); confs (B, max_symbols) f32, the
    emitting frame's log-probability of each token, 0 past the length;
    frames (B, max_symbols) int32, the first frame of each token's run, 0
    past the length."""
    B, T, _ = logits.shape
    dev = logits.device
    frame_lens = frame_lens.to(device=dev, dtype=torch.int32)
    k = torch.argmax(logits, dim=-1)  # (B, T), the first of equal maxima
    lp = torch.log_softmax(logits.float(), dim=-1)
    k_lp = lp.gather(2, k[..., None])[..., 0]
    t_ids = torch.arange(T, device=dev, dtype=torch.int32)[None, :]
    prev = torch.cat([torch.full_like(k[:, :1], blank), k[:, :-1]], dim=1)
    keep = (k != blank) & (k != prev) & (t_ids < frame_lens[:, None])
    pos = torch.cumsum(keep, dim=1) - 1
    # kept tokens to their compacted columns; the rest to a spare column
    dst = torch.where(keep & (pos < max_symbols), pos, max_symbols)

    def scatter(fill, src, dtype):
        out = torch.full((B, max_symbols + 1), fill, dtype=dtype, device=dev)
        return out.scatter_(1, dst, src.to(dtype))[:, :max_symbols]

    tokens = scatter(blank, k, torch.int32)
    confs = scatter(0.0, k_lp, torch.float32)
    frames = scatter(0, t_ids.expand(B, T), torch.int32)
    lengths = torch.clamp(keep.sum(dim=1), max=max_symbols).to(torch.int32)
    return tokens, lengths, confs, frames


def ctc_prefix_beam_search(log_probs, frame_lens, *, beam: int = 8,
                           cand: int = 8, blank: int = 0,
                           max_symbols: int = 200, lm=None, ngram=None,
                           length_bonus: float = 0.0):
    """Prefix beam search over CTC log-posteriors log_probs (B, T, V)
    (log-softmax outputs) and frame_lens (B,).

    beam: K prefixes kept a frame; cand: the top C non-blank labels of a
    frame tried as extensions (C <= V - 1); max_symbols: the cap on a
    prefix's length; lm, ngram, length_bonus: shallow fusion (module
    docstring); their tables must lie on log_probs' device.

    Returns tokens (B, K, max_symbols) int32 blank-padded, best first;
    lengths (B, K) int32; scores (B, K) f32, log P(prefix) =
    logaddexp(p_blank, p_nonblank) over every alignment that collapses to
    it (within the beam and candidate pruning), the fused score with
    fusion."""
    B, T, V = log_probs.shape
    K, U = beam, max_symbols
    C = min(cand, V - 1)
    P = K * (1 + C)  # the pool: K stays and K * C extensions
    dev = log_probs.device
    frame_lens = frame_lens.to(device=dev, dtype=torch.int32)
    log_probs = log_probs.float()
    i32 = dict(dtype=torch.int32, device=dev)

    def flat(x):  # (B, K, ...) -> (B*K, ...)
        return x.reshape((B * K,) + tuple(x.shape[2:]))

    def unflat(x):
        return x.reshape((B, K) + tuple(x.shape[1:]))

    tokens = torch.full((B, K, U), blank, **i32)
    lens = torch.zeros((B, K), **i32)
    # beam 0 is the empty prefix with all its mass ending in blank; the
    # other beams start dead
    pb = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    pb[:, 0] = 0.0
    pnb = torch.full((B, K), NEG_INF, dtype=torch.float32, device=dev)
    hashes = torch.zeros((B, K, 2), dtype=torch.int64, device=dev)
    outs = {}
    if lm is not None:
        from rnn_transducer_tpu_torch.models.lm import (BOS_ID,
                                                        init_lm_state,
                                                        lm_step)
        # prefixes hold at most max_symbols labels (decode/beam.py)
        lm = _cap_lm_cache(lm, max_symbols)
        lm_params, lm_cfg, lm_w = lm[0], lm[1], lm[2]
        lp0, st0 = lm_step(lm_params, lm_cfg,
                           torch.full((B * K,), BOS_ID, dtype=torch.int64,
                                      device=dev),
                           init_lm_state(lm_cfg, B * K, dev))
        outs["lm_lp"] = unflat(lp0)
        outs["lm_st"] = _tree_map(unflat, st0)
    if ngram is not None:
        outs["ng_state"] = torch.full((B, K), ngram[0].start, **i32)
    carry = (tokens, lens, pb, pnb, hashes, outs)

    # made once: a host-to-device copy inside the loop would sync
    mult = _hash_mult(dev)
    u_ids = torch.arange(U, device=dev)
    p_ids = torch.arange(P, device=dev)
    for t in range(T):
        tokens, lens, pb, pnb, hashes, outs = carry
        lp = log_probs[:, t]  # (B, V)
        lp_blank = lp[:, blank]
        lp_ext = lp.clone()
        lp_ext[:, blank] = NEG_INF
        c_lp, c_ids = _top_k(lp_ext, C)  # (B, C)

        # each prefix's last label, -1 when empty
        last = tokens.gather(2, torch.clamp(lens - 1, min=0).long()[..., None]
                             )[..., 0]
        last = torch.where(lens > 0, last, -1)  # (B, K)
        lp_last = lp.gather(1, torch.clamp(last, min=0).long())
        total = _logaddexp(pb, pnb)

        # stays (pool slots [0, K)): a blank after anything, or the last
        # label repeated without a blank between (the same run)
        stay_pb = total + lp_blank[:, None]
        stay_pnb = torch.where(lens > 0, pnb + lp_last, NEG_INF)

        # extensions (slots [K, K + K*C)): a repeat of the last label
        # extends only the mass ending in blank
        is_rep = c_ids[:, None, :] == last[:, :, None]  # (B, K, C)
        ext_pnb = (torch.where(is_rep, pb[:, :, None], total[:, :, None])
                   + c_lp[:, None, :])
        c_bkc = c_ids[:, None, :].expand(B, K, C)
        if lm is not None:
            ext_pnb = ext_pnb + lm_w * outs["lm_lp"].gather(2, c_bkc)
        if ngram is not None:
            ext_pnb = ext_pnb + ngram[1] * ngram[0].lp[
                outs["ng_state"].long()].gather(2, c_bkc)
        if length_bonus:
            ext_pnb = ext_pnb + length_bonus
        ext_pnb = torch.where((lens >= U)[:, :, None], NEG_INF, ext_pnb)
        # dead prefixes spawn nothing
        ext_pnb = torch.where((total <= NEG_INF * 0.5)[:, :, None], NEG_INF,
                              ext_pnb)

        app = u_ids == torch.clamp(lens, max=U - 1)[:, :, None]  # (B, K, U)
        ext_tok = torch.where(app[:, :, None, :],
                              c_ids[:, None, :, None].to(torch.int32),
                              tokens[:, :, None, :])  # (B, K, C, U)
        ext_hash = _hash_append(
            hashes[:, :, None, :].expand(B, K, C, 2), c_bkc, mult)
        pool_tok = torch.cat([tokens, ext_tok.reshape(B, K * C, U)], dim=1)
        pool_len = torch.cat([lens, torch.clamp(lens + 1, max=U)[:, :, None]
                              .expand(B, K, C).reshape(B, K * C)], dim=1)
        pool_pb = torch.cat([stay_pb, torch.full((B, K * C), NEG_INF,
                                                 device=dev)], dim=1)
        pool_pnb = torch.cat([stay_pnb, ext_pnb.reshape(B, K * C)], dim=1)
        pool_hash = torch.cat([hashes, ext_hash.reshape(B, K * C, 2)], dim=1)

        # prefix merge: equal prefixes from distinct parents log-add
        eq = ((pool_len[:, :, None] == pool_len[:, None, :])
              & (pool_hash[:, :, None, :] == pool_hash[:, None, :, :]
                 ).all(dim=-1))  # (B, P, P)

        def merge_lane(x):
            xb = torch.where(eq, x[:, None, :], NEG_INF)
            mx = xb.max(dim=-1).values
            out = mx + torch.log(torch.exp(xb - mx[:, :, None]).sum(dim=-1))
            return torch.where(mx <= NEG_INF * 0.5, NEG_INF, out)

        m_pb, m_pnb = merge_lane(pool_pb), merge_lane(pool_pnb)
        first = torch.where(eq, p_ids, P).min(dim=-1).values
        m_total = torch.where(first == p_ids, _logaddexp(m_pb, m_pnb),
                              NEG_INF)

        top_sc, top_i = _top_k(m_total, K)
        dead = top_sc <= NEG_INF * 0.5
        n_tok = _take(pool_tok, top_i)
        n_len = _take(pool_len, top_i)
        n_pb = torch.where(dead, NEG_INF, m_pb.gather(1, top_i))
        n_pnb = torch.where(dead, NEG_INF, m_pnb.gather(1, top_i))
        n_hash = _take(pool_hash, top_i)

        # the fusion state of the kept prefixes: slot i < K is a stay of
        # prefix i (state unchanged), else an extension of prefix
        # (i - K) // C by label c_ids[(i - K) % C]
        n_outs = outs
        if outs:
            is_ext = top_i >= K
            src = torch.where(is_ext, (top_i - K) // C, top_i)
            lab = c_ids.gather(1, torch.where(is_ext, (top_i - K) % C, 0))
            n_outs = {}
            if lm is not None:
                g_lp = _take(outs["lm_lp"], src)
                g_st = _tree_map(lambda a: _take(a, src), outs["lm_st"])
                new_lp, new_st = lm_step(lm_params, lm_cfg, flat(lab),
                                         _tree_map(flat, g_st))

                def sel(new, old):
                    return torch.where(is_ext.reshape(
                        (B, K) + (1,) * (old.dim() - 2)), unflat(new), old)

                n_outs["lm_lp"] = sel(new_lp, g_lp)
                n_outs["lm_st"] = _tree_map(sel, new_st, g_st)
            if ngram is not None:
                g_ng = _take(outs["ng_state"], src)
                n_outs["ng_state"] = torch.where(
                    is_ext, ngram[0].next_state[g_ng.long(), lab], g_ng)

        # frames past a row's length leave its carry as it was
        active = t < frame_lens

        def pick(new, old):
            return torch.where(
                active.reshape((B,) + (1,) * (new.dim() - 1)), new, old)

        carry = _tree_map(pick, (n_tok, n_len, n_pb, n_pnb, n_hash, n_outs),
                          carry)

    tokens, lens, pb, pnb = carry[:4]
    scores = _logaddexp(pb, pnb)
    order = torch.argsort(-scores, dim=-1, stable=True)
    return (_take(tokens, order), _take(lens, order), _take(scores, order))


def recognize_ctc(params, cfg, feats, feat_lens, *, mode: str = "greedy",
                  beam: int = 8, cand: int = 8, max_symbols: int = 200,
                  with_confidence: bool = False,
                  with_timestamps: bool = False, lm=None, ngram=None,
                  length_bonus: float = 0.0):
    """Features -> label sequences through the CTC head (no predictor).

    mode="greedy": (tokens (B, U), lengths (B,)) [+ confs] [+ frames].
    mode="beam": (tokens (B, K, U), lengths (B, K), scores (B, K));
    confidences and timestamps are a best-path notion, greedy's alone.
    The params must carry a "ctc_head" (cfg.ctc_head)."""
    from rnn_transducer_tpu_torch.models import transducer as m

    if "ctc_head" not in params:
        raise ValueError("params have no 'ctc_head' (train with "
                         "cfg.ctc_head=True / --ctc-pretrain-steps)")
    if mode not in ("greedy", "beam"):
        raise ValueError(f"unknown CTC decode mode: {mode!r}")
    enc_out, enc_lens = m.encode(params, cfg, feats, feat_lens)
    logits = m.ctc_logits(params, cfg, enc_out)
    if mode == "greedy":
        tokens, lengths, confs, frames = ctc_greedy_decode(
            logits, enc_lens, blank=cfg.blank, max_symbols=max_symbols)
        out = (tokens, lengths)
        if with_confidence:
            out = out + (confs,)
        if with_timestamps:
            out = out + (frames,)
        return out
    return ctc_prefix_beam_search(
        torch.log_softmax(logits, dim=-1), enc_lens, beam=beam, cand=cand,
        blank=cfg.blank, max_symbols=max_symbols, lm=lm, ngram=ngram,
        length_bonus=length_bonus)
