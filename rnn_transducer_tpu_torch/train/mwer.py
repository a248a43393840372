"""Minimum word error rate (MWER) sequence training (PyTorch port of
`rnn_transducer_tpu/train/mwer.py`; Prabhavalkar et al. 2018).

After NLL training, a few MWER steps optimize the metric of record: decode
an N-best with the current params (beam search, no gradient), renormalize
the model's sequence log-probs over the list, and minimize the expected
edit count

    L = sum_i  p_hat(y_i | x) * W(y_i, y_ref),
    p_hat = softmax_i  log P(y_i | x)

Autograd of L gives the variance-reduced MWER gradient sum_i p_hat_i (W_i
- W_bar) d logP_i: the baseline falls out of the softmax's derivative.
log P(y_i | x) = -rnnt_loss, the lattice marginal at the `xla` tier
((B*K, T, U+1, V) logits over the encoder output repeated K times; on the
card its alpha / beta run in the K3 kernel), or for a multi-blank or TDT
model the marginal on its consumed-frames lattice (`sequence_nll`, as
JAX's `_seq_nll`), so gradients flow only through the lattice losses.
The beam search (decode/beam.py, whose predictor steps are single-step
products, not K4; the duration families' wake-time search) and the edit
distances carry none.

The edit-distance row recurrence has the insertion closure row[j] =
min_{k<=j} cand[k] + (j - k), solved in parallel on the device as j +
cummin(cand - j). Under the sequence-parallel mode (parallel/tp.py,
mode="sp", loss_kind="mwer") every model rank runs this loss whole on its
data shard, with the replicated params, so its beam is the same on every
model rank.
"""

from __future__ import annotations

import torch

from rnn_transducer_tpu_torch.decode.beam import beam_search
from rnn_transducer_tpu_torch.models import transducer as m
from rnn_transducer_tpu_torch.ops.rnnt_loss import rnnt_loss
from rnn_transducer_tpu_torch.ops.rnnt_multiblank import rnnt_loss_multiblank
from rnn_transducer_tpu_torch.ops.rnnt_tdt import rnnt_loss_tdt

NEG_INF = -1.0e30


def edit_distance_device(ref, ref_len, hyp, hyp_len):
    """Levenshtein distances of valid prefixes, on the tensors' device.

    ref: (N, Ur), hyp: (N, Uh) int padded; ref_len, hyp_len: (N,).
    Returns (N,) int32 = distance(ref[n, :ref_len[n]], hyp[n,
    :hyp_len[n]]). A cell (i, j) of the DP table depends only on the
    prefixes, so one padded table serves any valid lengths through a
    final gather (JAX `edit_distance_device`, one pair at a time under
    vmap there)."""
    N, Uh = hyp.shape
    j_ids = torch.arange(Uh + 1, dtype=torch.int32, device=hyp.device)
    row = j_ids.expand(N, Uh + 1)
    rows = [row]
    for i in range(ref.shape[1]):
        sub = row[:, :-1] + (ref[:, i:i + 1] != hyp).to(torch.int32)
        dele = row[:, 1:] + 1
        cand = torch.cat([torch.full((N, 1), i + 1, dtype=torch.int32,
                                     device=hyp.device),
                          torch.minimum(sub, dele)], dim=1)
        # insertion closure: row[j] = min_{k<=j} cand[k] + (j - k)
        row = j_ids + torch.cummin(cand - j_ids, dim=1).values
        rows.append(row)
    table = torch.stack(rows, dim=1)  # (N, Ur+1, Uh+1)
    n = torch.arange(N, device=hyp.device)
    return table[n, ref_len.long(), hyp_len.long()]


def sequence_nll(params, cfg, enc_out, pred_out, labels, enc_lens,
                 label_lens):
    """Differentiable per-utterance NLL of a label sequence over
    materialised logits: the standard lattice marginal, or the
    consumed-frames marginal of a multi-blank or TDT model (JAX
    `_seq_nll`, train/mwer.py:105-116)."""
    if cfg.tdt_durations:
        logits, dur_logits = m.joint_tdt(params, cfg, enc_out, pred_out)
        return rnnt_loss_tdt(logits, dur_logits, labels, enc_lens,
                             label_lens, cfg.tdt_durations, cfg.blank)
    logits = m.joint(params, cfg, enc_out, pred_out)
    if cfg.big_blank_durations:
        return rnnt_loss_multiblank(logits, labels, enc_lens, label_lens,
                                    cfg.big_blank_durations, cfg.blank)
    return rnnt_loss(logits, labels, enc_lens, label_lens, cfg.blank)


def hyp_logprobs(params, cfg, enc_out, enc_lens, hyps, hyp_lens):
    """log P(y_k | x) (B, K) of every hypothesis hyps (B, K, U) with
    lengths hyp_lens (B, K): the lattice marginals over the encoder output
    (B, T, De) repeated K times, differentiable."""
    B, K, U = hyps.shape
    flat_h, flat_l = hyps.reshape(B * K, U), hyp_lens.reshape(B * K)
    pred_out, _ = m.predict(params, cfg, flat_h)
    return -sequence_nll(params, cfg, enc_out.repeat_interleave(K, dim=0),
                     pred_out, flat_h, enc_lens.repeat_interleave(K, dim=0),
                     flat_l).reshape(B, K)


def expected_edits(logp, valid, hyps, hyp_lens, labels, label_lens):
    """Per utterance (B,): the edit counts of the valid hypotheses against
    the reference, weighted by their log-probs logp (B, K) renormalized
    over the list."""
    B, K, U = hyps.shape
    logp = torch.where(valid, logp, torch.full_like(logp, NEG_INF))
    p_hat = torch.softmax(logp, dim=-1)  # renormalized over the N-best
    wers = edit_distance_device(
        labels.repeat_interleave(K, dim=0),
        label_lens.repeat_interleave(K, dim=0), hyps.reshape(B * K, U),
        hyp_lens.reshape(B * K)).reshape(B, K).to(torch.float32)
    return torch.sum(p_hat * wers, dim=-1)  # expected edit count


def mwer_loss_from_hyps(params, cfg, enc_out, enc_lens, hyps, hyp_lens,
                        valid, labels, label_lens, nll_weight: float = 0.0):
    """Expected-edit-count risk over a fixed hypothesis list.

    enc_out: (B, T, De) (differentiable); hyps: (B, K, U) int with
    hyp_lens (B, K) and a (B, K) validity mask (dead beams left out).
    Returns (loss, per-utterance expected edits (B,))."""
    logp = hyp_logprobs(params, cfg, enc_out, enc_lens, hyps, hyp_lens)
    per_utt = expected_edits(logp, valid, hyps, hyp_lens, labels, label_lens)
    loss = per_utt.mean()
    if nll_weight:
        nll = sequence_nll(params, cfg, enc_out, m.predict(params, cfg,
                                                       labels)[0],
                       labels, enc_lens, label_lens)
        loss = loss + nll_weight * nll.mean()
    return loss, per_utt


def mwer_loss_fn(params, cfg, feats, feat_lens, labels, label_lens, *,
                 beam: int = 4, expansions: int = 2, max_symbols: int = 64,
                 nll_weight: float = 0.0):
    """The batch loss of `make_train_step(loss_kind="mwer")`: decode the
    N-best with the current params under no_grad, then the expected-WER
    risk through the lattice losses. Rows whose score is at or below
    NEG_INF / 2 are dead beams and left out."""
    m.check_supported(cfg)
    enc_out, enc_lens = m.encode(params, cfg, feats, feat_lens)
    with torch.no_grad():
        hyps, hyp_lens, scores, _ = beam_search(
            params, cfg, enc_out.detach(), enc_lens, beam=beam,
            max_symbols=max_symbols, expansions=expansions)
    valid = scores > NEG_INF / 2
    return mwer_loss_from_hyps(params, cfg, enc_out, enc_lens, hyps,
                               hyp_lens, valid, labels.to(hyps.dtype),
                               label_lens, nll_weight=nll_weight)
