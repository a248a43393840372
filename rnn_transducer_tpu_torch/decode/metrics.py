"""Evaluation metrics: WER/PER (edit distance), RTF and latency summaries
(PyTorch port of `rnn_transducer_tpu/decode/metrics.py`).

Host-side Python; the reference computes WER + RTF for its beam-search
benchmark (BASELINE.json configs[3]). The JAX module takes its edit
distance from a native library or `Levenshtein` when one is present; the
port has one path, the plain dynamic programme, whose integer results
are the same.
"""

from __future__ import annotations

from collections import Counter

import numpy as np


def edit_distance(ref, hyp) -> int:
    """Levenshtein distance between two token sequences."""
    ref, hyp = list(ref), list(hyp)
    m, n = len(ref), len(hyp)
    d = list(range(n + 1))
    for i in range(1, m + 1):
        prev, d = d, [i] + [0] * n
        for j in range(1, n + 1):
            d[j] = min(prev[j] + 1, d[j - 1] + 1,
                       prev[j - 1] + (ref[i - 1] != hyp[j - 1]))
    return d[n]


def error_rate(refs, hyps) -> float:
    """Corpus-level WER/PER: total edits / total reference tokens."""
    edits = sum(edit_distance(r, h) for r, h in zip(refs, hyps))
    total = sum(len(r) for r in refs)
    return edits / max(total, 1)


def tokens_to_lists(tokens, lengths):
    """(B, U) padded token array + lengths -> list of python lists."""
    tokens = np.asarray(tokens)
    lengths = np.asarray(lengths)
    return [tokens[b, : lengths[b]].tolist() for b in range(tokens.shape[0])]


class RtfMeter:
    """Accumulates decode wall time vs audio duration; reports RTF + p50/p90.

    RTF = processing_time / audio_duration (lower is better).
    """

    def __init__(self):
        self.latencies: list[float] = []
        self.audio_secs: list[float] = []

    def add(self, wall_s: float, audio_s: float, n_utts: int = 1):
        self.latencies.extend([wall_s / max(n_utts, 1)] * n_utts)
        self.audio_secs.append(audio_s)

    @property
    def rtf(self) -> float:
        return sum(self.latencies) / max(sum(self.audio_secs), 1e-9)

    def percentile_latency(self, q: float) -> float:
        return float(np.percentile(np.asarray(self.latencies), q))

    def summary(self) -> dict:
        return {
            "rtf": self.rtf,
            "p50_latency_s": self.percentile_latency(50),
            "p90_latency_s": self.percentile_latency(90),
            "n": len(self.latencies),
        }


def align_pair(ref, hyp):
    """Minimum-edit alignment ops between two token sequences.

    Returns a list of (op, ref_tok, hyp_tok) with op in
    {"ok", "sub", "ins", "del"} ("ins" = hyp token with no ref
    counterpart, ref_tok None; "del" = dropped ref token, hyp_tok None).
    Standard DP backtrace with the sclite tie-break order: substitution,
    then deletion, then insertion.
    """
    ref, hyp = list(ref), list(hyp)
    m, n = len(ref), len(hyp)
    d = np.zeros((m + 1, n + 1), np.int32)
    d[:, 0] = np.arange(m + 1)
    d[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            d[i, j] = min(d[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]),
                          d[i - 1, j] + 1, d[i, j - 1] + 1)
    ops = []
    i, j = m, n
    while i > 0 or j > 0:
        if i > 0 and j > 0 and \
                d[i, j] == d[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            ops.append(("ok" if ref[i - 1] == hyp[j - 1] else "sub",
                        ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif i > 0 and d[i, j] == d[i - 1, j] + 1:
            ops.append(("del", ref[i - 1], None))
            i -= 1
        else:
            ops.append(("ins", None, hyp[j - 1]))
            j -= 1
    return ops[::-1]


def error_report(refs, hyps, top: int = 20) -> dict:
    """sclite-style corpus error breakdown.

    refs/hyps: parallel lists of token sequences (words or ids).
    Returns {"wer", "sub_rate", "ins_rate", "del_rate", "n_ref",
    "n_utts", "sentence_error_rate", "confusions": [((ref, hyp), n)],
    "deletions": [(tok, n)], "insertions": [(tok, n)],
    "worst_utterances": [(idx, utt_wer)]} — the standard triage views.
    """
    subs, ins, dels = Counter(), Counter(), Counter()
    n_sub = n_ins = n_del = n_ref = 0
    sent_err = 0
    per_utt = []
    for idx, (r, h) in enumerate(zip(refs, hyps)):
        errs = 0
        for op, rt, ht in align_pair(r, h):
            if op == "sub":
                subs[(rt, ht)] += 1
                n_sub += 1
                errs += 1
            elif op == "ins":
                ins[ht] += 1
                n_ins += 1
                errs += 1
            elif op == "del":
                dels[rt] += 1
                n_del += 1
                errs += 1
        n_ref += len(list(r))
        sent_err += errs > 0
        per_utt.append((idx, errs / max(len(list(r)), 1)))
    denom = max(n_ref, 1)
    per_utt.sort(key=lambda x: -x[1])
    return {
        "wer": (n_sub + n_ins + n_del) / denom,
        "sub_rate": n_sub / denom,
        "ins_rate": n_ins / denom,
        "del_rate": n_del / denom,
        "n_ref": n_ref,
        "n_utts": len(per_utt),
        "sentence_error_rate": sent_err / max(len(per_utt), 1),
        "confusions": subs.most_common(top),
        "insertions": ins.most_common(top),
        "deletions": dels.most_common(top),
        "worst_utterances": per_utt[:top],
    }
