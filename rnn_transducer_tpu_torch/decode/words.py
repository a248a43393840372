"""Word-level segments from per-token decode sidecars (copy of
`rnn_transducer_tpu/decode/words.py`).

The decode paths emit per-token emission timestamps (``frames``, in INPUT
feature frames — the decode CLI's ``--timestamps``, every serving payload) and
per-token emission log-probs (``confidence``). This module groups those
token streams into word-level segments — the form downstream consumers
(subtitling, keyword spotting, call analytics) actually want:

    [{"word": "hello", "start_s": 0.42, "end_s": 0.71, "conf": -0.03}, ...]

Grouping follows the tokenizer's own text semantics (reference family
repos print flat text only; word timing is a capability extension):

- ``BpeTokenizer``: a piece starting with the sentencepiece word marker
  ("▁", data/bpe.py WORD_MARK) begins a new word.
- ``CharTokenizer``: the space character separates words (the space
  token's own frame/confidence belongs to no word).
- ``PhonemeTokenizer``: every phone is its own segment (TIMIT has no
  word-level transcripts).

A word's ``start_s`` is its first token's emission time; ``end_s`` is its
last token's emission time plus one frame hop (emission times are
points, not durations — the hop is the finest honest width). ``conf`` is
the MINIMUM of the word's token log-probs: the conservative standard
(one bad token makes the whole word suspect), kept in the log domain to
match the per-token payloads.
"""

from __future__ import annotations

from rnn_transducer_tpu_torch.data.bpe import WORD_MARK, BpeTokenizer
from rnn_transducer_tpu_torch.data.tokenizer import CharTokenizer, PhonemeTokenizer


def token_pieces(tok, ids) -> list[str]:
    """Per-token surface strings (unknown ids -> ""); parallel to `ids`."""
    if isinstance(tok, BpeTokenizer):
        # id 0 = blank; ids 1.. index the symbol table (data/bpe.py).
        return [tok.symbols[int(i) - 1]
                if 1 <= int(i) <= len(tok.symbols) else ""
                for i in ids]
    if isinstance(tok, CharTokenizer):
        return [tok.id_to_char.get(int(i), "") for i in ids]
    if isinstance(tok, PhonemeTokenizer):
        return [tok.id_to_phone.get(int(i), "") for i in ids]
    raise TypeError(f"not a tokenizer: {tok!r}")


def word_segments(tok, ids, frames, confs=None, hop_s: float = 0.01):
    """Group one utterance's tokens into word segments.

    ids/frames/confs: parallel per-token lists (frames in INPUT feature
    frames, confs in log-prob). Returns a list of dicts with "word",
    "start_s", "end_s" and, when confs is given, "conf".
    """
    pieces = token_pieces(tok, ids)
    per_phone = isinstance(tok, PhonemeTokenizer)
    is_bpe = isinstance(tok, BpeTokenizer)

    segs: list[dict] = []
    cur = None  # [chars, start_frame, end_frame, min_conf]

    def close():
        nonlocal cur
        if cur is not None and cur[0]:
            seg = {"word": cur[0],
                   "start_s": round(cur[1] * hop_s, 3),
                   "end_s": round((cur[2] + 1) * hop_s, 3)}
            if confs is not None:
                seg["conf"] = round(cur[3], 4)
            segs.append(seg)
        cur = None

    for k, piece in enumerate(pieces):
        if not piece:  # unknown/blank id: belongs to no word
            continue
        fr = int(frames[k])
        cf = float(confs[k]) if confs is not None else 0.0
        if per_phone:
            cur = [piece, fr, fr, cf]
            close()
            continue
        if is_bpe:
            starts_word = piece.startswith(WORD_MARK)
            text = piece[len(WORD_MARK):] if starts_word else piece
            if starts_word:
                close()
            if not text:  # a bare "▁" piece carries no visible chars
                continue
        else:  # char tokenizer
            if piece == " ":
                close()
                continue
            text = piece
        if cur is None:
            cur = [text, fr, fr, cf]
        else:
            cur[0] += text
            cur[2] = max(cur[2], fr)
            cur[3] = min(cur[3], cf)
    close()
    return segs


def attach_words(payload: dict, tok, hop_s: float = 0.01) -> dict:
    """Add "words" to a serving/recognize result dict in place.

    No-op unless the payload carries both "tokens" and "frames" (i.e.
    timestamps were requested/produced). Uses "confidence" when present.
    """
    if tok is not None and "frames" in payload and "tokens" in payload:
        payload["words"] = word_segments(
            tok, payload["tokens"], payload["frames"],
            payload.get("confidence"), hop_s=hop_s)
    return payload
