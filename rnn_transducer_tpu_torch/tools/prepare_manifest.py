"""Build a training or eval JSONL manifest from a directory of audio and
text (PyTorch port of the JAX package's tools/prepare_manifest.py).

Walks a corpus directory for utterances, computes log-mel features with
the port's `ops/logmel.log_mel` on --device (cuda unless the CPU is asked
for), tokenizes the transcripts, and writes <out>/feats/*.npy and
<out>/manifest.jsonl in the format data/manifest.py reads.

Audio: .wav (PCM16 / PCM32, stdlib `wave`), .npy (float32 PCM), .f32 (raw
float32 PCM), TIMIT's NIST SPHERE (.sph, or .wav with a SPHERE header;
uncompressed PCM16). LibriSpeech .flac needs converting first.

Layouts:
  paired:      <dir>/**/xxx.wav + xxx.txt (transcript beside the audio)
  librispeech: <dir>/**/<spk>-<chap>-<utt>.wav + <spk>-<chap>.trans.txt
  timit:       <dir>/**/xxx.wav|.sph + xxx.phn ("start end phone" lines;
               use --tokenizer phone)

    python -m rnn_transducer_tpu_torch.tools.prepare_manifest \\
        --in-dir corpus/ --out-dir data/train --tokenizer bpe \\
        [--layout paired|librispeech|timit] [--n-mels 80] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import wave

import numpy as np
import torch

from rnn_transducer_tpu_torch.data.bpe import BpeTokenizer
from rnn_transducer_tpu_torch.data.tokenizer import (CharTokenizer,
                                                     PhonemeTokenizer)
from rnn_transducer_tpu_torch.ops.logmel import featurize


def read_sphere(path: str) -> tuple[np.ndarray, int]:
    """NIST SPHERE reader (uncompressed PCM16 only, as TIMIT ships)."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if not magic.startswith(b"NIST_1A"):
            raise ValueError(f"{path}: not a NIST SPHERE file")
        header_size = int(f.read(8).strip())
        f.seek(0)
        header = f.read(header_size).decode("ascii", "ignore")
        fields = {}
        for line in header.splitlines()[2:]:
            parts = line.split()
            if len(parts) >= 3:
                fields[parts[0]] = parts[2]
        if fields.get("sample_coding", "pcm") not in ("pcm", "pcm,embedded-"):
            raise ValueError(f"{path}: compressed SPHERE unsupported "
                             f"({fields.get('sample_coding')}) — convert "
                             "with sph2pipe first")
        sr = int(fields.get("sample_rate", 16000))
        f.seek(header_size)
        pcm = np.frombuffer(f.read(), np.int16)
        if fields.get("sample_byte_format") == "10":  # big-endian
            pcm = pcm.byteswap()
        return pcm.astype(np.float32) / 32768.0, sr


def read_audio(path: str) -> tuple[np.ndarray, int]:
    """-> (float32 PCM in [-1, 1], sample_rate)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32), 16000
    if path.endswith(".f32"):
        return np.fromfile(path, np.float32), 16000
    if path.endswith(".sph"):
        return read_sphere(path)
    with open(path, "rb") as probe:
        if probe.read(8).startswith(b"NIST_1A"):  # TIMIT .wav are SPHERE
            return read_sphere(path)
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        raw = w.readframes(n)
        if width == 2:
            pcm = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        elif width == 4:
            pcm = np.frombuffer(raw, np.int32).astype(np.float32) / 2**31
        else:
            raise ValueError(f"{path}: unsupported sample width {width}")
        if w.getnchannels() > 1:
            pcm = pcm.reshape(-1, w.getnchannels()).mean(axis=1)
        return pcm, sr


def iter_paired(in_dir):
    for root, _, files in os.walk(in_dir):
        for f in sorted(files):
            if f.rsplit(".", 1)[-1] in ("wav", "npy", "f32"):
                stem = os.path.join(root, f.rsplit(".", 1)[0])
                txt = stem + ".txt"
                if os.path.exists(txt):
                    with open(txt) as t:
                        yield os.path.join(root, f), t.read().strip()


def iter_timit(in_dir):
    """TIMIT: audio + .phn phonetic transcription (start end phone lines)."""
    for root, _, files in os.walk(in_dir):
        for f in sorted(files):
            if f.rsplit(".", 1)[-1].lower() in ("wav", "sph"):
                stem = os.path.join(root, f.rsplit(".", 1)[0])
                for ext in (".phn", ".PHN"):
                    if os.path.exists(stem + ext):
                        with open(stem + ext) as t:
                            phones = [ln.split()[2] for ln in t
                                      if len(ln.split()) >= 3]
                        yield os.path.join(root, f), " ".join(phones)
                        break


def iter_librispeech(in_dir):
    for root, _, files in os.walk(in_dir):
        trans = [f for f in files if f.endswith(".trans.txt")]
        for tf in trans:
            with open(os.path.join(root, tf)) as t:
                for line in t:
                    utt_id, _, text = line.strip().partition(" ")
                    for ext in (".wav", ".npy", ".f32"):
                        p = os.path.join(root, utt_id + ext)
                        if os.path.exists(p):
                            yield p, text
                            break


def extract_feats(audio: np.ndarray, n_mels: int,
                  device: str | torch.device = "cuda") -> np.ndarray:
    return featurize(audio, device=device, n_mels=n_mels)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--in-dir", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--layout", default="paired",
                   choices=["paired", "librispeech", "timit"])
    p.add_argument("--tokenizer", default="char",
                   choices=["char", "phone", "bpe"])
    p.add_argument("--vocab-size", type=int, default=1024,
                   help="bpe only: target vocabulary size incl. blank "
                        "(configs[2] pins 1024)")
    p.add_argument("--bpe-model", default=None,
                   help="bpe only: model JSON path. Exists -> load it "
                        "(reuse the train set's model for eval sets); "
                        "else train on this corpus and save there "
                        "(default <out-dir>/bpe.json)")
    p.add_argument("--n-mels", type=int, default=80)
    p.add_argument("--max-utts", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where log_mel runs (default cuda; no fallback to "
                        "cpu)")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device available (pass "
                         "--device cpu to featurize on the CPU)")

    feats_dir = os.path.join(args.out_dir, "feats")
    os.makedirs(feats_dir, exist_ok=True)
    layouts = {"paired": iter_paired, "librispeech": iter_librispeech,
               "timit": iter_timit}
    it = layouts[args.layout](args.in_dir)

    bpe_path = None
    if args.tokenizer == "char":
        tok = CharTokenizer()
    elif args.tokenizer == "phone":
        tok = PhonemeTokenizer()
    else:  # bpe trains on the transcripts first
        it = list(it)
        if args.max_utts:
            it = it[:args.max_utts]
        bpe_path = args.bpe_model or os.path.join(args.out_dir, "bpe.json")
        if os.path.exists(bpe_path):
            tok = BpeTokenizer.load(bpe_path)
            print(f"loaded BPE model {bpe_path} "
                  f"(vocab {tok.vocab_size})", file=sys.stderr)
        else:
            tok = BpeTokenizer.train((t for _, t in it), args.vocab_size)
            tok.save(bpe_path)
            print(f"trained BPE model -> {bpe_path} "
                  f"(vocab {tok.vocab_size})", file=sys.stderr)

    n = 0
    skipped = 0
    with open(os.path.join(args.out_dir, "manifest.jsonl"), "w") as out:
        for audio_path, text in it:
            if args.max_utts and n >= args.max_utts:
                break
            labels = (tok.encode(text.split()) if args.tokenizer == "phone"
                      else tok.encode(text))
            audio, sr = read_audio(audio_path)
            if sr != 16000:
                print(f"skip {audio_path}: sr={sr} != 16000",
                      file=sys.stderr)
                skipped += 1
                continue
            feats = extract_feats(audio, args.n_mels, args.device)
            if len(feats) == 0 or not labels:
                skipped += 1
                continue
            fp = os.path.join(feats_dir, f"utt{n:07d}.npy")
            np.save(fp, feats)
            out.write(json.dumps({"feats": fp, "labels": labels,
                                  "text": text}) + "\n")
            n += 1
    summary = {"utts": n, "skipped": skipped,
               "vocab_size": tok.vocab_size,
               "manifest": os.path.join(args.out_dir, "manifest.jsonl")}
    if bpe_path is not None:
        summary["bpe_model"] = bpe_path
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
