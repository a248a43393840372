"""JSONL-manifest examples for decoding (PyTorch port of the decode half of
`rnn_transducer_tpu/data/manifest.py`).

One JSON object per line with either
  {"feats": <npy path>,  "labels": [int, ...]}           (precomputed) or
  {"audio": <raw f32 pcm path or .npy>, "labels": [...]} (frontend applied)
Token ids follow the model config (blank = cfg.blank excluded from labels).
Audio records are featurized by the port's `log_mel` on the device the
caller names; there is no host frontend beside it.

The decode CLI streams `manifest_examples` through data/bucketing.py's
`bucket_stream`. The training half of the JAX module (`manifest_batches`,
`fast_forward_state`, `manifest_dev_batch`) belongs to ROADMAP queue 1,
item 13 (training data) and is not here.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from rnn_transducer_tpu_torch.data.cmvn import apply_cmvn
from rnn_transducer_tpu_torch.ops.logmel import featurize

WIN, HOP = 400, 160  # log_mel's defaults: 25 ms window, 10 ms hop


def read_manifest(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def load_example(rec, input_dim: int, cmvn=None,
                 device: str | torch.device = "cuda"):
    """Manifest record -> (feats (T, F) fp32, labels (U,) int32), numpy.

    Audio is featurized by `log_mel` on `device`. cmvn: optional
    global-CMVN stats dict (data/cmvn.py) applied to the features after
    extraction (before any padding)."""
    labels = np.asarray(rec["labels"], np.int32)
    if "feats" in rec:
        feats = np.load(rec["feats"]).astype(np.float32)
    elif "audio" in rec:
        path = rec["audio"]
        audio = (np.load(path) if path.endswith(".npy")
                 else np.fromfile(path, np.float32))
        feats = featurize(audio, device=device, n_mels=input_dim)
    else:
        raise ValueError(f"manifest record needs 'feats' or 'audio': {rec}")
    if feats.shape[1] != input_dim:
        raise ValueError(
            f"feature dim {feats.shape[1]} != config input_dim {input_dim}")
    if cmvn is not None:
        feats = apply_cmvn(feats, cmvn)
    return feats, labels


def manifest_examples(path, cfg, order=None, cmvn=None,
                      device: str | torch.device = "cuda"):
    recs = read_manifest(path)
    if order is not None:
        recs = list(recs)
        recs = [recs[i] for i in order]
    for rec in recs:
        yield load_example(rec, cfg.input_dim, cmvn=cmvn, device=device)


def example_length(rec) -> int:
    """Frame count of a manifest record without loading its payload.

    .npy lengths come from the header via mmap; raw-f32 audio from the
    file size (FBANK frame count at the default 10 ms hop).
    """
    if "feats" in rec:
        return int(np.load(rec["feats"], mmap_mode="r").shape[0])
    path = rec["audio"]
    if path.endswith(".npy"):
        n = int(np.load(path, mmap_mode="r").shape[0])
    else:
        n = os.path.getsize(path) // 4
    return max(0, 1 + (n - WIN) // HOP)
