"""JSONL-manifest datasets for training and decoding (PyTorch port of
`rnn_transducer_tpu/data/manifest.py`).

One JSON object per line with either
  {"feats": <npy path>,  "labels": [int, ...]}           (precomputed) or
  {"audio": <raw f32 pcm path or .npy>, "labels": [...]} (frontend applied)
Token ids follow the model config (blank = cfg.blank excluded from labels).
Audio records are featurized by the port's `log_mel` on the device the
caller names; there is no host frontend beside it.

The decode CLI streams `manifest_examples` through data/bucketing.py's
`bucket_stream`. The trainer reads `manifest_batches`: bucketed, padded
batches epoch after epoch (SortaGrad's shortest-first first epoch, a
shuffle of rng(seed + epoch) after it, the first `skip_first` examples
held out as `manifest_dev_batch`), which `fast_forward_state` replays on
metadata alone so that a resumed run sees the batches an uninterrupted
one would. These are host numpy functions with the JAX module's exact
semantics: the same manifest gives the same batches, bit for bit.
"""

from __future__ import annotations

import itertools
import json
import os

import numpy as np
import torch

from rnn_transducer_tpu_torch.data.bucketing import (BucketBatcher,
                                                     bucket_stream)
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


def _epoch_order(path, epoch: int, skip_first: int, sortagrad: bool,
                 shuffle_seed: int | None, n: int | None = None,
                 lens=None):
    """Manifest-index order of one epoch, or None for raw manifest order
    (with skip_first applied by the caller). `n` / `lens` spare a caller
    that already scanned the manifest the re-scan."""
    if sortagrad and epoch == 0:
        if lens is None:
            lens = [example_length(r) for r in read_manifest(path)]
        lens = lens[skip_first:]
        return [skip_first + i for i in
                sorted(range(len(lens)), key=lens.__getitem__)]
    if shuffle_seed is not None:
        if n is None:
            n = sum(1 for _ in read_manifest(path))
        rng = np.random.default_rng(shuffle_seed + epoch)
        return [skip_first + int(i)
                for i in rng.permutation(max(0, n - skip_first))]
    return None


def fast_forward_state(path, tcfg, n_batches: int, skip_first: int = 0,
                       sortagrad: bool = False,
                       shuffle_seed: int | None = None):
    """Metadata-only replay of manifest_batches' first `n_batches`.

    Replays the epoch orders and the BucketBatcher add / emit / flush
    decisions from (n_frames, n_labels) per record; no feature payload is
    loaded (example_length reads .npy headers and file sizes). Returns
    (epoch, pos, pending, in_flush):

      epoch     epoch of the next batch to be produced
      pos       index into that epoch's order of the next example to add
                (ignored when in_flush)
      pending   manifest indices of the examples in partly filled buckets
                at the cut, in add order: re-adding them in this order
                rebuilds the batcher's per-bucket lists and its dict
                (flush) order
      in_flush  the cut fell inside the end-of-epoch flush: `pending`
                holds only the buckets not flushed yet, and the resumed
                epoch is their flush (no new adds)
    """
    recs = list(read_manifest(path))
    n = len(recs)
    lens = [example_length(r) for r in recs]
    llen = [len(r["labels"]) for r in recs]
    sizer = BucketBatcher(tcfg.buckets, tcfg.batch_size)
    remaining = int(n_batches)
    epoch = 0
    if remaining <= 0:
        return 0, 0, [], False
    while True:
        order = _epoch_order(path, epoch, skip_first, sortagrad,
                             shuffle_seed, n=n, lens=lens)
        if order is None:
            order = list(range(skip_first, n))
        pending: dict = {}  # bucket -> [(addseq, manifest idx), ...]
        addseq = 0
        for pos, idx in enumerate(order):
            b = sizer._bucket_for(lens[idx], llen[idx])
            if b is None:
                continue  # dropped (fits no bucket), as add() drops it
            pending.setdefault(b, []).append((addseq, idx))
            addseq += 1
            if len(pending[b]) == tcfg.batch_size:
                del pending[b]  # as _pending.pop on emit
                remaining -= 1
                if remaining == 0:
                    flat = sorted(
                        it for lst in pending.values() for it in lst)
                    return epoch, pos + 1, [i for _, i in flat], False
        # end-of-epoch flush: one padded batch per non-empty bucket, in
        # dict insertion order (the order of each bucket's first add)
        flush_order = [b for b in pending if pending[b]]
        for k, b in enumerate(flush_order):
            remaining -= 1
            if remaining == 0:
                flat = sorted(it for b2 in flush_order[k + 1:]
                              for it in pending[b2])
                return epoch, len(order), [i for _, i in flat], True
        epoch += 1


def manifest_batches(path, cfg, tcfg, skip_first: int = 0,
                     sortagrad: bool = False,
                     shuffle_seed: int | None = None,
                     resume_batches: int = 0, cmvn=None,
                     device: str | torch.device = "cuda"):
    """Endless stream of bucketed, padded training batches (feats,
    feat_lens, labels, label_lens), numpy, epoch after epoch.

    skip_first: leave the first N manifest examples out of every epoch
    (held out as the dev batch, `manifest_dev_batch`).
    sortagrad: the first epoch shortest utterance first; later epochs
    follow shuffle_seed (or manifest order).
    shuffle_seed: reshuffle the examples not held out every epoch with
    rng(seed + epoch); None keeps manifest order.
    resume_batches: skip the first N batches on metadata alone (the
    restored step count of a resumed run); the examples left in partly
    filled buckets at the cut are featurized again (at most buckets x
    batch_size of them).
    device: where audio records are featurized (`load_example`).
    """
    def examples(order):
        return manifest_examples(path, cfg, order=order, cmvn=cmvn,
                                 device=device)

    epoch = 0
    if resume_batches:
        epoch, pos, pending_idx, in_flush = fast_forward_state(
            path, tcfg, resume_batches, skip_first=skip_first,
            sortagrad=sortagrad, shuffle_seed=shuffle_seed)
        order = _epoch_order(path, epoch, skip_first, sortagrad,
                             shuffle_seed)
        if order is None:
            n = sum(1 for _ in read_manifest(path))
            order = list(range(skip_first, n))
        # the in-flight examples re-added in their add order rebuild the
        # batcher; then the epoch goes on from `pos` (or to its flush)
        seq = pending_idx + ([] if in_flush else order[pos:])
        yield from bucket_stream(examples(seq), tcfg.buckets,
                                 tcfg.batch_size, blank=cfg.blank)
        epoch += 1
    while True:
        order = _epoch_order(path, epoch, skip_first, sortagrad,
                             shuffle_seed)
        ex = examples(order)
        if order is None and skip_first:
            ex = itertools.islice(ex, skip_first, None)
        yielded = False
        for batch in bucket_stream(ex, tcfg.buckets, tcfg.batch_size,
                                   blank=cfg.blank):
            yielded = True
            yield batch
        if not yielded:  # the loop would re-read the file forever
            raise ValueError(
                f"manifest {path!r} produced no training batches "
                f"(skip_first={skip_first}, buckets={tcfg.buckets}) — "
                "every example was held out, dropped, or the file is empty")
        epoch += 1


def manifest_dev_batch(path, cfg, tcfg, cmvn=None,
                       device: str | torch.device = "cuda"):
    """The first batch_size examples as one fixed padded batch: (feats,
    feat_lens, labels, label_lens, n_valid), or None when the manifest is
    empty or nothing fits the buckets."""
    ex = itertools.islice(manifest_examples(path, cfg, cmvn=cmvn,
                                            device=device), tcfg.batch_size)
    for batch in bucket_stream(ex, tcfg.buckets, tcfg.batch_size,
                               blank=cfg.blank, with_valid=True):
        return batch
    return None
