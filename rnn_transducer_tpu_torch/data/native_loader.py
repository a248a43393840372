"""Multi-threaded prefetching manifest loader (PyTorch port of
`rnn_transducer_tpu/data/native_loader.py`).

C++ worker threads (`csrc/loader.cpp`, built by g++ at first use through
`utils/build.load_loader_library`) read manifest entries, length-bucket
them and publish padded fixed-shape batches into a bounded queue, so
that file IO and padding overlap the card's compute instead of running
on the training thread. The library is bound with ctypes.

Semantics match data/bucketing.bucket_stream: the same bucket rule (the
first (max_t, max_u) that fits), the same cyclic padding of a trailing
partial batch with a true n_valid. With seed=None the manifest order is
kept and a single worker gives the python loader's batches bit for bit;
with an int seed the examples are reshuffled every epoch by the C++
std::mt19937_64(seed + epoch), the JAX loader's shuffle.

The port has one frontend, `ops/logmel.log_mel`: for {"audio"} records
the threads publish padded PCM and its sample counts, bucketed by
log_mel's frame count, and this iterator featurizes each batch with
`log_mel` on `device` (the filterbank is the port's), zeroing the frames
past each row's length as padding. A manifest mixing feature and audio
records is refused. Global CMVN (`cmvn=`, a data/cmvn.py stats dict) is
applied after the pipeline, in place on each padded batch with the pad
frames kept at zero: the arithmetic of `data/cmvn.apply_cmvn_batch`,
bit for bit, in two passes over the batch and no copy (a batch of the
1600-frame bucket is 16 MB, and this runs on the training thread).
"""

from __future__ import annotations

import numpy as np
import torch

from rnn_transducer_tpu_torch.data.cmvn import stats_arrays
from rnn_transducer_tpu_torch.data.manifest import HOP, WIN, read_manifest
from rnn_transducer_tpu_torch.ops.logmel import log_mel
from rnn_transducer_tpu_torch.utils import build


QUEUE_BATCHES = 4  # the ready queue's bound: batches prefetched ahead


def available() -> bool:
    """Whether the loader library builds and loads here."""
    try:
        build.load_loader_library()
    except (OSError, RuntimeError):
        return False
    return True


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


class NativeLoader:
    """Iterate padded batches produced by the native prefetch pipeline.

    Yields numpy (feats, feat_lens, labels, label_lens, n_valid) with
    feats shaped (B, bucket_max_t, F). Use as a context manager (or rely
    on __del__) so the worker threads are joined. Raises where the
    library cannot be built: there is no fallback to the python loader.
    """

    def __init__(self, manifest_path: str, cfg, buckets, batch_size: int,
                 *, loop: bool = False, seed: int | None = None,
                 n_threads: int = 2, skip_first: int = 0,
                 cmvn: dict | None = None,
                 device: str | torch.device = "cuda"):
        self._h = None
        lib = build.load_loader_library()
        paths, kinds, labels = [], set(), []
        for rec in read_manifest(manifest_path):
            if "feats" in rec:
                paths.append(rec["feats"])
                kinds.add("feats")
            elif "audio" in rec:
                paths.append(rec["audio"])
                kinds.add("audio")
            else:
                raise ValueError(f"bad manifest record: {rec}")
            labels.append(np.asarray(rec["labels"], np.int32))
        if len(kinds) > 1:
            raise ValueError(f"manifest {manifest_path} mixes feats and "
                             "audio records; the native loader takes one")
        paths = paths[skip_first:]
        labels = labels[skip_first:]
        if not paths:
            raise ValueError(f"empty manifest {manifest_path}")

        self._audio = kinds == {"audio"}
        self._B = batch_size
        self._F = cfg.input_dim
        self._device = torch.device(device)
        self._cmvn = None if cmvn is None else stats_arrays(cmvn)
        # ascending, matching BucketBatcher's smallest-fitting-bucket rule
        self._buckets = sorted(tuple(b) for b in buckets)
        max_t = max(b[0] for b in self._buckets)
        self._max_u = max(b[1] for b in self._buckets)
        self._row = self._row_floats(max_t)
        self._lib = lib

        label_lens = np.asarray([len(l) for l in labels], np.int32)
        labels_cat = np.ascontiguousarray(np.concatenate(labels), np.int32)
        buckets_tu = np.asarray(self._buckets, np.int32).reshape(-1)
        self._h = lib.loader_create(
            "\n".join(paths).encode(), int(self._audio), len(paths),
            _ptr(labels_cat), _ptr(label_lens), _ptr(buckets_tu),
            len(self._buckets), batch_size, cfg.input_dim, cfg.blank,
            1 if loop else 0, -1 if seed is None else int(seed),
            int(n_threads), QUEUE_BATCHES, WIN, HOP)
        if not self._h:
            raise RuntimeError("loader_create failed")

    def _row_floats(self, max_t: int) -> int:
        """Floats of a padded row in a bucket of max_t frames: PCM that
        gives exactly max_t log_mel frames, or max_t feature frames."""
        return WIN + HOP * (max_t - 1) if self._audio else max_t * self._F

    def __iter__(self):
        B = self._B
        shape = np.empty((3,), np.int32)
        while True:
            # fresh buffers a batch, sized for the largest bucket: the
            # batch is a view of their prefix, copied once (by the C++)
            feats = np.empty((B * self._row,), np.float32)
            feat_lens = np.empty((B,), np.int32)
            labels = np.empty((B * self._max_u,), np.int32)
            label_lens = np.empty((B,), np.int32)
            b = self._lib.loader_next(self._h, _ptr(feats), _ptr(feat_lens),
                                      _ptr(labels), _ptr(label_lens),
                                      _ptr(shape))
            if b < 0:
                return
            t, u, n_valid = int(shape[0]), int(shape[1]), int(shape[2])
            x = feats[: B * self._row_floats(t)]
            if self._audio:
                x, feat_lens = self._featurize(x.reshape(B, -1), feat_lens)
            else:
                x = x.reshape(B, t, self._F)
                if self._cmvn is not None:
                    mean, istd = self._cmvn
                    x -= mean
                    x *= istd
                    for row, n in zip(x, feat_lens):
                        row[n:] = 0.0
            yield x, feat_lens, labels[: B * u].reshape(B, u), label_lens, \
                n_valid

    def _featurize(self, pcm: np.ndarray, n_samples: np.ndarray):
        """Padded PCM (B, N) -> its log_mel features (B, T, F), CMVN'd when
        asked, with the frames past each row's length zeroed, and the frame
        counts."""
        with torch.inference_mode():
            x = torch.from_numpy(pcm).to(self._device)
            n = torch.from_numpy(n_samples).to(self._device)
            f, lens = log_mel(x, n, n_mels=self._F)
            if self._cmvn is not None:
                mean, istd = (torch.from_numpy(a).to(f.device)
                              for a in self._cmvn)
                f = (f - mean) * istd
            t_ids = torch.arange(f.shape[1], device=f.device)
            f = torch.where((t_ids[None, :] < lens[:, None])[..., None], f,
                            torch.zeros((), device=f.device))
            return f.cpu().numpy(), lens.cpu().numpy()

    @property
    def dropped(self) -> int:
        """Examples that fit no bucket (bucket_stream's accounting)."""
        return int(self._lib.loader_dropped(self._h))

    def close(self):
        if self._h:
            self._lib.loader_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
