"""Global (corpus-level) cepstral mean-variance normalization (copy of
`rnn_transducer_tpu/data/cmvn.py`; host numpy, bit-equal to it).

The Kaldi-family recipes the reference belongs to normalize log-mel
features either per utterance (ops/logmel.py `cmvn=True`) or with
GLOBAL statistics accumulated over the training corpus — this module is
the global variant. Stats are computed once on the host
(`compute_cmvn` over a manifest), stored as plain JSON (2 x input_dim
floats),
threaded through the data loaders at featurization time, and recorded
in the checkpoint's meta.json so the decode CLI and the server
apply the SAME normalization automatically (self-describing
checkpoints, VERDICT r1).

Normalization happens on the host per-example, before padding, so
padded frames stay exactly zero and every downstream consumer (device
batches, streaming chunks, serving raw-PCM requests) sees one
consistent contract.
"""

from __future__ import annotations

import json

import numpy as np

# variance floor: silence-only mel bins must not blow up to huge scales
_VAR_FLOOR = 1e-8


def compute_cmvn(manifest_path: str, input_dim: int,
                 device: str = "cuda") -> dict:
    """Accumulate corpus mean/std over every frame of a manifest (audio
    records featurized by `log_mel` on `device`).

    Streaming two-pass-free accumulation (sum / sum-of-squares in
    float64); returns {"mean": [F], "std": [F], "frames": N}.
    """
    from rnn_transducer_tpu_torch.data.manifest import (load_example,
                                                        read_manifest)

    s = np.zeros((input_dim,), np.float64)
    ss = np.zeros((input_dim,), np.float64)
    n = 0
    for rec in read_manifest(manifest_path):
        feats, _ = load_example(rec, input_dim, device=device)
        f64 = feats.astype(np.float64)
        s += f64.sum(axis=0)
        ss += (f64 * f64).sum(axis=0)
        n += feats.shape[0]
    if n == 0:
        raise ValueError(f"manifest {manifest_path!r} has no frames")
    mean = s / n
    var = np.maximum(ss / n - mean * mean, _VAR_FLOOR)
    return {"mean": mean.tolist(), "std": np.sqrt(var).tolist(),
            "frames": int(n)}


def save_cmvn(stats: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(stats, f)


def load_cmvn(path_or_stats) -> dict:
    """Accept a JSON path or an already-loaded stats dict (meta.json)."""
    if isinstance(path_or_stats, dict):
        stats = path_or_stats
    else:
        with open(path_or_stats) as f:
            stats = json.load(f)
    if "mean" not in stats or "std" not in stats:
        raise ValueError("CMVN stats need 'mean' and 'std'")
    return stats


def stats_arrays(stats: dict) -> tuple[np.ndarray, np.ndarray]:
    """(mean (F,), 1/std (F,)) as float32 for fast per-example apply."""
    mean = np.asarray(stats["mean"], np.float32)
    istd = 1.0 / np.maximum(np.asarray(stats["std"], np.float32),
                            np.float32(np.sqrt(_VAR_FLOOR)))
    return mean, istd


def apply_cmvn(feats: np.ndarray, stats: dict) -> np.ndarray:
    """(T, F) float32 features -> globally normalized copy."""
    mean, istd = stats_arrays(stats)
    if feats.shape[-1] != mean.shape[0]:
        raise ValueError(f"feature dim {feats.shape[-1]} != CMVN dim "
                         f"{mean.shape[0]}")
    return ((feats - mean) * istd).astype(np.float32)


def apply_cmvn_batch(feats: np.ndarray, feat_lens: np.ndarray,
                     stats: dict) -> np.ndarray:
    """(B, T, F) padded batch -> normalized, padding kept at zero.

    Used by consumers that only see post-padding batches (the native
    C++ loader); the mask keeps the pad-frames-are-zero contract the
    per-example path gets for free.
    """
    mean, istd = stats_arrays(stats)
    mask = (np.arange(feats.shape[1])[None, :]
            < np.asarray(feat_lens)[:, None])[..., None]
    return np.where(mask, (feats - mean) * istd, 0.0).astype(np.float32)
