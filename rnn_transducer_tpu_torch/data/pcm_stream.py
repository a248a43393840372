"""Incremental (streaming) FBANK featurization of raw PCM (PyTorch port of
`rnn_transducer_tpu/data/pcm_stream.py`).

The offline frontend (ops/logmel.py) frames with kaldi-style snip-edges:
frame t covers samples [t*hop, t*hop + win), so consecutive frames
OVERLAP by win - hop samples and the preemphasis filter x[k] - p*x[k-1]
reaches one sample across every boundary. Featurizing each piece of PCM
on its own would drop the frames that straddle a boundary and preemphasize
each piece's first sample as a stream start.

``PcmFeaturizer`` makes chunked featurization EXACT: it preemphasizes
incrementally on the host (carrying the previous raw sample across
chunks) and keeps the un-framed tail of the preemphasized signal, so that
for any split of a waveform the concatenated outputs equal `log_mel` of
the whole waveform, frame for frame. The frames themselves are the
port's `log_mel` (preemph 0) on the device named at construction: the
streaming engine's in the server.
"""

from __future__ import annotations

import numpy as np
import torch

from rnn_transducer_tpu_torch.ops.logmel import featurize


class PcmFeaturizer:
    """Chunked raw PCM -> log-mel features, exactly ≡ offline featurization.

    feed(chunk) returns the (F, n_mels) f32 numpy features newly completed
    by this chunk (possibly F=0). Defaults: 16 kHz, 25 ms window, 10 ms
    hop, preemph 0.97, as `log_mel`'s.
    """

    def __init__(self, n_mels: int = 80, *, sample_rate: int = 16000,
                 n_fft: int = 512, hop: int = 160, win: int = 400,
                 preemph: float = 0.97,
                 device: str | torch.device = "cuda"):
        self.n_mels = n_mels
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop = hop
        self.win = win
        self.preemph = preemph
        self.device = torch.device(device)
        self._prev: float | None = None  # last raw sample seen
        self._buf = np.zeros((0,), np.float32)  # preemphasized tail

    def feed(self, chunk) -> np.ndarray:
        chunk = np.asarray(chunk, np.float32).reshape(-1)
        if chunk.size:
            pre = np.empty_like(chunk)
            if self._prev is None:
                pre[0] = chunk[0]  # stream start: first sample unchanged
            else:
                pre[0] = chunk[0] - self.preemph * self._prev
            pre[1:] = chunk[1:] - self.preemph * chunk[:-1]
            self._prev = float(chunk[-1])
            self._buf = np.concatenate([self._buf, pre])
        n = self._buf.shape[0]
        if n < self.win:
            return np.zeros((0, self.n_mels), np.float32)
        F = 1 + (n - self.win) // self.hop
        feats = self._fbank(self._buf)
        assert feats.shape[0] == F, (feats.shape, F)
        # frames 0..F-1 consumed samples [0, (F-1)*hop + win); the next
        # frame starts at F*hop: keep everything from there on
        self._buf = self._buf[F * self.hop:]
        return feats

    def _fbank(self, pre: np.ndarray) -> np.ndarray:
        """FBANK of an already-preemphasized signal (preemph=0)."""
        return featurize(pre, device=self.device,
                         sample_rate=self.sample_rate, n_fft=self.n_fft,
                         hop=self.hop, win=self.win, n_mels=self.n_mels,
                         preemph=0.0)
