"""Log-mel / FBANK frontend (PyTorch port of `rnn_transducer_tpu/ops/logmel.py`).

Pre-emphasis -> framing -> Hann window -> rFFT -> power -> mel filterbank
-> log -> (optional per-utterance CMVN), on the device the audio lies on:
framing is a strided view (`unfold`), the spectrum one `torch.fft.rfft`
and the filterbank one f32 (F, n_fft/2+1) x (n_fft/2+1, n_mels) product.
A CUDA tensor is featurized on the card; there is no host path beside it.

The JAX function is XLA (no Pallas kernel), so this module is the port's
one frontend: the serving layer, the PCM sessions (data/pcm_stream.py),
the manifest loader and the decode CLI all call `log_mel`.
`log_mel_oracle` is the float64 numpy reference the card is held to.

The filterbank is the JAX module's HTK-style triangular matrix, built in
numpy bit for bit; the window is numpy's symmetric `np.hanning`, not
`torch.hann_window`'s periodic default.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)


def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int,
                   f_min: float = 0.0, f_max: float | None = None) -> np.ndarray:
    """HTK-style triangular mel filterbank: (n_fft//2 + 1, n_mels) fp32."""
    f_max = f_max if f_max is not None else sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fb = np.zeros((n_bins, n_mels), np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


@functools.lru_cache(maxsize=16)
def _constants(win: int, n_mels: int, n_fft: int, sample_rate: int,
               device: torch.device):
    """The window and the filterbank on `device`, built once a device."""
    window = torch.from_numpy(np.hanning(win).astype(np.float32))
    fb = torch.from_numpy(mel_filterbank(n_mels, n_fft, sample_rate))
    return window.to(device), fb.to(device)


def log_mel(audio, audio_lens, *, sample_rate: int = 16000, n_fft: int = 512,
            hop: int = 160, win: int = 400, n_mels: int = 80,
            preemph: float = 0.97, cmvn: bool = False,
            log_floor: float = 1e-10):
    """(B, N) waveform -> ((B, T, n_mels) f32 log-mel features, (B,) int32
    frame lens), on the waveform's device.

    T = 1 + (N - win) // hop (no padding: kaldi snip-edges), and 0 when N
    is shorter than one window (the JAX function's T is then negative and
    its lens -1; the port's, like the JAX package's native frontend, give
    no frame). A row shorter than a window has 0 frames.
    """
    audio = torch.as_tensor(audio).to(torch.float32)
    audio_lens = torch.as_tensor(audio_lens).to(audio.device)
    if (audio.is_cuda and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError("log_mel's filterbank product runs in f32; "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    B, N = audio.shape
    if preemph:
        audio = torch.cat([audio[:, :1],
                           audio[:, 1:] - preemph * audio[:, :-1]], dim=1)
    T = max(1 + (N - win) // hop, 0)
    window, fb = _constants(win, n_mels, n_fft, sample_rate, audio.device)
    if T:
        frames = audio[:, :(T - 1) * hop + win].unfold(1, win, hop)
        # zero padding to n_fft happens inside the rfft
        spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
        power = spec.real ** 2 + spec.imag ** 2  # (B, T, n_fft//2 + 1)
        mel = torch.matmul(power, fb)
        feats = torch.log(torch.clamp(mel, min=log_floor))
    else:  # no whole window: no frame (an empty FFT is refused)
        feats = audio.new_zeros((B, 0, n_mels))
    frame_lens = torch.div(audio_lens.to(torch.int32) - win, hop,
                           rounding_mode="floor") + 1
    frame_lens = torch.clamp(frame_lens, 0, T).to(torch.int32)
    if cmvn:
        t_ids = torch.arange(T, dtype=torch.int32, device=audio.device)
        mask = (t_ids[None, :, None] < frame_lens[:, None, None]).to(
            torch.float32)
        denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
        mean = (feats * mask).sum(dim=1, keepdim=True) / denom
        var = ((feats - mean) ** 2 * mask).sum(dim=1, keepdim=True) / denom
        feats = (feats - mean) * torch.rsqrt(var + 1e-8)
        feats = feats * mask
    return feats, frame_lens


def featurize(audio, *, device: str | torch.device = "cuda", **kw):
    """One 1-D waveform (numpy or tensor) -> its (T, n_mels) f32 numpy
    features: `log_mel` (keywords passed on) on `device`."""
    x = torch.as_tensor(np.asarray(audio, np.float32)).reshape(1, -1)
    with torch.inference_mode():
        f, n = log_mel(x.to(device), torch.tensor(
            [x.shape[1]], dtype=torch.int32, device=device), **kw)
        return f[0, :int(n[0])].cpu().numpy()


def log_mel_oracle(audio, audio_lens, sample_rate=16000, n_fft=512, hop=160,
                   win=400, n_mels=80, preemph=0.97, log_floor=1e-10):
    """Literal numpy float64 reference (the plain version of `log_mel`)."""
    audio = np.asarray(audio, np.float64)
    B, N = audio.shape
    if preemph:
        audio = np.concatenate(
            [audio[:, :1], audio[:, 1:] - preemph * audio[:, :-1]], axis=1)
    T = max(1 + (N - win) // hop, 0)
    window = np.hanning(win)
    fb = mel_filterbank(n_mels, n_fft, sample_rate).astype(np.float64)
    out = np.zeros((B, T, n_mels))
    for b in range(B):
        for t in range(T):
            fr = audio[b, t * hop: t * hop + win] * window
            spec = np.fft.rfft(fr, n=n_fft)
            power = np.abs(spec) ** 2
            out[b, t] = np.log(np.maximum(power @ fb, log_floor))
    frame_lens = np.minimum(
        np.maximum(1 + (np.asarray(audio_lens) - win) // hop, 0), T)
    return out, frame_lens
