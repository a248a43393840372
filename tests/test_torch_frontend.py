"""PyTorch port of the log-mel frontend and the PCM featurizer, held
against the JAX package on the CPU.

`ops/logmel.log_mel` (f32, on the CPU here) against JAX `log_mel` within
1e-4 abs + 1e-5 relative (two f32 FFT libraries; log values reach ~10)
and against the float64 `log_mel_oracle` within 1e-3 (JAX's own
bound, tests/test_logmel.py); `mel_filterbank` and the window bit for
bit; `PcmFeaturizer` under the splits of tests/test_pcm_stream.py within
5e-4 of the offline features and of the JAX featurizer's output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnn_transducer_tpu.data.pcm_stream import PcmFeaturizer as JaxPcm
from rnn_transducer_tpu.ops import logmel as jl
from rnn_transducer_tpu_torch.data.pcm_stream import PcmFeaturizer
from rnn_transducer_tpu_torch.ops import logmel as tl

pytestmark = pytest.mark.quick

JAX_ATOL, JAX_RTOL = 1e-4, 1e-5  # port f32 against JAX f32
ORACLE_ATOL = 1e-3  # f32 against the float64 oracle (tests/test_logmel.py)
PCM_ATOL = 5e-4     # chunked against offline (tests/test_pcm_stream.py)


def _audio(seed=0, B=3, N=9000, scale=0.1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, N)) * scale).astype(np.float32)


def _port(audio, lens, **kw):
    f, n = tl.log_mel(torch.from_numpy(audio), torch.from_numpy(lens), **kw)
    return f.numpy(), n.numpy()


def _jax(audio, lens, **kw):
    f, n = jl.log_mel(jnp.asarray(audio), jnp.asarray(lens), **kw)
    return np.asarray(f), np.asarray(n)


@pytest.mark.parametrize("n_mels, n_fft, sr", [(80, 512, 16000),
                                               (8, 512, 16000),
                                               (40, 256, 8000)])
def test_filterbank_is_the_jax_matrix(n_mels, n_fft, sr):
    np.testing.assert_array_equal(tl.mel_filterbank(n_mels, n_fft, sr),
                                  jl.mel_filterbank(n_mels, n_fft, sr))


def test_window_is_numpys_symmetric_hann():
    window, fb = tl._constants(400, 80, 512, 16000, torch.device("cpu"))
    np.testing.assert_array_equal(window.numpy(),
                                  np.hanning(400).astype(np.float32))
    assert not torch.equal(window, torch.hann_window(400))  # periodic
    np.testing.assert_array_equal(fb.numpy(), jl.mel_filterbank(80, 512,
                                                                16000))


# ragged rows: a full row, a row ending inside a window, a row shorter
# than one window (0 frames) and a zero-length row
LENS = np.array([9000, 5321, 399, 0], np.int32)


@pytest.mark.parametrize("kw", [{}, {"cmvn": True}, {"preemph": 0.0},
                                {"n_mels": 8}, {"n_fft": 1024}])
def test_log_mel_matches_jax(kw):
    audio = _audio(B=4)
    got, got_n = _port(audio, LENS, **kw)
    want, want_n = _jax(audio, LENS, **kw)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_allclose(got, want, atol=JAX_ATOL, rtol=JAX_RTOL)
    if kw.get("cmvn"):
        # padding zeroed, the valid region normalized
        for b, n in enumerate(got_n):
            assert np.all(got[b, n:] == 0)
            if n > 1:
                assert abs(got[b, :n].mean()) < 1e-4


def test_log_mel_matches_the_oracle():
    audio = _audio(seed=1, B=2, N=16000)
    lens = np.array([16000, 8000], np.int32)
    got, got_n = _port(audio, lens)
    want, want_n = tl.log_mel_oracle(audio, lens)
    assert got.shape == (2, 98, 80)
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_allclose(got, want, atol=ORACLE_ATOL, rtol=ORACLE_ATOL)
    # the oracle is the JAX package's, literally
    jwant, jn = jl.log_mel_oracle(audio, lens)
    np.testing.assert_array_equal(want, jwant)
    np.testing.assert_array_equal(want_n, jn)


def test_audio_shorter_than_a_window_gives_no_frame():
    """A batch of rows all shorter than a window: no frame and lens 0, as
    the JAX package's native frontend gives (hostio.fbank -> (0, n_mels));
    JAX `log_mel` gives the same empty features but lens -1 there."""
    audio = _audio(B=2, N=160)
    lens = np.array([160, 100], np.int32)
    got, got_n = _port(audio, lens, n_mels=8)
    want, _ = _jax(audio, lens, n_mels=8)
    assert got.shape == want.shape == (2, 0, 8)
    np.testing.assert_array_equal(got_n, [0, 0])
    assert tl.log_mel_oracle(audio, lens, n_mels=8)[0].shape == (2, 0, 8)


def test_tone_peaks_at_its_mel_bin():
    sr, N = 16000, 16000
    t = np.arange(N) / sr
    audio = np.sin(2 * np.pi * 1000.0 * t)[None, :].astype(np.float32)
    feats, _ = _port(audio, np.array([N], np.int32), preemph=0.0)
    fb = tl.mel_filterbank(80, 512, sr)
    centers = np.linspace(0, sr / 2, fb.shape[0])[np.argmax(fb, axis=0)]
    want = int(np.argmin(np.abs(centers - 1000.0)))
    assert abs(int(np.argmax(feats.mean(axis=(0, 1)))) - want) <= 1


# ------------------------------ PcmFeaturizer ------------------------------

N = 400 + 160 * 42 + 73  # 43 frames + a dropped partial window
AUDIO = (np.random.default_rng(0).normal(size=N) * 0.1).astype(np.float32)


def _offline(audio=AUDIO):
    f, n = _port(audio[None], np.array([audio.shape[0]], np.int32),
                 n_mels=8)
    return f[0, :n[0]]


def _chunked(cls, audio, cuts, **kw):
    f = cls(8, **kw)
    return np.concatenate([f.feed(p) for p in np.split(audio, cuts)], 0)


def _splits():
    rng = np.random.default_rng(1)
    return [np.sort(rng.integers(1, N, size=7)) for _ in range(4)] + [[]]


@pytest.mark.parametrize("cuts", _splits(), ids=range(5))
def test_pcm_featurizer_under_splits(cuts):
    got = _chunked(PcmFeaturizer, AUDIO, cuts, device="cpu")
    want = _offline()
    assert got.shape == want.shape == (43, 8)
    np.testing.assert_allclose(got, want, atol=PCM_ATOL)
    np.testing.assert_allclose(got, _chunked(JaxPcm, AUDIO, cuts),
                               atol=PCM_ATOL)


def test_pcm_featurizer_tiny_chunks_and_empty_feeds():
    f, j = PcmFeaturizer(8, device="cpu"), JaxPcm(8)
    feeds = [AUDIO[:399], np.zeros((0,), np.float32)]
    feeds += [AUDIO[k:k + 1] for k in range(399, 402)] + [AUDIO[402:]]
    outs = [f.feed(x) for x in feeds]
    jouts = [j.feed(x) for x in feeds]
    assert [o.shape for o in outs] == [o.shape for o in jouts]
    # the first frame completes exactly when sample 400 arrives
    assert outs[0].shape == (0, 8) and outs[2].shape[0] == 1
    got = np.concatenate(outs, 0)
    np.testing.assert_allclose(got, _offline(), atol=PCM_ATOL)
    np.testing.assert_allclose(got, np.concatenate(jouts, 0), atol=PCM_ATOL)


def test_pcm_featurizer_drops_a_partial_window():
    f = PcmFeaturizer(8, device="cpu")
    assert f.feed(AUDIO[:399]).shape == (0, 8)
