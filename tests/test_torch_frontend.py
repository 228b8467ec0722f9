"""The port's mel front ends (``wfl_asr_tpu_torch/ops/frontend.py``)
against the JAX package's on the CPU, the JAX side under
``jax.default_matmul_precision("highest")``, on inputs drawn from a numpy
seed.

Tolerances: the filterbanks are the same numpy arithmetic (1e-7); the
spectra and log-mels ≤ 1e-5 × max|ref|. The port computes its STFT,
mel projection and log in float64, so what remains is the JAX package's
own f32 rounding (up to about 1.2e-5 of the log-mel's ≈ 1.4 in the
weakest bins)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wfl_asr_tpu.ops import frontend as JF
from wfl_asr_tpu_torch.ops import frontend as PF

REL_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    with jax.default_matmul_precision("highest"):
        yield


def _close(got, ref, tol=REL_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref, atol=tol * scale, rtol=0)


@pytest.mark.parametrize("args", [
    (201, 80, 16000, 0.0, 8000.0, "slaney", "slaney"),
    (201, 128, 16000, 0.0, 8000.0, "slaney", "slaney"),
    (201, 80, 16000, 0.0, None, "htk", None),
    (257, 40, 22050, 20.0, 9000.0, "htk", None),
])
def test_mel_filterbank(args):
    n_freqs, n_mels, sr, fmin, fmax, scale, norm = args
    ref = JF.mel_filterbank(n_freqs, n_mels, sr, fmin, fmax, scale=scale,
                            norm=norm)
    got = PF.mel_filterbank(n_freqs, n_mels, sr, fmin, fmax, scale=scale,
                            norm=norm)
    assert got.dtype == np.float32 and got.shape == (n_freqs, n_mels)
    np.testing.assert_allclose(got, ref, atol=1e-7, rtol=0)


@pytest.mark.parametrize("n_fft,hop,center", [(400, 160, True),
                                              (400, 320, False)])
def test_stft_power(n_fft, hop, center):
    x = (np.random.RandomState(1).randn(2, 7919) * 0.3).astype(np.float32)
    ref = JF.stft_power(jnp.asarray(x), n_fft, hop, center=center)
    got = PF.stft_power(torch.from_numpy(x), n_fft, hop, center=center)
    _close(got.numpy(), ref)


def _rows(rng, seconds):
    """Rows of ``seconds`` of audio (noise, a tone with silent bins,
    a quiet row) zero-padded to the longest."""
    n = int(max(seconds) * 16000)
    out = np.zeros((len(seconds), n), np.float32)
    for i, s in enumerate(seconds):
        m = int(s * 16000)
        t = np.arange(m) / 16000.0
        if i % 3 == 0:
            out[i, :m] = rng.randn(m) * 0.2
        elif i % 3 == 1:
            out[i, :m] = 0.4 * np.sin(2 * np.pi * 440.0 * t)
        else:
            out[i, :m] = rng.randn(m) * 1e-3
    return out


@pytest.mark.parametrize("n_mels", [80, 128])
def test_whisper_log_mel(n_mels):
    """Rows shorter and longer than 30 s (padded, truncated), and the
    per-sample max − 8 clamp over a quiet row."""
    x = _rows(np.random.RandomState(n_mels), (7.3, 31.2, 12.0))
    ref = JF.whisper_log_mel(jnp.asarray(x), n_mels=n_mels)
    got = PF.whisper_log_mel(torch.from_numpy(x), n_mels=n_mels)
    assert got.dtype == torch.float32
    assert got.shape == (3, n_mels, PF.WHISPER_N_FRAMES)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("center", [True, False])
def test_mel_spectrogram(center):
    """Centred (training) and precentered (the host reflect-padded the
    exact-length row, bucketed inference)."""
    x = _rows(np.random.RandomState(3), (2.13, 1.4))
    if not center:
        x = np.pad(x, ((0, 0), (200, 200)), mode="reflect")
    ref = JF.mel_spectrogram(jnp.asarray(x), 16000, 400, 320, 80,
                             center=center)
    got = PF.mel_spectrogram(torch.from_numpy(x), 16000, 400, 320, 80,
                             center=center)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref)


def test_pad_or_truncate():
    x = torch.arange(10.0)
    assert PF.pad_or_truncate(x, 4).tolist() == [[0.0, 1.0, 2.0, 3.0]]
    got = PF.pad_or_truncate(x[None], 12)
    assert got.shape == (1, 12) and got[0, 10:].tolist() == [0.0, 0.0]
