"""Audio front ends of the two encoders.

- WavLM: the wav2vec2 feature extractor's zero-mean, unit-variance
  normalization of each row (variance epsilon 1e-7).
- Whisper: ``WhisperFeatureExtractor``'s log-mel: the audio zero-padded or
  cut to 30 s, a centred STFT (periodic Hann window of 400, hop 160,
  reflect padding), the last frame dropped, the power through 80 Slaney
  mel filters (librosa's ``norm="slaney"`` bank, 0-8 kHz), ``log10`` with
  a floor of 1e-10, clamped to 8 below the row's maximum, then
  ``(x + 4) / 4``. Computed in float64 (the published extractor runs in
  NumPy), returned as float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

N_FFT, HOP, N_SAMPLES = 400, 160, 480_000


def wav2vec2_normalize(audio: torch.Tensor) -> torch.Tensor:
    mean = audio.mean(dim=-1, keepdim=True)
    var = audio.var(dim=-1, keepdim=True, unbiased=False)
    return (audio - mean) / torch.sqrt(var + 1e-7)


def _slaney_hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27)
    return np.where(f >= 1000.0, log, lin)


def _slaney_mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = m * (200.0 / 3)
    log = 1000.0 * np.exp((np.log(6.4) / 27) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


@functools.lru_cache(maxsize=4)
def slaney_mel_bank(n_mels: int, sr: int = 16000, n_fft: int = N_FFT,
                    fmax: float = 8000.0) -> np.ndarray:
    """[n_fft // 2 + 1, n_mels] float64, librosa.filters.mel(htk=False,
    norm="slaney")."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_f = _slaney_mel_to_hz(np.linspace(_slaney_hz_to_mel(0.0),
                                          _slaney_hz_to_mel(fmax),
                                          n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.T.copy()


def whisper_log_mel(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """[B, S] → [B, n_mels, 3000] float32."""
    x = audio.double()
    s = x.shape[-1]
    x = F.pad(x, (0, N_SAMPLES - s)) if s < N_SAMPLES else x[:, :N_SAMPLES]
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64,
                               device=x.device)
    spec = torch.stft(x, N_FFT, HOP, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    power = spec.abs().square()[..., :-1]                     # [B, F, 3000]
    bank = torch.from_numpy(slaney_mel_bank(n_mels)).to(x.device)
    mel = torch.einsum("bft,fm->bmt", power, bank)
    log_spec = torch.log10(mel.clamp_min(1e-10))
    top = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, top - 8.0)
    return ((log_spec + 4.0) / 4.0).float()
