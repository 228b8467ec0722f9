"""Audio front ends, the port of ``wfl_asr_tpu/ops/frontend.py``:

- ``wav2vec2_normalize[_masked]``: the WavLM front end;
- ``whisper_log_mel``: the Whisper front end, HF ``WhisperFeatureExtractor``
  numerics (pad or truncate to 30 s, STFT hann 400/160 centred, the last
  frame dropped, Slaney mel, log10 with a 1e-10 floor, the per-sample
  max − 8 clamp, then (x + 4) / 4);
- ``mel_spectrogram``: the ``encoder_type: none`` front end,
  ``torchaudio.transforms.MelSpectrogram`` as the reference builds it (HTK
  mel, no norm, power 2, centred with reflect padding, or ``precentered``
  where the host padded the exact-length row already).

Both mel front ends take f32 audio and return f32 whatever the compute
dtype, as the JAX tagger calls them. Inside, the STFT (``torch.stft``, an
FFT where the JAX package takes a strided conv over the windowed DFT basis
at ``Precision.HIGHEST``), the mel projection and the log run in float64:
an f32 STFT is off by up to 1e-3 relative in the weakest bins, which the
narrow low mel filters carry into the log-mel at about 1e-5, and a float64
product never takes TF32 on the card, whatever the global flags say.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

WHISPER_N_FFT = 400
WHISPER_HOP = 160
WHISPER_N_MELS = 80
WHISPER_N_SAMPLES = 480_000          # 30 s at 16 kHz
WHISPER_N_FRAMES = 3000              # feature frames after the last is dropped


# ---------------------------------------------------------------------------
# Mel filterbank (host-side numpy constant, cached)
# ---------------------------------------------------------------------------

def _hz_to_mel(freq: np.ndarray, scale: str) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    # slaney: linear below 1 kHz, log above
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz)
                    / logstep, mels)


def _mel_to_hz(mels: np.ndarray, scale: str) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    freqs)


@functools.lru_cache(maxsize=16)
def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   fmin: float = 0.0, fmax: Optional[float] = None,
                   scale: str = "htk", norm: Optional[str] = None
                   ) -> np.ndarray:
    """Triangular mel filterbank [n_freqs, n_mels] f32. ``scale="slaney",
    norm="slaney"`` is HF's (librosa's) Whisper bank; ``scale="htk",
    norm=None`` torchaudio's default. The array is cached: do not write
    to it."""
    if fmax is None:
        fmax = sample_rate / 2.0
    all_freqs = np.linspace(0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(_hz_to_mel(np.array(fmin), scale),
                          _hz_to_mel(np.array(fmax), scale), n_mels + 2)
    f_pts = _mel_to_hz(mel_pts, scale)

    f_diff = np.diff(f_pts)                                  # [n_mels + 1]
    slopes = f_pts[None, :] - all_freqs[:, None]             # [n_freqs, n_mels + 2]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))               # [n_freqs, n_mels]

    if norm == "slaney":
        enorm = 2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels])
        fb = fb * enorm[None, :]
    return fb.astype(np.float32)


def stft_power(x: torch.Tensor, n_fft: int = WHISPER_N_FFT,
               hop: int = WHISPER_HOP, center: bool = True) -> torch.Tensor:
    """Power spectrogram |STFT|² [B, n_frames, n_fft // 2 + 1], float64,
    under the periodic Hann window. ``center=True`` reflect-pads n_fft // 2
    on each side (``torch.stft``'s default), giving ``n_frames = 1 + S //
    hop``."""
    if x.dim() == 1:
        x = x[None, :]
    win = torch.hann_window(n_fft, dtype=torch.float64, device=x.device)
    spec = torch.stft(x.double(), n_fft, hop_length=hop, win_length=n_fft,
                      window=win, center=center, pad_mode="reflect",
                      onesided=True, return_complex=True)   # [B, bins, T]
    power = spec.real.square() + spec.imag.square()
    return power.transpose(1, 2)


def pad_or_truncate(x: torch.Tensor, length: int) -> torch.Tensor:
    """Zero-pad or truncate the time axis of [B, S] to ``length``."""
    if x.dim() == 1:
        x = x[None, :]
    s = x.shape[-1]
    if s > length:
        return x[:, :length]
    if s < length:
        return F.pad(x, (0, length - s))
    return x


def _mel(power: torch.Tensor, fb: np.ndarray) -> torch.Tensor:
    """[B, T, bins] · [bins, n_mels] in the power's dtype."""
    return torch.matmul(power, torch.from_numpy(fb).to(power))


def whisper_log_mel(audio: torch.Tensor,
                    n_mels: int = WHISPER_N_MELS) -> torch.Tensor:
    """HF ``WhisperFeatureExtractor`` log-mel on the tensor's device:
    [B, S] (any S) → [B, n_mels, 3000] f32."""
    audio = pad_or_truncate(audio, WHISPER_N_SAMPLES)
    power = stft_power(audio, WHISPER_N_FFT, WHISPER_HOP)[:, :-1]
    fb = mel_filterbank(WHISPER_N_FFT // 2 + 1, n_mels, 16000, 0.0, 8000.0,
                        scale="slaney", norm="slaney")
    log_spec = torch.log10(_mel(power, fb).clamp_min(1e-10))
    per_sample_max = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, per_sample_max - 8.0)
    return ((log_spec + 4.0) / 4.0).transpose(1, 2).float()


def mel_spectrogram(audio: torch.Tensor, sample_rate: int = 16000,
                    n_fft: int = 400, hop: int = 320, n_mels: int = 80,
                    center: bool = True) -> torch.Tensor:
    """``torchaudio.transforms.MelSpectrogram`` as the reference builds it
    (hann, power 2, HTK mel, no norm, fmin 0, fmax sr / 2), time-major:
    [B, S] → [B, T, n_mels] f32. ``center=False`` for rows the host
    reflect-padded at their exact length (bucketed inference)."""
    power = stft_power(audio, n_fft, hop, center=center)
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, scale="htk",
                        norm=None)
    return _mel(power, fb).float()


# ---------------------------------------------------------------------------
# Wav2Vec2 normalization (the WavLM front end)
# ---------------------------------------------------------------------------

def wav2vec2_normalize(audio: torch.Tensor) -> torch.Tensor:
    """Zero-mean unit-variance per row over the full (padded) row, variance
    eps 1e-7 (HF ``Wav2Vec2FeatureExtractor``)."""
    if audio.dim() == 1:
        audio = audio[None, :]
    mean = audio.mean(dim=-1, keepdim=True)
    var = audio.var(dim=-1, keepdim=True, unbiased=False)
    return (audio - mean) / torch.sqrt(var + 1e-7)


def wav2vec2_normalize_masked(audio: torch.Tensor,
                              sample_mask: torch.Tensor) -> torch.Tensor:
    """Per-row normalization with statistics over valid samples only
    (bucket-padded inference equals the exact-length row)."""
    if audio.dim() == 1:
        audio = audio[None, :]
    m = sample_mask.to(audio.dtype)
    count = m.sum(dim=-1, keepdim=True).clamp_min(1.0)
    mean = (audio * m).sum(dim=-1, keepdim=True) / count
    var = ((audio - mean).square() * m).sum(dim=-1, keepdim=True) / count
    return (audio - mean) / torch.sqrt(var + 1e-7)
