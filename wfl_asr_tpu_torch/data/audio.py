"""Native WAV I/O and resampling (no soundfile/librosa/torchaudio dependency).

The reference delegates audio I/O to ``soundfile`` (train.py:60, infer.py:217)
and resampling to ``torchaudio.functional.resample`` (train.py:63). Here both
are implemented directly: RIFF/WAVE parsing over stdlib + NumPy, and polyphase
resampling with a Kaiser-windowed sinc (matching torchaudio's default
``sinc_interp_hann``-class quality via scipy's ``resample_poly``).
"""

from __future__ import annotations

import struct
import wave
from math import gcd
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file → (float64 samples in [-1, 1], sample_rate).

    Like ``soundfile.read``: multi-channel files return shape [T, C]; mono
    returns shape [T]. Supports PCM 8/16/24/32-bit and IEEE float32/64.
    """
    with open(path, "rb") as f:
        header = f.read(12)
        if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"Not a RIFF/WAVE file: {path}")

        fmt = None
        data = None
        while True:
            chunk_hdr = f.read(8)
            if len(chunk_hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", chunk_hdr)
            if cid == b"fmt ":
                fmt = f.read(csize)
            elif cid == b"data":
                data = f.read(csize)
            else:
                f.seek(csize + (csize & 1), 1)
                continue
            if csize & 1:
                f.seek(1, 1)
            if fmt is not None and data is not None:
                break

    if fmt is None or data is None:
        raise ValueError(f"Missing fmt/data chunk in {path}")

    (audio_format, channels, sample_rate, _byte_rate, _block_align,
     bits) = struct.unpack("<HHIIHH", fmt[:16])
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]

    if audio_format == 1:  # PCM
        if bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.float64) - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float64) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8)
            raw = raw[: (len(raw) // 3) * 3].reshape(-1, 3)
            as_int = (raw[:, 0].astype(np.int32)
                      | (raw[:, 1].astype(np.int32) << 8)
                      | (raw[:, 2].astype(np.int32) << 16))
            as_int = np.where(as_int >= (1 << 23), as_int - (1 << 24), as_int)
            x = as_int.astype(np.float64) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float64) / 2147483648.0
        else:
            raise ValueError(f"Unsupported PCM bit depth {bits} in {path}")
    elif audio_format == 3:  # IEEE float
        dtype = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(data, dtype=dtype).astype(np.float64)
    else:
        raise ValueError(f"Unsupported WAV format code {audio_format} in {path}")

    if channels > 1:
        x = x[: (len(x) // channels) * channels].reshape(-1, channels)
    return x, int(sample_rate)


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write float samples in [-1, 1] as 16-bit PCM WAV."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        channels = 1
    else:
        channels = samples.shape[1]
    clipped = np.clip(samples, -1.0, 1.0)
    pcm = (clipped * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def wav_duration(path: str) -> Tuple[int, int]:
    """(num_samples, sample_rate) without decoding sample data."""
    with open(path, "rb") as f:
        header = f.read(12)
        if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"Not a RIFF/WAVE file: {path}")
        fmt = None
        data_size = None
        while True:
            chunk_hdr = f.read(8)
            if len(chunk_hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", chunk_hdr)
            if cid == b"fmt ":
                fmt = f.read(csize + (csize & 1))
            else:
                if cid == b"data":
                    data_size = csize
                f.seek(csize + (csize & 1), 1)
            if fmt is not None and data_size is not None:
                break
    if fmt is None or data_size is None:
        raise ValueError(f"Missing fmt/data chunk in {path}")
    (_fmt_code, channels, sample_rate, _br, block_align, _bits) = \
        struct.unpack("<HHIIHH", fmt[:16])
    return data_size // max(block_align, 1), int(sample_rate)


def resample(samples: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase resampling (host). Equivalent role to
    ``torchaudio.functional.resample`` (reference train.py:63, infer.py:219)."""
    if orig_sr == new_sr:
        return samples
    from scipy.signal import resample_poly
    g = gcd(int(orig_sr), int(new_sr))
    return resample_poly(samples, new_sr // g, orig_sr // g, axis=0)


def resampled_length(n: int, orig_sr: int, new_sr: int) -> int:
    """Samples :func:`resample` returns for ``n`` (polyphase:
    ⌈n·up/down⌉), from a header alone."""
    if orig_sr == new_sr:
        return n
    g = gcd(int(orig_sr), int(new_sr))
    return -(-n * (int(new_sr) // g) // (int(orig_sr) // g))


def peak_normalize(samples: np.ndarray, eps: float = 0.0) -> np.ndarray:
    """Divide by peak absolute value; silence passes through unchanged
    (reference train.py:65-69; infer.py:234-235 adds 1e-8 via ``eps``)."""
    peak = np.max(np.abs(samples)) if samples.size else 0.0
    if eps > 0.0:
        return samples / (peak + eps)
    if peak > 0:
        return samples / peak
    return samples
