"""Wav2Vec2 normalization of raw audio (the WavLM front end), the port of
``wfl_asr_tpu/ops/frontend.py:wav2vec2_normalize[_masked]``.

The mel/STFT front ends (Whisper, the ``none`` encoder) are not ported yet
(ROADMAP.md Queue 1).
"""

from __future__ import annotations

import torch


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
