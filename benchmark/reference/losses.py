"""The training objective: cross-entropy with label smoothing over the
labelled frames (frames labelled -100 are ignored), plus the boundary
offsets' L1 error weighted by ``subframe_weight``.

The offset targets: each segment's start (channel 0) and end (channel 1)
at frame ``int(t / Δ)`` with the fraction ``t/Δ − frame``, kept where the
frame lies inside the item's label length; the error is averaged over an
item's targets, then over the batch's items.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F


def offset_targets(segments: Sequence[Tuple[float, float, str]],
                   frame_duration: float, label_len: int):
    out = []
    for start, end, _ph in segments:
        for channel, t in ((0, float(start)), (1, float(end))):
            frame = int(t / frame_duration)
            if frame < label_len:
                out.append((frame, channel, t / frame_duration - frame))
    return out


def offset_l1(offsets: torch.Tensor, targets: List[list]) -> torch.Tensor:
    """offsets [B, T, 2]; targets: per item [(frame, channel, fraction)]."""
    per_item = []
    for i, tg in enumerate(targets):
        if not tg:
            per_item.append(offsets.new_zeros(()))
            continue
        f = torch.tensor([x[0] for x in tg], device=offsets.device)
        c = torch.tensor([x[1] for x in tg], device=offsets.device)
        x = torch.tensor([x[2] for x in tg], dtype=torch.float32,
                         device=offsets.device)
        f = f.clamp(0, offsets.shape[1] - 1)
        per_item.append((offsets[i, f, c].float() - x).abs().mean())
    return torch.stack(per_item).mean()


def tagger_loss(logits, offsets, labels, targets, label_smoothing: float,
                subframe_weight: float) -> torch.Tensor:
    ce = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                         labels.reshape(-1), ignore_index=-100,
                         label_smoothing=label_smoothing)
    return ce + subframe_weight * offset_l1(offsets, targets)
