"""Training losses, the port of ``wfl_asr_tpu/train/losses.py``.

- ``cross_entropy``: torch ``nn.CrossEntropyLoss(label_smoothing,
  ignore_index=-100)`` semantics — mean over non-ignored frames, smoothing
  mass spread uniformly over classes.
- ``offset_loss``: the sub-frame boundary L1, vectorized to frame space:
  boundary targets are precomputed host-side as (frame, channel, fraction)
  triples (``offset_targets_from_segments``) and gathered on the device.
- ``soft_iou_segmental_loss``: the optional trainable soft-IoU term
  (``model.differentiable_segmental_weight``).
- ``segmental_loss_value``: the reference's segmental loss, value-only (it
  is detached in the reference, so it carries no gradient), on the host.

On a batch sharded over data ranks, the two means over a count that
differs from rank to rank (the CE's valid labels, the soft-IoU's present
tags) take ``mean_count`` (``parallel.Mesh.mean_count``): the count over
every rank, as this rank's share, so that the average of the ranks'
losses is the unsharded loss. The offset loss is a mean over samples,
exact as it is because every rank holds as many rows.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

Segment = Tuple[float, float, str]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0,
                  ignore_index: int = -100,
                  mean_count: Optional[Callable] = None) -> torch.Tensor:
    """logits [N, C] (or [B, T, C]), labels [N] int — mean over labels !=
    ignore_index, with uniform label smoothing (torch semantics), in f32.
    ``mean_count``: the count's reduction over data ranks (module
    docstring)."""
    if logits.dim() == 3:
        logits = logits.reshape(-1, logits.shape[-1])
        labels = labels.reshape(-1)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = -log_probs.gather(-1, safe[:, None])[:, 0]
    if label_smoothing > 0.0:
        smooth = -log_probs.mean(dim=-1)
        loss = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    else:
        loss = nll
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if mean_count is not None:
        return loss.sum() / mean_count(valid.sum())
    return loss.sum() / valid.sum().clamp_min(1)


def offset_targets_from_segments(
        segments: Sequence[Segment], frame_duration: float,
        label_len: int, max_targets: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host-side: one sample's GT segments → padded boundary-target arrays
    (frames, channels, fracs, valid), each [max_targets]. Channel 0 is a
    segment start, 1 an end; frac is the sub-frame residual
    ``t/Δ − floor(t/Δ)``; targets whose frame falls at/after ``label_len``
    are dropped."""
    frames, channels, fracs = [], [], []
    for seg in segments:
        if not isinstance(seg, (list, tuple)) or len(seg) != 3:
            continue  # malformed-segment skip
        gt_start, gt_end = float(seg[0]), float(seg[1])
        for channel, t in ((0, gt_start), (1, gt_end)):
            frame = int(t / frame_duration)
            if frame < label_len:
                frames.append(frame)
                channels.append(channel)
                fracs.append(t / frame_duration - frame)
    n = min(len(frames), max_targets)
    out_f = np.zeros(max_targets, np.int32)
    out_c = np.zeros(max_targets, np.int32)
    out_x = np.zeros(max_targets, np.float32)
    out_v = np.zeros(max_targets, bool)
    out_f[:n] = frames[:n]
    out_c[:n] = channels[:n]
    out_x[:n] = fracs[:n]
    out_v[:n] = True
    return out_f, out_c, out_x, out_v


def offset_loss(offsets: torch.Tensor, frames: torch.Tensor,
                channels: torch.Tensor, fracs: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """offsets [B, T, 2]; frames/channels/fracs/valid [B, K]. Per sample the
    mean |offsets[frame, channel] − frac| over valid targets, then the batch
    mean of the per-sample means."""
    b, t, _ = offsets.shape
    rows = torch.arange(b, device=offsets.device)[:, None]
    pred = offsets[rows, frames.long().clamp(0, t - 1), channels.long()]
    validf = valid.float()
    err = (pred.float() - fracs.float()).abs() * validf
    count = validf.sum(dim=1)
    per_sample = torch.where(count > 0, err.sum(dim=1) / count.clamp_min(1),
                             torch.zeros_like(count))
    return per_sample.mean()


def soft_iou_segmental_loss(logits: torch.Tensor, labels: torch.Tensor,
                            ignore_index: int = -100,
                            mean_count: Optional[Callable] = None
                            ) -> torch.Tensor:
    """Soft Jaccard over tag posteriors: per (sample, tag)
    iou = Σ_t p·g / Σ_t (p + g − p·g), averaged over tags present in the
    GT; loss = 1 − mean iou. ``mean_count``: as for
    :func:`cross_entropy`."""
    c = logits.shape[-1]
    valid = (labels != ignore_index)[..., None].float()
    probs = torch.softmax(logits.float(), dim=-1) * valid
    safe = torch.where(labels == ignore_index, torch.zeros_like(labels),
                       labels).long()
    g = torch.nn.functional.one_hot(safe, c).float() * valid
    inter = (probs * g).sum(dim=1)                           # [B, C]
    union = (probs + g - probs * g).sum(dim=1)
    present = g.sum(dim=1) > 0
    iou = torch.where(present, inter / union.clamp_min(1e-6),
                      torch.zeros_like(inter))
    if mean_count is not None:
        return 1.0 - iou.sum() / mean_count(present.sum())
    n = present.sum().clamp_min(1)
    return 1.0 - iou.sum() / n


def segmental_loss_value(segments_pred: List[Segment],
                         segments_gt: List[Segment],
                         loss_weights=(1.0, 1.0, 2.0)) -> float:
    """Greedy best-match score per GT segment, averaged over matched GT
    segments (value only, no gradient)."""
    w_start, w_end, w_iou = loss_weights
    if not segments_pred:
        return 0.0
    p_start = np.array([s[0] for s in segments_pred])
    p_end = np.array([s[1] for s in segments_pred])
    p_ph = np.array([s[2] for s in segments_pred])

    total = 0.0
    matched = 0
    for seg in segments_gt:
        if not isinstance(seg, (list, tuple)) or len(seg) != 3:
            continue
        gt_start, gt_end, gt_ph = seg
        mask = p_ph == gt_ph
        if not mask.any():
            continue
        ps, pe = p_start[mask], p_end[mask]
        inter = np.maximum(0.0, np.minimum(gt_end, pe)
                           - np.maximum(gt_start, ps))
        union = np.maximum(gt_end, pe) - np.minimum(gt_start, ps)
        iou = np.where(union > 0, inter / np.where(union > 0, union, 1.0),
                       0.0)
        score = (w_start * np.abs(gt_start - ps) + w_end * np.abs(gt_end - pe)
                 + w_iou * (1.0 - iou))
        total += float(score.min())
        matched += 1
    return total / matched if matched else 0.0
