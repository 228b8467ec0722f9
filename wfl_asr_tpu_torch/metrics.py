"""Evaluation metrics on the host (numpy): frame accuracy, phoneme error
rate, timing error rate — the port of ``wfl_asr_tpu/metrics.py``."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .labels import clean_lab

Segment = Tuple[float, float, str]


def framewise_accuracy(pred_ids: np.ndarray, label_ids: np.ndarray) -> float:
    """Fraction of frames where the argmax prediction equals the label (no
    ignore-index masking, as in the reference)."""
    pred_ids = np.asarray(pred_ids)
    label_ids = np.asarray(label_ids)
    total = label_ids.size
    if total == 0:
        return 0.0
    return float((pred_ids == label_ids).sum()) / total


def phoneme_error_rate(pred_segments: Sequence[Segment],
                       gt_segments: Sequence[Segment]) -> float:
    """Levenshtein distance between the phoneme sequences over len(GT), as
    a vectorized row DP."""
    gt_seq = [ph for _, _, ph in gt_segments]
    pred_seq = [ph for _, _, ph in pred_segments]
    m, n = len(gt_seq), len(pred_seq)
    if m == 0:
        return float(n)
    if n == 0:
        return float(m) / m

    vocab = {ph: i for i, ph in enumerate(dict.fromkeys(gt_seq + pred_seq))}
    gt = np.array([vocab[p] for p in gt_seq])
    pred = np.array([vocab[p] for p in pred_seq])

    prev = np.arange(n + 1)
    offs = np.arange(n + 1)
    for i in range(1, m + 1):
        sub = prev[:-1] + (pred != gt[i - 1])
        dele = prev[1:] + 1
        best = np.minimum(sub, dele)
        # insertion as a running min: cur[j] = j + cummin(best_k − k)
        b = np.concatenate(([i], best)) - offs
        prev = np.minimum.accumulate(b) + offs
    return float(prev[n]) / m


def timing_error_rate(pred_segments: Sequence[Segment],
                      gt_segments: Sequence[Segment]) -> float:
    """Mean matched boundary error over mean GT duration: each GT segment
    is matched to the first prediction of the same cleaned phoneme; 0.0
    when nothing matches."""
    first_pred = {}
    for pred_start, pred_end, pred_ph in pred_segments:
        first_pred.setdefault(clean_lab(pred_ph), (pred_start, pred_end))
    matched_errors: List[float] = []
    gt_durations: List[float] = []
    for gt_start, gt_end, gt_ph in gt_segments:
        hit = first_pred.get(clean_lab(gt_ph))
        if hit is not None:
            matched_errors.append(abs(gt_start - hit[0])
                                  + abs(gt_end - hit[1]))
            gt_durations.append(gt_end - gt_start)
    if not matched_errors:
        return 0.0
    avg_timing_error = float(np.mean(matched_errors)) / 2
    avg_duration = float(np.mean(gt_durations))
    return avg_timing_error / avg_duration if avg_duration > 0 else 0.0
