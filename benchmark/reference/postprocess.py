"""From frame logits and offsets to an HTK ``.lab`` text, as WFL-ASR's
inference defines it:

- gate: a frame whose largest softmax probability is below the threshold
  becomes "O", else it takes the most probable tag (the first of equals);
- median filter of odd size over the tag ids (size 1: none), reflecting
  at the edges;
- BIO decode: a segment opens at ``B-x`` (or at ``I-x`` after another
  phoneme) and closes at "O", at a new ``B-``, or at an ``I-`` of another
  phoneme; its times are ``(index + offset) · Δ`` with the start's offset
  channel 0 at the first frame and the end's channel 1 at the closing frame
  (at the last frame for a segment still open at the end);
- merging: a segment of the same phoneme as the one before extends it
  ("right");
- text: ``int(start·1e7) int(end·1e7) phoneme`` a line.

:func:`ambiguous_frames` marks frames where a float32 rounding could flip
the gate or the arg-max; a comparison with a program's own ``.lab`` skips
files that have any.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

Segment = Tuple[float, float, str]


def softmax32(logits: np.ndarray) -> np.ndarray:
    x = logits.astype(np.float32)
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def gate_ids(logits: np.ndarray, threshold: float, o_id: int) -> np.ndarray:
    p = softmax32(logits)
    ids = p.argmax(axis=-1)
    return np.where(p.max(axis=-1) < threshold, o_id, ids)


def ambiguous_frames(logits: np.ndarray, threshold: float,
                     tol: float = 1e-5) -> np.ndarray:
    p = np.sort(softmax32(logits).astype(np.float64), axis=-1)
    top, second = p[:, -1], p[:, -2]
    return (np.abs(top - threshold) < tol) | ((top >= threshold)
                                              & (top - second < tol))


def median_ids(ids: np.ndarray, size: int) -> np.ndarray:
    if size <= 1:
        return ids
    half = size // 2
    padded = np.pad(ids, half, mode="symmetric")
    win = np.lib.stride_tricks.sliding_window_view(padded, size)
    return np.median(win, axis=-1).astype(ids.dtype)


def decode(tags: Sequence[str], offsets: np.ndarray,
           dt: float = 0.02) -> List[Segment]:
    offsets = np.asarray(offsets, np.float64)
    segs: List[Segment] = []
    cur, start = None, 0

    def close(end_idx):
        segs.append(((start + float(offsets[start, 0])) * dt,
                     (end_idx + float(offsets[end_idx, 1])) * dt, cur))

    for i, tag in enumerate(tags):
        if tag == "O":
            if cur is not None:
                close(i)
                cur = None
        elif tag.startswith("B-"):
            if cur is not None:
                close(i)
            cur, start = tag[2:], i
        elif tag[2:] != cur:
            if cur is not None:
                close(i)
            cur, start = tag[2:], i
    if cur is not None:
        close(len(tags) - 1)
    return segs


def merge_right(segs: List[Segment]) -> List[Segment]:
    out: List[Segment] = []
    for s in segs:
        if out and out[-1][2] == s[2]:
            out[-1] = (out[-1][0], s[1], s[2])
        else:
            out.append(s)
    return out


def lab_text(segs: List[Segment]) -> str:
    return "".join(f"{int(s * 1e7)} {int(e * 1e7)} {ph}\n"
                   for s, e, ph in segs)


def label_file(logits: np.ndarray, offsets: np.ndarray, labels: List[str],
               threshold: float, median: int) -> str:
    ids = median_ids(gate_ids(logits, threshold, labels.index("O")), median)
    return lab_text(merge_right(decode([labels[i] for i in ids], offsets)))
