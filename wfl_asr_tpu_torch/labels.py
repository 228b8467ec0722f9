"""Label / artifact formats: HTK ``.lab`` I/O, BIO tagging, segment decode & merge.

Host-side, pure Python+NumPy. These functions are parity-critical: they must
reproduce the reference's observable behavior exactly, including its quirks
(see SURVEY.md appendix). Behavioral contracts are cited to the reference
implementation (``preprocess.py``, ``utils.py``, ``infer.py`` in
usamireko/WFL-ASR) but the code here is written fresh.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

HTK_TIME_FACTOR = 1e7  # 100 ns units (reference utils.py:8)

Segment = Tuple[float, float, str]


# ---------------------------------------------------------------------------
# HTK .lab I/O
# ---------------------------------------------------------------------------

def parse_lab(lab_path: str) -> List[Segment]:
    """Parse an HTK label file into ``[(start_s, end_s, phoneme), ...]``.

    Contract (reference preprocess.py:12-31): each line is ``start end ph`` in
    100 ns units; malformed lines (wrong field count or non-integer times) are
    skipped with a warning rather than raising.
    """
    segments: List[Segment] = []
    with open(lab_path, "r", encoding="utf-8") as f:
        for line_num, line in enumerate(f, 1):
            fields = line.strip().split()
            if len(fields) != 3:
                print(f"[WARN] Skipping malformed line {line_num} in {lab_path}: "
                      f"{line.strip()}")
                continue
            try:
                start = int(fields[0]) / HTK_TIME_FACTOR
                end = int(fields[1]) / HTK_TIME_FACTOR
            except Exception as exc:  # noqa: BLE001 - mirror tolerant parsing
                print(f"[ERROR] Failed to parse line {line_num} in {lab_path}: {exc}")
                continue
            segments.append((start, end, fields[2]))
    return segments


def save_lab(path: str, segments: Sequence[Segment]) -> None:
    """Write segments as HTK ``.lab`` lines, truncating times to int 100 ns
    units (reference utils.py:76-81 uses ``int()``, i.e. truncation)."""
    with open(path, "w", encoding="utf-8") as f:
        for start, end, ph in segments:
            f.write(f"{int(start * HTK_TIME_FACTOR)} {int(end * HTK_TIME_FACTOR)} {ph}\n")


# ---------------------------------------------------------------------------
# BIO tagging
# ---------------------------------------------------------------------------

def to_bio_tags(segments: Sequence[Segment], num_frames: int,
                frame_duration: float) -> List[str]:
    """Rasterize segments into per-frame BIO tags.

    Contract (reference preprocess.py:33-46): ``B-ph`` at ``int(start/dt)``,
    ``I-ph`` through ``int(end/dt)`` **inclusive** (quirk Q7), both clamped to
    ``num_frames``; later segments overwrite earlier frames; everything else
    is ``"O"``.
    """
    tags = ["O"] * num_frames
    for start, end, ph in segments:
        b = int(start / frame_duration)
        e = int(end / frame_duration)
        if e >= num_frames:
            e = num_frames - 1
        if b >= num_frames:
            continue
        tags[b] = f"B-{ph}"
        for i in range(b + 1, e + 1):
            if i < num_frames:
                tags[i] = f"I-{ph}"
    return tags


def decode_bio_tags(tags: Sequence[str], frame_duration: float = 0.02,
                    offsets=None) -> List[Segment]:
    """Decode per-frame BIO tags into segments.

    Contract (reference utils.py:10-74):

    - A segment closes when an ``O`` arrives, a new ``B-`` arrives, or an
      ``I-`` with a *different* phoneme arrives (treated as an implicit B).
    - Default boundaries sit at frame centers: ``(idx + 0.5) * dt``.
    - With ``offsets`` (array-like ``[T, 2]`` of sub-frame fractions in
      [0, 1]), boundaries are ``(idx + offsets[idx, 0]) * dt`` for starts and
      ``(idx + offsets[idx, 1]) * dt`` for ends.
    - A mid-sequence close uses the closing frame index ``i`` as the end
      index; the end-of-sequence flush uses ``len(tags) - 1`` (quirk Q14),
      and only applies offsets when both indices are in range.
    """
    if offsets is not None:
        offsets = np.asarray(offsets, dtype=np.float64)

    segments: List[Segment] = []
    cur_ph: Optional[str] = None
    cur_start = 0

    def boundary_times(b: int, e: int) -> Tuple[float, float]:
        if offsets is not None:
            return ((b + float(offsets[b, 0])) * frame_duration,
                    (e + float(offsets[e, 1])) * frame_duration)
        return (b + 0.5) * frame_duration, (e + 0.5) * frame_duration

    for i, tag in enumerate(tags):
        if tag == "O":
            if cur_ph is not None:
                st, en = boundary_times(cur_start, i)
                segments.append((st, en, cur_ph))
                cur_ph = None
            continue
        if tag.startswith("B-"):
            if cur_ph is not None:
                st, en = boundary_times(cur_start, i)
                segments.append((st, en, cur_ph))
            cur_ph = tag[2:]
            cur_start = i
        elif tag.startswith("I-"):
            ph = tag[2:]
            if cur_ph != ph:
                if cur_ph is not None:
                    st, en = boundary_times(cur_start, i)
                    segments.append((st, en, cur_ph))
                cur_ph = ph
                cur_start = i

    if cur_ph is not None:
        end_idx = len(tags) - 1
        start_time = (cur_start + 0.5) * frame_duration
        end_time = (end_idx + 0.5) * frame_duration
        if offsets is not None and cur_start < len(offsets) and end_idx < len(offsets):
            start_time = (cur_start + float(offsets[cur_start, 0])) * frame_duration
            end_time = (end_idx + float(offsets[end_idx, 1])) * frame_duration
        segments.append((start_time, end_time, cur_ph))

    return segments


# ---------------------------------------------------------------------------
# Segment merging
# ---------------------------------------------------------------------------

def merge_adjacent_segments(segments: List[Segment], mode: str = "right"
                            ) -> List[Segment]:
    """Collapse adjacent same-phoneme segments.

    Contract (reference utils.py:148-186). Modes:

    - ``"right"``: extend the previous merged segment's end.
    - ``"left"``: same observable result, scanned with pop/append.
    - ``"previous"``: when segment i-1 and i share a phoneme *and* i > 1,
      collapse (i-2, i-1, i) into one segment carrying i-2's phoneme and span
      — including when i-2 and i-1 differ (reference's 3-way collapse).
    - ``"none"``: no-op.
    """
    if not segments or mode == "none":
        return segments

    merged: List[Segment] = []
    if mode == "right":
        merged = [segments[0]]
        for start, end, ph in segments[1:]:
            last_start, _last_end, last_ph = merged[-1]
            if ph == last_ph:
                merged[-1] = (last_start, end, ph)
            else:
                merged.append((start, end, ph))
    elif mode == "left":
        for i, seg in enumerate(segments):
            if i > 0 and seg[2] == segments[i - 1][2]:
                prev_start, _prev_end, ph = merged.pop()
                merged.append((prev_start, seg[1], ph))
            else:
                merged.append(seg)
    elif mode == "previous":
        for i, seg in enumerate(segments):
            if i > 1 and segments[i - 1][2] == seg[2]:
                if len(merged) >= 2:
                    anchor = merged[-2]
                    merged.pop()
                    merged[-1] = (anchor[0], seg[1], anchor[2])
                else:
                    merged.append(seg)
            else:
                merged.append(seg)
    else:
        raise ValueError(f"Unsupported merge mode: {mode}")
    return merged


# ---------------------------------------------------------------------------
# Cross-language phoneme merging
# ---------------------------------------------------------------------------

def build_merge_map(groups) -> Tuple[Dict[str, Dict[str, str]],
                                     Dict[str, Dict[str, str]]]:
    """Build forward (lang→ph→canonical) and reverse (canonical→lang→ph) maps
    from ``merged_phoneme_groups``.

    Contract (reference preprocess.py:48-67): group[0] is the canonical; if it
    contains "/" its suffix becomes the canonical label and group[0] itself is
    also merged (the "/" edge case); entries without "/" are ignored; groups
    shorter than 2 are skipped.
    """
    merge_map: Dict[str, Dict[str, str]] = {}
    reverse_map: Dict[str, Dict[str, str]] = {}
    for group in groups or []:
        if not isinstance(group, (list, tuple)) or len(group) < 2:
            continue
        head = group[0]
        if "/" in head:
            canonical = head.split("/", 1)[1]
            members = group
        else:
            canonical = head
            members = group[1:]
        for member in members:
            if "/" not in member:
                continue
            lang, ph = member.split("/", 1)
            merge_map.setdefault(lang, {})[ph] = canonical
            reverse_map.setdefault(canonical, {})[lang] = ph
    return merge_map, reverse_map


def canonical_to_lang(phoneme: str, lang: str, merge_map) -> str:
    """Map a canonical phoneme back to its per-language symbol
    (reference utils.py:206-211)."""
    if not merge_map:
        return phoneme
    if phoneme in merge_map:
        return merge_map[phoneme].get(lang, phoneme)
    return phoneme


def clean_lab(ph_segment) -> str:
    """Extract a bare phoneme string from a segment or nested singleton lists,
    dropping any "lang/" prefix (reference train.py:89-96)."""
    ph = ph_segment[2] if (isinstance(ph_segment, (tuple, list))
                           and len(ph_segment) == 3) else ph_segment
    while isinstance(ph, (tuple, list)) and len(ph) == 1:
        ph = ph[0]
    return str(ph).split("/")[-1]


# ---------------------------------------------------------------------------
# Forced alignment
# ---------------------------------------------------------------------------

def align_phoneme_list(segments_pred: List[Segment],
                       forced_list: List[str]) -> List[Segment]:
    """Align predicted segments to a forced phoneme sequence.

    Contract (reference infer.py:30-60), two greedy passes:

    1. Monotone label match: for each forced phoneme in order, claim the first
       unclaimed prediction at/after the previous claim whose phoneme matches.
    2. Fill: unmatched forced phonemes claim the earliest still-unclaimed
       predictions, in order.

    Output keeps each claimed prediction's timing with the forced phoneme's
    label; forced phonemes with no claimable prediction are dropped.
    """
    used: set = set()
    claim: List[Optional[int]] = [None] * len(forced_list)

    scan_from = 0
    for f_i, f_ph in enumerate(forced_list):
        for p_i in range(scan_from, len(segments_pred)):
            if segments_pred[p_i][2] == f_ph and p_i not in used:
                claim[f_i] = p_i
                used.add(p_i)
                scan_from = p_i + 1
                break

    fill_ptr = 0
    for f_i in range(len(forced_list)):
        if claim[f_i] is None:
            while fill_ptr < len(segments_pred) and fill_ptr in used:
                fill_ptr += 1
            if fill_ptr < len(segments_pred):
                claim[f_i] = fill_ptr
                used.add(fill_ptr)
                fill_ptr += 1

    result: List[Segment] = []
    for f_i, f_ph in enumerate(forced_list):
        p_i = claim[f_i]
        if p_i is not None and p_i < len(segments_pred):
            s, e, _ = segments_pred[p_i]
            result.append((s, e, f_ph))
    return result


# ---------------------------------------------------------------------------
# Artifact file I/O (phonemes.txt, langs.txt, lang_phonemes.json, merge map)
# ---------------------------------------------------------------------------

def load_phoneme_list(path: str) -> List[str]:
    """Non-empty stripped lines of phonemes.txt (reference utils.py:83-85)."""
    with open(path, "r", encoding="utf-8") as f:
        return [line.strip() for line in f if line.strip()]


def load_langs(path: str) -> Dict[str, int]:
    """``lang,id`` lines of langs.txt (reference utils.py:188-194)."""
    lang2id: Dict[str, int] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            lang, idx = line.strip().split(",")
            lang2id[lang] = int(idx)
    return lang2id


def load_lang_phonemes(path: str):
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def load_phoneme_merge_map(path: str):
    """Reverse merge map JSON, or None if absent (reference utils.py:200-204)."""
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)
