"""Device-side postprocess: confidence gate, median filter, BIO decode.
The port of ``wfl_asr_tpu/ops/postprocess.py:28-203``.

The BIO state machine is vectorized (no per-frame loop): the "open
phoneme" state after frame i is set by the last non-pass-through frame
(O clears it, B-x/I-x set x, other tags keep it) — a ``torch.cummax`` over
frame indices plus one gather; closes are compacted into fixed-size arrays
by a scatter with a dump slot.
"""

from __future__ import annotations

import numpy as np
import torch


def confidence_gate_ids(logits: torch.Tensor, threshold: float,
                        o_id: int) -> torch.Tensor:
    """argmax ids; frames whose max softmax prob < threshold become "O"
    (strict ``<``, reference infer.py:86-96). logits: [..., T, n_tags]."""
    probs = torch.softmax(logits, dim=-1)
    max_probs = probs.amax(dim=-1)
    pred_ids = probs.argmax(dim=-1)   # first maximum, as jnp.argmax
    return torch.where(max_probs < threshold,
                       torch.full_like(pred_ids, o_id), pred_ids)


def _reflect_index(idx: torch.Tensor, n) -> torch.Tensor:
    """scipy 'reflect' (numpy 'symmetric') boundary for any offset:
    period 2n, exact even when the window exceeds the sequence."""
    m = torch.remainder(idx, 2 * n)
    return torch.where(m >= n, 2 * n - 1 - m, m)


def median_filter_ids(ids: torch.Tensor, size: int) -> torch.Tensor:
    """``scipy.ndimage.median_filter(ids, size=size)`` on the last axis:
    reflect boundary, extra tap on the left for even sizes, rank size//2."""
    if size <= 1 or ids.dim() == 0:
        return ids
    left = size // 2
    t = ids.shape[-1]
    i = torch.arange(t, device=ids.device)
    cols = [ids[..., _reflect_index(i + (k - left), t)] for k in range(size)]
    win = torch.stack(cols, dim=-1)
    return torch.sort(win, dim=-1).values[..., size // 2]


def median_filter_ids_masked(ids: torch.Tensor, size: int,
                             length) -> torch.Tensor:
    """``median_filter_ids(ids[:length], size)`` on the first ``length``
    frames of a padded 1-D row; frames ≥ length pass through."""
    if size <= 1 or ids.dim() == 0:
        return ids
    left = size // 2
    t = ids.shape[-1]
    i = torch.arange(t, device=ids.device)
    length = torch.as_tensor(length, device=ids.device)
    n = length.clamp_min(1)
    cols = [ids[_reflect_index(i + (k - left), n)] for k in range(size)]
    out = torch.sort(torch.stack(cols, dim=-1), dim=-1).values[..., size // 2]
    return torch.where(i < length, out, ids)


def bio_tables(label_list):
    """Per-label-id tables for :func:`extract_segments_ids`: ``kind[id]`` ∈
    {0: "O", 1: "B-", 2: "I-", 3: other (pass-through)}, ``ph[id]`` indexes
    ``ph_names`` (B-x and I-x share it), −1 for non-BIO. Host, once."""
    ph_names, ph_index = [], {}
    kind = np.zeros(len(label_list), np.int32)
    ph = np.full(len(label_list), -1, np.int32)
    for i, tag in enumerate(label_list):
        if tag.startswith("B-"):
            kind[i] = 1
        elif tag.startswith("I-"):
            kind[i] = 2
        elif tag == "O":
            continue
        else:
            kind[i] = 3
            continue
        name = tag[2:]
        if name not in ph_index:
            ph_index[name] = len(ph_names)
            ph_names.append(name)
        ph[i] = ph_index[name]
    return kind, ph, ph_names


def extract_segments_ids(ids: torch.Tensor, offsets: torch.Tensor, length,
                         kind_table: torch.Tensor, ph_table: torch.Tensor):
    """BIO state machine on label ids → fixed-size segment arrays
    (``labels.decode_bio_tags`` semantics; end-of-sequence flush uses
    ``length - 1``). Boundary times are left to the host (f64 math keeps
    ``.lab`` truncation parity).

    ids [T] int; offsets [T, 2] f32; length: true frame count ≤ T.
    Returns (start_idx, end_idx, ph_id, start_off, end_off, count); entries
    ≥ count are padding, segments in the host decoder's emission order."""
    dev = ids.device
    t = ids.shape[0]
    idx = torch.arange(t, dtype=torch.int32, device=dev)
    length = torch.as_tensor(length, device=dev).to(torch.int32)
    valid = idx < length
    ids = ids.long()
    kind = torch.where(valid, kind_table[ids], torch.zeros_like(ids,
                                                                dtype=torch.int32))
    is_bio = (kind == 1) | (kind == 2)
    neg1 = torch.full_like(idx, -1)
    ph = torch.where(is_bio, ph_table[ids], neg1)
    sel = torch.where(kind != 3, idx, neg1)
    last_sel = torch.cummax(sel, dim=0).values
    eff = torch.where(last_sel >= 0, ph[last_sel.clamp(0, t - 1).long()],
                      neg1)
    prev = torch.cat([neg1[:1], eff[:-1]])
    prev_active = prev != -1
    is_start = (kind == 1) | ((kind == 2) & (ph != prev))
    close_here = prev_active & valid & (
        (kind == 0) | (kind == 1) | ((kind == 2) & (ph != prev)))

    start_pos = torch.where(is_start, idx, neg1)
    run_start = torch.cummax(start_pos, dim=0).values
    run_start_prev = torch.cat([neg1[:1], run_start[:-1]])

    last = (length - 1).clamp_min(0).long()
    flush_on = (length > 0) & (eff[last] != -1)
    flush_start = run_start[last]

    close_i = close_here.to(torch.int32)
    n_closes = close_i.sum()
    pos = torch.cumsum(close_i, dim=0) - 1
    tgt = torch.where(close_here, pos, torch.full_like(pos, t)).long()
    zeros = torch.zeros(t + 1, dtype=torch.int32, device=dev)
    out_b = zeros.clone().scatter_(0, tgt, run_start_prev)
    out_e = zeros.clone().scatter_(0, tgt, idx)
    out_p = zeros.clone().scatter_(0, tgt, prev)
    flush_tgt = torch.where(flush_on, n_closes, torch.tensor(t, device=dev)
                            ).long().reshape(1)
    out_b.scatter_(0, flush_tgt, flush_start.reshape(1))
    out_e.scatter_(0, flush_tgt, last.to(torch.int32).reshape(1))
    out_p.scatter_(0, flush_tgt, eff[last].reshape(1))
    out_b, out_e, out_p = out_b[:t], out_e[:t], out_p[:t]

    start_off = offsets[out_b.clamp(0, t - 1).long(), 0]
    end_off = offsets[out_e.clamp(0, t - 1).long(), 1]
    count = n_closes + flush_on.to(torch.int32)
    return out_b, out_e, out_p, start_off, end_off, count
