"""Position-stable attention-probability dropout mask (K6), the port of
``wfl_asr_tpu/ops/pallas/dropout_mask.py``.

The keep decision for score element (b, h, q, k) is a pure integer hash of
those absolute indices and a seed — two xorshift-multiply rounds in uint32
wraparound arithmetic, a 24-bit uniform compared with round(rate·2²⁴) — so
the forward and both backward passes regenerate the same mask at any tiling,
and the mask is bit-identical to the JAX package's. Kept probabilities are
scaled by 1/(1 − rate) (torch semantics: HF WavLM's ``attention_dropout``,
``nn.MultiheadAttention(dropout=...)``): inside the online softmax the row
normaliser and the LSE add up the undropped exp(s − m), only P·V takes the
mask, and the backward keeps delta = rowsum(dO·O) with
dV = (P·M)ᵀ·dO and dS = P·(M·dP − delta).

The CUDA kernels evaluate the same hash in ``csrc/common.cuh``
(``wfl::drop_keep``); this module is the plain PyTorch version the plain
attention twins use.
"""

from __future__ import annotations

import struct

import torch

# odd 32-bit mixing constants (dropout_mask.py:45-50), as uint32
C_Q = 0x9E3779B1
C_K = 0x85EBCA77
C_B = 0x27D4EB2F
C_H = 0x165667B1
C_M1 = 0x7FEB352D
C_M2 = 0x846CA68B

_MASK32 = 0xFFFFFFFF


def _u32(x) -> torch.Tensor:
    """An int tensor (or Python int) as int64 holding its uint32 bits."""
    return torch.as_tensor(x).to(torch.int64) & _MASK32


def _mul32(u: torch.Tensor, c: int) -> torch.Tensor:
    """(u · c) mod 2³² for u in [0, 2³²): split c in 16-bit halves so no
    int64 product overflows."""
    lo = u * (c & 0xFFFF)
    hi = ((u * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def uniform24(seed, b, h, q_idx, k_idx) -> torch.Tensor:
    """24-bit uniform integer in [0, 2²⁴) per (seed, b, h, q, k), int64.
    Arguments broadcast against each other; ``seed`` is an int32 (its bits
    are taken as uint32, as the JAX int32 wraparound arithmetic does)."""
    u = (_mul32(_u32(q_idx), C_Q) + _mul32(_u32(k_idx), C_K) + _u32(seed)
         + _mul32(_u32(b), C_B) + _mul32(_u32(h), C_H)) & _MASK32
    u = u ^ (u >> 13)
    u = _mul32(u, C_M1)
    u = u ^ (u >> 17)
    u = _mul32(u, C_M2)
    u = u ^ (u >> 16)
    return u & 0xFFFFFF


def keep_threshold(rate: float) -> int:
    """Keep iff uniform24 ≥ this: round(rate·2²⁴), clamped to [0, 2²⁴]."""
    t = int(round(float(rate) * (1 << 24)))
    return max(0, min(t, 1 << 24))


def keep_scale(rate: float) -> float:
    """The f32 scale of a kept probability, float32(1 / (1 − rate))."""
    return struct.unpack("f", struct.pack("f", 1.0 / (1.0 - float(rate))))[0]


def check_rate(rate: float) -> float:
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    return rate


def keep_mask(seed, b, h, q_idx, k_idx, rate: float) -> torch.Tensor:
    """The scaled keep mask (0 or 1/(1 − rate)) as f32."""
    keep = uniform24(seed, b, h, q_idx, k_idx) >= keep_threshold(rate)
    return keep.to(torch.float32) * keep_scale(rate)


def mask_grid(seed, b: int, h: int, tq: int, tk: int, rate: float,
              device=None) -> torch.Tensor:
    """``keep_mask`` over a whole [B, H, Tq, Tk] score grid, f32."""
    def ar(n):
        return torch.arange(n, dtype=torch.int64, device=device)
    seed = torch.as_tensor(seed, device=device).reshape(())
    return keep_mask(seed, ar(b)[:, None, None, None],
                     ar(h)[None, :, None, None], ar(tq)[:, None],
                     ar(tk)[None, :], rate)


def attention_prob_dropout_plain(probs: torch.Tensor, seed,
                                 rate: float) -> torch.Tensor:
    """Torch-semantics dropout with the exact kernel mask on a
    [B, H, Tq, Tk] probability tensor (the oracle of the kernels)."""
    b, h, tq, tk = probs.shape
    return probs * mask_grid(seed, b, h, tq, tk, rate,
                             probs.device).to(probs.dtype)
