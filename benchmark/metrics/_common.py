"""Shared arithmetic of the per-layer readers: the calls a span recorded
inside the traced host interval, and the kernel bounds of those calls."""

from __future__ import annotations

import torch

from benchmark.core import counts


def dtype_key(dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "f32_tf32x3"


def elem(dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def traced_calls(run: dict, span: str):
    t0, t1 = run["trace_host"]
    return [c for c in run["spans"].calls.get(span, ()) if t0 <= c[0] < t1]


def valid_keys(kv_len, b: int, t: int) -> float:
    if kv_len is None:
        return float(b * t)
    return float(torch.as_tensor(kv_len).sum())


def roofline(run: dict, span: str, bound_of) -> float:
    """Σ bound over Σ device time of the span's calls in the traced
    window, in %; None where the span launched nothing."""
    if "device_under" not in run:
        return None
    device_s, ops = run["device_under"].get(span, (0.0, 0))
    calls = traced_calls(run, span)
    if not calls or not ops or device_s <= 0:
        return None
    bound = sum(bound_of(info) for _t0, _t1, info in calls)
    return 100.0 * bound / device_s


def attention_fwd_bound(info) -> float:
    (b, h, t, d), dtype, bias, kv_len = info
    f, n = counts.attention_fwd(b, h, t, d, valid_keys(kv_len, b, t),
                                elem(dtype), bias)
    return counts.bound_s(f, n, dtype_key(dtype))[0]


def attention_bwd_bound(info) -> float:
    (b, h, t, d), dtype, bias, kv_len = info
    f, n = counts.attention_bwd(b, h, t, d, valid_keys(kv_len, b, t),
                                elem(dtype), bias)
    return counts.bound_s(f, n, dtype_key(dtype))[0]
