"""Functional NN primitives, the port of ``wfl_asr_tpu/models/layers.py``.

Parameters live in plain ``nn.Linear``/``nn.Conv1d``/``nn.LayerNorm``
modules (so state_dict keys are the reference checkpoint's) and stay f32;
these functions cast them to the activation dtype at use, as the JAX
package does (``p["w"].astype(x.dtype)``), and keep normalization
statistics in f32 whatever the activation dtype.

- GELU is the exact erf form (torch ``F.gelu`` default).
- ``int8`` serving quantization is not ported (ROADMAP.md Queue 1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None,
            training: bool = True) -> torch.Tensor:
    """Inverted dropout whose keep mask is drawn from ``generator`` (torch's
    default generator when None; it must live on ``x``'s device). The
    identity outside training or at rate 0."""
    if not training or rate <= 0.0:
        return x
    keep = torch.empty(x.shape, dtype=x.dtype, device=x.device).bernoulli_(
        1.0 - rate, generator=generator)
    return x * keep / (1.0 - rate)


def attention_dropout_seed(generator: Optional[torch.Generator],
                           device) -> torch.Tensor:
    """One attention call's dropout seed (K6): an int32 drawn from
    ``generator`` on ``device``, as [1] — it stays on the device, so the
    kernels read it by pointer and the host never waits. The JAX package
    draws it with ``jax.random.randint(key, (), -2**31, 2**31 - 1)``
    (wavlm.py:418, heads.py:252)."""
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (1,), generator=generator,
                         device=device, dtype=torch.int32)


def _cast(p: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dtype)


def linear(mod: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, _cast(mod.weight, x.dtype), _cast(mod.bias, x.dtype))


def conv1d(mod: nn.Conv1d, x: torch.Tensor, stride: int = 1, padding=0,
           groups: int = 1, dilation: int = 1,
           weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [B, C, T] (NCH); padding an int (symmetric) or "VALID"."""
    w = mod.weight if weight is None else weight
    return F.conv1d(x, _cast(w, x.dtype), _cast(mod.bias, x.dtype),
                    stride=stride, padding=0 if padding == "VALID" else padding,
                    dilation=dilation, groups=groups)


def layer_norm(mod: nn.LayerNorm, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, statistics and affine in f32."""
    y = F.layer_norm(x.float(), (x.shape[-1],), mod.weight.float(),
                     mod.bias.float(), eps)
    return y.to(x.dtype)


def group_norm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
               num_groups: int, eps: float = 1e-5,
               time_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm over [B, C, T]; ``time_mask`` [B, T] restricts the
    statistics to valid timesteps (bucketed inference)."""
    b, c, t = x.shape
    xf = x.float().reshape(b, num_groups, c // num_groups, t)
    if time_mask is None:
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = xf.var(dim=(2, 3), keepdim=True, unbiased=False)
    else:
        m = time_mask.float()[:, None, None, :]
        count = m.sum(dim=(2, 3), keepdim=True).clamp_min(1.0) \
            * (c // num_groups)
        mean = (xf * m).sum(dim=(2, 3), keepdim=True) / count
        var = ((xf - mean).square() * m).sum(dim=(2, 3), keepdim=True) / count
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, t)
    return (y * scale.float()[None, :, None]
            + bias.float()[None, :, None]).to(x.dtype)


def channel_stats(x: torch.Tensor,
                  time_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, channel) mean and (biased) variance over T of [B, T, C]
    in f32, optionally over ``time_mask`` [B, T] only — the statistics half
    of the WavLM layer-0 GroupNorm (layers.py:205-220)."""
    xf = x.float()
    if time_mask is None:
        return xf.mean(dim=1), xf.var(dim=1, unbiased=False)
    m = time_mask.float()[:, :, None]
    count = m.sum(dim=1).clamp_min(1.0)
    mean = (xf * m).sum(dim=1) / count
    var = ((xf - mean[:, None, :]).square() * m).sum(dim=1) / count
    return mean, var
