"""Seeded weights, drawn on the device in two large calls (one uniform,
one normal draw for every entry of the spec), in float32, the type the
program serves and trains them in."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from ..reference.tagger import fill_sinusoid


def make_state(spec: List[Tuple[str, tuple, str, float]], seed: int,
               device) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {kind: sum(math.prod(s) for _, s, k, _ in spec if k == kind)
             for kind in ("uniform", "normal")}
    pools = {"uniform": torch.rand(sizes["uniform"], generator=gen,
                                   device=device).mul_(2).sub_(1),
             "normal": torch.randn(sizes["normal"], generator=gen,
                                   device=device)}
    offs = {"uniform": 0, "normal": 0}
    out = {}
    for name, shape, kind, scale in spec:
        n = math.prod(shape)
        if kind in pools:
            o = offs[kind]
            out[name] = pools[kind][o:o + n].view(shape) * scale
            offs[kind] = o + n
        elif kind == "sinusoid":
            out[name] = fill_sinusoid(shape).to(device)
        elif name.endswith("num_batches_tracked"):
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
        else:
            out[name] = torch.full(shape, scale, device=device)
    return out
