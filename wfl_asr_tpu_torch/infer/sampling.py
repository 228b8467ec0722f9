"""Frame-label sampling, the port of ``wfl_asr_tpu/infer/sampling.py``:
``sample_from_logits`` (top-k) and ``top_p_sample`` (nucleus) over
per-frame label distributions, reference infer.py:62-84. As in the
reference and the JAX package they are dead in the pipeline — the sampled
ids would be overwritten by the confidence/argmax path (quirk Q2) — and
are provided for API completeness. The draws come from an explicit
``torch.Generator`` (on the logits' device) where the JAX functions take a
PRNG key, so the two agree in distribution, not bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch


def sample_from_logits(generator: Optional[torch.Generator],
                       logits: torch.Tensor, k: int = 5,
                       temperature: float = 1.0) -> torch.Tensor:
    """Top-k sampling per frame: logits [T, C] → ids [T]."""
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    topk_probs, topk_idx = torch.topk(probs, k, dim=-1)
    topk_probs = topk_probs / topk_probs.sum(dim=-1, keepdim=True)
    choice = torch.multinomial(topk_probs, 1, generator=generator)
    return torch.gather(topk_idx, -1, choice)[:, 0]


def top_p_sample(generator: Optional[torch.Generator], logits: torch.Tensor,
                 p: float = 0.9, temperature: float = 1.0) -> torch.Tensor:
    """Nucleus sampling per frame: logits [T, C] → ids [T]. Keeps the
    classes whose cumulative probability (in descending order) is ≤ p, and
    always the top class."""
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    sorted_probs, order = torch.sort(probs, dim=-1, descending=True)
    keep_sorted = torch.cumsum(sorted_probs, dim=-1) <= p
    keep_sorted[:, 0] = True
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    filtered = torch.where(keep, probs, torch.zeros_like(probs))
    filtered = filtered / filtered.sum(dim=-1, keepdim=True)
    return torch.multinomial(filtered, 1, generator=generator)[:, 0]
