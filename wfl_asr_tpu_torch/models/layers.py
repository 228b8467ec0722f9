"""Functional NN primitives, the port of ``wfl_asr_tpu/models/layers.py``.

Parameters live in plain ``nn.Linear``/``nn.Conv1d``/``nn.LayerNorm``
modules (so state_dict keys are the reference checkpoint's) and stay f32;
these functions cast them to the activation dtype at use, as the JAX
package does (``p["w"].astype(x.dtype)``), and keep normalization
statistics in f32 whatever the activation dtype.

- GELU is the exact erf form (torch ``F.gelu`` default).
- ``int8`` serving (``model.serving_quantization: int8``, W8A8-dynamic, as
  ``quantize_tree_int8`` / ``_linear_int8``): ``quantize_int8`` swaps the
  encoder's large ``nn.Linear``s for :class:`Int8Linear`s at session load,
  and ``linear`` dispatches on the quantized form. Checkpoints stay float.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import recompute


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


class Generators(NamedTuple):
    """The two draw streams of a step sharded over several ranks: ``local``
    for element-wise dropout masks (one stream a data rank, so that the
    ranks' masks do not repeat), ``shared`` for the whole-batch draws —
    LayerDrop and the strict-dropout seeds — which every rank must draw
    alike. One process passes a single ``torch.Generator``, which serves
    as both."""
    local: torch.Generator
    shared: torch.Generator


def local_generator(generator):
    """The element-wise dropout stream of ``generator`` (a
    :class:`Generators` pair or a single generator)."""
    return generator.local if isinstance(generator, Generators) \
        else generator


def shared_generator(generator):
    """The whole-batch stream of ``generator`` (LayerDrop, strict-dropout
    seeds)."""
    return generator.shared if isinstance(generator, Generators) \
        else generator


def generator_state(generator):
    """The state of a generator or of both of a pair."""
    if isinstance(generator, Generators):
        return Generators(generator.local.get_state(),
                          generator.shared.get_state())
    return generator.get_state()


def set_generator_state(generator, state) -> None:
    if isinstance(generator, Generators):
        generator.local.set_state(state.local)
        generator.shared.set_state(state.shared)
    else:
        generator.set_state(state)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None,
            training: bool = True) -> torch.Tensor:
    """Inverted dropout whose keep mask is drawn from ``generator`` (torch's
    default generator when None; it must live on ``x``'s device; of a
    :class:`Generators` pair, the local stream). The identity outside
    training or at rate 0."""
    if not training or rate <= 0.0:
        return x
    keep = torch.empty(x.shape, dtype=x.dtype, device=x.device).bernoulli_(
        1.0 - rate, generator=local_generator(generator))
    return x * keep / (1.0 - rate)


def checkpointed(fn, generator: Optional[torch.Generator], *args,
                 layer: Optional[int] = None):
    """``fn(*args, generator)`` under ``torch.utils.checkpoint`` (remat):
    only its inputs are saved, and the backward pass recomputes it. Its
    draws from ``generator`` are the same in the first pass, in the
    recompute and without remat: the function runs on a private generator
    set to ``generator``'s state at the call, and after the first pass
    ``generator`` takes the private one's end state. (``checkpoint``
    restores only the default CPU/CUDA generators, never an explicit one.)
    With no generator, the default generators' states are what it
    restores. Each run after the first (the recompute, on the thread that
    runs the backward) is a ``wfl.recompute`` span with ``layer``."""
    from torch.utils.checkpoint import checkpoint
    first = True

    def traced(*inputs):
        nonlocal first
        if first:
            first = False
            return fn(*inputs)
        with recompute(layer):
            return fn(*inputs)

    if generator is None:
        return checkpoint(traced, *args, None, use_reentrant=False)
    start = generator_state(generator)
    if isinstance(generator, Generators):
        private = Generators(*(torch.Generator(device=g.device)
                               for g in generator))
    else:
        private = torch.Generator(device=generator.device)

    def run(*inputs):
        set_generator_state(private, start)
        return traced(*inputs, private)

    out = checkpoint(run, *args, use_reentrant=False)
    set_generator_state(generator, generator_state(private))
    return out


def attention_dropout_seed(generator: Optional[torch.Generator],
                           device) -> torch.Tensor:
    """One attention call's dropout seed (K6): an int32 drawn from
    ``generator`` (of a pair, the shared stream: every rank of a sharded
    step draws the same seed) on ``device``, as [1] — it stays on the
    device, so the
    kernels read it by pointer and the host never waits. The JAX package
    draws it with ``jax.random.randint(key, (), -2**31, 2**31 - 1)``
    (wavlm.py:418, heads.py:252)."""
    return torch.randint(-2 ** 31, 2 ** 31 - 1, (1,),
                         generator=shared_generator(generator),
                         device=device, dtype=torch.int32)


def _cast(p: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dtype)


def linear(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``x @ W.T + b`` in ``x``'s dtype. Under tensor parallelism (weights
    placed by ``parallel.tp``) a column-parallel layer (weight sharded on
    its output dim) takes the replicated ``x`` and returns this rank's
    columns, its input gradient summed over the model group; a
    row-parallel layer (sharded on its input dim) takes this rank's
    columns of ``x`` and returns the sum over the model group plus the
    replicated bias."""
    if isinstance(mod, Int8Linear):
        return linear_int8(mod, x)
    w, b = mod.weight, mod.bias
    if type(w) is not nn.Parameter and type(w) is not torch.Tensor:
        from ..parallel import tp
        shard = tp.model_dim_shard(w)
        if shard is not None:
            dim, group = shard
            w = w.to_local()
            b = b.to_local() if b is not None else None
            if dim == 0:
                return F.linear(tp.copy_to_model(x, group),
                                _cast(w, x.dtype), _cast(b, x.dtype))
            y = tp.reduce_from_model(F.linear(x, _cast(w, x.dtype)), group)
            return y + b.to(y.dtype) if b is not None else y
    return F.linear(x, _cast(w, x.dtype), _cast(b, x.dtype))


# ---------------------------------------------------------------------------
# int8 serving quantization (W8A8-dynamic)
# ---------------------------------------------------------------------------
# Weights quantize per output channel once, at session load; activations
# per row (last axis) inside each call. The int8 product is a library call
# (torch._int_mm, cuBLASLt on the card), as the JAX package leaves its int8
# dot_general to XLA.

class Int8Linear(nn.Module):
    """A quantized ``nn.Linear``: ``w_q`` int8 [out, in], ``w_scale`` f32
    [out] (symmetric: w ≈ w_q · w_scale per output row), the f32 bias."""

    def __init__(self, w_q: torch.Tensor, w_scale: torch.Tensor,
                 bias: Optional[torch.Tensor]):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("bias", bias)

    @property
    def in_features(self) -> int:
        return self.w_q.shape[1]

    @property
    def out_features(self) -> int:
        return self.w_q.shape[0]


def quantize_linear_int8(mod: nn.Linear) -> Int8Linear:
    """Symmetric per-output-channel int8 (``quantize_linear_int8``): scale =
    max|w| over the input axis / 127, floored at 1e-12; w_q = rint(w /
    scale) clipped to ±127 — in f32 on the CPU, so the codes are the JAX
    function's bit for bit."""
    w = mod.weight.detach().float().cpu()                     # [out, in]
    scale = torch.clamp_min(w.abs().amax(dim=1) / 127.0, 1e-12)
    w_q = torch.clamp(torch.round(w / scale[:, None]), -127, 127) \
        .to(torch.int8)
    bias = None if mod.bias is None else mod.bias.detach().float().cpu()
    return Int8Linear(w_q, scale, bias).to(mod.weight.device)


def quantize_int8(module: nn.Module, min_dim: int = 256) -> List[str]:
    """Replace, in place, every ``nn.Linear`` under ``module`` whose two
    dims are both ≥ ``min_dim`` with its :class:`Int8Linear` — the linears
    ``quantize_tree_int8`` picks (gates, convs, embeddings and norms stay
    float). Returns the replaced modules' names."""
    names = [name for name, sub in module.named_modules()
             if isinstance(sub, nn.Linear)
             and min(sub.in_features, sub.out_features) >= min_dim]
    for name in names:
        parent, _, leaf = name.rpartition(".")
        owner = module.get_submodule(parent) if parent else module
        setattr(owner, leaf, quantize_linear_int8(getattr(owner, leaf)))
    return names


# cuBLASLt's int8 product (torch._int_mm on CUDA) takes more than 16 rows
# and K, N that are multiples of 8
INT_MM_MIN_ROWS = 17


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """x_q int8 [M, K] · w_q int8 [N, K]ᵀ → int32 [M, N]. On the card the
    rows are zero-padded to INT_MM_MIN_ROWS when fewer; K or N that is no
    multiple of 8 raises (no float fallback)."""
    m, k = x_q.shape
    n = w_q.shape[0]
    if x_q.is_cuda:
        if k % 8 or n % 8:
            raise ValueError(
                f"int8 linear [{k} -> {n}]: torch._int_mm on CUDA needs "
                f"in and out features that are multiples of 8")
        if m < INT_MM_MIN_ROWS:
            x_q = F.pad(x_q, (0, 0, 0, INT_MM_MIN_ROWS - m))
    return torch._int_mm(x_q.contiguous(), w_q.t())[:m]


def linear_int8(mod: Int8Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ dequant(w_q)ᵀ with dynamic per-row activation quantization, as
    ``_linear_int8``: s_x = max|x| / 127 (floored at 1e-12), x_q =
    round(x / s_x) in f32, the int32 product × s_x × w_scale in f32, cast
    to x's dtype, plus the bias. A zero row gives zeros."""
    s_x = x.abs().amax(dim=-1, keepdim=True).float()
    s_x = torch.clamp_min(s_x / 127.0, 1e-12)
    x_q = torch.round(x.float() / s_x).to(torch.int8)
    lead = x.shape[:-1]
    acc = int8_matmul(x_q.reshape(-1, x.shape[-1]), mod.w_q)
    y = acc.reshape(*lead, -1).float() * s_x * mod.w_scale
    y = y.to(x.dtype)
    if mod.bias is not None:
        y = y + mod.bias.to(x.dtype)
    return y


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
