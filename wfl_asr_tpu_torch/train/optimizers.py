"""The optimizers by name, the port of ``wfl_asr_tpu/train/loop.py:71-138``
(``_OPTAX_OPTIMIZERS``, ``make_optimizer``) at the semantics of optax 0.2.6.

Each name is a ``torch.optim.Optimizer`` that computes its optax factory's
function step for step:

- the catalog is the JAX package's: the torch.optim family (adamw, adam,
  sgd, adagrad, adadelta, rmsprop, rprop, nadam, nadamw, radam, adamax,
  adamaxw), the pytorch_optimizer family (lion, adafactor, lamb, lars,
  adabelief, adan, novograd, yogi, fromage, amsgrad, sm3) and three of
  ``optax.contrib`` (dadaptadamw, ademamix, adopt), plus Prodigy
  (train/prodigy.py). Lookup is case-insensitive; any other name raises the
  JAX package's ``ValueError``;
- :data:`OPTAX_KWARGS` holds, as data, each optax factory's keyword
  arguments (its signature without ``learning_rate``) with optax's
  defaults. ``make_optimizer`` filters the config's kwargs by it as the JAX
  package filters them by signature: ``training.weight_decay`` reaches only
  the factories that take ``weight_decay``, torch's ``betas`` become
  ``b1``/``b2`` where the factory has ``b1`` and are dropped where it has
  neither;
- ``lr`` is read from ``param_groups`` at every step (the loop's schedulers
  set it, as ``optax.inject_hyperparams`` feeds the JAX step) and rounded
  to f32 as the injected hyperparameter is; the scalar factors that optax
  computes in f32 (bias corrections, fromage's multiplier, adafactor's decay,
  adopt's first-step betas) are computed in f32 on the host;
- state is f32 (``mu_dtype``/``accumulator_dtype``/``dtype_momentum`` may
  narrow a momentum buffer, as in optax) with an integer ``step`` count, and
  ``state_dict``/``load_state_dict`` round-trip it exactly;
- a parameter without a gradient counts as a zero gradient (the optax
  transform sees zeros there); a boolean ``mask``/``weight_decay_mask``/
  ``trust_ratio_mask`` applies its transform to every parameter or to none;
- the statistics optax takes over a whole leaf (lamb's and lars's trust
  ratio, fromage's norms, novograd's gradient norm, adafactor's factored
  moments, block RMS and parameter scale, sm3's per-axis accumulators) are
  taken over each JAX leaf: ``leaf_blocks`` maps a parameter that stacks
  several JAX leaves to their row blocks (the Conformer's packed
  ``in_proj_weight``/``in_proj_bias`` are JAX's ``q``, ``k``, ``v``; see
  ``BIOPhonemeTagger.jax_leaf_blocks``). A transposed Linear needs no map:
  adafactor factors the two largest axes, whose row and column factors are
  symmetric under a transpose, and sm3's per-axis maxima commute with a
  permutation of the axes;
- under pipeline parallelism (``stacked``, a ``parallel.pp.StackedLeaves``)
  the JAX package's optimizer sees each encoder parameter name as one
  stacked ``[L, ...]`` leaf, so those statistics span every layer of the
  name, on every stage: the norms, the factored moments' block and
  parameter RMS, sm3's accumulators (one over the layer axis, each other
  axis's the maximum over all layers) and novograd's moment are taken over
  the stacked leaf, reduced over the stage group; Prodigy's and
  dadaptadamw's global sums add the stage-local leaves over the stages and
  count the replicated ones once;
- elementwise algebra runs as multi-tensor (``torch._foreach_*``) ops;
  per-leaf statistics run a few ops per leaf.
"""

from __future__ import annotations

import inspect
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .norms import leaf_norms
from .prodigy import Prodigy, global_sum

f32 = np.float32


def _fourth_root(count):
    """adopt's default ``clip_value_fn`` (``lambda x: x ** 0.25`` on the
    int32 count, in f32)."""
    return float(f32(count) ** f32(0.25))


_ADAM = dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, mu_dtype=None)

# Each optax factory's keyword arguments, in signature order, with optax
# 0.2.6's defaults (``dtype_momentum``'s ``jnp.float32`` as its name; adopt's
# ``clip_value_fn`` None for its ``lambda x: x ** 0.25``, _fourth_root, so
# that the param groups hold no function and the sidecar loads weights-only).
OPTAX_KWARGS: Dict[str, Dict] = {
    "adamw": dict(_ADAM, weight_decay=1e-4, mask=None, nesterov=False),
    "adam": dict(_ADAM, nesterov=False),
    "sgd": dict(momentum=None, nesterov=False, accumulator_dtype=None),
    "adagrad": dict(initial_accumulator_value=0.1, eps=1e-7),
    "adadelta": dict(rho=0.9, eps=1e-6, weight_decay=0.0,
                     weight_decay_mask=None),
    "rmsprop": dict(decay=0.9, eps=1e-8, initial_scale=0.0, eps_in_sqrt=True,
                    centered=False, momentum=None, nesterov=False,
                    bias_correction=False),
    "rprop": dict(eta_minus=0.5, eta_plus=1.2, min_step_size=1e-6,
                  max_step_size=50.0),
    "nadam": dict(_ADAM, nesterov=True),
    "nadamw": dict(_ADAM, weight_decay=1e-4, mask=None, nesterov=True),
    "radam": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, threshold=5.0,
                  nesterov=False),
    "adamax": dict(b1=0.9, b2=0.999, eps=1e-8),
    "adamaxw": dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4, mask=None),
    "lion": dict(b1=0.9, b2=0.99, mu_dtype=None, weight_decay=1e-3,
                 mask=None),
    "adafactor": dict(min_dim_size_to_factor=128, decay_rate=0.8,
                      decay_offset=0, multiply_by_parameter_scale=True,
                      clipping_threshold=1.0, momentum=None,
                      dtype_momentum="float32", weight_decay_rate=None,
                      eps=1e-30, factored=True, weight_decay_mask=None),
    "lamb": dict(b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0, weight_decay=0.0,
                 mask=None),
    "lars": dict(weight_decay=0.0, weight_decay_mask=True,
                 trust_coefficient=0.001, eps=0.0, trust_ratio_mask=True,
                 momentum=0.9, nesterov=False),
    "adabelief": dict(b1=0.9, b2=0.999, eps=1e-16, eps_root=1e-16,
                      nesterov=False),
    "adan": dict(b1=0.98, b2=0.92, b3=0.99, eps=1e-8, eps_root=1e-8,
                 weight_decay=0.0, mask=None),
    "novograd": dict(b1=0.9, b2=0.25, eps=1e-6, eps_root=0.0,
                     weight_decay=0.0),
    "yogi": dict(b1=0.9, b2=0.999, eps=1e-3),
    "fromage": dict(min_norm=1e-6),
    "amsgrad": dict(_ADAM),
    "sm3": dict(momentum=0.9),
    "dadaptadamw": dict(betas=(0.9, 0.999), eps=1e-8, estim_lr0=1e-6,
                        weight_decay=0.0),
    "ademamix": dict(b1=0.9, b2=0.999, b3=0.9999, alpha=5.0, eps=1e-8,
                     eps_root=0.0, mu_dtype=None, weight_decay=0.0, mask=None),
    "adopt": dict(b1=0.9, b2=0.9999, eps=1e-6, mu_dtype=None, nesterov=False,
                  use_clipping=True, clip_value_fn=None),
}

_MASKS = ("mask", "weight_decay_mask", "trust_ratio_mask")

# The names whose state under pipeline parallelism is kept per stacked leaf
# (sm3's layer-axis and shared axis accumulators, novograd's moment of the
# stacked leaf): it does not carry over to a run without, or vice versa
STACKED_STATE = ("sm3", "novograd")
_DTYPES = {"float32": torch.float32, "f32": torch.float32,
           "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "f16": torch.float16}


def _dtype(value) -> torch.dtype:
    """A buffer dtype option (None keeps f32)."""
    if value is None:
        return torch.float32
    if isinstance(value, torch.dtype):
        return value
    name = getattr(value, "__name__", value)
    if str(name) not in _DTYPES:
        raise ValueError(f"dtype {value!r}: one of {sorted(_DTYPES)}")
    return _DTYPES[str(name)]


def _bc(decay: float, k: int) -> float:
    """optax's bias correction ``1 − decay**k``, in f32."""
    return float(f32(1) - f32(decay) ** f32(k))


def _moment_(ts: List[torch.Tensor], xs: List[torch.Tensor],
             decay: float) -> None:
    """optax's ``update_moment``: t ← (1 − decay)·x + decay·t, in place."""
    torch._foreach_mul_(ts, decay)
    torch._foreach_add_(ts, xs, alpha=1.0 - decay)


class _Buffers:
    """A state buffer in its own dtype (``mu_dtype`` and its kin may narrow
    it). optax multiplies the stored buffer by a weakly typed scalar, which
    takes the buffer's dtype (0.9 becomes bf16's 0.8984375), and adds the
    f32 rest: :meth:`scaled` and :meth:`moment` round as optax does and
    return f32 values, which :meth:`store` casts back."""

    def __init__(self, sts, key: str):
        self.kept = [st[key] for st in sts]
        self.narrow = self.kept[0].dtype != torch.float32

    def f32(self) -> List[torch.Tensor]:
        return [t.float() for t in self.kept] if self.narrow else self.kept

    def scaled(self, decay: float) -> List[torch.Tensor]:
        """decay·t, decay and product rounded to the buffer's dtype, as
        f32."""
        if not self.narrow:
            return torch._foreach_mul(self.kept, decay)
        decay = float(torch.tensor(decay, dtype=self.kept[0].dtype))
        return [t.float() for t in torch._foreach_mul(self.kept, decay)]

    def moment(self, xs, decay: float) -> List[torch.Tensor]:
        """optax's ``update_moment``, (1 − decay)·x + decay·t: in place for
        an f32 buffer, else as new f32 values for :meth:`store`."""
        if not self.narrow:
            _moment_(self.kept, xs, decay)
            return self.kept
        out = self.scaled(decay)
        torch._foreach_add_(out, xs, alpha=1.0 - decay)
        return out

    def store(self, values: List[torch.Tensor]) -> None:
        if values is not self.kept:
            torch._foreach_copy_(self.kept, values)


class OptaxOptimizer(torch.optim.Optimizer):
    """The common frame: the kwargs of ``OPTAX_KWARGS[optax_name]``, the
    gradients (zeros for a parameter without one), the count, the f32 ``lr``,
    and ``p ← p + u`` with the update ``u`` of :meth:`_updates`.
    Hyperparameters are read per group at every step."""

    optax_name = ""

    def __init__(self, params: Iterable, lr: float = 1e-3,
                 leaf_blocks: Optional[Dict] = None, stacked=None,
                 **kwargs):
        table = OPTAX_KWARGS[self.optax_name]
        unknown = sorted(set(kwargs) - set(table))
        if unknown:
            raise TypeError(f"{type(self).__name__}: unexpected {unknown}; "
                            f"optax.{self.optax_name} takes {list(table)}")
        for key in _MASKS:
            if key in kwargs and not isinstance(kwargs[key],
                                                (bool, type(None))):
                raise ValueError(
                    f"{key}={kwargs[key]!r}: the port applies a mask to "
                    f"every parameter (true, or none) or to none (false)")
        defaults = dict(table, **kwargs, lr=lr)
        super().__init__(params, defaults)
        for group in self.param_groups:
            group.setdefault("initial_lr", group["lr"])
        self.leaf_blocks = dict(leaf_blocks or {})
        self.stacked = stacked

    # -- leaves ------------------------------------------------------------

    def _blocks(self, p) -> List[Tuple[int, int]]:
        return self.leaf_blocks.get(p) or [(0, p.shape[0] if p.dim() else 1)]

    def _leaves(self, p, t: torch.Tensor) -> List[torch.Tensor]:
        """``t`` (shaped as ``p``) cut into the views of p's JAX leaves."""
        blocks = self.leaf_blocks.get(p)
        return [t[a:b] for a, b in blocks] if blocks else [t]

    def _leaf_shapes(self, p) -> List[torch.Size]:
        return [v.shape for v in self._leaves(p, p)]

    def _per_leaf_scale_(self, ps, us, scales) -> None:
        """u ← u · scale, one scale (a 0-dim tensor) per leaf, in leaf
        order over ``ps``."""
        it = iter(scales)
        for p, u in zip(ps, us):
            for view in self._leaves(p, u):
                view.mul_(next(it))

    def _leaf_views(self, ps, ts) -> List[torch.Tensor]:
        return [v for p, t in zip(ps, ts) for v in self._leaves(p, t)]

    def _is_stacked(self, p) -> bool:
        """``p`` is a layer's slice of a stacked leaf (pipeline parallelism)."""
        return self.stacked is not None and p in self.stacked

    def _owners(self, ps) -> List[torch.Tensor]:
        """The parameter of each leaf view of ``ps``, in view order."""
        return [p for p in ps for _ in self._blocks(p)]

    def _combined(self, ps, values: torch.Tensor) -> torch.Tensor:
        """Per-view sums (one per leaf view of ``ps``) as sums over each
        view's whole JAX leaf: a stacked leaf's over its layers on every
        stage."""
        if self.stacked is None:
            return values
        return self.stacked.combine(self._owners(ps), values)

    def _leaf_norms(self, ps, ts) -> torch.Tensor:
        """The L2 norm of each leaf view of ``ts`` (shaped as ``ps``), taken
        over its JAX leaf."""
        norms = leaf_norms(self._leaf_views(ps, ts))
        if self.stacked is None:
            return norms
        return self._combined(ps, norms * norms).sqrt()

    # -- the step ----------------------------------------------------------

    def _init(self, group: dict, p: torch.Tensor, st: dict) -> None:
        pass

    def _updates(self, group: dict, ps: List[torch.Tensor],
                 gs: List[torch.Tensor], sts: List[dict], count: int,
                 lr: float) -> List[torch.Tensor]:
        raise NotImplementedError

    @staticmethod
    def _grads(ps) -> List[torch.Tensor]:
        return [p.grad.float() if p.grad is not None
                else torch.zeros_like(p, dtype=torch.float32) for p in ps]

    def _prepare(self, group):
        ps = [p.detach() for p in group["params"]]
        sts = [self.state[p] for p in group["params"]]
        if "step" not in sts[0]:
            for p, st in zip(group["params"], sts):
                st["step"] = torch.zeros((), dtype=torch.int64)
                self._init(group, p, st)
        return ps, sts, int(sts[0]["step"])

    @staticmethod
    def _count_up(sts) -> None:
        for st in sts:
            st["step"] += 1

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            if not group["params"]:
                continue
            ps, sts, count = self._prepare(group)
            gs = self._grads(group["params"])
            us = self._updates(group, list(group["params"]), gs, sts, count,
                               float(f32(group["lr"])))
            torch._foreach_add_(ps, us)
            self._count_up(sts)
        return loss


def _zeros(p, dtype=torch.float32):
    return torch.zeros_like(p, dtype=dtype,
                            memory_format=torch.preserve_format)


def _decay_(us, ps, group, key: str = "mask", wd_key: str = "weight_decay"):
    """optax's ``add_decayed_weights``: u ← u + wd·p (under a bool mask)."""
    wd = group.get(wd_key) or 0.0
    if wd and group.get(key) in (None, True):
        torch._foreach_add_(us, [p.detach() for p in ps], alpha=wd)


def _trace_(us, sts, decay: float, nesterov: bool, key: str = "trace"):
    """optax's ``trace``: t ← u + decay·t; u ← t (or u + decay·t with
    Nesterov). Returns the new update list."""
    buf = _Buffers(sts, key)
    if buf.narrow:
        trace = torch._foreach_add(us, buf.scaled(decay))
    else:
        trace = buf.kept
        torch._foreach_mul_(trace, decay)
        torch._foreach_add_(trace, us)
    out = torch._foreach_add(us, trace, alpha=decay) if nesterov else trace
    buf.store(trace)
    return out


# ---------------------------------------------------------------------------
# The Adam family
# ---------------------------------------------------------------------------

class Adam(OptaxOptimizer):
    """optax ``scale_by_adam`` (+ ``add_decayed_weights`` for the ``w``
    names) and ``scale_by_learning_rate``."""

    optax_name = "adam"

    def _init(self, group, p, st):
        st["mu"] = _zeros(p, _dtype(group.get("mu_dtype")))
        st["nu"] = _zeros(p)

    def _direction(self, group, gs, sts, count):
        """The scaled update m̂ / (√(v̂ + eps_root) + eps)."""
        b1, b2, k = group["b1"], group["b2"], count + 1
        buf = _Buffers(sts, "mu")
        mu = buf.moment(gs, b1)
        nu = [st["nu"] for st in sts]
        _moment_(nu, torch._foreach_mul(gs, gs), b2)
        if group.get("nesterov"):
            mu_hat = torch._foreach_div(mu, _bc(b1, k + 1))
            torch._foreach_mul_(mu_hat, b1)
            torch._foreach_add_(mu_hat, torch._foreach_div(gs, _bc(b1, k)),
                                alpha=1.0 - b1)
        else:
            mu_hat = torch._foreach_div(mu, _bc(b1, k))
        buf.store(mu)
        den = torch._foreach_div(nu, _bc(b2, k))
        torch._foreach_add_(den, group["eps_root"])
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        torch._foreach_div_(mu_hat, den)
        return mu_hat

    def _updates(self, group, ps, gs, sts, count, lr):
        us = self._direction(group, gs, sts, count)
        _decay_(us, ps, group)
        torch._foreach_mul_(us, -lr)
        return us


class AdamW(Adam):
    optax_name = "adamw"


class NAdam(Adam):
    optax_name = "nadam"


class NAdamW(Adam):
    optax_name = "nadamw"


class Lamb(Adam):
    """``scale_by_adam`` (no Nesterov), ``add_decayed_weights``,
    ``scale_by_trust_ratio`` per leaf, ``scale_by_learning_rate``."""

    optax_name = "lamb"

    def _updates(self, group, ps, gs, sts, count, lr):
        us = self._direction(group, gs, sts, count)
        _decay_(us, ps, group)
        self._per_leaf_scale_(ps, us, _trust_ratios(
            self._leaf_norms(ps, ps), self._leaf_norms(ps, us)))
        torch._foreach_mul_(us, -lr)
        return us


def _safe_norms(norms: torch.Tensor, min_norm: float) -> torch.Tensor:
    """optax ``safe_norm`` of each leaf: its norm, or ``min_norm`` where the
    norm is ≤ min_norm."""
    return torch.where(norms <= min_norm, torch.full_like(norms, min_norm),
                       norms)


def _trust_ratios(p_norms, u_norms, min_norm: float = 0.0,
                  coefficient: float = 1.0, eps: float = 0.0):
    """optax ``scale_by_trust_ratio``'s factor for each leaf, from the
    leaves' norms: coefficient·‖p‖/(‖u‖ + eps), 1 where either norm is
    0."""
    pn = _safe_norms(p_norms, min_norm)
    un = _safe_norms(u_norms, min_norm)
    ratio = coefficient * pn / (un + eps)
    ratio = torch.where((pn == 0.0) | (un == 0.0), torch.ones_like(ratio),
                        ratio)
    return ratio.unbind()


class AMSGrad(OptaxOptimizer):
    """optax ``scale_by_amsgrad``: Adam with the running maximum of v̂."""

    optax_name = "amsgrad"

    def _init(self, group, p, st):
        st["mu"] = _zeros(p, _dtype(group.get("mu_dtype")))
        st["nu"] = _zeros(p)
        st["nu_max"] = _zeros(p)

    def _updates(self, group, ps, gs, sts, count, lr):
        b1, b2, k = group["b1"], group["b2"], count + 1
        buf = _Buffers(sts, "mu")
        mu = buf.moment(gs, b1)
        nu = [st["nu"] for st in sts]
        _moment_(nu, torch._foreach_mul(gs, gs), b2)
        us = torch._foreach_div(mu, _bc(b1, k))
        buf.store(mu)
        nu_max = [st["nu_max"] for st in sts]
        torch._foreach_maximum_(nu_max, torch._foreach_div(nu, _bc(b2, k)))
        den = torch._foreach_add(nu_max, group["eps_root"])
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        torch._foreach_div_(us, den)
        torch._foreach_mul_(us, -lr)
        return us


class RAdam(OptaxOptimizer):
    """optax ``scale_by_radam``: the rectified Adam step once the SMA length
    ρ reaches ``threshold``, else the bias-corrected momentum."""

    optax_name = "radam"

    def _init(self, group, p, st):
        st["mu"] = _zeros(p)
        st["nu"] = _zeros(p)

    def _updates(self, group, ps, gs, sts, count, lr):
        b1, b2, k = group["b1"], group["b2"], count + 1
        mu = [st["mu"] for st in sts]
        nu = [st["nu"] for st in sts]
        _moment_(mu, gs, b1)
        _moment_(nu, torch._foreach_mul(gs, gs), b2)
        ro_inf = f32(2.0 / (1.0 - b2) - 1.0)
        b2t = f32(b2) ** f32(k)
        ro = ro_inf - f32(2 * k) * b2t / (f32(1) - b2t)
        if group.get("nesterov"):
            us = torch._foreach_div(mu, _bc(b1, k + 1))
            torch._foreach_mul_(us, b1)
            torch._foreach_add_(us, torch._foreach_div(gs, _bc(b1, k)),
                                alpha=1.0 - b1)
        else:
            us = torch._foreach_div(mu, _bc(b1, k))
        if ro >= group["threshold"]:
            r = np.sqrt((ro - f32(4)) * (ro - f32(2)) * ro_inf
                        / ((ro_inf - f32(4)) * (ro_inf - f32(2)) * ro))
            torch._foreach_mul_(us, float(f32(r)))
            den = torch._foreach_div(nu, _bc(b2, k))
            torch._foreach_add_(den, group["eps_root"])
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            torch._foreach_div_(us, den)
        torch._foreach_mul_(us, -lr)
        return us


class AdaBelief(OptaxOptimizer):
    """optax ``scale_by_belief``: v tracks (g − m)² (+ eps_root each step)."""

    optax_name = "adabelief"

    def _init(self, group, p, st):
        st["mu"] = _zeros(p)
        st["nu"] = _zeros(p)

    def _updates(self, group, ps, gs, sts, count, lr):
        b1, b2, k = group["b1"], group["b2"], count + 1
        mu = [st["mu"] for st in sts]
        nu = [st["nu"] for st in sts]
        _moment_(mu, gs, b1)
        err = torch._foreach_sub(gs, mu)
        _moment_(nu, torch._foreach_mul(err, err), b2)
        torch._foreach_add_(nu, group["eps_root"])
        if group.get("nesterov"):
            us = torch._foreach_div(mu, _bc(b1, k + 1))
            torch._foreach_mul_(us, b1)
            torch._foreach_add_(us, torch._foreach_div(gs, _bc(b1, k)),
                                alpha=1.0 - b1)
        else:
            us = torch._foreach_div(mu, _bc(b1, k))
        den = torch._foreach_div(nu, _bc(b2, k))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        torch._foreach_div_(us, den)
        torch._foreach_mul_(us, -lr)
        return us


class Yogi(OptaxOptimizer):
    """optax ``scale_by_yogi`` (moments start at 1e-6):
    v ← v − (1 − b2)·sign(v − g²)·g²."""

    optax_name = "yogi"

    def _init(self, group, p, st):
        st["mu"] = torch.full_like(p, 1e-6, dtype=torch.float32)
        st["nu"] = torch.full_like(p, 1e-6, dtype=torch.float32)

    def _updates(self, group, ps, gs, sts, count, lr):
        b1, b2, k = group["b1"], group["b2"], count + 1
        mu = [st["mu"] for st in sts]
        nu = [st["nu"] for st in sts]
        _moment_(mu, gs, b1)
        g2 = torch._foreach_mul(gs, gs)
        step = torch._foreach_sign(torch._foreach_sub(nu, g2))
        torch._foreach_mul_(step, 1.0 - b2)
        torch._foreach_mul_(step, g2)
        torch._foreach_sub_(nu, step)
        us = torch._foreach_div(mu, _bc(b1, k))
        den = torch._foreach_div(nu, _bc(b2, k))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        torch._foreach_div_(us, den)
        torch._foreach_mul_(us, -lr)
        return us


class Adamax(OptaxOptimizer):
    """optax ``scale_by_adamax``: v ← max(|g| + eps, b2·v), u = m̂ / v."""

    optax_name = "adamax"

    def _init(self, group, p, st):
        st["mu"] = _zeros(p)
        st["nu"] = _zeros(p)

    def _updates(self, group, ps, gs, sts, count, lr):
        b1, k = group["b1"], count + 1
        mu = [st["mu"] for st in sts]
        nu = [st["nu"] for st in sts]
        _moment_(mu, gs, b1)
        torch._foreach_mul_(nu, group["b2"])
        torch._foreach_maximum_(nu, torch._foreach_add(
            torch._foreach_abs(gs), group["eps"]))
        us = torch._foreach_div(mu, _bc(b1, k))
        torch._foreach_div_(us, nu)
        _decay_(us, ps, group)
        torch._foreach_mul_(us, -lr)
        return us


class AdamaxW(Adamax):
    optax_name = "adamaxw"


class Lion(OptaxOptimizer):
    """optax ``scale_by_lion``: u = sign((1 − b1)·g + b1·m); m tracks g at
    b2."""

    optax_name = "lion"

    def _init(self, group, p, st):
        st["mu"] = _zeros(p, _dtype(group.get("mu_dtype")))

    def _updates(self, group, ps, gs, sts, count, lr):
        b1 = group["b1"]
        buf = _Buffers(sts, "mu")
        us = torch._foreach_mul(gs, 1.0 - b1)
        torch._foreach_add_(us, buf.scaled(b1))
        us = torch._foreach_sign(us)
        buf.store(buf.moment(gs, group["b2"]))
        _decay_(us, ps, group)
        torch._foreach_mul_(us, -lr)
        return us


class AdEMAMix(OptaxOptimizer):
    """optax.contrib ``scale_by_ademamix``: (m̂1 + alpha·m2)/(√(v̂ + eps_root)
    + eps), m2 a slow EMA at b3 without bias correction."""

    optax_name = "ademamix"

    def _init(self, group, p, st):
        # optax makes these in mu_dtype but never casts them back, so they
        # are f32 from the first update on (and zeros of either dtype give
        # the same first update)
        _dtype(group.get("mu_dtype"))
        st["m1"], st["m2"], st["nu"] = _zeros(p), _zeros(p), _zeros(p)

    def _updates(self, group, ps, gs, sts, count, lr):
        b1, b2, k = group["b1"], group["b2"], count + 1
        b3, alpha = group["b3"], group["alpha"]
        b3 = b3(count) if callable(b3) else b3
        alpha = alpha(count) if callable(alpha) else alpha
        m1, m2, nu = ([st[key] for st in sts] for key in ("m1", "m2", "nu"))
        _moment_(m1, gs, b1)
        _moment_(m2, gs, b3)
        _moment_(nu, torch._foreach_mul(gs, gs), b2)
        us = torch._foreach_div(m1, _bc(b1, k))
        torch._foreach_add_(us, m2, alpha=alpha)
        den = torch._foreach_div(nu, _bc(b2, k))
        torch._foreach_add_(den, group["eps_root"])
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        torch._foreach_div_(us, den)
        _decay_(us, ps, group)
        torch._foreach_mul_(us, -lr)
        return us


class ADOPT(OptaxOptimizer):
    """optax.contrib ``scale_by_adopt``: g is normalised by the *previous*
    √v (clipped to ±clip_value_fn(count) with ``use_clipping``); the first
    step only sets v = g² (b2 = 0 and b1 = 1 there)."""

    optax_name = "adopt"

    def _init(self, group, p, st):
        st["mu"] = _zeros(p, _dtype(group.get("mu_dtype")))
        st["nu"] = _zeros(p)

    def _updates(self, group, ps, gs, sts, count, lr):
        b1 = f32(group["b1"]) if count > 0 else f32(1)
        b2 = f32(group["b2"]) if count > 0 else f32(0)
        nu = [st["nu"] for st in sts]
        den = torch._foreach_sqrt(nu)
        torch._foreach_maximum_(den, group["eps"])
        upd = torch._foreach_div(gs, den)
        if group["use_clipping"]:
            fn = group["clip_value_fn"] or _fourth_root
            clip = float(fn(count))
            torch._foreach_clamp_min_(upd, -clip)
            torch._foreach_clamp_max_(upd, clip)
        torch._foreach_mul_(nu, float(b2))
        torch._foreach_add_(nu, torch._foreach_mul(gs, gs),
                            alpha=float(f32(1) - b2))
        # b1 here is an f32 array in optax, not a weak scalar: the product
        # with a narrow mu is taken in f32
        buf = _Buffers(sts, "mu")
        mu = buf.f32()
        torch._foreach_mul_(mu, float(b1))
        torch._foreach_add_(mu, upd, alpha=float(f32(1) - b1))
        if group["nesterov"]:
            us = torch._foreach_mul(mu, float(b1))
            torch._foreach_add_(us, upd, alpha=float(f32(1) - b1))
            torch._foreach_mul_(us, -lr)
        else:
            us = torch._foreach_mul(mu, -lr)
        buf.store(mu)
        return us


# ---------------------------------------------------------------------------
# SGD and the adaptive-rate family
# ---------------------------------------------------------------------------

class SGD(OptaxOptimizer):
    """optax ``sgd``: ``trace`` (when ``momentum`` is set), then
    ``scale_by_learning_rate``."""

    optax_name = "sgd"

    def _init(self, group, p, st):
        if group["momentum"] is not None:
            st["trace"] = _zeros(p, _dtype(group["accumulator_dtype"]))

    def _updates(self, group, ps, gs, sts, count, lr):
        us = gs if group["momentum"] is None else _trace_(
            gs, sts, group["momentum"], group["nesterov"])
        return torch._foreach_mul(us, -lr)


class Adagrad(OptaxOptimizer):
    """optax ``scale_by_rss``: g / √(Σg² + eps), the sum starting at
    ``initial_accumulator_value`` (0 where the sum is 0)."""

    optax_name = "adagrad"

    def _init(self, group, p, st):
        st["sum_of_squares"] = torch.full_like(
            p, group["initial_accumulator_value"], dtype=torch.float32)

    def _updates(self, group, ps, gs, sts, count, lr):
        sos = [st["sum_of_squares"] for st in sts]
        torch._foreach_add_(sos, torch._foreach_mul(gs, gs))
        inv = torch._foreach_rsqrt(torch._foreach_add(sos, group["eps"]))
        us = [torch.where(s > 0, i, torch.zeros_like(i)) * g
              for s, i, g in zip(sos, inv, gs)]
        torch._foreach_mul_(us, -lr)
        return us


class Adadelta(OptaxOptimizer):
    """optax ``adadelta``: ``add_decayed_weights`` first, then
    √(E[Δx²] + eps)/√(E[g²] + eps)·g."""

    optax_name = "adadelta"

    def _init(self, group, p, st):
        st["e_g"] = _zeros(p)
        st["e_x"] = _zeros(p)

    def _updates(self, group, ps, gs, sts, count, lr):
        rho, eps = group["rho"], group["eps"]
        us = [g.clone() for g in gs]
        _decay_(us, ps, group, key="weight_decay_mask")
        e_g = [st["e_g"] for st in sts]
        e_x = [st["e_x"] for st in sts]
        _moment_(e_g, torch._foreach_mul(us, us), rho)
        ratio = torch._foreach_sqrt(torch._foreach_add(e_x, eps))
        torch._foreach_div_(ratio, torch._foreach_sqrt(
            torch._foreach_add(e_g, eps)))
        us = torch._foreach_mul(ratio, us)
        _moment_(e_x, torch._foreach_mul(us, us), rho)
        torch._foreach_mul_(us, -lr)
        return us


class RMSprop(OptaxOptimizer):
    """optax ``rmsprop``: ``scale_by_rms`` (or ``scale_by_stddev`` when
    centered) — eps inside the square root by default, v starting at
    ``initial_scale``, no bias correction by default — then
    ``scale_by_learning_rate`` and an optional ``trace``."""

    optax_name = "rmsprop"

    def _init(self, group, p, st):
        st["nu"] = torch.full_like(p, group["initial_scale"],
                                   dtype=torch.float32)
        if group["centered"]:
            st["mu"] = _zeros(p)
        if group["momentum"] is not None:
            st["trace"] = _zeros(p)

    def _updates(self, group, ps, gs, sts, count, lr):
        decay, eps, k = group["decay"], group["eps"], count + 1
        nu = [st["nu"] for st in sts]
        _moment_(nu, torch._foreach_mul(gs, gs), decay)
        nu_hat = (torch._foreach_div(nu, _bc(decay, k))
                  if group["bias_correction"] else nu)
        if group["centered"]:
            mu = [st["mu"] for st in sts]
            _moment_(mu, gs, decay)
            mu_hat = (torch._foreach_div(mu, _bc(decay, k))
                      if group["bias_correction"] else mu)
            var = torch._foreach_sub(nu_hat, torch._foreach_mul(mu_hat,
                                                                mu_hat))
        else:
            var = nu_hat
        if group["eps_in_sqrt"]:
            scale = torch._foreach_rsqrt(torch._foreach_add(var, eps))
        else:
            scale = torch._foreach_sqrt(var)
            torch._foreach_add_(scale, eps)
            torch._foreach_reciprocal_(scale)
        us = torch._foreach_mul(scale, gs)
        torch._foreach_mul_(us, -lr)
        if group["momentum"] is not None:
            us = _trace_(us, sts, group["momentum"], group["nesterov"])
        return us


class Rprop(OptaxOptimizer):
    """optax ``scale_by_rprop`` then ``scale(-1)``: per-element step sizes
    (starting at the ``lr`` the optimizer was built with) grow by
    ``eta_plus`` while the gradient keeps its sign and shrink by
    ``eta_minus`` when it flips; the applied update is the previous step's
    signed step (0 after a flip), as optax 0.2.6 computes it."""

    optax_name = "rprop"

    def _init(self, group, p, st):
        st["step_sizes"] = torch.full_like(
            p, float(f32(group["initial_lr"])), dtype=torch.float32)
        st["prev_updates"] = _zeros(p)

    def _updates(self, group, ps, gs, sts, count, lr):
        us = []
        for g, st in zip(gs, sts):
            prev = st["prev_updates"]
            sign = g * prev
            grown = st["step_sizes"] * torch.where(
                sign > 0, torch.full_like(sign, group["eta_plus"]),
                torch.full_like(sign, group["eta_minus"]))
            steps = torch.where(sign == 0, st["step_sizes"], grown.clamp(
                min=group["min_step_size"], max=group["max_step_size"]))
            flipped = sign < 0
            new_prev = torch.where(flipped, torch.zeros_like(g),
                                   steps * torch.sign(g))
            us.append(-torch.where(flipped, torch.zeros_like(prev), prev))
            st["step_sizes"], st["prev_updates"] = steps, new_prev
        return us


# ---------------------------------------------------------------------------
# Per-leaf statistics
# ---------------------------------------------------------------------------

class Lars(OptaxOptimizer):
    """optax ``lars``: ``add_decayed_weights``, the trust ratio
    coefficient·‖p‖/(‖u‖ + eps) per leaf, ``scale_by_learning_rate``, then
    ``trace`` (momentum)."""

    optax_name = "lars"

    def _init(self, group, p, st):
        st["trace"] = _zeros(p)

    def _updates(self, group, ps, gs, sts, count, lr):
        us = [g.clone() for g in gs]
        _decay_(us, ps, group, key="weight_decay_mask")
        if group["trust_ratio_mask"] in (None, True):
            self._per_leaf_scale_(ps, us, _trust_ratios(
                self._leaf_norms(ps, ps), self._leaf_norms(ps, us),
                coefficient=group["trust_coefficient"], eps=group["eps"]))
        torch._foreach_mul_(us, -lr)
        return _trace_(us, sts, group["momentum"], group["nesterov"])


class Fromage(OptaxOptimizer):
    """optax ``fromage``: m = 1/√(1 + lr²); u = −lr·m·(‖p‖/‖g‖)·g per leaf
    (norms floored at ``min_norm``), plus (m − 1)·p."""

    optax_name = "fromage"

    def _updates(self, group, ps, gs, sts, count, lr):
        lr32 = f32(lr)
        mult = f32(1) / np.sqrt(f32(1) + lr32 * lr32)
        us = [g.clone() for g in gs]
        self._per_leaf_scale_(ps, us, _trust_ratios(
            self._leaf_norms(ps, ps), self._leaf_norms(ps, us),
            min_norm=group["min_norm"]))
        torch._foreach_mul_(us, float(f32(-1) * (lr32 * mult)))
        torch._foreach_add_(us, [p.detach() for p in ps],
                            alpha=float(mult - f32(1)))
        return us


class NovoGrad(OptaxOptimizer):
    """optax ``scale_by_novograd``: v is a scalar per leaf, ‖g‖² (its EMA at
    b2 after the first step); m ← b1·m + g/(√(v + eps_root) + eps) + wd·p."""

    optax_name = "novograd"

    def _init(self, group, p, st):
        st["mu"] = _zeros(p)
        st["nu"] = torch.zeros(len(self._blocks(p)), dtype=torch.float32,
                               device=p.device)

    def _updates(self, group, ps, gs, sts, count, lr):
        b1, b2 = group["b1"], group["b2"]
        norms = self._leaf_norms(ps, gs)
        sq = norms * norms
        nus = torch.cat([st["nu"] for st in sts])
        nus = sq if count == 0 else (1.0 - b2) * sq + b2 * nus
        dens = torch.sqrt(nus + group["eps_root"]) + group["eps"]
        us, at = [], 0
        for p, g, st in zip(ps, gs, sts):
            n = len(self._blocks(p))
            st["nu"] = nus[at:at + n].clone()
            add = g.clone()
            for view, den in zip(self._leaves(p, add), dens[at:at + n]):
                view.div_(den)
            at += n
            us.append(add)
        wd = group["weight_decay"]
        if wd:
            torch._foreach_add_(us, [p.detach() for p in ps], alpha=wd)
        mu = [st["mu"] for st in sts]
        if count > 0:
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, us)
        else:
            torch._foreach_copy_(mu, us)
        return torch._foreach_mul(mu, -lr)


def _factored_dims(shape, factored: bool, min_dim: int):
    """optax's ``_factored_dims``: the two largest axes (second largest,
    largest), when the second largest is at least ``min_dim``."""
    if not factored or len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(OptaxOptimizer):
    """optax ``adafactor``: ``scale_by_factored_rms`` (row and column second
    moments over the two largest axes of a leaf whose second largest axis is
    ≥ ``min_dim_size_to_factor``, else a full one; decay 1 − (t+1)^−0.8),
    ``clip_by_block_rms``, ``scale_by_learning_rate`` (unflipped),
    ``scale_by_param_block_rms`` (RMS of the leaf, floored at 1e-3), an
    optional EMA momentum, ``add_decayed_weights(weight_decay_rate)``, and
    ``scale(-1)``; each per leaf."""

    optax_name = "adafactor"

    def _dims(self, group, p, shape):
        """The factored axes of a leaf view of ``p``; a stacked parameter's
        are the stacked ``[L, ...]`` leaf's, which must not factor the layer
        axis (a per-layer moment then spans layers, not ported)."""
        if not self._is_stacked(p):
            return _factored_dims(shape, group["factored"],
                                  group["min_dim_size_to_factor"])
        dims = _factored_dims((self.stacked.num_layers,) + tuple(shape),
                              group["factored"],
                              group["min_dim_size_to_factor"])
        if dims is None:
            return None
        if 0 in dims:
            raise ValueError(
                f"adafactor under pipeline parallelism: the stacked leaf "
                f"[{self.stacked.num_layers}, {list(shape)}] factors its "
                f"layer axis, which is not ported")
        return dims[0] - 1, dims[1] - 1

    def _init(self, group, p, st):
        def z(shape):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)
        rows, cols, full = [], [], []
        for shape in self._leaf_shapes(p):
            dims = self._dims(group, p, shape)
            if dims is not None:
                d1, d0 = dims
                rows.append(z([s for i, s in enumerate(shape) if i != d0]))
                cols.append(z([s for i, s in enumerate(shape) if i != d1]))
                full.append(z((1,)))
            else:
                rows.append(z((1,)))
                cols.append(z((1,)))
                full.append(z(shape))
        st["v_row"], st["v_col"], st["v"] = rows, cols, full
        if group["momentum"] is not None:
            st["ema"] = _zeros(p, _dtype(group["dtype_momentum"]))

    def _leaf_update(self, group, g, v_row, v_col, v, decay, dims):
        """The factored-RMS update of one leaf (factored over ``dims``);
        updates its moments."""
        one_minus = float(f32(1) - decay)
        decay = float(decay)
        eps = group["eps"]
        gsq = g * g + eps
        if dims is None:
            v.mul_(decay).add_(gsq, alpha=one_minus)
            return g * v.pow(-0.5)
        d1, d0 = dims
        v_row.mul_(decay).add_(gsq.mean(dim=d0), alpha=one_minus)
        v_col.mul_(decay).add_(gsq.mean(dim=d1), alpha=one_minus)
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = v_row.mean(dim=reduced_d1, keepdim=True)
        row_factor = (v_row / row_col_mean).pow(-0.5)
        col_factor = v_col.pow(-0.5)
        return g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)

    def _rms(self, ps, views) -> List[torch.Tensor]:
        """The RMS of each leaf view, over its JAX leaf (a stacked leaf's
        over its layers on every stage)."""
        if self.stacked is None:
            return [torch.sqrt(torch.mean(v * v)) for v in views]
        sums = torch.stack([(v * v).sum() for v in views])
        sizes = torch.tensor([float(v.numel()) for v in views],
                             device=sums.device)
        return list(torch.sqrt(self._combined(ps, sums)
                               / self._combined(ps, sizes)).unbind())

    def _updates(self, group, ps, gs, sts, count, lr):
        t = f32(count - group["decay_offset"] + 1)
        decay = f32(1) - t ** f32(-group["decay_rate"])
        clip = group["clipping_threshold"]
        raw = []
        for p, g, st in zip(ps, gs, sts):
            for j, gl in enumerate(self._leaves(p, g)):
                raw.append(self._leaf_update(
                    group, gl, st["v_row"][j], st["v_col"][j], st["v"][j],
                    decay, self._dims(group, p, gl.shape)))
        if clip is not None:
            raw = [u / torch.clamp(rms / clip, min=1.0)
                   for u, rms in zip(raw, self._rms(ps, raw))]
        raw = [u * lr for u in raw]
        if group["multiply_by_parameter_scale"]:
            scales = self._rms(ps, self._leaf_views(ps, ps))
            raw = [u * torch.where(r <= 1e-3, torch.full_like(r, 1e-3), r)
                   for u, r in zip(raw, scales)]
        us, at = [], 0
        for p in ps:
            n = len(self._blocks(p))
            us.append(raw[at] if n == 1 else torch.cat(raw[at:at + n]))
            at += n
        if group["momentum"] is not None:
            us = _ema(us, sts, group["momentum"])
        _decay_(us, ps, group, key="weight_decay_mask",
                wd_key="weight_decay_rate")
        return torch._foreach_neg(us)


def _ema(us, sts, decay: float):
    """optax ``ema(debias=False)``: e ← (1 − decay)·u + decay·e; u ← e."""
    buf = _Buffers(sts, "ema")
    ema = buf.moment(us, decay)
    out = [e.clone() for e in ema]
    buf.store(ema)
    return out


class SM3(OptaxOptimizer):
    """optax ``sm3`` (``scale_by_sm3(b1=momentum, b2=1)``, ``scale(−lr)``):
    per leaf, one accumulator vector per axis; a = g² + min over the axes'
    accumulators (broadcast), each axis keeps the max of a over the other
    axes; u is the EMA at ``momentum`` of g/√(a + 1e-8)."""

    optax_name = "sm3"

    def _init(self, group, p, st):
        def z(s):
            return torch.zeros(s, dtype=torch.float32, device=p.device)
        if self._is_stacked(p):
            # one [L]-axis accumulator (this layer's entry), then one per
            # axis of the layer's tensor
            st["accumulators"] = [[z(1)] + [z(s) for s in p.shape]]
        else:
            st["accumulators"] = [
                [z(s) for s in shape] if len(shape) >= 2 else [z(shape)]
                for shape in self._leaf_shapes(p)]
        st["nu"] = _zeros(p)

    @staticmethod
    def _accumulate(g, acc):
        """a = g² + the minimum of the axes' accumulators (broadcast), and
        each axis's maximum of a over the other axes."""
        nd = g.dim()
        low = acc[0].reshape([-1] + [1] * (nd - 1))
        for i in range(1, nd):
            shape = [1] * nd
            shape[i] = -1
            low = torch.minimum(low, acc[i].reshape(shape))
        a = g * g + low
        return a, [a.amax(dim=[d for d in range(nd) if d != i])
                   for i in range(nd)]

    def _updates(self, group, ps, gs, sts, count, lr):
        ups, shared = [], {}
        for p, g, st in zip(ps, gs, sts):
            pieces = []
            for j, gl in enumerate(self._leaves(p, g)):
                acc = st["accumulators"][j]
                if self._is_stacked(p):
                    # a layer of the stacked leaf: the other axes' maxima
                    # span the leaf's layers on every stage
                    a, maxima = self._accumulate(gl.unsqueeze(0), acc)
                    acc[0] = maxima[0]
                    shared.setdefault(self.stacked.key[p], []).append(
                        (acc, maxima[1:]))
                    a = a[0]
                elif gl.dim() < 2:
                    a = gl * gl + acc[0]
                    acc[0] = a
                else:
                    a, acc[:] = self._accumulate(gl, acc)
                inv = torch.where(a > 0, torch.rsqrt(a + 1e-8),
                                  torch.zeros_like(a))
                pieces.append(gl * inv)
            ups.append(pieces[0] if len(pieces) == 1 else torch.cat(pieces))
        if shared:
            # per stacked leaf, per axis: the maximum over this stage's
            # layers, then over the stages (one flat reduction)
            parts = [torch.stack([m[i] for _, m in views]).amax(0)
                     for views in shared.values()
                     for i in range(len(views[0][1]))]
            flat = self.stacked.max(torch.cat(parts))
            at = 0
            for views in shared.values():
                for i in range(len(views[0][1])):
                    n = views[0][1][i].numel()
                    for acc, _ in views:
                        acc[i + 1] = flat[at:at + n].clone()
                    at += n
        nu = [st["nu"] for st in sts]
        _moment_(nu, ups, group["momentum"])
        return torch._foreach_mul(nu, -lr)


class Adan(OptaxOptimizer):
    """optax ``scale_by_adan``: m (g, b1), v (g − g_prev, b2), n ((g + (1 −
    b2)(g − g_prev))², b3), all bias-corrected; u = (m̂ + (1 − b2)·v̂) /
    (√(n̂ + eps_root) + eps); the difference is 0 at the first step."""

    optax_name = "adan"

    def _init(self, group, p, st):
        for key in ("m", "v", "n", "g"):
            st[key] = _zeros(p)

    def _updates(self, group, ps, gs, sts, count, lr):
        b1, b2, b3, k = group["b1"], group["b2"], group["b3"], count + 1
        m, v, n, prev = ([st[key] for st in sts] for key in "mvng")
        diff = (torch._foreach_sub(gs, prev) if count > 0
                else [torch.zeros_like(g) for g in gs])
        _moment_(m, gs, b1)
        _moment_(v, diff, b2)
        sq = torch._foreach_add(gs, diff, alpha=1.0 - b2)
        _moment_(n, torch._foreach_mul(sq, sq), b3)
        torch._foreach_copy_(prev, gs)
        us = torch._foreach_div(m, _bc(b1, k))
        torch._foreach_add_(us, torch._foreach_div(v, _bc(b2, k)),
                            alpha=1.0 - b2)
        den = torch._foreach_div(n, _bc(b3, k))
        torch._foreach_add_(den, group["eps_root"])
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        torch._foreach_div_(us, den)
        _decay_(us, ps, group)
        torch._foreach_mul_(us, -lr)
        return us


class DAdaptAdamW(OptaxOptimizer):
    """optax.contrib ``dadapt_adamw``: AdamW whose step size d (``estim_lr``,
    from ``estim_lr0``) grows with the global ratio Σ⟨g, s/(√v + eps)⟩ /
    Σ|s|. The global sums run over every parameter of every group; the
    hyperparameters are the first group's; d and the weighted numerator are
    0-dim tensors on the parameters' device in the first parameter's state,
    so a step never waits on the host."""

    optax_name = "dadaptadamw"

    def _init(self, group, p, st):
        st["exp_avg"], st["exp_avg_sq"], st["grad_sum"] = (
            _zeros(p), _zeros(p), _zeros(p))

    def global_state(self) -> dict:
        """d (``estim_lr``) and the weighted numerator."""
        return self.state[self.param_groups[0]["params"][0]]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = [p for g in self.param_groups for p in g["params"]]
        if not params:
            return loss
        hp = self.param_groups[0]
        ps, sts, count = self._prepare(dict(hp, params=params))
        lead = sts[0]
        dev = dict(dtype=torch.float32, device=params[0].device)
        if "estim_lr" not in lead:
            lead["estim_lr"] = torch.tensor(hp["estim_lr0"], **dev)
            lead["numerator_weighted"] = torch.zeros((), **dev)
        b1, b2 = hp["betas"]
        sb2, eps, k = b2 ** 0.5, hp["eps"], count + 1
        bc = np.sqrt(f32(1) - f32(b2) ** f32(k)) / (f32(1) - f32(b1) ** f32(k))
        dlr = lead["estim_lr"] * float(f32(hp["lr"])) * float(f32(bc))
        gs = self._grads(params)
        ea, eas, gsum = ([st[key] for st in sts]
                         for key in ("exp_avg", "exp_avg_sq", "grad_sum"))
        den = torch._foreach_sqrt(eas)
        torch._foreach_add_(den, eps)
        weighted = torch._foreach_div(gsum, den)
        numerator = global_sum(self.stacked, params, torch.stack(
            [x.sum() for x in torch._foreach_mul(gs, weighted)]))
        torch._foreach_mul_(ea, b1)
        torch._foreach_add_(ea, torch._foreach_mul(gs, (1 - b1) * dlr))
        torch._foreach_mul_(eas, b2)
        torch._foreach_add_(eas, torch._foreach_mul(
            torch._foreach_mul(gs, 1 - b2), gs))
        torch._foreach_mul_(gsum, sb2)
        torch._foreach_add_(gsum, torch._foreach_mul(gs, (1 - sb2) * dlr))
        l1 = global_sum(self.stacked, params, leaf_norms(gsum, 1))
        nw = sb2 * lead["numerator_weighted"] + (1 - sb2) * dlr * numerator
        estim_lr = torch.maximum(lead["estim_lr"], nw / ((1 - sb2) * l1))
        den = torch._foreach_sqrt(eas)
        torch._foreach_add_(den, eps)
        us = torch._foreach_div(ea, den)
        torch._foreach_neg_(us)
        if hp["weight_decay"]:
            torch._foreach_sub_(us, torch._foreach_mul(
                ps, hp["weight_decay"] * dlr))
        torch._foreach_add_(ps, us)
        lead.update(estim_lr=estim_lr, numerator_weighted=nw)
        self._count_up(sts)
        return loss


# ---------------------------------------------------------------------------
# By name
# ---------------------------------------------------------------------------

OPTIMIZERS: Dict[str, type] = {
    cls.optax_name: cls for cls in (
        AdamW, Adam, SGD, Adagrad, Adadelta, RMSprop, Rprop, NAdam, NAdamW,
        RAdam, Adamax, AdamaxW, Lion, Adafactor, Lamb, Lars, AdaBelief, Adan,
        NovoGrad, Yogi, Fromage, AMSGrad, SM3, DAdaptAdamW, AdEMAMix, ADOPT)}


def make_optimizer(cfg, params, leaf_blocks: Optional[Dict] = None,
                   stacked=None) -> torch.optim.Optimizer:
    """The optimizer by name, kwargs filtered as the JAX package filters
    them by signature (loop.py:100-138): ``training.weight_decay`` joins the
    kwargs as ``weight_decay``; ``betas`` become ``b1``/``b2`` where the
    factory has ``b1`` and are dropped where it takes neither; anything the
    factory does not take is dropped. ``leaf_blocks`` maps a parameter that
    stacks several JAX leaves to their row blocks (for the per-leaf
    statistics); ``stacked`` (a ``parallel.pp.StackedLeaves``) the stacked
    leaves of a pipeline-parallel run."""
    name = cfg.optimizer
    kwargs = dict(cfg.optimizer_params)
    if cfg.weight_decay is not None:
        kwargs["weight_decay"] = cfg.weight_decay
    if name.lower() == "prodigy":
        cls, extra = Prodigy, dict(stacked=stacked)
        accepted = set(inspect.signature(Prodigy).parameters) - {
            "params", "lr", "stacked"}
    else:
        cls = OPTIMIZERS.get(name.lower())
        if cls is None:
            raise ValueError(f"Optimizer '{name}' not found. Available: "
                             f"Prodigy, {sorted(OPTIMIZERS)}")
        accepted, extra = set(OPTAX_KWARGS[cls.optax_name]), dict(
            leaf_blocks=leaf_blocks, stacked=stacked)
    if "betas" in kwargs and "betas" not in accepted:
        if "b1" in accepted:
            kwargs["b1"], kwargs["b2"] = kwargs.pop("betas")
        else:
            kwargs.pop("betas")
    if "betas" in kwargs:
        kwargs["betas"] = tuple(kwargs["betas"])
    filtered = {k: v for k, v in kwargs.items() if k in accepted}
    return cls(params, lr=cfg.learning_rate, **filtered, **extra)
