"""Prodigy as a ``torch.optim.Optimizer``, the port of
``wfl_asr_tpu/train/prodigy.py`` (the optax transform) with its semantics:
``use_bias_correction=False``, ``safeguard_warmup=False``, ``decouple=True``
by default.

    d_lr = d · lr · bc(k)                    (bc = 1 unless bias correction)
    numerator = β3·numerator + (d/d0)·d_lr·Σ⟨g, p0 − p⟩
    m = β1·m + (1−β1)·d·g
    v = β2·v + (1−β2)·d²·g²
    s = β3·s + (d/d0)·d_lr·g
    d̂ = d_coef · numerator / Σ|s|
    d = max(d, d̂) while d == d0;  d_max = max(d_max, d̂);
    d = min(d_max, d·growth_rate)
    p ← p − d_lr·m/(√v + d·ε) − d_lr·weight_decay·p

- The numerator's Σ⟨g, p0 − p⟩ and the denominator Σ|s| are global sums
  over every parameter of every group (under pipeline parallelism,
  ``stacked``, the stage-local parameters added over the stages, the
  replicated ones counted once); the hyperparameters that enter them (lr,
  betas, d0, ...) are the first group's.
- While Σ|s| is 0 (all-zero gradients so far) or lr ≤ 0, ``d`` does not
  change and the parameter update is skipped (the moments still update).
- ``p0`` is a real f32 copy of the parameters at the first step; all state
  is f32, and the global scalars (d, d_max, the numerator, the step) are
  0-dim tensors on the parameters' device kept in the first parameter's
  state, so a step never waits on the host and ``state_dict`` carries them.
- A parameter without a gradient counts as a zero gradient (the optax
  transform sees zeros there): its moments decay and weight decay applies.
- Parameters are f32 (the port keeps every parameter in f32), and the
  state is updated in place with multi-tensor (``torch._foreach_*``) ops,
  a few launches per step instead of a few per parameter.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from .norms import leaf_norms


def global_sum(stacked, params, values: torch.Tensor) -> torch.Tensor:
    """Σ values (one per parameter) over the whole JAX tree: under pipeline
    parallelism the stage-local leaves added over the stages, the
    replicated ones counted once."""
    if stacked is None:
        return values.sum()
    return stacked.split_sums(params, values)


class Prodigy(torch.optim.Optimizer):
    def __init__(self, params: Iterable, lr: float = 1.0,
                 betas: tuple = (0.9, 0.999), beta3: Optional[float] = None,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 decouple: bool = True, use_bias_correction: bool = False,
                 safeguard_warmup: bool = False, d0: float = 1e-6,
                 d_coef: float = 1.0, growth_rate: float = float("inf"),
                 stacked=None):
        defaults = dict(lr=lr, betas=tuple(betas), beta3=beta3, eps=eps,
                        weight_decay=weight_decay, decouple=decouple,
                        use_bias_correction=use_bias_correction,
                        safeguard_warmup=safeguard_warmup, d0=d0,
                        d_coef=d_coef, growth_rate=growth_rate)
        super().__init__(params, defaults)
        # a pipeline-parallel run's stacked leaves (parallel.pp): the global
        # sums add the stage-local parameters over the stages
        self.stacked = stacked

    def _params(self):
        return [p for g in self.param_groups for p in g["params"]]

    def global_state(self) -> dict:
        """The global scalars (d, d_max, d_numerator, k), in the first
        parameter's state."""
        return self.state[self._params()[0]]

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        params = self._params()
        if not params:
            return loss
        hp = self.param_groups[0]
        beta1, beta2 = hp["betas"]
        beta3 = hp["beta3"] if hp["beta3"] is not None else beta2 ** 0.5
        lr, d0, eps = hp["lr"], hp["d0"], hp["eps"]
        f32 = dict(dtype=torch.float32, device=params[0].device)
        lead = self.state[params[0]]
        if "d" not in lead:
            lead.update(d=torch.tensor(d0, **f32),
                        d_max=torch.tensor(d0, **f32),
                        d_numerator=torch.zeros((), **f32),
                        k=torch.zeros((), **f32))
        for p in params:
            st = self.state[p]
            if "p0" not in st:
                st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                st["s"] = torch.zeros_like(p, dtype=torch.float32)
                st["p0"] = p.detach().float().clone()

        d, k = lead["d"], lead["k"]
        if hp["use_bias_correction"]:
            bc = (torch.sqrt(1.0 - beta2 ** (k + 1))
                  / (1.0 - beta1 ** (k + 1)))
        else:
            bc = 1.0
        d_lr = d * lr * bc
        grads = [p.grad.float() if p.grad is not None
                 else torch.zeros_like(p, dtype=torch.float32)
                 for p in params]

        sts = [self.state[p] for p in params]
        ps = [p.detach() for p in params]
        m, v, s_ = ([st[k] for st in sts] for k in ("exp_avg", "exp_avg_sq",
                                                     "s"))
        # one multi-tensor op per line of the algorithm, in the optax
        # version's order of operations (scalar factors first)
        diff = torch._foreach_sub([st["p0"] for st in sts], ps)
        dot = global_sum(self.stacked, params, torch.stack(
            [x.sum() for x in torch._foreach_mul(grads, diff)]))
        d_numerator = beta3 * lead["d_numerator"] + (d / d0) * d_lr * dot
        s_alpha = (d / d0) * (d if hp["safeguard_warmup"] else d_lr)
        torch._foreach_mul_(m, beta1)
        torch._foreach_add_(m, torch._foreach_mul(grads, (1.0 - beta1) * d))
        gg = torch._foreach_mul(grads, (1.0 - beta2) * d * d)
        torch._foreach_mul_(gg, grads)
        torch._foreach_mul_(v, beta2)
        torch._foreach_add_(v, gg)
        torch._foreach_mul_(s_, beta3)
        torch._foreach_add_(s_, torch._foreach_mul(grads, s_alpha))
        d_denom = global_sum(self.stacked, params, leaf_norms(s_, 1))

        do_update = (d_denom > 0.0) & (lr > 0.0)
        d_hat = hp["d_coef"] * d_numerator / d_denom
        d1 = torch.where(d == d0, torch.maximum(d, d_hat), d)
        d_max = torch.maximum(lead["d_max"], d_hat)
        d_new = torch.where(do_update,
                            torch.minimum(d_max, d1 * hp["growth_rate"]), d)
        d_max = torch.where(do_update, d_max, lead["d_max"])
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, d_new * eps)
        delta = torch._foreach_mul(m, -d_lr)
        torch._foreach_div_(delta, denom)
        if hp["decouple"]:
            torch._foreach_sub_(delta, torch._foreach_mul(
                ps, d_lr * hp["weight_decay"]))
        torch._foreach_mul_(delta, do_update.float())
        torch._foreach_add_(ps, delta)
        lead.update(d=d_new, d_max=d_max, d_numerator=d_numerator, k=k + 1)
        return loss
