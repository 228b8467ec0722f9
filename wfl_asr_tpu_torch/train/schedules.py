"""LR schedulers with the reference's runtime semantics.

The reference drives torch ``_LRScheduler`` objects imperatively: ``step()``
after every validation by default, or after every update when
``scheduler_step_on_update`` is set, with a ``ReduceLROnPlateau`` special
case fed the best validation loss (reference train.py:258-259, 441-449;
lr_schedulers.py:5-36). We mirror that with small host-side stateful objects
producing an lr *factor* that multiplies the base learning rate injected
into the optimizer each step.

``get_scheduler`` resolves names the same way the reference does: its own
ConstantLR/WarmupLR first, then a registry standing in for the
pytorch-optimizer / torch.optim.lr_scheduler fallback lookup.
"""

from __future__ import annotations


import math
from typing import Dict, Optional, Type


class Scheduler:
    """Mirrors torch _LRScheduler's observable behavior: ``last_epoch`` is
    -1 pre-init, ``step()`` increments it and recomputes the factor, and the
    constructor performs an initial ``step()`` (so WarmupLR starts at 0)."""

    needs_metric = False

    def __init__(self):
        self.last_epoch = -1
        self.factor = 1.0
        self.step()

    def get_factor(self) -> float:
        return 1.0

    def step(self, metric_or_epoch: Optional[float] = None) -> None:
        """torch semantics: ``step()`` increments last_epoch; ``step(epoch)``
        jumps to that epoch (the reference passes the global step when the
        scheduler accepts one, train.py:445-449)."""
        if metric_or_epoch is not None:
            self.last_epoch = int(metric_or_epoch)
        else:
            self.last_epoch += 1
        self.factor = self.get_factor()

    # Persisted in the training sidecar so resume continues the LR curve
    # exactly (the reference persists nothing — quirk Q4 — but our sidecar
    # advertises exact optimizer resume, and a cosine/warmup restarting at
    # epoch 0 mid-run is a silent schedule shift).
    _STATE_KEYS = ("last_epoch", "factor")

    def state_dict(self) -> dict:
        return {k: getattr(self, k) for k in self._STATE_KEYS}

    def load_state_dict(self, state: dict) -> None:
        for k in self._STATE_KEYS:
            if k in state:
                setattr(self, k, type(getattr(self, k))(state[k]))


class ConstantLR(Scheduler):
    """reference lr_schedulers.py:5-10."""

    def get_factor(self) -> float:
        return 1.0


class WarmupLR(Scheduler):
    """Linear warmup over ``warmup_steps`` (reference lr_schedulers.py:12-20)."""

    def __init__(self, warmup_steps: int):
        self.warmup_steps = warmup_steps
        super().__init__()

    def get_factor(self) -> float:
        if self.last_epoch < self.warmup_steps:
            return self.last_epoch / self.warmup_steps
        return 1.0


class StepLR(Scheduler):
    def __init__(self, step_size: int, gamma: float = 0.1):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__()

    def get_factor(self) -> float:
        return self.gamma ** (self.last_epoch // self.step_size)


class ExponentialLR(Scheduler):
    def __init__(self, gamma: float):
        self.gamma = gamma
        super().__init__()

    def get_factor(self) -> float:
        return self.gamma ** self.last_epoch


class CosineAnnealingLR(Scheduler):
    def __init__(self, T_max: int, eta_min: float = 0.0):
        self.T_max = T_max
        self.eta_min_ratio = eta_min  # interpreted as a factor floor
        super().__init__()

    def get_factor(self) -> float:
        cos = (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2
        return self.eta_min_ratio + (1.0 - self.eta_min_ratio) * cos


class LinearLR(Scheduler):
    def __init__(self, start_factor: float = 1.0 / 3,
                 end_factor: float = 1.0, total_iters: int = 5):
        self.start_factor = start_factor
        self.end_factor = end_factor
        self.total_iters = total_iters
        super().__init__()

    def get_factor(self) -> float:
        t = min(self.last_epoch, self.total_iters)
        return self.start_factor + (self.end_factor - self.start_factor) \
            * t / self.total_iters


class MultiStepLR(Scheduler):
    """torch.optim.lr_scheduler.MultiStepLR: decay by ``gamma`` at each
    milestone (factor = gamma^(milestones passed))."""

    def __init__(self, milestones, gamma: float = 0.1):
        self.milestones = sorted(int(m) for m in milestones)
        self.gamma = gamma
        super().__init__()

    def get_factor(self) -> float:
        import bisect
        return self.gamma ** bisect.bisect_right(self.milestones,
                                                 self.last_epoch)


class CosineAnnealingWarmRestarts(Scheduler):
    """torch semantics (SGDR): cosine anneal over a cycle of length T_i,
    restarting with T_i ← T_i·T_mult. Computed statelessly from
    ``last_epoch`` so both ``step()`` and the loop's ``step(global_step)``
    jump (train.py:445-449) land on the same schedule."""

    def __init__(self, T_0: int, T_mult: int = 1, eta_min: float = 0.0):
        if T_0 <= 0:
            raise ValueError("T_0 must be positive")
        if T_mult < 1:
            raise ValueError("T_mult must be >= 1")
        self.T_0 = T_0
        self.T_mult = int(T_mult)
        self.eta_min_ratio = eta_min  # factor floor, like CosineAnnealingLR
        super().__init__()

    def get_factor(self) -> float:
        epoch = max(self.last_epoch, 0)
        if self.T_mult == 1:
            t_cur, t_i = epoch % self.T_0, self.T_0
        else:
            n = int(math.log(epoch / self.T_0 * (self.T_mult - 1) + 1,
                             self.T_mult))
            t_cur = epoch - self.T_0 * (self.T_mult ** n - 1) \
                / (self.T_mult - 1)
            t_i = self.T_0 * self.T_mult ** n
        cos = (1 + math.cos(math.pi * t_cur / t_i)) / 2
        return self.eta_min_ratio + (1.0 - self.eta_min_ratio) * cos


class OneCycleLR(Scheduler):
    """torch's one-cycle policy as a *factor of the peak lr* (the config's
    ``learning_rate`` plays torch's ``max_lr``): warm up from
    max_lr/div_factor over ``pct_start`` of ``total_steps``, then anneal to
    max_lr/div_factor/final_div_factor. ``anneal_strategy``: 'cos' | 'linear'.
    Steps past total_steps clamp to the final value (torch raises; a
    clamped tail is safer for max_steps mismatches)."""

    def __init__(self, total_steps: int, pct_start: float = 0.3,
                 anneal_strategy: str = "cos", div_factor: float = 25.0,
                 final_div_factor: float = 1e4):
        if total_steps < 2:
            raise ValueError("total_steps must be >= 2")
        if not 0.0 < pct_start < 1.0:
            raise ValueError("pct_start must be in (0, 1)")
        if anneal_strategy not in ("cos", "linear"):
            raise ValueError("anneal_strategy must be 'cos' or 'linear'")
        self.total_steps = total_steps
        self.pct_start = pct_start
        self.anneal_strategy = anneal_strategy
        self.start_factor = 1.0 / div_factor
        self.final_factor = 1.0 / (div_factor * final_div_factor)
        super().__init__()

    def _anneal(self, start: float, end: float, pct: float) -> float:
        if self.anneal_strategy == "cos":
            return end + (start - end) / 2.0 * (1 + math.cos(math.pi * pct))
        return (end - start) * pct + start

    def get_factor(self) -> float:
        step = min(max(self.last_epoch, 0), self.total_steps - 1)
        up_steps = float(self.pct_start * self.total_steps) - 1
        # up_steps == 0 (pct_start*total == 1): warmup is the single step 0
        # at the peak — torch divides 0/0 here; we skip straight to anneal.
        if up_steps > 0 and step <= up_steps:
            return self._anneal(self.start_factor, 1.0, step / up_steps)
        up_steps = max(up_steps, 0.0)
        down_steps = self.total_steps - up_steps - 1
        return self._anneal(1.0, self.final_factor,
                            (step - up_steps) / down_steps)


class ReduceLROnPlateau(Scheduler):
    """torch semantics over the val metric (fed best_loss, train.py:442-443)."""

    needs_metric = True

    def __init__(self, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 min_lr: float = 0.0, cooldown: int = 0):
        self.mode = mode
        self.reduce_factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_factor = min_lr  # as a factor floor
        self.cooldown = cooldown
        self.cooldown_counter = 0
        self.best: Optional[float] = None
        self.num_bad = 0
        super().__init__()

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best * (1.0 - self.threshold)
        return metric > self.best * (1.0 + self.threshold)

    def step(self, metric_or_epoch: Optional[float] = None) -> None:
        # Exact torch ordering: best updates on improvement regardless of
        # cooldown; the cooldown counter decrements EVERY metric step while
        # active (and suppresses bad-epoch accumulation); the reduction
        # check runs after.
        self.last_epoch += 1
        if metric_or_epoch is None:
            return
        metric = float(metric_or_epoch)
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.factor = max(self.factor * self.reduce_factor,
                              self.min_factor)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0

    _STATE_KEYS = ("last_epoch", "factor", "cooldown_counter", "num_bad")

    def state_dict(self) -> dict:
        state = {k: getattr(self, k) for k in self._STATE_KEYS}
        state["best"] = math.nan if self.best is None else self.best
        return state

    def load_state_dict(self, state: dict) -> None:
        super().load_state_dict(state)  # covers _STATE_KEYS (all numeric)
        if "best" in state:
            b = float(state["best"])
            self.best = None if math.isnan(b) else b


_REGISTRY: Dict[str, Type[Scheduler]] = {
    "ConstantLR": ConstantLR,
    "WarmupLR": WarmupLR,
    "StepLR": StepLR,
    "ExponentialLR": ExponentialLR,
    "CosineAnnealingLR": CosineAnnealingLR,
    "CosineAnnealingWarmRestarts": CosineAnnealingWarmRestarts,
    "MultiStepLR": MultiStepLR,
    "OneCycleLR": OneCycleLR,
    "LinearLR": LinearLR,
    "ReduceLROnPlateau": ReduceLROnPlateau,
}


def get_scheduler(name: str, params: Optional[dict] = None,
                  base_lr: float = 1.0) -> Scheduler:
    """Name-based lookup (reference lr_schedulers.py:22-36).

    ``base_lr``: the config's learning_rate. torch's ``eta_min``
    (CosineAnnealing*) and ``min_lr`` (ReduceLROnPlateau) are ABSOLUTE
    learning rates; our schedulers produce factors of base_lr, so those
    params are converted here — a reference YAML keeps its exact LR floor.
    """
    params = dict(params or {})
    if name not in _REGISTRY:
        raise ValueError(
            f"Scheduler '{name}' not found (available: {sorted(_REGISTRY)})")
    if base_lr > 0:
        for key in ("eta_min", "min_lr"):
            if key in params:
                params[key] = float(params[key]) / float(base_lr)
    return _REGISTRY[name](**params)
