"""Prodigy (Mishchenko and Defazio, "Prodigy: An Expeditiously Adaptive
Parameter-Free Learner", 2023), Algorithm 4 with Adam's moments as the
authors' ``prodigyopt`` package implements it: decoupled weight decay, no
bias correction, no safeguard warm-up, d0 = 1e-6, growth rate unbounded,
β3 = √β2. Per step k, with d the current estimate and dlr = d·lr:

    numerator = β3·numerator + (d/d0)·dlr·Σ⟨g, p0 − p⟩
    m = β1·m + (1−β1)·d·g ;  v = β2·v + (1−β2)·d²·g²
    s = β3·s + (d/d0)·dlr·g
    d̂ = numerator / Σ|s| ;  d_max = max(d_max, d̂) ;  d_new = d_max
    p ← p − dlr·wd·p − dlr·m / (√v + d_new·ε)

Σ runs over every parameter. While Σ|s| is 0 the parameters stay.
"""

from __future__ import annotations

from typing import List

import torch


class Prodigy:
    def __init__(self, params: List[torch.Tensor], lr: float = 1.0,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, d0: float = 1e-6):
        self.params = list(params)
        self.lr, self.eps, self.wd, self.d0 = lr, eps, weight_decay, d0
        self.b1, self.b2 = betas
        self.b3 = self.b2 ** 0.5
        self.d = self.d_max = d0
        self.numerator = 0.0
        self.state = [dict(p0=p.detach().clone(), m=torch.zeros_like(p),
                           v=torch.zeros_like(p), s=torch.zeros_like(p))
                      for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        d, lr = self.d, self.lr
        dlr = d * lr
        dot = 0.0
        for p, st in zip(self.params, self.state):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            dot += float(torch.sum(g.double() * (st["p0"] - p).double()))
        self.numerator = self.b3 * self.numerator + (d / self.d0) * dlr * dot
        denom = 0.0
        for p, st in zip(self.params, self.state):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            st["m"].mul_(self.b1).add_(g, alpha=(1 - self.b1) * d)
            st["v"].mul_(self.b2).addcmul_(g, g, value=(1 - self.b2) * d * d)
            st["s"].mul_(self.b3).add_(g, alpha=(d / self.d0) * dlr)
            denom += float(st["s"].double().abs().sum())
        if denom == 0.0 or lr <= 0.0:
            return
        d_hat = self.numerator / denom
        self.d_max = max(self.d_max, d_hat)
        # min(d_max, d·growth) with an unbounded growth rate
        self.d = d = self.d_max
        for p, st in zip(self.params, self.state):
            p.add_(p, alpha=-self.wd * dlr)
            p.addcdiv_(st["m"], st["v"].sqrt().add_(d * self.eps),
                       value=-dlr)
