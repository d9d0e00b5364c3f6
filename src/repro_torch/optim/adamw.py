"""AdamW with linear warmup then linear decay (port of the per-leaf half
of `repro.optim.adamw` with f32 moments; the bucket-space optimizer of
the ZeRO wire and the 8-bit moments (``state_bits``) are not ported
yet).

The paper fine-tunes with AdamW, linear warmup then linear decay
(Appendix C).  Scalars (learning rate, bias corrections) are computed
in float32 as the JAX package computes them.  Unlike the JAX package,
`apply_updates` updates parameters and moments in place.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 5e-6
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "linear"        # linear | constant


def lr_at(cfg: AdamWConfig, step: int) -> float:
    """Learning rate at ``step`` (1-based), in float32."""
    f = np.float32
    step = f(step)
    warm = min(step / f(max(cfg.warmup_steps, 1)), f(1.0))
    if cfg.schedule == "constant":
        return float(f(cfg.lr) * warm)
    decay = np.clip((f(cfg.total_steps) - step)
                    / f(max(cfg.total_steps - cfg.warmup_steps, 1)),
                    f(0.0), f(1.0))
    return float(f(cfg.lr) * warm * decay)


def init_opt_state(params: dict) -> dict:
    """Zero f32 moments for every parameter, step 0."""
    return {"mu": {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()},
            "nu": {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()},
            "step": 0}


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: dict, grads: dict,
                  state: dict) -> dict:
    """One AdamW step on ``params`` (name -> tensor) with ``grads`` of
    the same names, in place.  Returns the new optimizer state."""
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    f = np.float32
    c1 = float(f(1.0) - f(cfg.b1) ** f(step))
    c2 = float(f(1.0) - f(cfg.b2) ** f(step))
    for k, p in params.items():
        g = grads[k].float()
        mu, nu = state["mu"][k], state["nu"][k]
        mu.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        nu.mul_(cfg.b2).add_(g.square() * (1 - cfg.b2))
        d = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        d += cfg.weight_decay * p.float()
        p.sub_((lr * d).to(p.dtype))
    return {"mu": state["mu"], "nu": state["nu"], "step": step}
