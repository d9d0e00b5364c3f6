"""AdamW with linear warmup then linear decay (port of
`repro.optim.adamw`).

The paper fine-tunes with AdamW, linear warmup then linear decay
(Appendix C).  Scalars (learning rate, bias corrections) are computed
in float32 as the JAX package computes them.  Unlike the JAX package,
the updates work in place on parameters and moments.

Two state forms:

* per leaf (`init_opt_state`, `apply_updates`): f32 moments a
  parameter, or with ``state_bits`` (8-bit Adam) each moment as b-bit
  codes with one f32 scale a row of the parameter's native shape,
  rounded to nearest, the second moment stored as its square root.  A
  leaf sharded along its last dim holds part of each row; the sharded
  trainer holds its moments in f32 over the update (`widen_moments`)
  and codes them with the whole rows' scales (`code_moments`), the
  reduction over the ranks JAX leaves to GSPMD;
* in bucket space (`init_bucket_opt_state`, `apply_bucket_updates`):
  f32 moments of one (seg, group_d) segment of the flattened parameter
  bucket, the segment owner's update under the ZeRO DP wire
  (``ring-sharded``).  Its ops are the per-leaf update's, in the same
  order, so the two give the same bits elementwise.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import quantization as Q


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
    state_bits: int = 0             # 0 = f32 moments; b = b-bit codes
                                    # with per-row scales (8-bit Adam)


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


def _q_enc(x: torch.Tensor, bits: int) -> dict:
    """A moment as b-bit codes with one f32 scale a row of its native
    shape, rounded to nearest."""
    codes, scale = Q.quantize(x, bits)
    return {"codes": codes, "scale": scale}


def _q_dec(enc: dict, bits: int) -> torch.Tensor:
    return Q.dequantize(enc["codes"], enc["scale"], bits)


def widen_moments(state: dict, names, bits: int) -> None:
    """Hold the b-bit moments of ``names`` in f32 (the second moment
    squared back), in place: `apply_updates` then updates them in f32,
    and `code_moments` codes them again."""
    for k in names:
        state["mu"][k] = _q_dec(state["mu"][k], bits)
        state["nu"][k] = _q_dec(state["nu"][k], bits).square()


def code_moments(state: dict, names, bits: int, row_max) -> None:
    """Code the f32 moments `widen_moments` left of ``names`` back to b
    bits (the second as its square root), in place, as `apply_updates`
    codes a leaf, but each row's scale from ``row_max``: given the rows'
    absolute maxima concatenated (every first moment's rows, then every
    second's), it returns them reduced over the ranks that share the
    rows (a MAX all-reduce), so a leaf sharded along its last dim gets
    the whole rows' scales and codes."""
    names = list(names)
    if not names:
        return
    xs = [state["mu"][k] for k in names] \
        + [torch.sqrt(state["nu"][k]) for k in names]
    maxima = row_max(torch.cat([x.float().abs().amax(-1).reshape(-1)
                                for x in xs]))
    off, coded = 0, []
    for x in xs:
        rows = x.numel() // x.shape[-1]
        s = maxima[off:off + rows].reshape(*x.shape[:-1], 1)
        off += rows
        coded.append(dict(zip(("codes", "scale"), Q.quantize(
            x, bits, scale=Q.absmax_scale(s)))))
    for i, k in enumerate(names):
        state["mu"][k], state["nu"][k] = coded[i], coded[len(names) + i]


def init_opt_state(params: dict, state_bits: int = 0) -> dict:
    """Zero moments for every parameter (f32, or b-bit codes with
    ``state_bits``), step 0."""
    def zeros(p):
        z = torch.zeros_like(p, dtype=torch.float32)
        return _q_enc(z, state_bits) if state_bits else z
    return {"mu": {k: zeros(p) for k, p in params.items()},
            "nu": {k: zeros(p) for k, p in params.items()},
            "step": 0}


def init_bucket_opt_state(n_ranks: int, seg: int, group_d: int, *,
                          device=None) -> dict:
    """Zero f32 moments of ``n_ranks`` (seg, group_d) segments of the
    parameter bucket, stacked (n_ranks, seg, group_d): the simulator's
    workers, or with ``n_ranks=1`` one rank's own segment."""
    shape = (n_ranks, seg, group_d)
    return {"mu": torch.zeros(shape, dtype=torch.float32, device=device),
            "nu": torch.zeros(shape, dtype=torch.float32, device=device),
            "step": 0}


def _scalars(cfg: AdamWConfig, step: int) -> tuple:
    """(lr, c1, c2) at ``step``, in float32."""
    f = np.float32
    return (lr_at(cfg, step), float(f(1.0) - f(cfg.b1) ** f(step)),
            float(f(1.0) - f(cfg.b2) ** f(step)))


def _update(cfg: AdamWConfig, lr: float, c1: float, c2: float,
            p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
            nu: torch.Tensor) -> None:
    """One AdamW update of p, mu and nu, in place: the one sequence of
    ops both state forms run."""
    g = g.float()
    mu.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    nu.mul_(cfg.b2).add_(g.square() * (1 - cfg.b2))
    d = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
    d += cfg.weight_decay * p.float()
    p.sub_((lr * d).to(p.dtype))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: dict, grads: dict,
                  state: dict) -> dict:
    """One AdamW step on ``params`` (name -> tensor) with ``grads`` of
    the same names, in place.  Returns the new optimizer state.  A leaf
    whose moments are f32 tensors in a b-bit state (`widen_moments`)
    is updated in f32 and left so."""
    step = state["step"] + 1
    lr, c1, c2 = _scalars(cfg, step)
    qb = cfg.state_bits
    for k, p in params.items():
        mu, nu = state["mu"][k], state["nu"][k]
        coded = isinstance(mu, dict)
        if coded:
            mu = _q_dec(mu, qb)
            nu = _q_dec(nu, qb).square()      # nu is stored as sqrt(nu)
        _update(cfg, lr, c1, c2, p, grads[k], mu, nu)
        if coded:
            # the square root keeps small second moments resolved
            state["mu"][k] = _q_enc(mu, qb)
            state["nu"][k] = _q_enc(torch.sqrt(nu), qb)
    return {"mu": state["mu"], "nu": state["nu"], "step": step}


@torch.no_grad()
def apply_bucket_updates(cfg: AdamWConfig, pbucket: torch.Tensor,
                         gbucket: torch.Tensor, state: dict) -> dict:
    """One AdamW step on segments of the f32 parameter bucket, in place:
    ``pbucket``, ``gbucket`` (the segment means the ZeRO wire leaves on
    their owners) and the moments of `init_bucket_opt_state` share one
    shape.  Elementwise the bits of `apply_updates` on f32 leaves.
    Returns the new optimizer state."""
    if cfg.state_bits:
        raise ValueError(
            "state_bits (8-bit Adam) is per-leaf; unsupported with the "
            "bucket-space sharded optimizer (dp_wire='ring-sharded')")
    step = state["step"] + 1
    _update(cfg, *_scalars(cfg, step), pbucket, gbucket, state["mu"],
            state["nu"])
    return {"mu": state["mu"], "nu": state["nu"], "step": step}
