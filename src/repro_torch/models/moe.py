"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
`repro.models.moe`).

Covers both MoE styles of the JAX package:

* Mixtral: 8 experts, top-2, no shared experts;
* DeepSeek / Moonlight: 64 fine-grained experts, top-6, and 2 shared
  experts (one dense FFN of twice the expert width, always applied);
  the leading dense layers are the model's ``prefix``
  (`repro_torch.models.model`).

Dispatch is the JAX package's: the (token, choice) pairs are sorted by
expert (a STABLE sort, so which pair drops is JAX's), each pair's
position inside its expert comes from the experts' running counts, and
pairs at or past the capacity ``cap = ceil(T k / E capacity_factor)``
go to a sentinel row and are dropped.  ``per_sequence`` dispatches each
sequence of the batch on its own (JAX's ``vmap`` over the batch, the
aux averaged): the serving prefill, and the continuous batcher's pooled
step, a row at a time.  The expert products are batched matmuls over
the (E, groups cap, d) buffer in every dispatch, or, given an
``expert_map`` (JAX's hook), one expert after another, each expert's
weights taken from the hook just before its product and its step
checkpointed on its own (JAX's ``lax.scan`` over
``jax.checkpoint(one_expert)``): the distributed trainer's ZeRO-3
gathers one expert at a time there, and again in that expert's
backward, so no more than one expert's gathered weights are live.

The combine adds each token's kept contributions in expert order
through the inverse of the sort, one explicit add after another: the
order of JAX's scatter-add on the CPU, and a fixed order on the card
(an ``index_add_`` there adds atomically, in a varying order).  Every
index op's backward here writes unique rows (the dispatch gathers a
token's k copies through an ``expand``, whose backward is a sum), so
the CPU backward is bit-reproducible, as a resumed run needs.

Expert parallelism (``ep``, the distributed trainer's
``moe_mode="expert_parallel"``): the (E, cap, d) buffer crosses the data
group by all-to-all (`repro_torch.launch.mesh.RingGroup.all_to_all`),
each data rank computes its own E/D experts on every rank's tokens (or,
where E < D, its 1/(D/E) share of one expert's), and the inverse
all-to-all brings the rows back, so the combine is unchanged.  ``cap``
is rounded up to a multiple of D / gcd(E, D) so the buffer splits
evenly.  A rank computes with its own experts' weights: sliced from the
whole stacks where it holds them (JAX's unsharded branch), or, where
the distributed trainer shards the stacks over the data group (ZeRO-3,
`repro_torch.training.pipeline.StageFsdp`), handed in whole by its
weight all-to-all (JAX's sharded branch, ``ep_weights``), which then
stand in the stacks' place, (E/D, ...) or (1, ...) instead of (E, ...).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L


class MoE(nn.Module):
    """One MoE FFN's weights (JAX ``init_moe``): ``router`` (d, E), the
    expert stacks ``w_gate``/``w_up`` (E, d, ff) and ``w_down`` (E, ff,
    d), and ``shared``, the ``n_shared`` shared experts fused into one
    `layers.MLP` of width ``n_shared * ff`` (None without them)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, e, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.top_k, self.capacity_factor = cfg.top_k, cfg.capacity_factor
        self.act = cfg.act
        self.router = nn.Parameter(torch.empty(d, e, device=device))
        self.w_gate = nn.Parameter(torch.empty(e, d, ff, device=device))
        self.w_up = nn.Parameter(torch.empty(e, d, ff, device=device))
        self.w_down = nn.Parameter(torch.empty(e, ff, d, device=device))
        self.shared = L.MLP(d, cfg.n_shared_experts * ff, cfg.act,
                            cfg.mlp_gated, device=device) \
            if cfg.n_shared_experts else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """JAX ``init_moe``'s scales: N(0, 1/d) router and input
        projections, N(0, 1/ff) output projections."""
        s_in = 1.0 / math.sqrt(self.router.shape[0])
        for w in (self.router, self.w_gate, self.w_up):
            L.init_normal_(w, s_in, generator)
        L.init_normal_(self.w_down, 1.0 / math.sqrt(self.w_down.shape[1]),
                       generator)
        if self.shared is not None:
            self.shared.reset_parameters(generator)

    def forward(self, x: torch.Tensor, *, per_sequence: bool = False,
                ep=None, expert_map: Optional[Callable] = None):
        """x (B, S, d) -> (out (B, S, d), aux scalar)."""
        return moe_ffn(self, x, top_k=self.top_k,
                       capacity_factor=self.capacity_factor, act=self.act,
                       per_sequence=per_sequence, ep=ep,
                       expert_map=expert_map)


def router_probs(p: MoE, x: torch.Tensor) -> torch.Tensor:
    """x (..., T, d) -> the router's softmax probabilities (..., T, E),
    in f32."""
    return torch.softmax(x.float() @ p.router.float(), dim=-1)


def capacity(t: int, top_k: int, e: int, capacity_factor: float,
             ep_size: int = 0) -> int:
    """Slots an expert takes from a dispatch of ``t`` tokens: JAX's
    ``ceil(t k / E capacity_factor)``, rounded up to a multiple of
    D / gcd(E, D) under expert parallelism over D ranks."""
    cap = int(math.ceil(t * top_k / e * capacity_factor))
    if ep_size:
        m = ep_size // math.gcd(e, ep_size)
        cap = -(-cap // m) * m
    return cap


def route(p: MoE, xg: torch.Tensor, top_k: int, cap: int) -> dict:
    """The routing of G independent dispatches, xg (G, T, d): the
    router's ``probs`` (G, T, E), the renormalised top-k ``top_v`` and
    ``top_i`` (G, T, k), the stable sort of the (token, choice) pairs by
    expert (``order``, (G, T k)), each pair's buffer ``slot`` in sorted
    order (E cap for a dropped one) and ``keep``."""
    g, t, _ = xg.shape
    e = p.router.shape[-1]
    probs = router_probs(p, xg)
    top_v, top_i = torch.topk(probs, top_k, dim=-1)
    top_v = top_v / top_v.sum(-1, keepdim=True)
    flat_e = top_i.reshape(g, t * top_k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    counts = torch.zeros((g, e), dtype=torch.int64, device=xg.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 1) - counts             # exclusive
    pos = torch.arange(t * top_k, device=xg.device) - torch.gather(
        starts, 1, se)
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, e * cap)     # dropped: sentinel
    return {"probs": probs, "top_v": top_v, "top_i": top_i, "order": order,
            "slot": slot, "keep": keep}


def _experts(fn, buf: torch.Tensor, wg, wu, wd) -> torch.Tensor:
    """The gated expert MLPs over buf (E, C, d) -> (E, C, d)."""
    return (fn(buf @ wg) * (buf @ wu)) @ wd


def _experts_in_turn(fn, buf: torch.Tensor, expert_map: Callable,
                     dtype: torch.dtype) -> torch.Tensor:
    """The gated expert MLPs over buf (E, C, d), one expert after
    another: expert e's (w_gate, w_up, w_down) from ``expert_map(e)``
    inside its own checkpoint, so its backward calls the hook again."""
    def one(e, be):
        wg, wu, wd = (w.to(dtype) for w in expert_map(e))
        return _experts(fn, be, wg, wu, wd)
    return torch.stack([checkpoint(one, e, buf[e], use_reentrant=False,
                                   preserve_rng_state=False)
                        for e in range(buf.shape[0])])


def slice_experts(p: MoE) -> Callable:
    """The ``expert_map`` of whole stacks: expert e's slices of one
    ``unbind`` of each stack (its backward stacks the E gradients in
    one op)."""
    stacks = [w.unbind(0) for w in (p.w_gate, p.w_up, p.w_down)]
    return lambda e: tuple(s[e] for s in stacks)


def moe_ffn(p: MoE, x: torch.Tensor, *, top_k: int, capacity_factor: float,
            act: str = "silu", per_sequence: bool = False, ep=None,
            expert_map: Optional[Callable] = None):
    """x (B, S, d) -> (out (B, S, d), aux scalar), JAX ``moe_ffn``.

    One dispatch over the B S tokens, or with ``per_sequence`` one a
    sequence (capacity counted per sequence, the aux averaged over
    them).  ``ep``: the data group the expert-parallel buffer crosses
    (``size``, ``index``, ``all_to_all``), or None.  ``expert_map(e)``
    -> expert e's whole (w_gate, w_up, w_down): the experts then run
    one at a time (`_experts_in_turn`; the module docstring)."""
    b, s, d = x.shape
    groups, t = (b, s) if per_sequence else (1, b * s)
    if ep is not None and groups > 1:
        raise ValueError("expert parallelism takes one dispatch")
    e = p.router.shape[-1]
    dtype = x.dtype
    xg = x.reshape(groups, t, d)
    cap = capacity(t, top_k, e, capacity_factor,
                   ep.size if ep is not None else 0)
    r = route(p, xg, top_k, cap)
    order, slot = r["order"], r["slot"]
    gi = torch.arange(groups, device=x.device)[:, None].expand_as(slot)

    # dispatch: a token's k copies (an expand, whose backward sums them),
    # in sorted order, scattered into the (E cap + 1) rows of the buffer
    rows = xg[:, :, None].expand(groups, t, top_k, d).reshape(
        groups, t * top_k, d)
    rows = rows[gi, order]
    buf = x.new_zeros((groups, e * cap + 1, d)).index_put((gi, slot), rows)
    buf = buf[:, :e * cap].reshape(groups, e, cap, d)

    fn = L._act(act)
    if ep is not None:
        w = (p.w_gate.to(dtype), p.w_up.to(dtype), p.w_down.to(dtype))
        y = _expert_parallel_ffn(buf[0], w, fn, ep)[None]
    else:
        eb = buf.transpose(0, 1).reshape(e, groups * cap, d)
        if expert_map is None:
            y = _experts(fn, eb, p.w_gate.to(dtype), p.w_up.to(dtype),
                         p.w_down.to(dtype))
        else:
            y = _experts_in_turn(fn, eb, expert_map, dtype)
        y = y.reshape(e, groups, cap, d).transpose(0, 1)
    y = torch.cat([y.reshape(groups, e * cap, d),
                   x.new_zeros((groups, 1, d))], dim=1)

    # combine: a token's contributions in expert order (its pairs' sorted
    # positions, ascending), added one after another
    wts = torch.gather(r["top_v"].reshape(groups, t * top_k), 1,
                       order).to(dtype)
    contrib = y[gi, slot] * wts[..., None]
    inv = torch.argsort(order, dim=-1)
    at = inv.reshape(groups, t, top_k).sort(dim=-1).values
    parts = contrib[torch.arange(groups, device=x.device)[:, None, None],
                    at].unbind(2)
    out = parts[0]
    for c in parts[1:]:
        out = out + c
    out = out.reshape(b, s, d)

    # Switch-style load-balance loss: E * sum_e f_e * P_e, f from the
    # first choice only
    first = torch.zeros((groups, e), dtype=torch.float32, device=x.device)
    first.scatter_add_(1, r["top_i"][..., 0],
                       torch.ones((groups, t), device=x.device))
    aux = (e * (first / t * r["probs"].mean(1)).sum(-1)).mean()

    if p.shared is not None:
        out = out + p.shared(x)
    return out, aux


def _expert_parallel_ffn(buf: torch.Tensor, w: tuple, fn, ep
                         ) -> torch.Tensor:
    """The expert products with the buffer (E, cap, d) spread over the D
    ranks of ``ep`` (JAX ``_expert_parallel_ffn``): rank g computes
    experts [g E/D, (g+1) E/D) (E >= D) or its 1/(D/E) token share of
    expert g E/D (E < D) on every rank's rows; the inverse all-to-all
    restores the dispatch layout.  ``w``: the whole stacks (E, ...), or
    this rank's own experts (ne, ...) where a weight all-to-all brought
    them (module docstring).  Wire per call: 2 x E cap d values."""
    e, cap, d = buf.shape
    dd = ep.size
    ne = max(e // dd, 1)                   # experts computed per rank
    chunk = e * cap // dd                  # rows sent to each rank
    recv = ep.all_to_all(buf.reshape(dd, chunk, d))      # (D, chunk, d)
    # rows for my expert e_loc from every source, contiguous per expert
    recv = recv.reshape(dd, ne, chunk // ne, d).transpose(0, 1).reshape(
        ne, dd * (chunk // ne), d)
    if w[0].shape[0] == e:                 # the whole stacks: slice mine
        start = ep.index * e // dd
        w = tuple(t[start:start + ne] for t in w)
    y = _experts(fn, recv, *w)
    y = y.reshape(ne, dd, chunk // ne, d).transpose(0, 1).reshape(
        dd, chunk, d)
    return ep.all_to_all(y).reshape(e, cap, d)


def moe_dense_reference(p: MoE, x: torch.Tensor, *, top_k: int,
                        act: str = "silu") -> torch.Tensor:
    """The exact (drop-free) answer: every expert on every token,
    weighted by the renormalised top-k gates (JAX
    ``moe_dense_reference``)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    probs = router_probs(p, xf)
    top_v, top_i = torch.topk(probs, top_k, dim=-1)
    top_v = top_v / top_v.sum(-1, keepdim=True)
    gates = torch.zeros_like(probs).scatter(1, top_i, top_v)
    fn = L._act(act)
    dtype = x.dtype
    h = fn(torch.einsum("td,edf->tef", xf, p.w_gate.to(dtype))) \
        * torch.einsum("td,edf->tef", xf, p.w_up.to(dtype))
    y = torch.einsum("tef,efd->ted", h, p.w_down.to(dtype))
    out = torch.einsum("ted,te->td", y, gates.to(dtype)).reshape(b, s, d)
    if p.shared is not None:
        out = out + p.shared(x)
    return out
