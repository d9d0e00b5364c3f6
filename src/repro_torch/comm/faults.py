"""Deterministic fault injection and payload guards for every plane
(port of `repro.comm.faults`).

The paper's setting (slow, decentralized, preemptible networks) makes
corrupt payloads a when, not an if, and stateful compression makes
them worse: a NaN that reaches the ``dp_error`` carry or the AQ-SGD
message buffers poisons every later step through the telescoping sum.

**Injection.** A :class:`FaultPlan` of ``(step, plane, kind)``
coordinates, parsed from ``step:plane:kind`` text (``--fault
3:dp:nan-scale``).  Three kinds, each the post-decode effect of a real
wire failure: ``corrupt-codes`` (garbage codes: the decoded payload
turns into +-1e32), ``nan-scale`` (a NaN row scale: the decode is NaN)
and ``drop-hop`` (a zeroed hop: the payload is silently all-zero).  DP
faults use the registry itself: `fault_wire` registers an internal
wrapper wire (``ring+fault-nan-scale``) whose collective and simulator
delegate to the base wire and corrupt the decoded mean, and
`faulted_comm` swaps it into ``comm.dp.wire`` for exactly the fault
step.  fw / bw / zbuf faults corrupt the carried training state between
steps (`inject_sim_state`); kv faults poison one serving slot
(`repro_torch.serving.batcher`).

**Guards.** `guard_dp_pair` NaN-poisons the decoded DP mean and its
carry on the device when the mean is non-finite, above ``GUARD_MAX``
or all-zero.  `check_train_state` scans the post-step state on the
device, brings a few flags to the host, and raises a structured
:class:`WireFaultError` naming plane, wire and step; attribution is by
which state a plane can reach, in dependency order: message buffers ->
zbuf if ``zbuf.bits`` else fw; ``dp_error`` -> dp; params / opt / loss
-> bw if ``bw.bits`` else dp if ``dp.bits`` else fw.
`repro_torch.launch.runner` catches it and replays from the last good
checkpoint.  `_arr_detail` (the batcher's admission check) and
`slot_flags` (its per-tick scan of the pool) serve the kv plane.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import math

import numpy as np
import torch

from repro_torch.comm import wires as W
from repro_torch.weights import jax_leaf_names

FAULT_KINDS = ("corrupt-codes", "nan-scale", "drop-hop")
# drop-hop's zero sentinel only works where an all-zero payload is
# implausible: the DP gradient mean and the seen rows of the message
# buffers.  bw gradients and kv cache rows can be legitimately zero.
ALLOWED_KINDS = {
    "dp": FAULT_KINDS, "fw": FAULT_KINDS, "zbuf": FAULT_KINDS,
    "bw": ("corrupt-codes", "nan-scale"),
    "kv": ("corrupt-codes", "nan-scale"),
}
GUARD_MAX = 1e30   # |value| above this is declared corrupt: far above
                   # any trained tensor, far below corrupt-codes' 1e32


class WireFaultError(RuntimeError):
    """A guard detected a corrupt payload.  Carries the structured
    coordinates (``plane``, ``wire``, ``step``, ``detail``) so the
    recovery loop and the tests can assert on what was caught."""

    def __init__(self, *, plane: str, wire: str, step: int,
                 detail: str):
        self.plane, self.wire = plane, wire
        self.step, self.detail = step, detail
        super().__init__(f"wire fault detected: plane={plane} "
                         f"wire={wire!r} step={step}: {detail}")


@dataclass(frozen=True)
class FaultSpec:
    """One injected fault: at training step ``step`` (0-based; for the
    kv plane, the batcher tick), on ``plane`` (fw/bw/zbuf/dp/kv), of
    ``kind`` (`FAULT_KINDS`)."""
    step: int
    plane: str
    kind: str

    def __post_init__(self):
        if self.plane not in ALLOWED_KINDS:
            raise ValueError(f"unknown fault plane {self.plane!r}; "
                             f"one of {sorted(ALLOWED_KINDS)}")
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")
        if self.kind not in ALLOWED_KINDS[self.plane]:
            raise ValueError(
                f"kind {self.kind!r} is not injectable on plane "
                f"{self.plane!r} (an all-zero payload is legitimate "
                f"there); allowed: {ALLOWED_KINDS[self.plane]}")
        if self.step < 0:
            raise ValueError(f"fault step {self.step} < 0")

    def text(self) -> str:
        """The ``step:plane:kind`` token for this fault."""
        return f"{self.step}:{self.plane}:{self.kind}"


@dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of injected faults (possibly empty).
    Built from text by `parse`; queried per step by `at`."""
    faults: tuple = ()

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse ``step:plane:kind[,step:plane:kind...]``.  Empty text
        is no faults.  Bad tokens raise with the expected grammar."""
        faults = []
        for tok in filter(None, (t.strip() for t in text.split(","))):
            parts = tok.split(":")
            if len(parts) != 3 or not parts[0].lstrip("-").isdigit():
                raise ValueError(
                    f"bad fault token {tok!r}: expected "
                    f"step:plane:kind, e.g. 3:dp:nan-scale")
            faults.append(FaultSpec(step=int(parts[0]), plane=parts[1],
                                    kind=parts[2]))
        return cls(faults=tuple(faults))

    def at(self, step: int, plane: Optional[str] = None) -> list:
        """The faults scheduled for ``step`` (optionally one plane)."""
        return [f for f in self.faults if f.step == step
                and (plane is None or f.plane == plane)]

    def text(self) -> str:
        """The text form (inverse of `parse`)."""
        return ",".join(f.text() for f in self.faults)

    def __bool__(self):
        return bool(self.faults)


# ---------------------------------------------------------------------------
# corruption patterns (the post-decode effect of each fault kind)
# ---------------------------------------------------------------------------

def _is_float(x) -> bool:
    """True for a floating-point or complex tensor."""
    return isinstance(x, torch.Tensor) and (x.is_floating_point()
                                            or x.is_complex())


def corrupt_array(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The ``kind``-corrupted version of a float tensor (a new tensor of
    its shape, dtype and device; int and bool tensors come back
    unchanged: codes corruption is modelled post-decode on the float
    payload)."""
    if not _is_float(x):
        return x
    if kind == "corrupt-codes":
        sign = 1 - 2 * (torch.arange(x.numel(), device=x.device) % 2)
        return (sign.reshape(x.shape) * 1e32).to(x.dtype)
    if kind == "nan-scale":
        return torch.full_like(x, float("nan"))
    if kind == "drop-hop":
        return torch.zeros_like(x)
    raise ValueError(f"unknown fault kind {kind!r}")


def corrupt_tree(tree, kind: str):
    """`corrupt_array` over every float tensor of a tree (a tensor, or
    dicts and lists of them), in the tree's structure."""
    if isinstance(tree, dict):
        return {k: corrupt_tree(v, kind) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(corrupt_tree(v, kind) for v in tree)
    return corrupt_array(tree, kind)


# ---------------------------------------------------------------------------
# DP plane: internal wrapper wires (the registry pattern itself)
# ---------------------------------------------------------------------------

def fault_wire(base: str, kind: str) -> str:
    """Ensure the internal DP wrapper wire ``<base>+fault-<kind>`` is
    registered and return its name.  The wrapper delegates to the base
    wire's collective and simulator and corrupts the DECODED MEAN on the
    way out (the carry passes through; the guard poisons it).  It copies
    the base spec's flags and byte model, so `CommConfig` validation and
    chunk checks still hold, and registers ``internal=True``, so
    enumeration (the ``--dp-wire`` choices, ``--list-wires``) never sees
    it.  Swapping this name into ``comm.dp.wire`` for one step is the
    whole injection mechanism."""
    if kind not in FAULT_KINDS:
        raise ValueError(f"unknown fault kind {kind!r}")
    name = f"{base}+fault-{kind}"
    try:
        W.get_wire(name)
        return name
    except ValueError:
        pass
    spec = W.get_wire(base)

    def collective(v_grad, err, group, bits, **kw):
        mean, new_err = spec.collective(v_grad, err, group, bits, **kw)
        return corrupt_tree(mean, kind), new_err

    def sim_allreduce(grads_list, error_state, bits, **kw):
        out, new_err = spec.sim_allreduce(grads_list, error_state, bits,
                                          **kw)
        return corrupt_tree(out, kind), new_err

    W.register_wire(
        name, plane="dp-grad", internal=True,
        summary=f"FAULT-INJECTION wrapper: {base} with {kind} "
                f"corruption on the decoded mean (harness-only)",
        wire_bytes=spec.wire_bytes, collective=collective,
        sim_allreduce=sim_allreduce, sharded=spec.sharded,
        chunkable=spec.chunkable, psum_lowered=spec.psum_lowered)
    return name


def faulted_comm(comm, spec: FaultSpec):
    """``comm`` with the DP wire swapped for its fault wrapper (for
    ``spec.plane == 'dp'``; the other planes inject through
    `inject_sim_state` or the batcher)."""
    assert spec.plane == "dp", spec
    if not comm.dp.bits:
        raise ValueError("a dp fault needs dp.bits > 0 (the DP plane "
                         "is off)")
    return comm.with_(dp=comm.dp.with_(
        wire=fault_wire(comm.dp.wire, spec.kind)))


# ---------------------------------------------------------------------------
# fw / bw / zbuf planes: state injection between steps
# ---------------------------------------------------------------------------

def _param_leaves(state: dict) -> list:
    """``[(key, leaf)]``: the parameters of a training state in
    `repro_torch.weights.jax_leaves` order, a stacked leaf as the list of
    its layers, from its ``model``, or the ``params`` dict of a plain
    tree."""
    if "model" in state:
        named = dict(state["model"].named_parameters())
        return [("/".join(k.split(".")),
                 [named[n] for n in names] if k.startswith("layers.")
                 else named[names[0]])
                for k, names in jax_leaf_names(named)]
    return list(state.get("params", {}).items())


@torch.no_grad()
def inject_sim_state(state: dict, spec: FaultSpec, comm) -> dict:
    """Corrupt the carried training state, in place, with the
    post-decode effect of ``spec``; returns the state.

    * fw / zbuf (the runner applies it BEFORE the fault step): the
      stored message payload of boundary 0 (``m`` for raw buffers,
      ``scale`` for z-bit ones); ``drop-hop`` zeroes the payload (and
      the codes) while leaving ``seen`` rows marked, which is the guard's
      all-zero-seen-row sentinel;
    * bw (the runner applies it AFTER the fault step: a corrupt backward
      hop lands in the parameters at the update, after the forward wrote
      clean messages): the first float leaf of the parameters, in
      `repro_torch.weights.jax_leaves` order;
    * dp: injected by `faulted_comm` (wire swap), not here.
    """
    if spec.plane == "dp":
        raise ValueError("dp faults inject via faulted_comm (wire "
                         "swap), not state corruption")
    if spec.plane in ("fw", "zbuf"):
        bufs = state["buffers"]
        payload = "m" if "m" in bufs else "scale"
        if spec.kind == "drop-hop" and "codes" in bufs:
            bufs["codes"][0].zero_()
        bufs[payload][0].copy_(corrupt_array(bufs[payload][0], spec.kind))
    elif spec.plane == "bw":
        for _, leaf in _param_leaves(state):
            tensors = leaf if isinstance(leaf, list) else [leaf]
            if _is_float(tensors[0]):
                for t in tensors:
                    t.copy_(corrupt_array(t, spec.kind))
                break
    else:
        raise ValueError(f"plane {spec.plane!r} does not inject into "
                         f"train state")
    return state


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def _pieces(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for leaf in tree for t in _pieces(leaf)]


@torch.no_grad()
def guard_dp_pair(grads, new_err, *, expect_nonzero: bool = True):
    """Guard on the decoded DP mean: if any element of ``grads`` is
    non-finite or ``> GUARD_MAX`` in magnitude, or (with
    ``expect_nonzero``) the whole tree is zero (a dropped payload: a
    real full gradient mean is never identically zero), fill both
    ``grads`` and the error-feedback carry ``new_err`` with NaN, so the
    fault shows in the loss and the carry.  Clean payloads pass through
    bit-exactly.  Works in place and on the device: the verdict is a
    device scalar, never read by the host.  Returns (grads, new_err)."""
    pieces = [t for t in _pieces(grads) if t.numel()]
    if not pieces:
        return grads, new_err
    bad = torch.zeros((), dtype=torch.bool, device=pieces[0].device)
    zero = torch.ones_like(bad)
    for t in pieces:
        m = t.abs().amax()            # NaN propagates through amax
        bad |= ~(m <= GUARD_MAX)
        zero &= m == 0
    if expect_nonzero:
        bad |= zero
    for t in pieces + _pieces(new_err):
        t.masked_fill_(bad, float("nan"))
    return grads, new_err


def _bad(a: torch.Tensor) -> torch.Tensor:
    """Elementwise: non-finite or above ``GUARD_MAX`` in magnitude."""
    a = a.float() if a.is_floating_point() else a.abs()
    return ~torch.isfinite(a) | (a.abs() > GUARD_MAX)


def _flags(t: torch.Tensor) -> torch.Tensor:
    """(non-finite anywhere, above ``GUARD_MAX`` anywhere) of a float
    tensor, as a (2,) bool device tensor, from its max and min alone (a
    NaN propagates through both)."""
    mx, mn = t.max().float(), t.min().float()
    return torch.stack([~(torch.isfinite(mx) & torch.isfinite(mn)),
                        torch.maximum(mx.abs(), mn.abs()) > GUARD_MAX])


def _detail(nonfinite: bool, big: bool) -> Optional[str]:
    if nonfinite:
        return "non-finite values"
    if big:
        return f"magnitude above guard bound {GUARD_MAX:g}"
    return None


@torch.no_grad()
def _arr_detail(a) -> Optional[str]:
    """What is corrupt in one payload (None when clean or not a float
    tensor): the batcher's admission check, one host read."""
    if not _is_float(a) or not a.numel():
        return None
    return _detail(*_flags(a).tolist())


@torch.no_grad()
def slot_flags(pool: dict) -> np.ndarray:
    """Per-slot corruption flags for the serving batcher's pool (the
    slot is dim 1 of every stacked leaf; the ``pos`` vector is dim 0).
    A slot is flagged when ANY of its float payload is non-finite or
    above ``GUARD_MAX``.  The reduction runs on the pool's device and
    one (num_slots,) bool comes to the host.  The caller masks with its
    active set: inactive slots hold stale bytes by design."""
    num_slots = pool["pos"].shape[0]
    flags = torch.zeros(num_slots, dtype=torch.bool,
                        device=pool["pos"].device)
    for leaf in pool.values():
        if not _is_float(leaf) or leaf.dim() < 2 \
                or leaf.shape[1] != num_slots or not leaf.numel():
            continue
        flags |= _bad(leaf).movedim(1, 0).reshape(num_slots, -1).any(dim=1)
    return flags.cpu().numpy()


# ---------------------------------------------------------------------------
# the trainer's guard: scan the state on the device, raise structured errors
# ---------------------------------------------------------------------------

def _float_items(tree, key: str = "") -> list:
    """``[(path, tensor)]`` of a tree's non-empty float tensors, dict
    keys sorted and ``/``-joined, list items by index."""
    if isinstance(tree, dict):
        return [it for k in sorted(tree)
                for it in _float_items(tree[k], f"{key}/{k}" if key
                                       else str(k))]
    if isinstance(tree, (list, tuple)):
        return [it for i, v in enumerate(tree)
                for it in _float_items(v, f"{key}/{i}" if key else str(i))]
    return [(key or "<root>", tree)] if _is_float(tree) and tree.numel() \
        else []


@torch.no_grad()
def _tree_detail(tree) -> Optional[str]:
    """What is corrupt in a tree (None when clean): its first float
    tensor that holds a non-finite value or one above ``GUARD_MAX``.
    One host read for the whole tree."""
    items = _float_items(tree)
    if not items:
        return None
    flags = torch.stack([_flags(t) for _, t in items]).tolist()
    for (key, _), f in zip(items, flags):
        d = _detail(*f)
        if d:
            return f"{key}: {d}"
    return None


@torch.no_grad()
def _buffers_detail(bufs: dict) -> Optional[str]:
    """Corruption in the AQ-SGD message buffers: bad float payloads, or
    the drop-hop sentinel — a SEEN sample whose whole stored message is
    zero (a real message is a full-precision activation plus deltas;
    identically zero means the hop was dropped)."""
    payload = "m" if "m" in bufs else ("scale" if "scale" in bufs
                                      else None)
    if payload is None:
        return None
    d = _tree_detail({k: v for k, v in bufs.items() if k != "seen"})
    if d:
        return d
    counts = []
    for i in range(len(bufs["seen"])):
        m = bufs[payload][i]
        zero = ~(m.reshape(m.shape[0], -1) != 0).any(dim=1)
        counts.append((zero & bufs["seen"][i]).sum())
    for i, n in enumerate(torch.stack(counts).tolist()):
        if n:
            return (f"boundary {i}: {n} seen sample(s) with an all-zero "
                    f"stored message (dropped hop)")
    return None


def check_train_state(state: dict, *, comm, step: int,
                      loss=None) -> None:
    """Raise :class:`WireFaultError` if the post-step training state (or
    the step's loss, a host float) carries a corrupt payload; return
    None when clean.  ``state``: the simulated trainer's (``model``,
    ``opt``, ``buffers``, ``dp_error``), or a plain tree with ``params``
    in place of ``model``.  The scan runs on the state's device; a few
    flags a group come to the host, never the state.

    Attribution is by which state each plane can reach, in dependency
    order: the message buffers come first (written from the forward
    pass, a later DP decode cannot reach them: bad buffers point at the
    fw codec, or zbuf when ``zbuf.bits``); then ``dp_error`` (clean
    buffers + a bad carry is a dp fault); params / opt / loss, which
    everything upstream reaches, go to the widest-reach compressed
    plane."""
    if state.get("buffers") is not None and comm.mode == "aqsgd":
        d = _buffers_detail(state["buffers"])
        if d:
            plane = "zbuf" if comm.zbuf.bits else "fw"
            raise WireFaultError(
                plane=plane, wire=getattr(comm, plane).wire, step=step,
                detail=f"message buffers: {d}")
    if "dp_error" in state:
        d = _tree_detail(state["dp_error"])
        if d:
            raise WireFaultError(plane="dp", wire=comm.dp.wire,
                                 step=step, detail=f"dp_error {d}")
    blame = "bw" if comm.bw.bits else ("dp" if comm.dp.bits else "fw")
    for name, tree in (("params", dict(_param_leaves(state))),
                       ("opt", state.get("opt"))):
        d = _tree_detail(tree)
        if d:
            raise WireFaultError(
                plane=blame, wire=getattr(comm, blame).wire,
                step=step, detail=f"{name} {d}")
    if loss is not None:
        loss = float(loss)
        d = _detail(not math.isfinite(loss), abs(loss) > GUARD_MAX)
        if d:
            raise WireFaultError(plane=blame,
                                 wire=getattr(comm, blame).wire,
                                 step=step, detail=f"loss {d}")
