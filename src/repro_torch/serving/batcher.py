"""Continuous batching over the compressed serving plane (port of
`repro.serving.batcher`).

One fixed pool of ``num_slots`` cache rows (each request owns one row
of every cache leaf for its lifetime) fed by a FIFO of requests.  Every
tick one decode step advances all slots together at the static shape
``(num_slots, 1)``; admission and eviction are host-side slot
bookkeeping.

State machine (per request)::

    PENDING --admit (free slot: B=1 exact-length prefill,
            |        write row into the pool, emit first token)
            v
    ACTIVE --pooled decode step each tick, one token per tick
            |
            +--EOS sampled, or max_new_tokens reached
            v
    DONE   (slot freed, next PENDING request admitted)

Mixed lengths: each slot carries its own write head in the pool's
``pos``, a (num_slots,) int32 tensor on the device, and the pooled step
is `Transformer.forward_with_caches` over the whole pool with those
per-row heads (where the JAX package `vmap`s its single-row decode):
each row's positions start at its own head, it attends over its own
valid prefix only, its KV rows are appended at its own head (B3's
per-row write heads), and the heads advance on the device.  Idle rows
advance on garbage, as in the reference; their heads may pass
``cache_len``, and the clamp at the write keeps those writes in the
row's own store.  Each admission prefills at B = 1 and the prompt's own
length (B10 over the row's cache), so the pooled step never prefills.

Every family serves, as in the reference, whose pooled step carries
every cache leaf at the slot axis 1: an ssm or hybrid slot's rows are
its layers' SSD states (f32) and conv windows (the pool's dtype), which
an admission's prefill fills from zero states and the pooled step reads
and writes in place (the hybrid's shared block also keeps raw k and v
at the per-row heads; a quantizing ``kv_codec`` there raises JAX's
``quantize_caches`` message when the batcher is built).  Requests carry
no frames or patches, as the reference's: an audio slot's cross caches
``xk``/``xv`` stay zero, a vlm model serves text only.  `_write_slot`,
the fault injection and the slot guard take every leaf, these
included.

Compression hooks: a `serving.kvcache.KVCodec` switches the pool to the
quantized layout, and a `serving.delta.DeltaHopCodec` with
``num_stages`` routes every hidden-state hop between stage groups
through the delta codec (its reference buffers live in the pool as
``hop_m``, one row a slot, and are rewritten with their slot).

Decoding is greedy (argmax per slot): one host read of the
(num_slots,) tokens a tick, plus the slot guard's flags when it is on.

Fault isolation: a slot's row never mixes with its neighbours' in the
pooled step (every operation is per row), so a poisoned row cannot
leak.  A `repro_torch.comm.faults.FaultPlan` injects kv-plane
corruption into one active slot's cache at a chosen tick, and the slot
guard (`faults.slot_flags` over the pool after each step, plus an
admission check on every prefill row) evicts the poisoned request to
``DONE`` with ``req.error`` set; the surviving slots' token streams
stay equal to an uninjected run's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.comm import faults as F
from repro_torch.serving.delta import DeltaHopCodec
from repro_torch.serving.kvcache import KVCodec

PENDING, ACTIVE, DONE = "PENDING", "ACTIVE", "DONE"


@dataclasses.dataclass
class ServeRequest:
    """One prompt in flight; ``tokens`` accumulates greedy output.
    ``error`` is empty for a clean completion; a request evicted by
    the slot guard lands in ``DONE`` with the structured fault text
    (plane/wire/tick) here instead of poisoning its neighbours."""
    prompt: list
    max_new_tokens: int = 16
    tokens: list = dataclasses.field(default_factory=list)
    state: str = PENDING
    slot: int = -1
    error: str = ""


class ContinuousBatcher:
    """Per-request cache slots and one static-shape pooled decode step.

    ``model`` is a `repro_torch.models.model.Transformer` (it carries
    the config the reference takes beside its params).  The keywords
    are the reference's, without ``block_k`` (the JAX attention scan's
    key block; the port's prefill runs the B10 kernel, which tiles
    itself).  The pool lives on the model's device.
    ``kv_codec``/``hop_codec``/``num_stages`` default to the
    uncompressed single-stage baseline; ``eos_id=None`` disables EOS
    eviction (requests run to ``max_new_tokens``); ``dtype`` is the raw
    cache's (unused by a quantizing codec).

    ``fault_plan`` schedules kv-plane injections by batcher tick (the
    `FaultSpec.step` coordinate); ``guard`` turns the per-tick slot scan
    and the admission check on (default: on exactly when a plan is
    given).  ``stats`` sums the seconds spent in admissions' prefills
    and in pooled decode steps (each ends in a host read);
    ``last_logits`` holds the last pooled step's (num_slots, V) logits
    on the device."""

    def __init__(self, model, *, num_slots: int, cache_len: int,
                 kv_codec: Optional[KVCodec] = None,
                 hop_codec: Optional[DeltaHopCodec] = None,
                 num_stages: int = 1, eos_id: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16,
                 fault_plan: Optional[F.FaultPlan] = None,
                 guard: Optional[bool] = None):
        self.model, self.cfg = model, model.cfg
        self.device = model.embed.device
        self.num_slots, self.cache_len = num_slots, cache_len
        self.kv_codec = kv_codec if (kv_codec and kv_codec.bits) else None
        self.hop_codec = hop_codec if num_stages > 1 else None
        self.num_stages = num_stages
        self.eos_id, self.dtype = eos_id, dtype
        self.fault_plan = fault_plan or F.FaultPlan()
        self.guard = bool(self.fault_plan) if guard is None else guard
        self._tick = 0
        self._fired: set = set()
        self.requests: list[ServeRequest] = []
        self._slots: list[Optional[ServeRequest]] = [None] * num_slots
        self._next_tok = torch.zeros(num_slots, dtype=torch.long,
                                     device=self.device)
        self.caches = self._init_pool()
        self.stats = {"prefills": 0, "prefill_s": 0.0, "ticks": 0,
                      "decode_s": 0.0}
        self.last_logits: Optional[torch.Tensor] = None

    # -- pool construction --------------------------------------------------

    def _row_caches(self, batch: int) -> dict:
        caches = self.model.init_caches(batch, self.cache_len, self.dtype,
                                        device=self.device,
                                        kv_codec=self.kv_codec)
        if self.hop_codec is not None:
            caches["hop_m"] = self.hop_codec.init_state(
                self.num_stages - 1, batch, self.cfg.d_model,
                device=self.device)["m"]
        return caches

    def _init_pool(self) -> dict:
        pool = self._row_caches(self.num_slots)
        # per-slot heads replace the int head of a uniform batch
        pool["pos"] = torch.zeros(self.num_slots, dtype=torch.int32,
                                  device=self.device)
        return pool

    # -- steps --------------------------------------------------------------

    def _forward(self, tokens: torch.Tensor, caches: dict, prefill: bool):
        """One `forward_with_caches` with the batcher's codecs; returns
        (the last position's logits (B, V), caches)."""
        bfn = self.hop_codec.boundary_fn(prefill=prefill) \
            if self.hop_codec is not None else None
        logits, caches = self.model.forward_with_caches(
            tokens, caches, logits_last_only=True,
            num_stages=self.num_stages, boundary_fn=bfn,
            kv_codec=self.kv_codec)
        return logits[:, -1], caches

    def _prefill(self, prompt: list):
        """B = 1 exact-length prefill into a fresh row cache; returns
        (its logits (1, V) on the device, the row's caches)."""
        tokens = torch.tensor([prompt], dtype=torch.long,
                              device=self.device)
        return self._forward(tokens, self._row_caches(1), prefill=True)

    def _decode(self) -> torch.Tensor:
        """The pooled decode step over every slot: greedy tokens
        (num_slots,) on the device; no host read."""
        self.last_logits, self.caches = self._forward(
            self._next_tok[:, None], self.caches, prefill=False)
        return torch.argmax(self.last_logits, dim=-1)

    # -- slot bookkeeping ---------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 16) -> ServeRequest:
        req = ServeRequest(list(prompt), max_new_tokens)
        self.requests.append(req)
        return req

    def _write_slot(self, i: int, row_caches: dict) -> None:
        """Copy the whole row (every leaf, ``hop_m`` and the head) into
        slot ``i`` of the pool."""
        for name, leaf in row_caches.items():
            if name == "pos":
                self.caches["pos"][i] = leaf
            else:
                self.caches[name][:, i] = leaf[:, 0]

    def _row_bad(self, row: dict) -> bool:
        """Admission guard: is this prefill row's float payload corrupt
        (non-finite or above the guard bound)?"""
        return any(F._arr_detail(leaf) is not None
                   for leaf in row.values())

    def _admit(self) -> None:
        pending = [r for r in self.requests if r.state == PENDING]
        for i, slot in enumerate(self._slots):
            if slot is not None or not pending:
                continue
            req = pending.pop(0)
            t0 = time.perf_counter()
            logits, row = self._prefill(req.prompt)
            tok = torch.argmax(logits[0])
            first = int(tok)
            self.stats["prefill_s"] += time.perf_counter() - t0
            self.stats["prefills"] += 1
            if self.guard and self._row_bad(row):
                # poisoned before it ever touched the pool: reject at
                # admission, never occupy a slot
                req.state = DONE
                req.error = (f"wire fault detected: plane=kv "
                             f"wire='paged' tick={self._tick}: "
                             f"corrupt prefill payload")
                continue
            self._write_slot(i, row)
            req.state, req.slot = ACTIVE, i
            self._slots[i] = req
            self._next_tok[i] = tok
            self._emit(req, first)

    def _emit(self, req: ServeRequest, tok: int) -> None:
        req.tokens.append(tok)
        done = (self.eos_id is not None and tok == self.eos_id) \
            or len(req.tokens) >= req.max_new_tokens
        if done:
            req.state = DONE
            self._slots[req.slot] = None
            req.slot = -1

    def _evict_faulted(self, req: ServeRequest, detail: str) -> None:
        """Slot-level isolation: the poisoned request leaves the pool as
        DONE(error); its row is dead until the next admission overwrites
        every leaf (`_write_slot` writes the full row)."""
        req.error = (f"wire fault detected: plane=kv wire='paged' "
                     f"tick={self._tick}: {detail}")
        req.state = DONE
        self._slots[req.slot] = None
        req.slot = -1

    def _inject_faults(self) -> None:
        """Fire due kv-plane faults into the lowest-index active slot,
        in place on the pool's float leaves (each spec fires once, at
        the first due tick with a victim)."""
        for spec in self.fault_plan.faults:
            if spec.plane != "kv" or spec in self._fired \
                    or self._tick < spec.step:
                continue
            victims = [i for i, r in enumerate(self._slots)
                       if r is not None]
            if not victims:
                continue       # no active slot yet; retry next tick
            v = victims[0]
            self._fired.add(spec)
            for name, leaf in self.caches.items():
                if name != "pos" and F._is_float(leaf):
                    leaf[:, v] = F.corrupt_array(leaf[:, v], spec.kind)

    # -- drive --------------------------------------------------------------

    def step(self) -> None:
        """One pooled decode tick over every slot (idle rows advance on
        garbage and are ignored: the price of a static shape).  With the
        guard on, the pool is scanned after the decode and any ACTIVE
        slot carrying a corrupt payload is evicted BEFORE its (garbage)
        token is emitted."""
        self._inject_faults()
        t0 = time.perf_counter()
        toks = self._decode()
        self._next_tok = toks
        host = toks.tolist()
        flags = F.slot_flags(self.caches) if self.guard \
            else [False] * self.num_slots
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["ticks"] += 1
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            if flags[i]:
                self._evict_faulted(req, "corrupt cache payload")
            else:
                self._emit(req, host[i])
        self._tick += 1

    def run(self, max_ticks: int = 10_000) -> list:
        """Admit and decode until every submitted request is DONE;
        returns the requests in submission order."""
        for _ in range(max_ticks):
            self._admit()
            if all(r.state == DONE for r in self.requests):
                break
            self.step()
        return self.requests
