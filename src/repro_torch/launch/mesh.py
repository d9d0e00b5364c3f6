"""The process mesh of the distributed trainer (the torch.distributed
counterpart of `repro.launch.mesh`).

One process per rank of a ``(data=D, model=K)`` grid, rank ``r = d*K +
k`` (row-major, the index order of the JAX package's
``make_debug_mesh(data, model)``): model rank ``k`` is pipeline stage
``k``; the D ranks of one model column form a data group, the ring of
the data-parallel gradient wire.  `spawn` starts the processes and
gathers their results; `Mesh` is one rank's view: its coordinates, its
data group and the `Transport` every byte goes through.

Transport.  The backend is gloo, and every payload is staged through
pinned host memory explicitly: device -> host before a send, host ->
device after a receive.  gloo does not move CUDA tensors point to
point, and NCCL refuses two ranks on one card, which is how a D x K
mesh runs on a single GPU.  The codecs still run on the card; only the
packed bytes cross the host, as they would cross a slow network.  The
transport records every call it makes by plane, kind, dtype and bytes,
so a run can hold its traffic against the wire registry's byte models
and manifests (`repro_torch.comm.wires`).  The distributed trainer's
expert parallelism sends its MoE dispatch buffers across the data group
by all-to-all (`RingGroup.all_to_all`, the ``ep`` plane), an autograd
function whose backward is the inverse all-to-all.

ZeRO-3 (`repro_torch.training.pipeline.StageFsdp`) gathers a unit's
weight shards over the data group in one flat all-gather on the
``fsdp`` plane (`RingGroup.all_gather_sunk`), and under expert
parallelism exchanges expert weights by one all-to-all on the same
plane (`RingGroup.all_to_all_sunk`).  Both are autograd functions whose
backward sends nothing: it hands the whole weights' gradients to a
sink, the trainer's f32 accumulators, and gives the shards none.
"""
from __future__ import annotations

import collections
import datetime
import os
import queue
import shutil
import tempfile
import traceback
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DTYPE_NAMES = {torch.float32: "f32", torch.float16: "f16", torch.int32: "s32",
               torch.uint8: "u8"}


@dataclass(frozen=True)
class MeshShape:
    """A ``(data, model)`` process grid."""
    data: int
    model: int

    def __post_init__(self):
        if self.data < 1 or self.model < 1:
            raise ValueError(f"mesh {self.data} x {self.model}: both axes "
                             f"must be >= 1")

    @property
    def world(self) -> int:
        return self.data * self.model

    def rank(self, d: int, k: int) -> int:
        """Row-major rank of data rank d, model rank k."""
        return d * self.model + k

    def coords(self, rank: int) -> tuple:
        """(data rank, model rank) of a global rank."""
        return divmod(rank, self.model)


class _Pending:
    """A posted permute: wait() returns the received tensor."""

    def __init__(self, transport, reqs, host_out, keep):
        self._t, self._reqs, self._out, self._keep = transport, reqs, \
            host_out, keep

    def wait(self) -> torch.Tensor:
        for r in self._reqs:
            r.wait()
        self._keep = None
        return self._t.to_device(self._out)


class Transport:
    """gloo calls staged through host memory, each recorded as ``(plane,
    kind, dtype, bytes)``.  Kinds: ``send`` and ``recv`` (a pipeline
    hop), ``collective-permute`` (the send half of a ring rotation, whose
    receive half is not recorded: every rank sends one), ``all-reduce``
    and ``all-gather`` (recorded with the bytes this rank sends: its
    tensor to each other member of the group), and ``all-to-all``
    (recorded with the bytes this rank sends: its slices for the other
    members).  It also keeps the largest buffer an all-gather filled, by
    plane (`largest_gather`)."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.calls: list = []
        self.largest: dict = {}

    # -- staging ----------------------------------------------------------

    def to_host(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if t.device.type == "cpu":
            return t.contiguous()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)                        # synchronous device -> host
        return h

    def _host_empty(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def to_device(self, h: torch.Tensor) -> torch.Tensor:
        return h if self.device.type == "cpu" else h.to(self.device)

    def _record(self, plane: str, kind: str, t: torch.Tensor,
                copies: int = 1) -> None:
        self.calls.append((plane, kind, DTYPE_NAMES.get(t.dtype, str(t.dtype)),
                           copies * t.numel() * t.element_size()))

    # -- calls --------------------------------------------------------------

    def send(self, x: torch.Tensor, dst: int, plane: str) -> None:
        """Blocking send of x to global rank dst."""
        self._record(plane, "send", x)
        dist.send(self.to_host(x), dst)

    def recv(self, shape, dtype, src: int, plane: str, *,
             host: bool = False) -> torch.Tensor:
        """Blocking receive of a (shape, dtype) tensor from global rank
        src, on this rank's device (with ``host``, in host memory)."""
        h = self._host_empty(shape, dtype)
        dist.recv(h, src)
        self._record(plane, "recv", h)
        return h if host else self.to_device(h)

    def permute_start(self, x: torch.Tensor, dst: int, src: int,
                      plane: str) -> _Pending:
        """Post the send of x to dst and the receive of a tensor like x
        from src; `_Pending.wait` returns it.  Every rank of a rotation
        posts both halves, so none waits on another's order."""
        self._record(plane, "collective-permute", x)
        hx = self.to_host(x)
        out = self._host_empty(x.shape, x.dtype)
        reqs = [dist.isend(hx, dst), dist.irecv(out, src)]
        return _Pending(self, reqs, out, hx)

    def all_reduce(self, x: torch.Tensor, op, group, plane: str
                   ) -> torch.Tensor:
        """Reduce x over ``group`` (None = every rank); returns the
        result on this rank's device (x is not modified)."""
        self._record(plane, "all-reduce", x)
        h = self.to_host(x)
        if h.data_ptr() == x.data_ptr():
            h = h.clone()
        dist.all_reduce(h, op=op, group=group)
        return self.to_device(h)

    def all_gather(self, x: torch.Tensor, out: torch.Tensor,
                   ranks: Sequence[int], plane: str) -> torch.Tensor:
        """Gather x from each of ``ranks`` (global ranks, this one among
        them) into ``out`` (len(ranks), *x.shape) on this rank's device,
        member j's in slot j, through pinned host memory: one send to
        each other member and one receive from each, all posted at once
        (gloo's own all-gather was the slower of the two between the
        ranks of one host).  Returns out."""
        self._record(plane, "all-gather", x, copies=len(ranks) - 1)
        self.largest[plane] = max(self.largest.get(plane, 0),
                                  out.numel() * out.element_size())
        me = dist.get_rank()
        hx = self.to_host(x)
        host = self._host_empty(out.shape, out.dtype)
        reqs = []
        for slot, r in zip(host, ranks):
            if r == me:
                slot.copy_(hx)
            else:
                reqs += [dist.isend(hx, r), dist.irecv(slot, r)]
        for q in reqs:
            q.wait()
        out.copy_(host)
        return out

    def all_to_all(self, x: torch.Tensor, group, size: int, plane: str
                   ) -> torch.Tensor:
        """Split x (size, ...) along dim 0 over the ``size`` ranks of
        ``group``, member j getting slice j, through pinned host memory;
        returns (size, ...) on this rank's device, member j's slice for
        this rank in slot j."""
        self._record(plane, "all-to-all", x[0], copies=size - 1)
        hx = self.to_host(x.contiguous())
        out = self._host_empty(x.shape, x.dtype)
        dist.all_to_all_single(out, hx, group=group)
        return self.to_device(out)

    # -- accounting ---------------------------------------------------------

    def bytes_sent(self, plane: str) -> int:
        """Bytes this rank put on the network for ``plane``."""
        return sum(b for p, kind, _, b in self.calls
                   if p == plane and kind != "recv")

    def manifest(self, plane: str) -> list:
        """This rank's sending calls of ``plane`` as sorted ``(kind,
        dtype, bytes, count)`` rows, the form of a wire's
        ``expected_collectives``."""
        c = collections.Counter((kind, dt, b) for p, kind, dt, b in self.calls
                                if p == plane and kind != "recv")
        return sorted((k, dt, b, n) for (k, dt, b), n in c.items())

    def largest_gather(self, plane: str) -> int:
        """The bytes of the largest buffer one all-gather of ``plane``
        filled (the gathered whole, this rank's part included)."""
        return self.largest.get(plane, 0)

    def reset(self) -> None:
        self.calls, self.largest = [], {}


class RingGroup:
    """The ranks of one data group in ring order, as one rank sees it."""

    def __init__(self, ranks: Sequence[int], me: int, pg, transport):
        self.ranks = tuple(ranks)
        self.index = self.ranks.index(me)
        self.pg = pg
        self.transport = transport

    @property
    def size(self) -> int:
        return len(self.ranks)

    def permute_start(self, x: torch.Tensor, shift: int,
                      plane: str = "dp") -> _Pending:
        """Rotation by ``shift``: ring member i sends x to member
        (i + shift) mod n and receives from (i - shift) mod n."""
        n, i = self.size, self.index
        return self.transport.permute_start(
            x, self.ranks[(i + shift) % n], self.ranks[(i - shift) % n],
            plane)

    def permute(self, x: torch.Tensor, shift: int,
                plane: str = "dp") -> torch.Tensor:
        return self.permute_start(x, shift, plane).wait()

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM,
                   plane: str = "dp") -> torch.Tensor:
        """Reduce over the ring's ranks (a ring of one returns x)."""
        if self.size == 1:
            return x
        return self.transport.all_reduce(x, op, self.pg, plane)

    def all_gather(self, x: torch.Tensor, out: torch.Tensor,
                   plane: str = "dp-gather") -> torch.Tensor:
        """Every member's x into ``out`` (size, *x.shape), member j's in
        slot j (a ring of one copies x to slot 0)."""
        if self.size == 1:
            out[0].copy_(x)
            return out
        return self.transport.all_gather(x, out, self.ranks, plane)

    def all_to_all(self, x: torch.Tensor, plane: str = "ep"
                   ) -> torch.Tensor:
        """x (size, ...): member j's slice j of every member's x, in slot
        j (a ring of one returns x).  Differentiable: the backward sends
        the gradient back by the inverse all-to-all, which every member
        runs in the same order as its forward ones."""
        if self.size == 1:
            return x
        return _AllToAll.apply(x, self, plane)

    def all_gather_sunk(self, tensors: Sequence[torch.Tensor],
                        assemble: Callable, sink: Callable,
                        plane: str = "fsdp") -> tuple:
        """Every member's ``tensors``, flattened into one buffer, gathered
        as `all_gather` lays them out ((size, n), member j's in row j;
        the members' n must agree) and turned into whole tensors by
        ``assemble(rows)``.  Differentiable: the backward hands the whole
        tensors' gradients to ``sink(grads)`` and gives ``tensors``
        none, so nothing crosses the group backward."""
        def collect(*ts):
            flat = torch.cat([t.reshape(-1) for t in ts])
            out = flat.new_empty((self.size, flat.numel()))
            return tuple(assemble(self.all_gather(flat, out, plane)))
        return _Sunk.apply(collect, sink, *tensors)

    def all_to_all_sunk(self, x: torch.Tensor, assemble: Callable,
                        sink: Callable, plane: str = "fsdp") -> tuple:
        """`all_to_all` of x (size, ...) turned into whole tensors by
        ``assemble(received)``, differentiable as `all_gather_sunk`: the
        backward hands their gradients to ``sink`` and sends nothing."""
        def collect(t):
            return tuple(assemble(self.transport.all_to_all(
                t, self.pg, self.size, plane)))
        return _Sunk.apply(collect, sink, x)


class _Sunk(torch.autograd.Function):
    """Tensors ``collect(*inputs)`` makes over a collective (new tensors,
    no views of the inputs); the backward passes their gradients to
    ``sink`` and returns none to the inputs."""

    @staticmethod
    def forward(ctx, collect, sink, *inputs):
        ctx.sink, ctx.n = sink, len(inputs)
        return collect(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.sink(grads)
        return (None, None) + (None,) * ctx.n


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, plane):
        ctx.group, ctx.plane = group, plane
        return group.transport.all_to_all(x, group.pg, group.size, plane)

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        return group.transport.all_to_all(g, group.pg, group.size,
                                          ctx.plane), None, None


class Mesh:
    """One rank's view of the process mesh.  Construct it on every rank
    (it creates one gloo group per model column, a collective call)."""

    def __init__(self, shape: MeshShape, rank: int, device):
        self.shape = shape
        self.rank = rank
        self.data_rank, self.model_rank = shape.coords(rank)
        self.transport = Transport(device)
        self.device = self.transport.device
        groups = []
        for k in range(shape.model):            # same order on every rank
            ranks = [shape.rank(d, k) for d in range(shape.data)]
            groups.append((ranks, dist.new_group(ranks, backend="gloo")
                           if shape.data > 1 else None))
        ranks, pg = groups[self.model_rank]
        self.data_group = RingGroup(ranks, rank, pg, self.transport)

    def stage_rank(self, k: int) -> int:
        """Global rank of model rank k in this rank's data row."""
        return self.shape.rank(self.data_rank, k)


# ---------------------------------------------------------------------------
# process start-up
# ---------------------------------------------------------------------------

def _entry(fn, rank, world, init_file, results, threads, args):
    torch.set_num_threads(threads)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(minutes=10))
        out = fn(rank, world, *args)
        results.put((rank, "ok", out))
    except BaseException:                  # reported to the parent
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), *,
          timeout: float = 600.0, store_dir: Optional[str] = None,
          threads: int = 1) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes joined
    by a gloo process group (a file store under ``store_dir``, or a new
    temporary directory), and return their results by rank.  ``fn``
    must be importable (a module-level function) and return picklable
    values.  A rank that raises, or a run that outlasts ``timeout``
    seconds, stops every process and raises here."""
    ctx = mp.get_context("spawn")
    own_dir = store_dir is None
    store_dir = tempfile.mkdtemp(prefix="repro_torch_mesh_") if own_dir \
        else str(store_dir)
    init_file = os.path.join(store_dir, f"store-{os.getpid()}-{id(fn)}")
    results = ctx.Queue()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, init_file,
                                               results, threads, args),
                         daemon=True)
             for r in range(world)]
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    out, error = {}, None
    try:
        for p in procs:
            p.start()
        while len(out) < world and error is None:
            left = (deadline - datetime.datetime.now()).total_seconds()
            if left <= 0:
                error = f"timed out after {timeout:.0f} s with ranks " \
                        f"{sorted(set(range(world)) - set(out))} unfinished"
                break
            try:
                rank, status, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    error = f"a rank exited with code {dead[0]} " \
                            f"without a result"
                continue
            if status == "ok":
                out[rank] = value
            else:
                error = f"rank {rank} failed:\n{value}"
        for p in procs:
            p.join(timeout=30 if error is None else 1)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        if own_dir:
            shutil.rmtree(store_dir, ignore_errors=True)
    if error is not None:
        raise RuntimeError(f"distributed run failed: {error}")
    return [out[r] for r in range(world)]
