"""The port's process mesh (`repro_torch.launch.mesh`) over gloo
processes on the CPU.

`spawn` runs a function on every rank and returns the results by rank,
or raises with the failing rank's traceback; `Mesh` lays ranks out
row-major over ``(data, model)`` (rank = d * K + k, the index order of
the JAX package's ``make_debug_mesh``) with one data group per model
column; the `Transport` stages every payload through host memory and
records each call by plane, kind, dtype and bytes.

This file imports no JAX, so the spawned ranks of
tests/test_torch_ring.py, tests/test_torch_zero.py,
tests/test_torch_moe_dist.py and tests/test_torch_oncore.py import their
workers (`wire_worker`, `zero_worker`, `ep_worker`, `knob_worker`) from
here without loading JAX in every process.  The all-to-all (`RingGroup.all_to_all`, an autograd function
whose backward is the inverse all-to-all) is tested here too.
"""
import os

import pytest
import torch
import torch.distributed as dist

from repro_torch.comm import wires as TW
from repro_torch.core import collectives as TC
from repro_torch.env import ONCORE_PRNG
from repro_torch.kernels import ref as TR
from repro_torch.launch.mesh import Mesh, MeshShape, RingGroup, spawn


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SPAWN_TIMEOUT = 120
# the DP wires held against the simulator: (wire, chunks)
CASES = [("psum", 1), ("ring", 1), ("ring", 2), ("ring", 3)]
# the wires driven with a generator under the on-core noise knob
SEEDED = [("psum", 1), ("ring", 1), ("ring-sharded", 1), ("ring", 2),
          ("ring", 3), ("ring-sharded", 2)]


def wire_generator(step, rank):
    """The generator a rank's DP wire is handed at ``step`` in
    `wire_worker`'s seeded cases."""
    return torch.Generator().manual_seed(1000 + 10 * step + rank)


def _seeded_cases(mesh, rank, inputs) -> dict:
    """Every wire of SEEDED, stochastic, two steps, handed
    `wire_generator` and no noise: on the cuda backend (its plain
    versions, these being CPU tensors) with the on-core noise knob on
    (``"1"``) and off (``"0"``), and on the reference backend fed the
    knob's stream (``"oncore-u"``: `oncore_uniform_ref` under the seed
    the generator gives) and the generator's draw (``"drawn-u"``).
    {(variant, wire, chunks): [(mean, carry) a step]}."""
    shape, out = inputs["shape"], {}
    was = os.environ.get(ONCORE_PRNG)
    try:
        for wire, chunks in SEEDED:
            spec = TW.get_wire(wire)
            kw = {"chunks": chunks} if spec.chunkable else {}
            for variant in ("1", "0", "oncore-u", "drawn-u"):
                os.environ[ONCORE_PRNG] = "1" if variant == "1" else "0"
                err, got = torch.zeros(shape), []
                for step in range(2):
                    gen = wire_generator(step, rank)
                    noise = {"generator": gen, "backend": "cuda"}
                    if variant == "oncore-u":
                        seed = torch.randint(-2 ** 31, 2 ** 31, (2,),
                                             generator=gen,
                                             dtype=torch.int32)
                        noise = {"u": TR.oncore_uniform_ref(seed, *shape),
                                 "backend": "reference"}
                    elif variant == "drawn-u":
                        noise = {"u": torch.rand(shape, generator=gen),
                                 "backend": "reference"}
                    mean, err = spec.collective(
                        torch.from_numpy(inputs["v"][step][rank]), err,
                        mesh.data_group, inputs["bits"], stochastic=True,
                        **noise, **kw)
                    got.append((mean.numpy(), err.numpy().copy()))
                out[(variant, wire, chunks)] = got
    finally:
        if was is None:
            os.environ.pop(ONCORE_PRNG, None)
        else:
            os.environ[ONCORE_PRNG] = was
    return out


def wire_worker(rank, world, inputs):
    """Rank ``rank`` of an n-rank ring: every case of CASES, two steps
    each, deterministic then stochastic, and `_seeded_cases`.  Returns
    means, carries, bytes and manifests (numpy and plain data)."""
    mesh = Mesh(MeshShape(world, 1), rank, "cpu")
    out = _seeded_cases(mesh, rank, inputs)
    for stochastic in (False, True):
        for wire, chunks in CASES:
            spec = TW.get_wire(wire)
            kw = {"chunks": chunks} if spec.chunkable else {}
            err = torch.zeros(inputs["shape"])
            got = []
            for step in range(2):
                mesh.transport.reset()
                u = torch.from_numpy(inputs["noise"][step][rank]) \
                    if stochastic else None
                mean, err = spec.collective(
                    torch.from_numpy(inputs["v"][step][rank]), err,
                    mesh.data_group, inputs["bits"], stochastic=stochastic,
                    u=u, backend="reference", **kw)
                got.append((mean.numpy(), err.numpy().copy(),
                            mesh.transport.bytes_sent("dp"),
                            mesh.transport.manifest("dp")))
            out[(stochastic, wire, chunks)] = got
    return out


def knob_worker(rank, world, spec):
    """The distributed trainer's run of ``spec`` on this rank
    (`training.pipeline.train_rank`) with the on-core noise knob on,
    then off: [losses, losses]."""
    from repro_torch.training import pipeline as PL
    was, out = os.environ.get(ONCORE_PRNG), []
    try:
        for knob in ("1", "0"):
            os.environ[ONCORE_PRNG] = knob
            out.append(PL.train_rank(rank, world, spec)["losses"])
    finally:
        if was is None:
            os.environ.pop(ONCORE_PRNG, None)
        else:
            os.environ[ONCORE_PRNG] = was
    return out


def zero_worker(rank, world, inputs):
    """Rank ``rank`` of a 3-rank world, over the whole world (n = 3) and
    over ranks {0, 1} (n = 2): the ZeRO wire (chunks 1 and 2, two steps
    with the noise in ``inputs``), the fp16 wire (two steps), the
    segments' all-gather and `quantized_psum_mean` (deterministic).
    Returns numpy results, bytes and manifests by (n, case)."""
    mesh = Mesh(MeshShape(world, 1), rank, "cpu")
    pg2 = dist.new_group([0, 1], backend="gloo")    # every rank calls it
    groups = {3: mesh.data_group}
    if rank < 2:
        groups[2] = RingGroup([0, 1], rank, pg2, mesh.transport)
    tr, out = mesh.transport, {}
    for n, group in groups.items():
        for wire, chunks in (("ring-sharded", 1), ("ring-sharded", 2),
                             ("fp16", 1)):
            spec = TW.get_wire(wire)
            kw = {"chunks": chunks} if spec.chunkable else {}
            err = torch.zeros(inputs["shape"])
            got = []
            for step in range(2):
                tr.reset()
                mean, err = spec.collective(
                    torch.from_numpy(inputs["v"][n][step][rank]), err, group,
                    inputs["bits"], stochastic=True,
                    u=torch.from_numpy(inputs["noise"][n][step][rank]),
                    backend="reference", **kw)
                got.append((mean.numpy(), err.numpy().copy(),
                            tr.bytes_sent("dp"), tr.manifest("dp")))
            out[(n, wire, chunks)] = got
        tr.reset()
        seg = torch.full((3, 4), float(rank))
        gathered = group.all_gather(seg, torch.empty(n, 3, 4))
        out[(n, "gather")] = (gathered.numpy(), tr.bytes_sent("dp-gather"),
                              tr.manifest("dp-gather"))
        out[(n, "psum-mean")] = TC.quantized_psum_mean(
            torch.from_numpy(inputs["x"][rank]), group, inputs["bits"],
            stochastic=False, backend="reference").numpy()
    return out


def ep_worker(rank, world, inputs):
    """Rank ``rank`` of a ``world`` x 1 mesh: for each case of
    ``inputs["cases"]`` (a port ``ModelConfig``, its MoE weights and this
    rank's x and output gradient as numpy), the expert-parallel
    `moe.moe_ffn` over the data group, then its backward.  Returns the
    outputs, aux, x's and the weights' gradients, and the ``ep`` calls
    (numpy and plain data)."""
    from repro_torch.models import moe as TMoE
    mesh = Mesh(MeshShape(world, 1), rank, "cpu")
    out = []
    for case in inputs["cases"]:
        cfg = case["cfg"]
        m = TMoE.MoE(cfg)
        m.load_state_dict({k: torch.from_numpy(v)
                           for k, v in case["weights"].items()})
        x = torch.from_numpy(case["x"][rank]).requires_grad_()
        mesh.transport.reset()
        y, aux = TMoE.moe_ffn(m, x, top_k=cfg.top_k,
                              capacity_factor=cfg.capacity_factor,
                              ep=mesh.data_group)
        (y * torch.from_numpy(case["g"][rank])).sum().backward()
        out.append({"y": y.detach().numpy(), "aux": aux.item(),
                    "x_grad": x.grad.numpy(),
                    "grads": {n: p.grad.numpy()
                              for n, p in m.named_parameters()},
                    "calls": list(mesh.transport.calls)})
    return out


def _a2a_worker(rank, world):
    mesh = Mesh(MeshShape(world, 1), rank, "cpu")
    x = (torch.arange(world * 2, dtype=torch.float32).reshape(world, 2)
         + 10 * rank).requires_grad_()
    y = mesh.data_group.all_to_all(x)
    (y * torch.arange(1.0, world + 1)[:, None]).sum().backward()
    return {"y": y.detach().tolist(), "grad": x.grad.tolist(),
            "calls": list(mesh.transport.calls)}


def test_all_to_all_and_its_backward(tmp_path):
    """Member j's slice i goes to slot j of member i; the backward sends
    the gradient back (member i's slices all land in slot i, weighted
    i + 1, so their gradient is i + 1); both calls recorded on ``ep``
    with the bytes for the other members."""
    out = spawn(_a2a_worker, 3, timeout=SPAWN_TIMEOUT, store_dir=tmp_path)
    for i, got in enumerate(out):
        assert got["y"] == [[2 * i + 10 * j, 2 * i + 1 + 10 * j]
                            for j in range(3)]
        assert got["grad"] == [[float(i + 1)] * 2] * 3
        assert got["calls"] == [("ep", "all-to-all", "f32", 16)] * 2


def _mesh_worker(rank, world, shape):
    """Exercise every transport call on a (data, model) mesh."""
    mesh = Mesh(MeshShape(*shape), rank, "cpu")
    tr = mesh.transport
    k, kk = mesh.model_rank, mesh.shape.model
    x = torch.full((3, 5), float(rank))
    got = {"coords": (mesh.data_rank, mesh.model_rank),
           "group": mesh.data_group.ranks}
    if k < kk - 1:
        tr.send(x, mesh.stage_rank(k + 1), "fw")
    if k > 0:
        got["from_prev"] = tr.recv((3, 5), torch.float32,
                                   mesh.stage_rank(k - 1), "fw")[0, 0].item()
    y = mesh.data_group.permute(torch.tensor([rank], dtype=torch.int32), 1)
    got["permuted"] = y.item()
    z = mesh.data_group.all_reduce(torch.tensor([rank], dtype=torch.int32))
    got["group_sum"] = z.item()
    w = tr.all_reduce(torch.ones(2), torch.distributed.ReduceOp.SUM, None,
                      "grad")
    got["world_sum"] = w[0].item()
    got["calls"] = list(tr.calls)
    got["bytes"] = {p: tr.bytes_sent(p) for p in ("fw", "dp", "grad")}
    got["manifest"] = tr.manifest("dp")
    return got


def _failing_worker(rank, world):
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    return rank


def test_mesh_shape_is_row_major():
    s = MeshShape(2, 3)
    assert s.world == 6
    assert [s.rank(d, k) for d in range(2) for k in range(3)] \
        == list(range(6))
    assert [s.coords(r) for r in range(6)] \
        == [(d, k) for d in range(2) for k in range(3)]
    with pytest.raises(ValueError):
        MeshShape(0, 2)


def test_transport_calls_and_groups(tmp_path):
    out = spawn(_mesh_worker, 6, ((3, 2),), timeout=SPAWN_TIMEOUT,
                store_dir=tmp_path)
    for r, got in enumerate(out):
        d, k = divmod(r, 2)
        assert got["coords"] == (d, k)
        assert got["group"] == (k, 2 + k, 4 + k)           # model column k
        assert got["permuted"] == 2 * ((d - 1) % 3) + k    # from ring i-1
        assert got["group_sum"] == k + (2 + k) + (4 + k)
        assert got["world_sum"] == 6.0
        if k == 1:
            assert got["from_prev"] == float(r - 1)
        assert got["bytes"] == {"fw": 60 if k == 0 else 0, "dp": 8,
                                "grad": 8}
        assert got["manifest"] == [("all-reduce", "s32", 4, 1),
                                   ("collective-permute", "s32", 4, 1)]
        kinds = [c[1] for c in got["calls"]]
        assert kinds.count("recv") == (1 if k == 1 else 0)


def test_spawn_reports_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        spawn(_failing_worker, 2, timeout=SPAWN_TIMEOUT, store_dir=tmp_path)
