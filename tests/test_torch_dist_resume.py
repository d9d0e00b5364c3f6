"""The distributed trainer's checkpoints in the JAX launcher's global
layout (`repro_torch.training.pipeline_state`), resumed in the port,
on the CPU.

One spawn of a 2 x 2 gloo mesh (``gpt2-xl-paper`` SMOKE, aqsgd fw 4 /
bw 8 deterministic, DP 4-bit, 8 samples, so each data rank's message
rows 4-7 lie past the JAX layout's ``samples // D`` and go to the
``torch_rows`` sidecar) runs, for each case: 4 uninterrupted steps;
the same run stopped after step 2 (a checkpoint every 2 steps, the
optimizer's schedule still that of 4 steps); and a resume to step 4.
The cases: the ``psum``, ``ring`` and ``ring-sharded`` DP wires, 8-bit
AdamW moments, 8-bit z-bit message buffers, and ``deepseek-moe-16b``
SMOKE under expert parallelism.  The resumed steps 2 and 3 equal the
uninterrupted run's bit for bit on every rank, the buffer replicas and
tied-embedding copies hold after every resumed step, and the directory
holds ``step_*`` entries and the sidecar and no per-rank directory.
One rank writes and one reads: rank 0's are the bytes on disk, the
others' zero, and rank 0 sends the others at the restore exactly their
slots, a header each and, under the ZeRO wire, the parameter bucket.
On ``ring`` a further run stops after step 2 with a checkpoint every
step, the newest ``step_*`` is then removed, and the resume starts
from step 1, as JAX's ``latest_step`` picks (the warm-up epoch's
second step is replayed); a resume from an empty directory raises on
every rank.  The ``ring`` and ``ring-sharded`` runs are
bit-equal, so the ZeRO checkpoint's (D, seg, group_d) moments,
flattened, are the ``ring`` checkpoint's per-leaf moments in the DP
bucket's order, bit for bit.

This module imports no JAX: each spawned rank imports it for its
worker function.
"""
import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import checkpoint as ck
from repro_torch.configs.base import get_config
from repro_torch.core import grad_compress as GC
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import spawn
from repro_torch.training import pipeline as PL
from repro_torch.training import pipeline_state as PS


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SPAWN_TIMEOUT = 300.0
# case -> (extra launcher flags, spec changes)
CASES = {
    "psum": (["--dp-wire", "psum"], {}),
    "ring": ([], {}),
    "ring-sharded": (["--dp-wire", "ring-sharded"], {}),
    "adam8": ([], {"state_bits": 8}),
    "zbit8": (["--buffer-bits", "8"], {}),
    "moe-ep": (["--arch", "deepseek-moe-16b"],
               {"pipeline": {"moe_mode": "expert_parallel"}}),
}


def _spec(case, ckpt_dir, *, steps=4, save_every=0, resume=False):
    flags, change = CASES[case]
    args = tlaunch.build_parser().parse_args(
        ["--device", "cpu", "--smoke", "--distributed", "--data-par", "2",
         "--stages", "2", "--mode", "aqsgd", "--fw-bits", "4",
         "--bw-bits", "8", "--dp-grad-bits", "4", "--no-stochastic",
         "--steps", "4", "--seq", "16", "--samples", "8", "--batch", "4",
         "--ckpt-dir", ckpt_dir, "--save-every", str(save_every),
         *(["--resume"] if resume else []), *flags])
    spec = tlaunch.distributed_spec(args, torch.device("cpu"))
    spec["steps"] = steps            # the schedule stays that of 4 steps
    if "state_bits" in change:
        spec["optimizer"]["state_bits"] = change["state_bits"]
    if "pipeline" in change:
        spec["pipeline"] = change["pipeline"]
    return spec


def _scatter_bytes(case) -> int:
    """The bytes rank 0 sends the other ranks at a restore: a 24-byte
    header each, every slot of theirs (`pipeline_state.places`) and,
    under the ZeRO wire, the full-model parameter bucket."""
    lo = PS.spec_layout(_spec(case, ""))
    trees = {"main": PS.global_structs(lo), "rows": PS.rows_structs(lo)}
    rows = GC.ring_segment_rows(lo.bucket.rows, lo.data) * lo.data
    total = 0
    for r in range(1, lo.data * lo.stages):
        total += 24 + (rows * lo.bucket.group_d * 4 if lo.zero else 0)
        for pl in PS.places(lo, *divmod(r, lo.stages)):
            slot = PS.leaf(trees[pl.tree], pl.dst)[pl.index]
            total += slot.numel() * slot.element_size()
    return total


def resume_worker(rank, world, runs):
    """Every (label, spec) of ``runs`` in turn; before a spec marked
    ``drop``, rank 0 removes the newest committed ``step_*`` and every
    rank waits for it; a spec marked ``fails`` gives the message of the
    `CheckpointError` it raises."""
    out = {}
    for label, spec in runs:
        if spec.pop("drop", False):
            if rank == 0:
                d = spec["ckpt_dir"]
                shutil.rmtree(os.path.join(d, "step_%08d"
                                           % ck.latest_step(d)))
            dist.barrier()
        if spec.pop("fails", False):
            try:
                PL.train_rank(rank, world, spec)
            except ck.CheckpointError as e:
                out[label] = str(e)
            continue
        out[label] = PL.train_rank(rank, world, spec)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_resume")
    plan = []
    for case in CASES:
        d = str(root / case)
        plan += [(f"{case}/base", _spec(case, "")),
                 (f"{case}/stop", _spec(case, d, steps=2, save_every=2)),
                 (f"{case}/resume", _spec(case, d, resume=True))]
    d = str(root / "drop")
    plan += [("drop/stop", _spec("ring", d, steps=2, save_every=1)),
             ("drop/resume", dict(_spec("ring", d, resume=True),
                                  drop=True)),
             ("empty/resume", dict(_spec("ring", str(root / "empty"),
                                         resume=True), fails=True))]
    out = spawn(resume_worker, 4, (plan,), timeout=SPAWN_TIMEOUT,
                store_dir=str(root))
    return root, out


@pytest.mark.parametrize("case", list(CASES))
def test_stop_and_resume_bit_parity(case, runs):
    root, out = runs
    # a tied embedding's two copies are compared; an untied model has
    # one and checks none
    tied = get_config(_spec(case, "")["arch"], smoke=True).tie_embeddings
    for r in out:
        base, stop, res = (r[f"{case}/{k}"] for k in
                           ("base", "stop", "resume"))
        assert len(base["losses"]) == 4 and np.isfinite(base["losses"]).all()
        assert stop["losses"] == base["losses"][:2]
        assert res["start"] == 2 and res["losses"] == base["losses"][2:]
        assert [c["op"] for c in stop["ckpt"]] == ["save"]
        got = res["ckpt"][0]
        assert got["op"] == "restore" and got["step"] == 2 \
            and got["rows"] is True
        for rep in res["replicas"]:
            if res["model_rank"] == 1:
                assert rep["m_in_equal"] is True
                assert rep["embed_equal"] is (True if tied else None)
    d = str(root / case)
    assert sorted(os.listdir(d)) == ["step_00000002", PS.ROWS_DIR]
    assert ck.checkpoint_steps(PS.rows_dir(d)) == [2]
    on_disk = ck.checkpoint_nbytes(d, 2) \
        + ck.checkpoint_nbytes(PS.rows_dir(d), 2)
    # one writer: only rank 0 wrote bytes, every rank sent on `ckpt`
    saves = [r[f"{case}/stop"]["ckpt"][0] for r in out]
    assert saves[0]["bytes"] == on_disk
    assert [s["bytes"] for s in saves[1:]] == [0, 0, 0]
    assert saves[0]["ckpt_plane_bytes"] == 0
    assert all(s["ckpt_plane_bytes"] > 0 for s in saves[1:])
    # one reader: rank 0 read both steps and sent the others their parts
    restores = [r[f"{case}/resume"]["ckpt"][0] for r in out]
    assert restores[0]["bytes"] == on_disk
    assert [c["bytes"] for c in restores[1:]] == [0, 0, 0]
    assert [c["ckpt_plane_bytes"] for c in restores[1:]] == [0, 0, 0]
    assert restores[0]["ckpt_plane_bytes"] == _scatter_bytes(case)


def test_resume_takes_the_newest_committed_step(runs):
    root, out = runs
    for r in out:
        base = r["ring/base"]["losses"]
        res = r["drop/resume"]
        assert r["drop/stop"]["losses"] == base[:2]
        assert res["start"] == 1 and res["losses"] == base[1:]
    assert ck.checkpoint_steps(str(root / "drop")) == [1]


def test_a_failed_read_raises_on_every_rank(runs):
    """Rank 0 alone reads the checkpoint: where it finds none, it raises
    and tells the others, which raise too instead of waiting."""
    _, out = runs
    assert "no committed checkpoint" in out[0]["empty/resume"]
    for r in out[1:]:
        assert "rank (0, 0) could not restore it" in r["empty/resume"]


def test_zero_segments_are_the_ring_moments_in_bucket_order(runs):
    """``ring`` and ``ring-sharded`` run bit-equal, so the ZeRO
    checkpoint's moment segments, flattened, are the per-leaf moments
    of the ``ring`` checkpoint written into the DP bucket's order."""
    root, out = runs
    assert out[0]["ring/base"]["losses"] == \
        out[0]["ring-sharded/base"]["losses"]
    lo = PS.spec_layout(_spec("ring", ""))
    zero = PS.spec_layout(_spec("ring-sharded", ""))
    ring = ck.restore_state(str(root / "ring"), PS.global_structs(lo))[0]
    sharded = ck.restore_state(str(root / "ring-sharded"),
                               PS.global_structs(zero))[0]
    # past the model's values the segments hold the padding rows' own
    # moments (an odd number of code levels leaves a zero gradient a
    # nonzero mean), which no per-leaf moment has
    n = lo.bucket.total
    for m in ("mu", "nu"):
        flat = PS.bucket_of(lo, ring["opt"][m], lo.bucket.rows).reshape(-1)
        seg = sharded["opt"][m].reshape(-1)
        assert flat[:n].abs().sum() > 0 and not flat[n:].any()
        assert torch.equal(flat[:n].view(torch.int32),
                           seg[:n].view(torch.int32)), m
    assert ring["opt"]["step"] == sharded["opt"]["step"] == 2
    for a, b in zip(ck.flatten_tree(ring["params"]).values(),
                    ck.flatten_tree(sharded["params"]).values()):
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
