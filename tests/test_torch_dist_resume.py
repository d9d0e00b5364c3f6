"""Per-rank checkpoints and resume in the distributed trainer
(`repro_torch.training.pipeline`), on the CPU.

One spawn of a 2 x 2 gloo mesh (``gpt2-xl-paper`` SMOKE, aqsgd fw 4 /
bw 8 deterministic, DP 4-bit) runs, for each of ``psum``, ``ring`` and
``ring-sharded``: 4 uninterrupted steps; the same run stopped after
step 2 (checkpoints every 2 steps, the optimizer's schedule still that
of 4 steps); and a resume to step 4.  The resumed steps 2 and 3 equal
the uninterrupted run's bit for bit on every rank, the buffer replicas
and tied-embedding copies hold after every resumed step, and each rank
wrote its own ``rank_<data>_<model>`` directory.  On ``ring`` a fourth
run stops after step 2 with checkpoints every step, one rank's step-2
checkpoint is then removed, and the resume starts from step 1, the
newest step every rank committed (the warm-up epoch's second step is
replayed).

This module imports no JAX: each spawned rank imports it for its
worker function.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ck
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import MeshShape, spawn
from repro_torch.training import pipeline as PL


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SPAWN_TIMEOUT = 240.0
WIRES = ("psum", "ring", "ring-sharded")
DROPPED = (1, 0)        # the rank (data, model) that loses its step 2


def _spec(wire, ckpt_dir, *, steps=4, save_every=0, resume=False):
    args = tlaunch.build_parser().parse_args(
        ["--device", "cpu", "--smoke", "--distributed", "--data-par", "2",
         "--stages", "2", "--mode", "aqsgd", "--fw-bits", "4",
         "--bw-bits", "8", "--dp-grad-bits", "4", "--dp-wire", wire,
         "--no-stochastic", "--steps", "4", "--seq", "16", "--samples",
         "8", "--batch", "4", "--ckpt-dir", ckpt_dir, "--save-every",
         str(save_every), *(["--resume"] if resume else [])])
    spec = tlaunch.distributed_spec(args, torch.device("cpu"))
    spec["steps"] = steps            # the schedule stays that of 4 steps
    return spec


def resume_worker(rank, world, runs):
    """Every (label, spec) of ``runs`` in turn; before a spec marked
    ``drop``, the rank at `DROPPED` removes its own newest checkpoint."""
    out = {}
    for label, spec in runs:
        if spec.pop("drop", False) and \
                MeshShape(2, 2).coords(rank) == DROPPED:
            shutil.rmtree(os.path.join(spec["ckpt_dir"], "rank_%d_%d"
                                       % DROPPED, "step_00000002"))
        out[label] = PL.train_rank(rank, world, spec)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_resume")
    plan = []
    for wire in WIRES:
        d = str(root / wire)
        plan += [(f"{wire}/base", _spec(wire, "")),
                 (f"{wire}/stop", _spec(wire, d, steps=2, save_every=2)),
                 (f"{wire}/resume", _spec(wire, d, resume=True))]
    d = str(root / "drop")
    plan += [("drop/stop", _spec("ring", d, steps=2, save_every=1)),
             ("drop/resume", dict(_spec("ring", d, resume=True),
                                  drop=True))]
    out = spawn(resume_worker, 4, (plan,), timeout=SPAWN_TIMEOUT,
                store_dir=str(root))
    return root, out


@pytest.mark.parametrize("wire", WIRES)
def test_stop_and_resume_bit_parity(wire, runs):
    root, out = runs
    for r in out:
        base, stop, res = (r[f"{wire}/{k}"] for k in
                           ("base", "stop", "resume"))
        assert len(base["losses"]) == 4 and np.isfinite(base["losses"]).all()
        assert stop["losses"] == base["losses"][:2]
        assert res["start"] == 2 and res["losses"] == base["losses"][2:]
        assert [c["op"] for c in stop["ckpt"]] == ["save"]
        assert res["ckpt"][0]["op"] == "restore" and \
            res["ckpt"][0]["step"] == 2 and res["ckpt"][0]["bytes"] > 0
        d, k = res["data_rank"], res["model_rank"]
        for rep in res["replicas"]:
            if k == 1:
                assert rep["m_in_equal"] is True
                assert rep["embed_equal"] is True
        own = os.path.join(str(root / wire), f"rank_{d}_{k}")
        assert ck.checkpoint_steps(own) == [2]
    assert sorted(os.listdir(str(root / wire))) == [
        "rank_0_0", "rank_0_1", "rank_1_0", "rank_1_1"]


def test_resume_takes_the_newest_step_every_rank_committed(runs):
    root, out = runs
    for r in out:
        base = r["ring/base"]["losses"]
        res = r["drop/resume"]
        assert r["drop/stop"]["losses"] == base[:2]
        assert res["start"] == 1 and res["losses"] == base[1:]
        d, k = res["data_rank"], res["model_rank"]
        own = os.path.join(str(root / "drop"), f"rank_{d}_{k}")
        want = [1] if (d, k) == DROPPED else [1, 2]
        assert ck.checkpoint_steps(own) == want
