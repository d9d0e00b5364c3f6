"""The port's fault tolerance on the simulated trainer
(`repro_torch.launch.runner`, the trainer half of
`repro_torch.comm.faults`) — tests/test_faults.py's trainer cases.

* The plan's queries, the internal fault-wrapper wires (registered,
  resolvable, hidden from `list_wires`, the ``--dp-wire`` choices and
  ``--list-wires``), `faulted_comm`, `corrupt_tree`.
* `check_train_state`'s attribution on synthetic states: plane, wire
  and step equal to JAX's `check_train_state` on the same state, in its
  dependency order (buffers before ``dp_error`` before params / opt /
  loss), and on the trainer's own state after a bw injection.
* End to end through `run_sim_training`, on ``gpt2-xl-paper`` SMOKE
  with aqsgd fw 4 / bw 8 and DP 4-bit over 2 workers: with
  checkpointing off it gives `training.simulated.train`'s losses bit for
  bit; a run stopped after 5 steps and resumed gives the uninterrupted
  stream bit for bit on ``psum``, ``ring`` and ``ring-sharded``; each of
  JAX's five fault specs is caught with the injected plane and step
  named, recovered from the last checkpoint, and the losses equal the
  clean run's bit for bit; a fault plan without a checkpoint directory
  and a resume under another seed are refused.
* The launcher in subprocesses: ``--kill-at 7`` exits 17 after step 7's
  line, ``--resume`` replays from step 6, and its loss lines (with the
  loss bits, ``float.hex``) equal an uninterrupted run's; ``--fault``
  recovers to the clean run's lines.
* The embedding's backward adds a repeated token's gradients in one
  order over a pool of threads too (`models.model.embed_rows`), which
  the bit-for-bit replays on a CPU rest on.

The trainers run with one torch thread (the launcher subprocesses
with ``OMP_NUM_THREADS=1``), as a gloo rank does: these tests share
the host with other test workers, where an intra-op pool that waits on
preempted threads slows by an order of magnitude.
"""
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CommConfig as JComm
from repro.comm import faults as JF
from repro_torch import checkpoint as ck
from repro_torch.comm import faults as F
from repro_torch.comm import wires as W
from repro_torch.comm.config import CommConfig
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import Dataset, DatasetConfig
from repro_torch.launch import runner
from repro_torch.launch import train as tlaunch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training import simulated as sim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_embedding_backward_is_reproducible():
    """A gradient through `embed_rows` is the same bits on every call
    over 8 threads, with many repeated tokens (an indexing's backward,
    ``index_put_`` with accumulation, is not)."""
    from repro_torch.models.model import embed_rows
    cfg = get_config("gpt2-xl-paper", smoke=True)
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(cfg.vocab_size, cfg.d_model, generator=gen,
                    requires_grad=True)
    tokens = torch.randint(0, 32, (8, 64), generator=gen)
    g = torch.randn(8, 64, cfg.d_model, generator=gen)
    torch.set_num_threads(8)
    try:
        grads = [torch.autograd.grad((embed_rows(cfg, w, tokens) * g).sum(),
                                     w)[0] for _ in range(20)]
    finally:
        torch.set_num_threads(1)
    assert all(torch.equal(grads[0], x) for x in grads[1:])


# ---------------------------------------------------------------------------
# the plan, the wrapper wires, the corruption
# ---------------------------------------------------------------------------

def test_plan_queries():
    plan = F.FaultPlan.parse("3:dp:nan-scale, 5:fw:drop-hop")
    assert plan.text() == "3:dp:nan-scale,5:fw:drop-hop"
    assert bool(plan)
    assert [s.kind for s in plan.at(3)] == ["nan-scale"]
    assert plan.at(3, "fw") == [] and plan.at(4) == []
    assert F.FaultPlan.parse("") == F.FaultPlan() and not F.FaultPlan()


def test_fault_wire_registered_but_hidden(capsys):
    name = F.fault_wire("ring", "nan-scale")
    assert name == "ring+fault-nan-scale" == JF.fault_wire("ring",
                                                            "nan-scale")
    assert name == F.fault_wire("ring", "nan-scale")    # idempotent
    spec = W.get_wire(name)
    base = W.get_wire("ring")
    assert spec.internal and spec.plane == "dp-grad"
    assert (spec.chunkable, spec.sharded, spec.wire_bytes) == \
        (base.chunkable, base.sharded, base.wire_bytes)
    assert name not in W.wire_names("dp-grad")
    assert name in W.wire_names("dp-grad", include_internal=True)
    assert all(not s.internal for s in W.list_wires())
    choices = next(a for a in tlaunch.build_parser()._actions
                   if a.dest == "dp_wire").choices
    assert name not in choices
    tlaunch.main(["--list-wires"])
    assert "+fault-" not in capsys.readouterr().out


def test_faulted_comm_swaps_wire():
    comm = CommConfig.from_dict({"dp": {"bits": 4, "wire": "ring"}})
    spec = F.FaultSpec(3, "dp", "corrupt-codes")
    fc = F.faulted_comm(comm, spec)
    assert fc.dp.wire == "ring+fault-corrupt-codes"
    assert fc.dp_wire_spec.internal and comm.dp.wire == "ring"
    with pytest.raises(ValueError, match="dp.bits"):
        F.faulted_comm(CommConfig.from_dict({}), spec)


def test_corrupt_tree():
    tree = {"a": torch.ones(2, 3), "b": [torch.ones(4), torch.arange(3)]}
    out = F.corrupt_tree(tree, "nan-scale")
    assert torch.isnan(out["a"]).all() and torch.isnan(out["b"][0]).all()
    assert out["b"][1] is tree["b"][1]                 # ints pass through
    assert torch.equal(tree["a"], torch.ones(2, 3))    # a new tree


# ---------------------------------------------------------------------------
# attribution, against JAX's check_train_state
# ---------------------------------------------------------------------------

COMM_FULL = {"mode": "aqsgd", "fw": {"bits": 4}, "bw": {"bits": 8},
             "dp": {"bits": 4, "wire": "ring"}}


def _clean_state():
    return {
        "params": {"w": np.ones((2, 2), np.float32)},
        "opt": {"mu": {"w": np.zeros((2, 2), np.float32)}},
        "dp_error": np.zeros((2, 8), np.float32),
        "buffers": {"seen": np.asarray([[True, False]]),
                    "m": np.ones((1, 2, 4, 8), np.float32)},
    }


def _dp_nan(s):
    s["dp_error"][0, 0] = np.nan


def _buf_nan_and_dp(s):
    s["buffers"]["m"][0] = np.nan
    s["dp_error"][0, 0] = np.nan


def _buf_drop(s):
    s["buffers"]["m"][0] = 0.0


def _params_big(s):
    s["params"]["w"][:] = 1e32


def _opt_inf(s):
    s["opt"]["mu"]["w"][1, 1] = -np.inf


CASES = {"dp_error": _dp_nan, "buffers_beat_dp_error": _buf_nan_and_dp,
         "buffer_drop_hop_sentinel": _buf_drop, "params_to_bw": _params_big,
         "opt_to_bw": _opt_inf}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(tree)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return [jnp.asarray(a) for a in tree] if tree.ndim == 4 or \
        tree.dtype == bool else jnp.asarray(tree)


@pytest.mark.parametrize("case", list(CASES))
def test_attribution_matches_jax(case):
    s = _clean_state()
    CASES[case](s)
    with pytest.raises(JF.WireFaultError) as je:
        JF.check_train_state(_to_jax(s), comm=JComm.from_dict(COMM_FULL),
                             step=4)
    with pytest.raises(F.WireFaultError) as te:
        F.check_train_state(_to_torch(s),
                            comm=CommConfig.from_dict(COMM_FULL), step=4)
    j, t = je.value, te.value
    assert (t.plane, t.wire, t.step) == (j.plane, j.wire, j.step)
    assert t.detail.split(":")[0] == j.detail.split(":")[0]
    assert f"plane={j.plane} wire={j.wire!r} step=4" in str(t)


def test_check_train_state_clean_and_loss():
    comm = CommConfig.from_dict(COMM_FULL)
    assert F.check_train_state(_to_torch(_clean_state()), comm=comm,
                               step=1, loss=2.5) is None
    for bad in (float("nan"), 3e30):
        with pytest.raises(F.WireFaultError) as e:
            F.check_train_state(_to_torch(_clean_state()), comm=comm,
                                step=4, loss=bad)
        assert e.value.plane == "bw" and "loss" in e.value.detail


def _mk(comm_dict):
    cfg = get_config("gpt2-xl-paper", smoke=True)
    tcfg = sim.SimTrainConfig(
        num_stages=2, comm=CommConfig.from_dict(comm_dict), dp_workers=2,
        optimizer=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=STEPS))
    return cfg, tcfg


def _dataset(cfg):
    return Dataset(DatasetConfig(num_samples=32, seq_len=16,
                                 vocab_size=cfg.vocab_size))


def test_inject_and_check_on_the_trainers_state():
    """On the trainer's own state: a bw fault corrupts the first leaf in
    `jax_leaves` order (the embedding) and is blamed on bw; a fw
    drop-hop zeroes boundary 0's stored messages."""
    cfg, tcfg = _mk(COMM_FULL)
    state = sim.init_train_state(cfg, tcfg, 8, 16, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    comm = tcfg.comm
    state["buffers"]["seen"][0, :3] = True
    state["buffers"]["m"].normal_()
    F.check_train_state(state, comm=comm, step=0)
    F.inject_sim_state(state, F.FaultSpec(2, "bw", "corrupt-codes"), comm)
    with pytest.raises(F.WireFaultError) as e:
        F.check_train_state(state, comm=comm, step=2)
    assert e.value.plane == "bw" and "params embed" in e.value.detail
    F.inject_sim_state(state, F.FaultSpec(2, "fw", "drop-hop"), comm)
    with pytest.raises(F.WireFaultError) as e:
        F.check_train_state(state, comm=comm, step=2)
    assert e.value.plane == "fw"
    assert "boundary 0: 3 seen sample(s)" in e.value.detail


# ---------------------------------------------------------------------------
# end to end through the runner
# ---------------------------------------------------------------------------

def _run(cfg, tcfg, num_steps, *, ckpt_dir="", save_every=0,
         resume=False, fault="", seed=0):
    out = []
    _, losses = runner.run_sim_training(
        cfg, tcfg, _dataset(cfg), num_steps=num_steps, batch_size=4,
        log_every=1, ckpt_dir=ckpt_dir, save_every=save_every,
        resume=resume, fault_plan=F.FaultPlan.parse(fault), seed=seed,
        device="cpu", print_fn=out.append)
    return losses, out


_BASE = {}


def _comm_dict(wire="ring", zbuf=False):
    d = dict(COMM_FULL, dp={"bits": 4, "wire": wire})
    if zbuf:
        d["zbuf"] = {"bits": 4}
    return d


def _base(wire="ring", zbuf=False):
    """The uninterrupted run's losses of a config (computed once)."""
    if (wire, zbuf) not in _BASE:
        cfg, tcfg = _mk(_comm_dict(wire, zbuf))
        _BASE[(wire, zbuf)] = _run(cfg, tcfg, STEPS)[0]
    return _BASE[(wire, zbuf)]


def test_runner_matches_sim_train_bit_for_bit():
    cfg, tcfg = _mk(COMM_FULL)
    _, ref = sim.train(cfg, tcfg, _dataset(cfg), num_steps=STEPS,
                       batch_size=4, device="cpu")
    assert _base() == ref


@pytest.mark.parametrize("wire", ["psum", "ring", "ring-sharded"])
def test_kill_and_resume_bit_parity(wire, tmp_path):
    """Train 5 of 8 steps with checkpoints every 2, stop, resume in a
    fresh call: the two loss streams make the uninterrupted one, bit for
    bit.  EF and stochastic activation compression on."""
    cfg, tcfg = _mk(_comm_dict(wire))
    d = str(tmp_path / wire)
    first, out1 = _run(cfg, tcfg, 5, ckpt_dir=d, save_every=2)
    assert ck.checkpoint_steps(d) == [2, 4, 5]          # keep 3
    assert [o.split(" (")[0] for o in out1 if o.startswith("checkpoint")] \
        == [f"checkpoint: saved step {s}" for s in (0, 2, 4, 5)]
    resumed, out = _run(cfg, tcfg, STEPS, ckpt_dir=d, resume=True)
    assert any(o.startswith("resumed from step 5") for o in out)
    assert first == _base(wire)[:5]
    assert resumed == _base(wire)[5:]


@pytest.mark.parametrize("fault", [
    "4:dp:corrupt-codes", "4:dp:drop-hop", "4:fw:nan-scale",
    "4:bw:corrupt-codes", "4:zbuf:drop-hop"])
def test_fault_detect_attribute_recover_bit_parity(fault, tmp_path):
    """Inject on every plane: the guard names the injected plane, wire
    and step, recovery replays from the last good checkpoint (step 4),
    and the loss stream equals the clean run's bit for bit."""
    plane = fault.split(":")[1]
    zbuf = plane == "zbuf"
    cfg, tcfg = _mk(_comm_dict(zbuf=zbuf))
    losses, out = _run(cfg, tcfg, STEPS, ckpt_dir=str(tmp_path / "ck"),
                       save_every=2, fault=fault)
    tripped = [o for o in out if o.startswith("guard tripped")]
    assert len(tripped) == 1, out
    wire = getattr(tcfg.comm, plane).wire
    assert f"plane={plane} wire={wire!r} step=4" in tripped[0]
    assert "recovered from checkpoint step 4 (retry 1/2)" in out
    assert losses == _base(zbuf=zbuf)


def test_fault_without_checkpoint_raises():
    cfg, tcfg = _mk(COMM_FULL)
    with pytest.raises(ValueError, match="--fault/--resume need"):
        _run(cfg, tcfg, 6, fault="3:dp:nan-scale")


def test_resume_under_another_seed_raises(tmp_path):
    cfg, tcfg = _mk(COMM_FULL)
    d = str(tmp_path / "ck")
    _run(cfg, tcfg, 2, ckpt_dir=d, save_every=2)
    with pytest.raises(ck.CheckpointError, match="seed"):
        _run(cfg, tcfg, 4, ckpt_dir=d, resume=True, seed=1)


# ---------------------------------------------------------------------------
# the launcher: --kill-at (exit 17), --resume, --fault, in subprocesses
# ---------------------------------------------------------------------------

def _cli(extra, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device",
         "cpu", "--smoke", "--stages", "2", "--steps", "12", "--batch",
         "4", "--samples", "16", "--seq", "16", "--mode", "aqsgd",
         "--fw-bits", "4", "--bw-bits", "8", "--dp-grad-bits", "4",
         "--dp-wire", "ring"] + extra,
        capture_output=True, text=True, timeout=timeout, env=env)


def _loss_lines(stdout):
    return [ln for ln in stdout.splitlines()
            if re.match(r"(step\s+\d+ loss|final loss)", ln)]


def test_cli_kill_resume_and_fault(tmp_path):
    base = _cli([])
    assert base.returncode == 0, base.stderr[-3000:]
    base_lines = _loss_lines(base.stdout)
    assert re.fullmatch(r"step    10 loss \S+ \[0x1\.[0-9a-f]+p[+-]\d+\]",
                        base_lines[1]), base_lines
    d = str(tmp_path / "ck")
    killed = _cli(["--ckpt-dir", d, "--save-every", "3", "--kill-at", "7"])
    assert killed.returncode == runner.KILL_EXIT_CODE == 17, \
        (killed.returncode, killed.stdout, killed.stderr[-2000:])
    assert "killing at step 7" in killed.stdout
    assert ck.checkpoint_steps(d) == [0, 3, 6]
    resumed = _cli(["--ckpt-dir", d, "--save-every", "3", "--resume"])
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert "resumed from step 6" in resumed.stdout
    assert _loss_lines(resumed.stdout) == [
        ln for ln in base_lines if not ln.startswith("step     0 ")]
    hit = _cli(["--ckpt-dir", str(tmp_path / "ck2"), "--save-every", "3",
                "--fault", "5:dp:nan-scale"])
    assert hit.returncode == 0, hit.stderr[-3000:]
    assert "plane=dp wire='ring' step=5" in hit.stdout
    assert "recovered from checkpoint step 3" in hit.stdout
    assert _loss_lines(hit.stdout) == base_lines
    refused = _cli(["--fault", "5:dp:nan-scale"])
    assert refused.returncode == 2
    assert "--resume/--save-every/--fault need --ckpt-dir" in refused.stderr
