"""The hybrid family (``zamba2-2.7b``) through the trainers' state and
the distributed trainer, against the JAX package (the model and serving
are in tests/test_torch_hybrid.py).

* a zamba2 simulated state written by either package restores in the
  other bit for bit (tests/test_torch_checkpoint.py's checks), and one
  more step then gives losses within the later-step tolerance;
* the distributed trainer on a 2 x 2 gloo mesh (one torch thread a
  rank, a join timeout; the ranks run tests/test_torch_pipeline.py's
  JAX-free `run_scenarios`) from JAX's SMOKE weights: in fp32 its
  losses along JAX ``loss_fn`` and AdamW's trajectory (rtol 2e-4) and
  each stage's first gradient against ``jax.grad`` (the shared block's
  summed over the stages, as every stage holds it); aqsgd with the
  4-bit ring, deterministic, against the JAX package's pipeline
  ``train_step`` on a 2 x 2 mesh of host devices, run meanwhile in a
  subprocess (this file as a script); the shared block's copies
  bit-equal on every stage after every step;
* the ``fsdp`` plane against the all-gathers of that JAX step's
  optimized HLO (read with `repro.launch.hlo_cost`'s parser, which
  counts while-loop trips; the compressed step's text, from the
  executable the run compiled): a layer's unit is JAX's per-layer
  gather, and the port's trunk bytes a microbatch differ from JAX's a
  pipeline tick by exactly the shared block (which XLA hoists out of
  every loop, so no backward gathers it again: the port gathers it once
  a stage call, outside the nested checkpoint) and one layer (the stage's
  last, which JAX's nested recompute runs inside its layer scan and
  torch's checkpoint stops before).  The transposes, reduce-scatters in
  JAX, have no counterpart (the port's backward sends nothing on the
  ``fsdp`` plane), so only the all-gathers are compared.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro.comm.config import CommConfig as JComm
from repro.configs.base import get_config as jget
from repro.data import pipeline as JD
from repro.launch.mesh import make_debug_mesh
from repro.optim import adamw as jadamw
from repro.training import pipeline as JPL
from repro.training import simulated as JS
from repro_torch import checkpoint as ck
from repro_torch.comm.config import CommConfig as TComm
from repro_torch.comm.config import PlaneConfig as TPlane
from repro_torch.configs.base import get_config as tget
from repro_torch.data import pipeline as TD
from repro_torch.launch.mesh import spawn
from repro_torch.training import pipeline as PL
from repro_torch.training import simulated as TS
from repro_torch.weights import stage_state_dict, to_pipeline_params
from test_torch_checkpoint import (DC, LATER_STEP_RTOL, _configs,
                                   assert_same_kind, assert_trees_bit_equal)
from test_torch_pipeline import run_scenarios
from test_torch_ssm import (DIST_RTOL, SPAWN_TIMEOUT, arch_params,
                            dist_batches, dist_spec, fp32_comm,
                            jax_reference)

ARCH = "zamba2-2.7b"
D, K = 2, 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------

def test_zamba2_sim_state_restores_across_packages(tmp_path):
    """The port's simulated state after 2 steps restores in JAX against
    its `init_train_state` structure, bit for bit, with JAX's
    fingerprint; JAX's after 2 deterministic steps restores in the port
    bit for bit, and a third step in each package gives losses within
    the later-step tolerance."""
    jcfg, tcfg = jget(ARCH, smoke=True), tget(ARCH, smoke=True)
    # port -> JAX
    jt, tt = _configs("ring")
    state = TS.init_train_state(tcfg, tt, DC["num_samples"], DC["seq_len"],
                                generator=torch.Generator().manual_seed(0),
                                device="cpu")
    ds = TD.Dataset(TD.DatasetConfig(vocab_size=tcfg.vocab_size, **DC))
    tb = list(ds.batches(4, 3))
    gen = torch.Generator().manual_seed(1)
    for b in tb[:2]:
        TS.train_step(state, TS.device_batch(b, "cpu"), gen, mcfg=tcfg,
                      tcfg=tt)
    tree = TS.to_jax_state(state)
    assert "shared_block" in tree["params"]
    ck.save_state(str(tmp_path / "port"), tree, step=2, comm=tt.comm)
    like = jax.eval_shape(lambda: JS.init_train_state(
        jcfg, jt, DC["num_samples"], DC["seq_len"], jax.random.PRNGKey(0)))
    out, body = jck.restore_state(str(tmp_path / "port"), like,
                                  comm=jt.comm)
    assert body["fingerprint"] == jck.tree_fingerprint(like) \
        == ck.tree_fingerprint(tree)
    assert_trees_bit_equal(tree, jax.tree.map(np.asarray, out))
    # JAX -> port
    jt, tt = _configs("ring", stochastic=False)
    jstate = JS.init_train_state(jcfg, jt, DC["num_samples"], DC["seq_len"],
                                 jax.random.PRNGKey(0))
    jds = JD.Dataset(JD.DatasetConfig(vocab_size=jcfg.vocab_size, **DC))
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in jds.batches(4, 3)]
    key = jax.random.PRNGKey(1)
    for b in batches[:2]:
        jstate, _ = JS.train_step(jstate, b, key, mcfg=jcfg, tcfg=jt)
    jck.save_state(str(tmp_path / "jax"), jstate, step=2, comm=jt.comm)
    _, jmet = JS.train_step(jstate, batches[2], key, mcfg=jcfg, tcfg=jt)
    state = TS.init_train_state(tcfg, tt, DC["num_samples"], DC["seq_len"],
                                generator=torch.Generator().manual_seed(0),
                                device="cpu")
    like = TS.to_jax_state(state)
    tree, body = ck.restore_state(str(tmp_path / "jax"), like, comm=tt.comm)
    assert body["fingerprint"] == ck.tree_fingerprint(like)
    assert_same_kind(like, tree)
    TS.load_jax_state(state, tree)
    assert_trees_bit_equal(TS.to_jax_state(state),
                           jax.tree.map(np.asarray, jstate))
    _, met = TS.train_step(state, TS.device_batch(tb[2], "cpu"),
                           torch.Generator().manual_seed(1), mcfg=tcfg,
                           tcfg=tt)
    want = float(jmet["loss"])
    assert abs(float(met["loss"]) - want) <= LATER_STEP_RTOL * abs(want)


# ---------------------------------------------------------------------------
# the distributed trainer
# ---------------------------------------------------------------------------

def aqsgd_det_comm():
    return TComm(mode="aqsgd", fw=TPlane(bits=4, stochastic=False),
                 bw=TPlane(bits=8, stochastic=False),
                 dp=TPlane(bits=4, wire="ring", stochastic=False))


def loop_gathers(text):
    """The all-gathers of an optimized HLO text: [{"loops": the trip
    counts of the while loops around it, outermost first, "bytes": its
    gathered buffer's, "dims": its shape}], through calls, fusions and
    the branches of conditionals (`repro.launch.hlo_cost`'s parser)."""
    from repro.launch import hlo_cost as H
    comps, out = H.parse_hlo(text), []

    def walk(comp, trips):
        for ins in comp.instrs:
            if ins.op == "while":
                n = H._TRIP_RE.search(ins.line)
                walk(comps[H._BODY_RE.search(ins.line).group(1)],
                     trips + [int(n.group(1)) if n else 1])
            elif ins.op == "conditional":
                for b in H._OPERAND.findall(
                        H._BRANCHES_RE.search(ins.line).group(1)):
                    walk(comps[b], trips)
            elif ins.op in ("fusion", "call", "async-start"):
                m = H._CALLS_RE.search(ins.line) or H._TO_RE.search(ins.line)
                if m and m.group(1) in comps:
                    walk(comps[m.group(1)], trips)
            elif ins.op in ("all-gather", "all-gather-start"):
                out.append({"loops": trips,
                            "bytes": H._type_bytes(ins.result_type),
                            "dims": H._shape_dims(ins.result_type)})
    walk(comps["__entry__"], [])
    return out


def per_tick(gathers, ticks):
    """The bytes JAX's pipeline gathers a tick: every all-gather inside
    the tick loops (outermost trip count ``ticks``: the forward's and
    the backward's), times its inner loops' trips."""
    return sum(g["bytes"] * int(np.prod(g["loops"][1:])) for g in gathers
               if g["loops"] and g["loops"][0] == ticks)


def trunk_gathers(cfg, pcfg, k):
    """{unit: (calls a microbatch, gathered bytes)} of the port's stage
    ``k`` trunk: its layers', experts' and shared block's units
    (`PL.fsdp_gathers`; the embedding, head and a dense prefix run
    outside JAX's stage function)."""
    units = PL.fsdp_gathers(cfg, pcfg, PL.stage_layout(cfg, K), k, D)
    return {u: (c, w) for u, (c, _, w) in units.items()
            if u.split(".")[0] in ("layers", "experts", "shared_block")}


def _jax_pipeline_losses(batches_path, out_path):
    """The JAX package's pipeline `train_step` on a 2 x 2 mesh of host
    devices (XLA_FLAGS must force 4 before JAX starts), zamba2 SMOKE from
    `arch_params`' weights, on the batches saved at ``batches_path``:
    the warm-up step, then compressed steps.  Writes the losses as JSON
    to ``out_path`` and the compressed step's `loop_gathers` to
    ``out_path + ".gathers"``."""
    jcfg, _, params, _ = arch_params(ARCH, {})
    comm = JComm.from_json(aqsgd_det_comm().to_json())
    mesh = make_debug_mesh(D, K)
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, schedule="constant")
    spec = dist_spec(ARCH, aqsgd_det_comm(), None)
    steps = {w: JPL.make_train_step(
        jcfg, JPL.PipelineConfig(microbatches=spec["microbatches"],
                                 warmup=w, comm=comm), mesh, opt,
        global_batch=spec["batch"],
        seq_len=spec["dataset"]["seq_len"],
        buffer_samples=spec["dataset"]["num_samples"] // D)[0]
        for w in (True, False)}
    pcfg = JPL.PipelineConfig(microbatches=spec["microbatches"], comm=comm)
    pipe = JPL.to_pipeline_params(jcfg, params, K)
    buf = JPL.buffer_structs(pcfg, K, spec["dataset"]["num_samples"],
                             spec["dataset"]["seq_len"], jcfg.d_model)
    state = {"params": pipe, "opt": jadamw.init_opt_state(pipe),
             "dp_error": JPL.init_dp_error(pcfg, pipe, D),
             "m_out": jnp.zeros(buf.shape, buf.dtype),
             "m_in": jnp.zeros(buf.shape, buf.dtype)}
    data = np.load(batches_path)
    m, gb = spec["microbatches"], spec["batch"]
    losses = []
    for i in range(spec["steps"]):
        batch = {k: data[f"{i}/{k}"].reshape(m, gb // m,
                                              *data[f"{i}/{k}"].shape[1:])
                 for k in ("tokens", "targets", "mask", "sample_ids")}
        state, met = steps[i < 1](state, batch, jax.random.PRNGKey(i))
        losses.append(float(met["loss"]))
    with open(out_path, "w") as f:
        json.dump(losses, f)
    # the executable the last step ran (a cache hit: no second build)
    text = steps[False].lower(state, batch, jax.random.PRNGKey(0)) \
        .compile().as_text()
    with open(out_path + ".gathers", "w") as f:
        json.dump(loop_gathers(text), f)


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    jcfg, tcfg, params, np_params = arch_params(ARCH, {})
    batches = dist_batches(jcfg.vocab_size)
    pipe = to_pipeline_params(np_params, tcfg, K)
    explicit = [(dist_spec(ARCH, fp32_comm(), pipe), batches, 0),
                (dist_spec(ARCH, aqsgd_det_comm(), pipe), batches, 1)]
    tmp = tmp_path_factory.mktemp("jax")
    np.savez(tmp / "batches.npz", **{f"{i}/{k}": v
                                     for i, b in enumerate(batches)
                                     for k, v in b.items()})
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=src,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen(
        [sys.executable, __file__, str(tmp / "batches.npz"),
         str(tmp / "losses.json")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        out = spawn(run_scenarios, D * K, ([], explicit),
                    timeout=SPAWN_TIMEOUT,
                    store_dir=tmp_path_factory.mktemp("mesh"))
        log, _ = jax_proc.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, log
    return {"fp32": [r[0] for r in out], "aqsgd": [r[1] for r in out],
            "jax-pipeline": json.loads((tmp / "losses.json").read_text()),
            "jax-gathers": json.loads((tmp / "losses.json.gathers")
                                      .read_text()),
            "jax": (jcfg, tcfg, params, np_params, batches)}


def test_distributed_fp32_matches_jax(dist_runs):
    jcfg, tcfg, params, np_params, batches = dist_runs["jax"]
    want, grads = jax_reference(jcfg, params, batches)
    for r in dist_runs["fp32"]:
        assert r["losses"] == dist_runs["fp32"][0]["losses"]
        k = r["model_rank"]
        g = stage_state_dict(to_pipeline_params(grads[0], tcfg, K), tcfg, K,
                             k, embed=True, final_norm=k == K - 1,
                             shared=True)
        assert set(r["grads"][0]) == set(g)
        for n in g:
            scale = float(np.abs(g[n]).max())
            np.testing.assert_allclose(r["grads"][0][n], g[n], rtol=1e-3,
                                       atol=1e-4 * scale, err_msg=n)
    np.testing.assert_allclose(dist_runs["fp32"][0]["losses"], want,
                               rtol=DIST_RTOL)


def test_distributed_aqsgd_matches_jax_pipeline(dist_runs):
    res = dist_runs["aqsgd"]
    for r in res:
        assert r["losses"] == res[0]["losses"]
    np.testing.assert_allclose(res[0]["losses"], dist_runs["jax-pipeline"],
                               rtol=DIST_RTOL)


@pytest.mark.parametrize("run", ["fp32", "aqsgd"])
def test_shared_block_copies_stay_equal(dist_runs, run):
    """Every stage holds the shared block; after every step its copies
    are bit-equal (the replica check ships stage 0's to the others), as
    are the buffers and the tied embedding."""
    for r in dist_runs[run]:
        for rep in r["replicas"]:
            if r["model_rank"] > 0:
                assert rep["shared_equal"] is True, rep
                assert rep["embed_equal"] is True, rep
            assert rep["m_in_equal"] in (None, True), rep
        names = set(r["params"][0])
        assert any(n.startswith("shared_block.") for n in names)


def test_fsdp_gathers_match_jax_hlo(dist_runs):
    """aqsgd + the 4-bit ring, nested remat: every rank's ``fsdp`` bytes
    equal `fsdp_gather_bytes` every step and its calls `fsdp_gathers`'
    (the shared block once a microbatch); JAX's layer scan gathers one
    layer unit three times an iteration (its backward loop); and the
    port's trunk bytes a microbatch equal JAX's a tick less one layer
    unit plus the shared block (the module docstring)."""
    spec = dist_spec(ARCH, aqsgd_det_comm(), None)
    m = spec["microbatches"]
    cfg = tget(ARCH, smoke=True)
    lay = PL.stage_layout(cfg, K)
    pcfg = PL.PipelineConfig(microbatches=m, comm=aqsgd_det_comm())
    gathers, ticks = dist_runs["jax-gathers"], m + K - 1
    for r in dist_runs["aqsgd"]:
        k = r["model_rank"]
        units = PL.fsdp_gathers(cfg, pcfg, lay, k, D)
        assert r["fsdp"] == [PL.fsdp_gather_bytes(cfg, pcfg, lay, k, D, m)] \
            * len(r["losses"])
        assert r["fsdp_gathers"] == [{u: m * c for u, (c, _, _)
                                      in units.items()}] * len(r["losses"])
        assert units["shared_block"][0] == 1
        trunk = trunk_gathers(cfg, pcfg, k)
        layer = trunk["layers.0"][1]
        assert trunk["layers.1"][1] == layer
        scan = [g for g in gathers if g["loops"] == [ticks, lay.lps]]
        assert sum(g["bytes"] for g in scan) == 3 * layer
        assert per_tick(gathers, ticks) == sum(
            c * w for c, w in trunk.values()) \
            - trunk["shared_block"][1] + layer


if __name__ == "__main__":
    _jax_pipeline_losses(sys.argv[1], sys.argv[2])
