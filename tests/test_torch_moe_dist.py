"""The moe family in the distributed trainer against the JAX package
(expert parallelism's FFN alone is tests/test_torch_moe_ep.py's).

deepseek-moe-16b SMOKE (the dense prefix on the first stage) on a 2 x 2
gloo mesh (one torch thread a rank, a join timeout; the ranks run
tests/test_torch_pipeline.py's JAX-free `run_scenarios`), in ``zero3``
and ``expert_parallel``: fp32 losses along JAX ``loss_fn``'s
cross-entropy and AdamW's trajectory (the distributed trainer drops
the router's aux, as JAX's does) and each stage's first gradient
against ``jax.grad`` of the cross-entropy; the two modes' fp32
gradients within the dense tolerances of each other; aqsgd with the
4-bit ring, deterministic, against the JAX package's pipeline
``train_step`` with the same ``moe_mode`` on a 2 x 2 mesh of host
devices, run meanwhile in subprocesses (this file as a script, one a
mode); the ``ep`` plane's bytes under nested remat equal to
`training.pipeline.ep_wire_bytes` exactly, 0 under ``zero3``; in
``zero3`` the ``fsdp`` plane against the all-gathers of the JAX step's
optimized HLO (tests/test_torch_hybrid_dist.py's `loop_gathers`): JAX's
expert scan gathers one expert's three weights an iteration, the port
gathers the same unit, and its trunk bytes a microbatch equal JAX's a
pipeline tick (only the all-gathers: JAX's transposes are
reduce-scatters, the port's backward sends nothing).
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

from repro.comm.config import CommConfig as JComm
from repro.launch.mesh import make_debug_mesh
from repro.models import model as Mo
from repro.optim import adamw as jadamw
from repro.training import pipeline as JPL
from repro_torch.configs.base import get_config as tget
from repro_torch.launch.mesh import spawn
from repro_torch.training import pipeline as PL
from repro_torch.weights import stage_state_dict, to_pipeline_params
from test_torch_hybrid_dist import (aqsgd_det_comm, loop_gathers, per_tick,
                                    trunk_gathers)
from test_torch_pipeline import run_scenarios
from test_torch_ssm import (DIST_RTOL, SPAWN_TIMEOUT, arch_params,
                            dist_batches, dist_spec, fp32_comm)

ARCH = "deepseek-moe-16b"
D, K = 2, 2
MODES = ("zero3", "expert_parallel")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the distributed trainer
# ---------------------------------------------------------------------------

def _with_mode(spec, mode):
    return dict(spec, pipeline={"moe_mode": mode})


def _jax_pipeline_losses(batches_path, out_path, mode):
    """The JAX package's pipeline `train_step` on a 2 x 2 mesh of host
    devices (XLA_FLAGS must force 4 before JAX starts), deepseek-moe-16b
    SMOKE from `arch_params`' weights, on the batches saved at
    ``batches_path``, with ``moe_mode`` ``mode``: the warm-up step, then
    compressed steps.  Writes the losses as JSON to ``out_path`` and, in
    ``zero3``, the compressed step's `loop_gathers` to ``out_path +
    ".gathers"``."""
    jcfg, _, params, _ = arch_params(ARCH, {})
    comm = JComm.from_json(aqsgd_det_comm().to_json())
    mesh = make_debug_mesh(D, K)
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, schedule="constant")
    spec = dist_spec(ARCH, aqsgd_det_comm(), None)
    m, gb = spec["microbatches"], spec["batch"]
    samples, seq = spec["dataset"]["num_samples"], spec["dataset"]["seq_len"]
    data = np.load(batches_path)
    steps = {w: JPL.make_train_step(
        jcfg, JPL.PipelineConfig(microbatches=m, warmup=w, comm=comm,
                                 moe_mode=mode), mesh, opt,
        global_batch=gb, seq_len=seq, buffer_samples=samples // D)[0]
        for w in (True, False)}
    pcfg = JPL.PipelineConfig(microbatches=m, comm=comm, moe_mode=mode)
    pipe = JPL.to_pipeline_params(jcfg, params, K)
    buf = JPL.buffer_structs(pcfg, K, samples, seq, jcfg.d_model)
    state = {"params": pipe, "opt": jadamw.init_opt_state(pipe),
             "dp_error": JPL.init_dp_error(pcfg, pipe, D),
             "m_out": jnp.zeros(buf.shape, buf.dtype),
             "m_in": jnp.zeros(buf.shape, buf.dtype)}
    losses = []
    for i in range(spec["steps"]):
        batch = {k: data[f"{i}/{k}"].reshape(
            m, gb // m, *data[f"{i}/{k}"].shape[1:])
            for k in ("tokens", "targets", "mask", "sample_ids")}
        state, met = steps[i < 1](state, batch, jax.random.PRNGKey(i))
        losses.append(float(met["loss"]))
    with open(out_path, "w") as f:
        json.dump(losses, f)
    if mode == "zero3":
        # the executable the last step ran (a cache hit: no second build)
        text = steps[False].lower(state, batch, jax.random.PRNGKey(0)) \
            .compile().as_text()
        with open(out_path + ".gathers", "w") as f:
            json.dump(loop_gathers(text), f)


def _jax_ce_reference(jcfg, params, batches):
    """fp32 by the JAX package on one device: each step's ``loss_fn``
    cross-entropy and its ``jax.grad`` along JAX AdamW's trajectory (the
    distributed trainer drops the router's aux, as JAX's does)."""
    opt_cfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                 schedule="constant")
    opt = jadamw.init_opt_state(params)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: Mo.loss_fn(p, jcfg, b)[1]["ce"]))
    losses, grads = [], []
    for batch in batches:
        b = {k: v for k, v in batch.items() if k != "sample_ids"}
        loss, g = grad_fn(params, b)
        params, opt = jadamw.apply_updates(opt_cfg, params, g, opt)
        losses.append(float(loss))
        grads.append(jax.tree.map(np.asarray, g))
    return losses, grads


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    jcfg, tcfg, params, np_params = arch_params(ARCH, {})
    batches = dist_batches(jcfg.vocab_size)
    pipe = to_pipeline_params(np_params, tcfg, K)
    explicit = [(_with_mode(dist_spec(ARCH, comm, pipe), mode), batches, w)
                for comm, w in ((fp32_comm(), 0), (aqsgd_det_comm(), 1))
                for mode in MODES]
    # the ep plane's bytes: dataset runs, nested remat (the default)
    bytes_specs = [_with_mode(dist_spec(ARCH, aqsgd_det_comm(), pipe), mode)
                   for mode in MODES]
    tmp = tmp_path_factory.mktemp("jax")
    np.savez(tmp / "batches.npz", **{f"{i}/{k}": v
                                     for i, b in enumerate(batches)
                                     for k, v in b.items()})
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=src,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    # one JAX process a mode, side by side
    procs = {mode: subprocess.Popen(
        [sys.executable, __file__, str(tmp / "batches.npz"),
         str(tmp / f"{mode}.json"), mode], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for mode in MODES}
    try:
        out = spawn(run_scenarios, D * K, (bytes_specs, explicit),
                    timeout=SPAWN_TIMEOUT,
                    store_dir=tmp_path_factory.mktemp("mesh"))
        logs = {mode: p.communicate(timeout=SPAWN_TIMEOUT)[0]
                for mode, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
    for mode, p in procs.items():
        assert p.returncode == 0, logs[mode]
    runs = {("bytes", mode): ([r[i] for r in out], spec)
            for i, (mode, spec) in enumerate(zip(MODES, bytes_specs))}
    for i, (run, mode) in enumerate((r, m) for r in ("fp32", "aqsgd")
                                    for m in MODES):
        runs[run, mode] = [r[len(MODES) + i] for r in out]
    runs["jax-pipeline"] = {mode: json.loads((tmp / f"{mode}.json")
                                             .read_text()) for mode in MODES}
    runs["jax-gathers"] = json.loads((tmp / "zero3.json.gathers").read_text())
    runs["jax"] = (jcfg, tcfg, params, np_params, batches)
    return runs


@pytest.mark.parametrize("mode", MODES)
def test_distributed_fp32_matches_jax(dist_runs, mode):
    jcfg, tcfg, params, np_params, batches = dist_runs["jax"]
    want, grads = _jax_ce_reference(jcfg, params, batches)
    for r in dist_runs["fp32", mode]:
        assert r["losses"] == dist_runs["fp32", mode][0]["losses"]
        k = r["model_rank"]
        g = stage_state_dict(to_pipeline_params(grads[0], tcfg, K), tcfg, K,
                             k, embed=True, final_norm=k == K - 1,
                             prefix=k == 0)
        assert set(r["grads"][0]) == set(g)
        assert any(n.startswith("prefix.") for n in g) == (k == 0)
        for n in g:
            scale = float(np.abs(g[n]).max())
            np.testing.assert_allclose(r["grads"][0][n], g[n], rtol=1e-3,
                                       atol=1e-4 * scale, err_msg=n)
    np.testing.assert_allclose(dist_runs["fp32", mode][0]["losses"], want,
                               rtol=DIST_RTOL)


def test_expert_parallel_gradients_equal_zero3(dist_runs):
    """fp32: every rank's mean gradient (after the bucket's all-reduce,
    what AdamW is given) and its losses in ``expert_parallel`` within
    the dense tolerances of ``zero3``'s."""
    for z, e in zip(dist_runs["fp32", "zero3"],
                    dist_runs["fp32", "expert_parallel"]):
        np.testing.assert_allclose(e["losses"], z["losses"], rtol=1e-6)
        for step in range(len(z["grads"])):
            for n, gz in z["grads"][step].items():
                scale = float(np.abs(gz).max()) or 1.0
                np.testing.assert_allclose(e["grads"][step][n], gz,
                                           rtol=1e-4, atol=1e-5 * scale,
                                           err_msg=n)


@pytest.mark.parametrize("mode", MODES)
def test_distributed_aqsgd_matches_jax_pipeline(dist_runs, mode):
    res = dist_runs["aqsgd", mode]
    for r in res:
        assert r["losses"] == res[0]["losses"]
        assert all(rep["m_in_equal"] in (None, True) and
                   rep["embed_equal"] in (None, True)
                   for rep in r["replicas"])
    np.testing.assert_allclose(res[0]["losses"],
                               dist_runs["jax-pipeline"][mode],
                               rtol=DIST_RTOL)


@pytest.mark.parametrize("mode", MODES)
def test_ep_bytes_match_the_byte_model(dist_runs, mode):
    """Every step of a dataset run (aqsgd, the 4-bit ring, nested
    remat): each rank's ``ep`` bytes equal `ep_wire_bytes` for its
    stage's one MoE layer, a microbatch's dispatch over its data shard's
    tokens, under ``expert_parallel``, and 0 under ``zero3``; the losses
    of the two modes within DIST_RTOL of each other."""
    runs, spec = dist_runs["bytes", mode]
    cfg = tget(ARCH, smoke=True)
    pcfg = PL.PipelineConfig(microbatches=spec["microbatches"],
                             **spec["pipeline"])
    lay = PL.stage_layout(cfg, K)
    tokens = spec["batch"] // spec["microbatches"] // D \
        * spec["dataset"]["seq_len"]
    want = PL.ep_wire_bytes(cfg, pcfg, lay.lps, tokens, D,
                            spec["microbatches"])
    assert want > 0
    for r in runs:
        assert [b["ep"] for b in r["bytes"]] == \
            [want if mode == "expert_parallel" else 0] * spec["steps"]
        assert all(b["dp"] > 0 for b in r["bytes"])
    np.testing.assert_allclose(
        runs[0]["losses"], dist_runs["bytes", "zero3"][0][0]["losses"],
        rtol=DIST_RTOL)


def test_zero3_gathers_match_jax_hlo(dist_runs):
    """``zero3``, aqsgd + the 4-bit ring, nested remat: each rank's
    ``fsdp`` calls a step equal `fsdp_gathers`', the largest gather that
    holds an expert's weights is one expert's w_gate, w_up and w_down
    (E calls of it a forward run of the layer, and E more in the
    experts' own backward); JAX's expert scan gathers exactly those
    three weights three times an iteration, and the port's trunk bytes
    a microbatch equal JAX's a tick."""
    runs, spec = dist_runs["bytes", "zero3"]
    cfg = tget(ARCH, smoke=True)
    lay = PL.stage_layout(cfg, K)
    m = spec["microbatches"]
    pcfg = PL.PipelineConfig(microbatches=m, **spec["pipeline"])
    d, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    gathers, ticks = dist_runs["jax-gathers"], m + K - 1
    scan = [g for g in gathers if g["loops"] == [ticks, e]]
    assert {tuple(g["dims"]) for g in scan} == {(d, ff), (ff, d)}
    for r in runs:
        k = r["model_rank"]
        units = PL.fsdp_gathers(cfg, pcfg, lay, k, D)
        assert r["fsdp_gathers"] == [{u: m * c for u, (c, _, _)
                                      in units.items()}] * spec["steps"]
        assert r["largest_gather"] == [PL.fsdp_largest_gather(
            cfg, pcfg, lay, k, D)] * spec["steps"]
        trunk = trunk_gathers(cfg, pcfg, k)
        calls, one = trunk["experts.0"]
        assert one == 4 * 3 * d * ff
        assert calls == e * (PL._passes(pcfg, 0, lay.lps) + 1)
        assert sum(g["bytes"] for g in scan) == 3 * one
        assert per_tick(gathers, ticks) == sum(c * w
                                               for c, w in trunk.values())


if __name__ == "__main__":
    _jax_pipeline_losses(*sys.argv[1:4])
