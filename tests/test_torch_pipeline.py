"""The port's distributed GPipe trainer (`repro_torch.training.pipeline`)
on a 2 x 2 gloo mesh on the CPU: the gates of
tests/workers/pipeline_worker.py.

``gpt2-xl-paper`` SMOKE cut to 4 layers (2 a stage), 2 microbatches,
global batch 4 x 32 tokens, 4 samples (so an epoch is one step).  One
spawn of four processes runs every scenario; the tests read its
results:

* fp32, 3 steps at lr 1e-3 from the JAX package's parameters: every
  loss equals JAX ``repro.models.model.loss_fn`` along JAX AdamW's
  trajectory (rtol 2e-4), each stage's first gradient equals
  ``jax.grad``'s (rtol 1e-3 plus 1e-4 of the leaf's largest), and
  every step's parameters equal JAX AdamW applied to the stage's
  parameters and gradient (atol 1e-6); the f32 sums run in other
  orders: gloo's all-reduce, PyTorch's kernels, per-microbatch sums;
* aqsgd with the 4-bit ``ring`` DP wire, deterministic rounding: the
  warm-up step and two compressed steps give the losses of the JAX
  package's own pipeline ``train_step`` on a 2 x 2 mesh of host
  devices (run in a subprocess, this file as a script) on the same
  parameters and batches (rtol 2e-4);
* aqsgd (fw 4 / bw 8, stochastic): after the warm-up epoch and 4
  compressed steps, each stage's ``m_in`` equals the upstream ``m_out``
  bit for bit after every step, and the losses are finite and fall;
  the hop bytes each rank sends equal the codec's byte model;
* the same with 8-bit z-bit buffers;
* the 4-bit DP wire: ``ring`` and ``psum`` give bit-identical losses
  over 4 steps, and the 2-chunk ring the monolithic one's;
* the ZeRO wire (``ring-sharded``, 4-bit, stochastic): the ``ring``
  wire's losses bit for bit, and with 2 chunks the monolithic one's;
  each rank's ``dp`` bytes and calls are the registry's model and
  manifest, and its parameter all-gather (the ``dp-gather`` plane) one
  f32 segment to the other data rank;
* the ``fp16`` wire: one f16 all-reduce of the bucket a rank a step,
  finite losses;
* 8-bit AdamW moments (``state_bits=8``, the ring wire, deterministic,
  on explicit batches): every step's parameters are the port's
  per-leaf 8-bit AdamW applied to the stage's gradient, bit for bit;
* in every run the two copies of the tied embedding (stages 0 and 1)
  are bit-equal after every step;
* the untied head: ``stablelm-12b`` SMOKE cut to 4 layers from the JAX
  package's parameters, the last stage holding ``head`` and no
  embedding (no embedding copy to check): fp32 against JAX
  ``loss_fn``, ``jax.grad`` and AdamW as the tied fp32 case; aqsgd with
  the 4-bit ring, deterministic, against the JAX package's pipeline,
  each step within twice the spread the port's own run shows when its
  weights move by 1e-7 of their size (rtol 2e-4 at least; see
  `test_untied_head_matches_jax_pipeline`);
* remat: aqsgd with the 4-bit ring, stochastic rounding on every
  plane, from the JAX package's parameters, with the pipeline's
  defaults (``remat_mode="nested"``, ``loss_chunks=64``), with
  ``remat=False`` and with ``remat_mode="layer"``: losses, every step's
  gradients and parameters bit-identical (the hops draw their noise and
  write the buffers outside the checkpoints, so a recompute draws and
  writes nothing).

The stage hop itself (`PL.Transfer`, every mode, forward and
backward) is held bit for bit against JAX ``make_transfer`` in one
process.

The JAX package is imported inside the tests only, so the spawned
ranks, which import this module for `run_scenarios`, do not load it.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.comm import wires as TW
from repro_torch.comm.config import CommConfig, PlaneConfig
from repro_torch.configs.base import get_config as tget
from repro_torch.core import quantization as TQ
from repro_torch.data.pipeline import Dataset, DatasetConfig
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import spawn
from repro_torch.training import pipeline as PL
from repro_torch.weights import (from_pipeline_params, stage_state_dict,
                                 to_pipeline_params)

ARCH = "gpt2-xl-paper"
LAYERS, D, K, M = 4, 2, 2, 2
BATCH, SEQ, SAMPLES = 4, 32, 4
SPAWN_TIMEOUT = 240


def run_scenarios(rank, world, specs, explicit):
    """Every spec of ``specs`` in turn on this rank, then every
    (spec, batches, warm steps) of ``explicit`` through `step_batches`."""
    return PL.train_ranks(rank, world, specs) + \
        [step_batches(rank, world, *e) for e in explicit]


def step_batches(rank, world, spec, batches, warm_steps):
    """Train on the given global batches (the first ``warm_steps`` with
    the warm-up step); return the losses, replica checks, and this
    stage's parameters before the first step and after every step, and
    the gradient AdamW was given at every step, each whole (the data
    ranks' shards gathered: `PL.gather_whole`), and each step's ``fsdp``
    bytes and calls by unit (`PL.StageFsdp.gathers`)."""
    trainer, _ = PL.build_rank(rank, world, spec)
    tr, fs = trainer.mesh.transport, trainer.stage.fsdp

    def numpy(tensors):
        return {n: t.detach().numpy().copy()
                for n, t in PL.gather_whole(trainer, tensors).items()}
    out = {"rank": rank, "model_rank": trainer.mesh.model_rank,
           "losses": [], "replicas": [], "grads": [], "fsdp": [],
           "fsdp_gathers": [], "params": [numpy(trainer.params)]}
    apply_updates = PL.adamw.apply_updates

    def spy(cfg, params, grads, state):
        out["grads"].append(numpy(grads))
        return apply_updates(cfg, params, grads, state)

    PL.adamw.apply_updates = spy
    for i, batch in enumerate(batches):
        tr.reset()
        out["losses"].append(trainer.step(PL.rank_batch(trainer, batch), i,
                                          warmup=i < warm_steps))
        out["fsdp"].append(tr.bytes_sent("fsdp"))
        out["fsdp_gathers"].append({} if fs is None else dict(fs.gathers))
        out["replicas"].append(PL.check_replicas(trainer))
        out["params"].append(numpy(trainer.params))
    PL.adamw.apply_updates = apply_updates
    return out


def _comm(mode, *, buffer_bits=0, dp_bits=0, wire="ring", chunks=1,
          stochastic=True):
    return CommConfig(mode=mode, fw=PlaneConfig(bits=4 if mode != "fp32"
                                                else 0,
                                                stochastic=stochastic),
                      bw=PlaneConfig(bits=8, stochastic=stochastic),
                      zbuf=PlaneConfig(bits=buffer_bits),
                      dp=PlaneConfig(bits=dp_bits, wire=wire, chunks=chunks,
                                     stochastic=stochastic))


def _spec(comm, *, steps, warmup_epochs=1, lr=1e-3, initial_params=None,
          arch=ARCH, state_bits=0):
    return {"arch": arch, "smoke": True, "num_layers": LAYERS,
            "comm": comm.to_json(), "device": "cpu", "data_par": D,
            "stages": K, "microbatches": M, "steps": steps, "batch": BATCH,
            "warmup_epochs": warmup_epochs, "seed": 0,
            "optimizer": {"lr": lr, "warmup_steps": 1,
                          "schedule": "constant", "state_bits": state_bits},
            "dataset": {"num_samples": SAMPLES, "seq_len": SEQ,
                        "vocab_size": tget(arch, smoke=True).vocab_size},
            "initial_params": initial_params}


def _moved(tree, seed):
    """Every array of a pipeline tree times ``1 + MOVE * N(0, 1)``
    (one numpy generator from ``seed``, keys in sorted order)."""
    rng = np.random.default_rng(seed)

    def move(t):
        if isinstance(t, dict):
            return {k: move(t[k]) for k in sorted(t)}
        a = np.asarray(t)
        return (a * (1 + MOVE * rng.standard_normal(a.shape))).astype(
            a.dtype)
    return move(tree)


def _jax_params(arch=ARCH):
    import jax
    from repro.configs.base import get_config as jget
    from repro.models import model as Mo
    cfg = jget(arch, smoke=True).with_(num_layers=LAYERS)
    params = Mo.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, jax.tree.map(np.asarray, params)


SCENARIOS = {
    "aqsgd": dict(comm=_comm("aqsgd"), steps=5),
    "zbit": dict(comm=_comm("aqsgd", buffer_bits=8), steps=4),
    "ring": dict(comm=_comm("aqsgd", dp_bits=4), steps=4, warmup_epochs=0),
    "psum": dict(comm=_comm("aqsgd", dp_bits=4, wire="psum"), steps=4,
                 warmup_epochs=0),
    "ring/K2": dict(comm=_comm("aqsgd", dp_bits=4, chunks=2), steps=4,
                    warmup_epochs=0),
    "ring-sharded": dict(comm=_comm("aqsgd", dp_bits=4, wire="ring-sharded"),
                         steps=4, warmup_epochs=0),
    "ring-sharded/K2": dict(comm=_comm("aqsgd", dp_bits=4, chunks=2,
                                       wire="ring-sharded"), steps=2,
                            warmup_epochs=0),
    "fp16": dict(comm=_comm("aqsgd", dp_bits=4, wire="fp16"), steps=2,
                 warmup_epochs=0),
}
# scenarios on explicit batches from the JAX package's parameters, at
# lr 1e-3: name -> (comm, warm-up steps)
EXPLICIT = {
    "fp32": (_comm("fp32"), 0),
    "aqsgd-ring-det": (_comm("aqsgd", dp_bits=4, stochastic=False), 1),
}
EXPLICIT_STEPS = 3
# the remat scenarios, on explicit batches: name -> `PipelineConfig`
# fields beside the defaults (remat on, "nested", 64 loss chunks)
REMAT = {"remat/nested": {}, "remat/off": {"remat": False},
         "remat/layer": {"remat_mode": "layer"}}
REMAT_COMM = _comm("aqsgd", dp_bits=4)
# the untied head (its own (d, vocab) matrix on the last stage), on
# explicit batches from the JAX package's parameters: name -> (arch,
# the EXPLICIT scenario it runs)
UNTIED_ARCH = "stablelm-12b"
UNTIED = {"untied/fp32": "fp32", "untied/aqsgd-ring-det": "aqsgd-ring-det"}
# the untied aqsgd-ring-det run again from its weights each moved by
# MOVE of its size (numpy seeds MOVED_SEEDS): the spread of the loss
# stream under f32 noise, the yardstick against the JAX pipeline's
MOVE, MOVED_SEEDS = 1e-7, (1, 2, 3, 4, 5)
UNTIED_MOVED = [f"untied/moved/{s}" for s in MOVED_SEEDS]
# 8-bit AdamW moments, on explicit batches: the EXPLICIT scenario it runs
ADAM8 = {"adam8": "aqsgd-ring-det"}
# the JAX pipeline's buffers hold SAMPLES // D samples a data rank, and
# a data rank's ids index its own; so each data rank's two samples of a
# step (one a microbatch) are its slots 0 and 1
SAMPLE_IDS = np.array([0, 0, 1, 1], np.int32)


def explicit_batches():
    """EXPLICIT_STEPS global (BATCH, SEQ) batches, made from a seed."""
    rng = np.random.default_rng(7)
    vocab = tget(ARCH, smoke=True).vocab_size
    return [{"tokens": rng.integers(0, vocab, (BATCH, SEQ), dtype=np.int32),
             "targets": rng.integers(0, vocab, (BATCH, SEQ), dtype=np.int32),
             "mask": (rng.random((BATCH, SEQ)) < 0.9).astype(np.float32),
             "sample_ids": SAMPLE_IDS.copy()}
            for _ in range(EXPLICIT_STEPS)]


def _jax_pipeline_losses(batches_path, out_path):
    """The JAX package's pipeline `train_step` on a 2 x 2 mesh of host
    devices (XLA_FLAGS must force 4 before JAX starts), from the
    ``init_params(PRNGKey(0))`` weights, on the batches saved at
    ``batches_path``: the warm-up step, then compressed steps, for the
    tied ``ARCH`` and the untied ``UNTIED_ARCH``.  Writes the losses as
    JSON ({arch: losses}) to ``out_path``."""
    out = {arch: _jax_arch_pipeline_losses(batches_path, arch)
           for arch in (ARCH, UNTIED_ARCH)}
    with open(out_path, "w") as f:
        json.dump(out, f)


def _jax_arch_pipeline_losses(batches_path, arch):
    import jax
    import jax.numpy as jnp
    from repro.comm.config import CommConfig as JComm
    from repro.launch.mesh import make_debug_mesh
    from repro.optim import adamw as jadamw
    from repro.training import pipeline as JPL
    jcfg, params, _ = _jax_params(arch)
    comm, warm = EXPLICIT["aqsgd-ring-det"]
    comm = JComm.from_json(comm.to_json())
    mesh = make_debug_mesh(D, K)
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, schedule="constant")
    steps = {w: JPL.make_train_step(
        jcfg, JPL.PipelineConfig(microbatches=M, warmup=w, comm=comm), mesh,
        opt, global_batch=BATCH, seq_len=SEQ,
        buffer_samples=SAMPLES // D)[0] for w in (True, False)}
    pcfg = JPL.PipelineConfig(microbatches=M, comm=comm)
    pipe = JPL.to_pipeline_params(jcfg, params, K)
    buf = JPL.buffer_structs(pcfg, K, SAMPLES, SEQ, jcfg.d_model)
    state = {"params": pipe, "opt": jadamw.init_opt_state(pipe),
             "dp_error": JPL.init_dp_error(pcfg, pipe, D),
             "m_out": jnp.zeros(buf.shape, buf.dtype),
             "m_in": jnp.zeros(buf.shape, buf.dtype)}
    data = np.load(batches_path)
    losses = []
    for i in range(EXPLICIT_STEPS):
        batch = {k: data[f"{i}/{k}"].reshape(M, BATCH // M,
                                              *data[f"{i}/{k}"].shape[1:])
                 for k in ("tokens", "targets", "mask", "sample_ids")}
        state, met = steps[i < warm](state, batch, jax.random.PRNGKey(i))
        losses.append(float(met["loss"]))
    return losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    _, _, np_params = _jax_params()
    tcfg = tget(ARCH, smoke=True).with_(num_layers=LAYERS)
    pipe = to_pipeline_params(np_params, tcfg, K)
    specs = []
    for kw in SCENARIOS.values():
        kw = dict(kw)
        specs.append(_spec(kw.pop("comm"), **kw))
    batches = explicit_batches()
    explicit = [(_spec(comm, steps=EXPLICIT_STEPS, initial_params=pipe),
                 batches, warm) for comm, warm in EXPLICIT.values()]
    explicit += [(dict(_spec(REMAT_COMM, steps=EXPLICIT_STEPS,
                             initial_params=pipe), pipeline=kw), batches, 1)
                 for kw in REMAT.values()]
    _, _, np_untied = _jax_params(UNTIED_ARCH)
    untied_pipe = to_pipeline_params(
        np_untied, tget(UNTIED_ARCH, smoke=True).with_(num_layers=LAYERS), K)
    explicit += [(_spec(EXPLICIT[name][0], steps=EXPLICIT_STEPS,
                        initial_params=untied_pipe, arch=UNTIED_ARCH),
                  batches, EXPLICIT[name][1]) for name in UNTIED.values()]
    comm, warm = EXPLICIT["aqsgd-ring-det"]
    explicit += [(_spec(comm, steps=EXPLICIT_STEPS,
                        initial_params=_moved(untied_pipe, seed),
                        arch=UNTIED_ARCH), batches, warm)
                 for seed in MOVED_SEEDS]
    explicit += [(_spec(EXPLICIT[name][0], steps=EXPLICIT_STEPS,
                        initial_params=pipe, state_bits=8), batches,
                  EXPLICIT[name][1]) for name in ADAM8.values()]
    # the JAX pipeline runs in a process of its own meanwhile
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
        out = spawn(run_scenarios, D * K, (specs, explicit),
                    timeout=SPAWN_TIMEOUT,
                    store_dir=tmp_path_factory.mktemp("mesh"))
        log, _ = jax_proc.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, log
    names = list(SCENARIOS) + list(EXPLICIT) + list(REMAT) + list(UNTIED) \
        + UNTIED_MOVED + list(ADAM8)
    res = {name: [out[r][i] for r in range(D * K)]
           for i, name in enumerate(names)}
    res["jax-pipeline"] = json.loads((tmp / "losses.json").read_text())
    return res


def _jax_reference_steps(arch=ARCH):
    """The fp32 scenario by the JAX package on one device: each step's
    ``loss_fn`` loss and ``jax.grad`` gradient, and the parameters JAX
    AdamW gives after it (trees of numpy arrays)."""
    import jax
    from repro.models import model as Mo
    from repro.optim import adamw as jadamw
    cfg, params, _ = _jax_params(arch)
    opt_cfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                 schedule="constant")
    opt = jadamw.init_opt_state(params)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: Mo.loss_fn(p, cfg, b)[0]))
    losses, grads, after = [], [], []
    for batch in explicit_batches():
        b = {k: v for k, v in batch.items() if k != "sample_ids"}
        loss, g = grad_fn(params, b)
        params, opt = jadamw.apply_updates(opt_cfg, params, g, opt)
        losses.append(float(loss))
        grads.append(jax.tree.map(np.asarray, g))
        after.append(jax.tree.map(np.asarray, params))
    return losses, grads, after


def _stage_tree(tree, k):
    """Stage k's entries of a whole-model numpy tree, by stage name."""
    tcfg = tget(ARCH, smoke=True).with_(num_layers=LAYERS)
    return stage_state_dict(to_pipeline_params(tree, tcfg, K), tcfg, K, k,
                            embed=k in (0, K - 1), final_norm=k == K - 1)


def test_fp32_loss_matches_jax(runs):
    """Every fp32 step's distributed loss against JAX ``loss_fn`` at the
    parameters JAX AdamW reaches from the same start and batches."""
    ref, _, _ = _jax_reference_steps()
    for r in runs["fp32"]:
        assert r["losses"] == runs["fp32"][0]["losses"]   # ranks agree
    np.testing.assert_allclose(runs["fp32"][0]["losses"], ref, rtol=2e-4)


def test_fp32_gradients_and_update_match_jax(runs):
    """On each stage: the gradient AdamW is given at the first fp32 step
    (the mean over the global batch: the microbatch sums, both data
    shards, both halves of the tied embedding, through the bucket's
    views) against ``jax.grad`` of the whole model's loss at the same
    parameters, and at every step the stage's new parameters against
    JAX AdamW applied to the stage's parameters and gradient.  (From
    the second step on the two trajectories are not the same
    parameters: Adam's first steps move each weight by about lr
    whatever its gradient's size, so a gradient near 0 whose f32 sum
    rounds to the other sign moves its weight the other way; the
    losses of every step are held against JAX's trajectory in
    `test_fp32_loss_matches_jax`.)"""
    from repro.optim import adamw as jadamw
    _, grads, _ = _jax_reference_steps()
    opt_cfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                 schedule="constant")
    for r in runs["fp32"]:
        k = r["model_rank"]
        opt = jadamw.init_opt_state(r["params"][0])
        for step in range(EXPLICIT_STEPS):
            g = _stage_tree(grads[step], k)
            assert set(r["grads"][step]) == set(g) == set(r["params"][0])
            for n in g if step == 0 else ():
                scale = float(np.abs(g[n]).max())
                np.testing.assert_allclose(r["grads"][step][n], g[n],
                                           rtol=1e-3, atol=1e-4 * scale,
                                           err_msg=f"grad {n} step {step}")
            want, opt = jadamw.apply_updates(opt_cfg, r["params"][step],
                                             r["grads"][step], opt)
            for n, p in want.items():
                np.testing.assert_allclose(r["params"][step + 1][n],
                                           np.asarray(p), rtol=0, atol=1e-6,
                                           err_msg=f"{n} step {step}")


def test_aqsgd_dp_ring_matches_jax_pipeline(runs):
    """aqsgd (fw 4 / bw 8) with the 4-bit ring DP wire and deterministic
    rounding: the warm-up step and two compressed steps against the JAX
    package's pipeline ``train_step`` on a 2 x 2 mesh."""
    res = runs["aqsgd-ring-det"]
    for r in res:
        assert r["losses"] == res[0]["losses"]
        for rep in r["replicas"]:
            assert rep["m_in_equal"] in (None, True)
            assert rep["embed_equal"] in (None, True)
    np.testing.assert_allclose(res[0]["losses"], runs["jax-pipeline"][ARCH],
                               rtol=2e-4)


def test_untied_fp32_matches_jax(runs):
    """stablelm-12b SMOKE (4 layers, its own head) in fp32: every loss
    against JAX ``loss_fn`` along JAX AdamW's trajectory (rtol 2e-4),
    the first step's gradient of every stage parameter, ``head``
    included, against ``jax.grad`` and every step's update against JAX
    AdamW, at the tied fp32 tests' tolerances; the last stage holds
    ``head`` and no embedding, so no embedding copy is checked."""
    from repro.optim import adamw as jadamw
    ref, grads, _ = _jax_reference_steps(UNTIED_ARCH)
    res = runs["untied/fp32"]
    tcfg = tget(UNTIED_ARCH, smoke=True).with_(num_layers=LAYERS)
    opt_cfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                 schedule="constant")
    for r in res:
        assert r["losses"] == res[0]["losses"]
        k = r["model_rank"]
        last = k == K - 1
        assert ("head" in r["params"][0]) == last
        assert ("embed" in r["params"][0]) == (not last)
        assert all(rep["embed_equal"] is None for rep in r["replicas"])
        g = stage_state_dict(to_pipeline_params(grads[0], tcfg, K), tcfg,
                             K, k, embed=k == 0, final_norm=last, head=last)
        assert set(r["grads"][0]) == set(g)
        for n in g:
            scale = float(np.abs(g[n]).max())
            np.testing.assert_allclose(r["grads"][0][n], g[n], rtol=1e-3,
                                       atol=1e-4 * scale, err_msg=n)
        opt = jadamw.init_opt_state(r["params"][0])
        for step in range(EXPLICIT_STEPS):
            want, opt = jadamw.apply_updates(opt_cfg, r["params"][step],
                                             r["grads"][step], opt)
            for n, p in want.items():
                np.testing.assert_allclose(r["params"][step + 1][n],
                                           np.asarray(p), rtol=0, atol=1e-6,
                                           err_msg=f"{n} step {step}")
    np.testing.assert_allclose(res[0]["losses"], ref, rtol=2e-4)


def test_untied_head_matches_jax_pipeline(runs):
    """stablelm-12b SMOKE under the tied ring case's settings (aqsgd fw
    4 / bw 8 and the 4-bit ring, deterministic) against the JAX
    package's pipeline.  Each step's loss within twice the spread the
    port's own run shows there when its weights move by 1e-7 of their
    size (the largest of MOVED_SEEDS' relative differences), and within
    the tied case's rtol 2e-4 where that spread is smaller.  With the
    untied head the third loss moves by up to 1.0e-3 under such moves,
    and sits 1.0e-3 from JAX's, whose f32 sums run in another order;
    the first two move by under 4e-5 and hold to 2e-4."""
    res = runs["untied/aqsgd-ring-det"]
    for r in res:
        assert r["losses"] == res[0]["losses"]
        for rep in r["replicas"]:
            assert rep["embed_equal"] is None
            assert rep["m_in_equal"] in (None, True)
        if r["model_rank"] == K - 1:
            assert all(rep["m_in_equal"] is True for rep in r["replicas"])
            assert not np.array_equal(r["params"][-1]["head"],
                                      r["params"][0]["head"])
    got = np.asarray(res[0]["losses"])
    moved = np.asarray([runs[name][0]["losses"] for name in UNTIED_MOVED])
    spread = (np.abs(moved - got) / np.abs(got)).max(axis=0)
    want = np.asarray(runs["jax-pipeline"][UNTIED_ARCH])
    gap = np.abs(got - want) / np.abs(want)
    limit = np.maximum(2e-4, 2 * spread)
    print(f"untied pipeline: gap to JAX {gap.tolist()} spread under "
          f"{MOVE} moves {spread.tolist()} limit {limit.tolist()}")
    assert (gap <= limit).all(), (gap, spread, limit)


@pytest.mark.parametrize("name", ["aqsgd", "zbit"])
def test_aqsgd_buffer_replicas_and_losses(runs, name):
    res = runs[name]
    for r in res:
        assert r["warm_steps"] == 1
        for step, rep in enumerate(r["replicas"]):
            if r["model_rank"] == 1:
                assert rep["m_in_equal"] is True, (r["rank"], step)
    losses = res[0]["losses"]
    assert all(r["losses"] == losses for r in res)
    assert np.all(np.isfinite(losses)), losses
    assert losses[-1] < losses[1], losses          # compressed steps fall
    # the hop bytes each rank sent, per step, against the codec's model
    cfg = tget(ARCH, smoke=True)
    mb = BATCH // D // M
    raw = M * mb * SEQ * cfg.d_model * 4
    fw = M * TQ.wire_bytes((mb, SEQ, cfg.d_model), 4)
    bw = M * TQ.wire_bytes((mb, SEQ, cfg.d_model), 8)
    for r in res:
        for step, b in enumerate(r["bytes"]):
            warm = step < r["warm_steps"]
            if r["model_rank"] == 0:
                assert (b["fw"], b["bw"]) == (raw if warm else fw, 0)
            else:
                assert (b["fw"], b["bw"]) == (0, raw if warm else bw)


def test_ring_and_psum_losses_are_bit_identical(runs):
    ring = runs["ring"][0]["losses"]
    assert np.all(np.isfinite(ring)) and len(ring) == 4
    assert runs["psum"][0]["losses"] == ring
    assert runs["ring/K2"][0]["losses"] == ring
    for r in runs["ring"]:
        assert r["losses"] == ring
        # the DP wire's calls each step: the registry's manifest
        rows = runs["ring"][0]["dp_bucket"]
        assert r["manifests"][0] == TW.get_wire("ring").expected_collectives(
            tuple(rows), 4, D)


def test_ring_sharded_losses_equal_ring(runs):
    """The ZeRO wire: the ring's losses bit for bit (the segment means
    are rows of the ring's mean, the bucket AdamW the per-leaf update's
    ops), 2 chunks the same; the dp plane's bytes and calls are the
    registry's, the parameter all-gather's bytes one f32 segment."""
    from repro_torch.core import collectives as TC
    ring = runs["ring"][0]["losses"]
    rows = tuple(runs["ring-sharded"][0]["dp_bucket"])
    spec = TW.get_wire("ring-sharded")
    for name, steps in (("ring-sharded", 4), ("ring-sharded/K2", 2)):
        for r in runs[name]:
            assert r["losses"] == ring[:steps], name
            for b in r["bytes"]:
                assert b["dp"] == spec.wire_bytes(rows, 4, D) \
                    == TC.ring_wire_bytes(rows, 4, D, sharded=True)
                assert b["dp-gather"] == TC.param_gather_bytes(rows, D) \
                    == TC.ring_segment_rows(rows[0], D) * rows[1] * 4
            if name == "ring-sharded":
                assert r["manifests"][0] == spec.expected_collectives(
                    rows, 4, D)
            if r["model_rank"] == K - 1:
                assert all(rep["m_in_equal"] is True
                           for rep in r["replicas"])


def test_fp16_wire_bytes(runs):
    rows = tuple(runs["fp16"][0]["dp_bucket"])
    for r in runs["fp16"]:
        assert np.all(np.isfinite(r["losses"]))
        assert r["losses"] == runs["fp16"][0]["losses"]
        for b, man in zip(r["bytes"], r["manifests"]):
            assert b["dp"] == rows[0] * rows[1] * 2
            assert b["dp-gather"] == 0
            assert man == [("all-reduce", "f16", rows[0] * rows[1] * 2, 1)]


def test_adam8_steps_like_per_leaf_8bit_adamw(runs):
    """8-bit moments on the distributed trainer: each stage's parameters
    after every step equal the port's per-leaf 8-bit AdamW applied to
    that step's gradient, bit for bit, from the same start."""
    cfg = PL.adamw.AdamWConfig(lr=1e-3, warmup_steps=1, schedule="constant",
                               state_bits=8)
    # one thread, as the ranks run: in this process, which has run JAX,
    # a replay over torch's thread pool was seen to put one thread's
    # chunk of the embedding (1/8 of it) a rounding off the ranks'
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _replay_adam8(runs, cfg)
    finally:
        torch.set_num_threads(threads)
    # the f32-moment run of the same batches ends on other weights (the
    # first step's update is sign(g) with either moments)
    for r, f32 in zip(runs["adam8"], runs["aqsgd-ring-det"]):
        assert any(not np.array_equal(a, f32["params"][-1][n])
                   for n, a in r["params"][-1].items())


def _replay_adam8(runs, cfg):
    for r in runs["adam8"]:
        assert r["losses"] == runs["adam8"][0]["losses"]
        params = {n: torch.from_numpy(a.copy())
                  for n, a in r["params"][0].items()}
        opt = PL.adamw.init_opt_state(params, 8)
        for step in range(EXPLICIT_STEPS):
            opt = PL.adamw.apply_updates(
                cfg, params, {n: torch.from_numpy(g)
                              for n, g in r["grads"][step].items()}, opt)
            for n, p in params.items():
                assert np.array_equal(p.numpy().view(np.int32),
                                      r["params"][step + 1][n].view(
                                          np.int32)), (r["rank"], n, step)


def test_remat_modes_are_bit_identical(runs):
    """Remat off and per layer against the nested default: the same
    losses, gradients and parameters at every step, bit for bit, and
    the buffer replicas equal."""
    base = runs["remat/nested"]
    for name in ("remat/off", "remat/layer"):
        for r, b in zip(runs[name], base):
            assert r["losses"] == b["losses"], name
            for mine, want in zip(r["grads"] + r["params"],
                                  b["grads"] + b["params"]):
                assert mine.keys() == want.keys()
                for key in mine:
                    assert np.array_equal(mine[key].view(np.int32),
                                          want[key].view(np.int32)), \
                        (name, r["rank"], key)
            if r["model_rank"] == K - 1:
                assert all(rep["m_in_equal"] is True
                           for rep in r["replicas"]), name


def test_tied_embedding_copies_stay_equal(runs):
    for name in [*SCENARIOS, *EXPLICIT, *REMAT, *ADAM8]:
        for r in runs[name]:
            if r["model_rank"] == K - 1:
                assert len(r["replicas"]) == len(r["losses"])
                assert all(rep["embed_equal"] is True
                           for rep in r["replicas"]), (name, r["rank"])


def test_pipeline_params_and_bucket_match_jax():
    """to/from_pipeline_params and the DP bucket's leaf order against
    the JAX package, on 3 stages over 4 layers (2 dead padded layers)."""
    import jax
    from repro.core import grad_compress as JG
    from repro.training import pipeline as JPL
    jcfg, params, np_params = _jax_params()
    tcfg = tget(ARCH, smoke=True).with_(num_layers=LAYERS)
    kk = 3
    jpipe = jax.tree.map(np.asarray, JPL.to_pipeline_params(jcfg, params,
                                                            kk))
    pipe = to_pipeline_params(np_params, tcfg, kk)
    for name, a in jpipe["stages"]["attn"].items():
        np.testing.assert_array_equal(pipe["stages"][f"attn.{name}"], a)
    back = from_pipeline_params(pipe, tcfg, kk)
    np.testing.assert_array_equal(back["layers"]["ffn.w_up"],
                                  np_params["layers"]["ffn"]["w_up"])
    lay = PL.stage_layout(tcfg, kk)
    assert (lay.lps, lay.n_padded) == (2, 2)
    bucket = PL.PipelineBucket(tcfg, lay, 512)
    jlay = JG.bucket_layout(jpipe, 512)
    assert bucket.shape == (jlay.rows, jlay.group_d)
    jflat = np.asarray(JG.flatten_bucket(jpipe, jlay)).reshape(-1)
    for k in range(kk):
        stage = PL.Stage(tcfg, lay, k).load_pipeline_params(pipe, lay)
        state = stage_state_dict(pipe, tcfg, kk, k, embed=k in (0, kk - 1),
                                 final_norm=k == kk - 1)
        assert set(state) == {n for n, _ in stage.named_parameters()}
        for name, p in stage.named_parameters():
            off, n = bucket.slot(stage, name)
            np.testing.assert_array_equal(
                jflat[off:off + n], p.detach().numpy().reshape(-1))
        flat = bucket.flatten(stage, dict(stage.named_parameters()))
        views = bucket.views(stage, flat, dict(stage.named_parameters()))
        for name, p in stage.named_parameters():
            assert torch.equal(views[name], p.detach())


@pytest.mark.parametrize("buffer_bits", [0, 8])
def test_buffers_match_jax(buffer_bits):
    import jax
    import jax.numpy as jnp
    from repro.comm.config import CommConfig as JComm
    from repro.training import pipeline as JPL
    rng = np.random.default_rng(buffer_bits)
    n, seq, d = 6, 4, 64
    val = rng.standard_normal((2, seq, d)).astype(np.float32)
    ids = np.array([4, 1], np.int32)
    jcomm = JComm.from_dict({"mode": "aqsgd", "zbuf": {"bits": buffer_bits}})
    jp = JPL.PipelineConfig(microbatches=2, comm=jcomm)
    tp = PL.PipelineConfig(microbatches=2,
                           comm=CommConfig.from_json(jcomm.to_json()))
    zeros = jax.tree.map(lambda x: jnp.zeros(x.shape[1:], x.dtype),
                         JPL.buffer_structs(jp, 1, n, seq, d))
    # jitted, as the JAX trainer runs them (queue C: jit vs eager dequant)
    jbuf = jax.jit(lambda b, v: JPL.buffer_write(
        jp, b, ids, v, np.ones(2, bool)))(zeros, val)
    tbuf = PL.init_buffer(tp, n, seq, d, "cpu")
    PL.buffer_write(tp, tbuf, torch.tensor(ids).long(), torch.tensor(val))
    if buffer_bits:
        for key in ("codes", "scale"):
            np.testing.assert_array_equal(np.asarray(jbuf[key]),
                                          tbuf[key].numpy())
    else:
        np.testing.assert_array_equal(
            np.asarray(jbuf.astype(jnp.float32)), tbuf["m"].float().numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.jit(lambda b: JPL.buffer_read(jp, b, ids))(jbuf)),
        PL.buffer_read(tp, tbuf, torch.tensor(ids).long(), d).numpy())


def test_distributed_launcher_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(tlaunch, "JOIN_TIMEOUT", SPAWN_TIMEOUT)
    results, losses = tlaunch.main(
        ["--device", "cpu", "--smoke", "--distributed", "--data-par", "2",
         "--stages", "2", "--dp-grad-bits", "4", "--steps", "3", "--seq",
         "16", "--samples", "8", "--batch", "4"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "final loss" in out
    assert len(results) == 4 and len(losses) == 3
    assert np.all(np.isfinite(losses))
    assert results[0]["warm_steps"] == 2            # 8 samples / batch 4
    for flag in (["--fault", "1:dp:nan-scale"], ["--kill-at", "1"]):
        with pytest.raises(SystemExit):
            tlaunch.main(["--device", "cpu", "--smoke", "--distributed",
                          *flag])
        assert "multi-process pipeline" in capsys.readouterr().err
    for wire in ("ring-sharded", "fp16"):
        pcfg = PL.PipelineConfig(comm=_comm("aqsgd", dp_bits=4, wire=wire))
        assert pcfg.comm.dp_wire_spec is TW.get_wire(wire)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.main(["--smoke", "--distributed", "--steps", "1"])


class _Loopback:
    """A transport whose sends queue up for its own receives (one rank
    is both ends of a hop)."""

    def __init__(self):
        self.queues = {}

    def send(self, t, peer, plane):
        self.queues.setdefault(plane, []).append(t.clone())

    def recv(self, shape, dtype, peer, plane):
        t = self.queues[plane].pop(0)
        assert (t.shape, t.dtype) == (tuple(shape), dtype)
        return t


@pytest.mark.parametrize("bw_bits", [8, 32])
@pytest.mark.parametrize("mode", PL.MODES)
def test_transfer_matches_jax(mode, bw_bits):
    """One stage hop, deterministic rounding, forward and backward, bit
    for bit against the JAX package's ``make_transfer`` (jitted, its
    ppermute over a vmapped 2-stage axis): what the next stage computes
    on, the new m_out and m_in, and the gradient the sender receives.
    In aqsgd the next stage computes on the f32 m_in that B2 returns,
    not on its bf16 copy in the buffer, as in the JAX package."""
    import jax
    import jax.numpy as jnp
    from repro.training import pipeline as JPL
    rng = np.random.default_rng(PL.MODES.index(mode) * 100 + bw_bits)
    shape = (2, 8, 64)
    out = rng.standard_normal((2, *shape)).astype(np.float32)
    # the buffers' messages: bf16 values (both replicas hold the same)
    msg = np.asarray(jnp.asarray(rng.standard_normal((2, *shape)),
                                 jnp.bfloat16).astype(jnp.float32))
    g = rng.standard_normal((2, *shape)).astype(np.float32)
    tr = JPL.make_transfer(mode, 4, bw_bits, False, 2)

    def hop(o, mo, mi, gg):
        (recv, nmo, nmi), vjp = jax.vjp(
            lambda x: tr(x, mo, mi, jax.random.PRNGKey(0)), o)
        return recv, nmo, nmi, vjp((gg, jnp.zeros_like(nmo),
                                    jnp.zeros_like(nmi)))[0]

    recv, nmo, nmi, gout = map(np.asarray, jax.jit(jax.vmap(
        hop, axis_name="model"))(out, msg, msg, g))
    # stage 0 sends to stage 1: its (recv, nmi) are JAX's [1], the
    # sender's (nmo, gradient) JAX's [0]
    t = PL.Transfer(mode, 4, bw_bits, False, "reference", _Loopback(),
                    src=0, dst=0)
    o0 = torch.tensor(out[0], requires_grad=True)
    token, t_nmo = t.send(o0, torch.tensor(msg[0]))
    h, t_nmi = t.recv(shape, torch.float32, torch.tensor(msg[1]))
    h.backward(torch.tensor(g[1]))
    token.backward()
    np.testing.assert_array_equal(h.detach().numpy(), recv[1])
    np.testing.assert_array_equal(o0.grad.numpy(), gout[0])
    if mode in ("warmup", "aqsgd"):
        np.testing.assert_array_equal(t_nmo.detach().numpy(), nmo[0])
        np.testing.assert_array_equal(t_nmi.detach().numpy(), nmi[1])
    else:
        assert t_nmo is None and t_nmi is None
    if mode == "aqsgd":
        rounded = np.asarray(jnp.asarray(recv[1], jnp.bfloat16)
                             .astype(jnp.float32))
        assert not np.array_equal(recv[1], rounded)


if __name__ == "__main__":
    _jax_pipeline_losses(sys.argv[1], sys.argv[2])
