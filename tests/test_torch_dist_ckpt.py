"""The distributed trainer's checkpoint against the JAX launcher's
(`repro_torch.training.pipeline_state` against `repro.launch.train`'s
``--distributed`` state), on the CPU.

* Structure: for each case of `STRUCTS` the port's global structure
  has the ``tree_fingerprint`` of the state the JAX launcher builds,
  ``jax.eval_shape`` of it (8-bit moments: ``make_state_structs``'
  ``opt_state_bits=8``), each axis once: five archs on a 2 x 2 mesh
  with the ring (deepseek-moe-16b in ``zero3`` and
  ``expert_parallel``), the ``psum``, ``ring-sharded`` and ``fp16``
  wires and 8-bit z-bit buffers on a 1 x 2 mesh, 8-bit moments.
* Resume across the packages: ``gpt2-xl-paper`` SMOKE on a 2 x 2 mesh,
  aqsgd fw 4 / bw 8 deterministic with the 4-bit ``ring``, from the JAX
  package's parameters, on explicit batches whose sample ids index each
  data rank's own message rows (where JAX's buffers keep them).  A
  gloo spawn runs the port to step 4, committing step 2; one JAX
  subprocess (this file as a script, 4 host devices) runs JAX to step
  4, committing step 2 with ``save_state``, then ``restore_state``s the
  port's step 2 (its fingerprint and comm checks) and runs steps 2-3;
  a second spawn restores JAX's step 2 in the port and runs steps 2-3,
  beside a stale sidecar of random rows (a port save cut before its
  main step would leave one), which it must not take: its stamp is not
  the main step's.  JAX -> port: the port's steps 2-3 match JAX's
  uninterrupted ones;
  port -> JAX: JAX's match the port's; both within rtol 2e-4 (the
  tolerance of tests/test_torch_pipeline.py).

The JAX package is imported inside the tests and the script only, so
the spawned ranks, which import this module for `explicit_worker`, do
not load it.
"""
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ck
from repro_torch.comm.config import CommConfig, PlaneConfig
from repro_torch.configs.base import get_config as tget
from repro_torch.launch.mesh import spawn
from repro_torch.optim import adamw
from repro_torch.training import pipeline as PL
from repro_torch.training import pipeline_state as PS
from repro_torch.weights import to_pipeline_params


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TIMEOUT = 300
ARCH, D, K, M = "gpt2-xl-paper", 2, 2, 2
BATCH, SEQ, SAMPLES, STEPS, SAVE_AT, WARM = 4, 32, 4, 4, 2, 1
LR = 1e-3
# each data rank's two samples of a step are its rows 0 and 1
SAMPLE_IDS = np.array([0, 0, 1, 1], np.int32)


def _comm(*, wire="ring", zbits=0):
    return CommConfig(mode="aqsgd", fw=PlaneConfig(bits=4, stochastic=False),
                      bw=PlaneConfig(bits=8, stochastic=False),
                      zbuf=PlaneConfig(bits=zbits),
                      dp=PlaneConfig(bits=4, wire=wire, stochastic=False))


# the structure cases: name -> (arch, data, stages, comm, moe_mode,
# state_bits), SMOKE, STRUCT_SAMPLES samples of STRUCT_SEQ tokens
STRUCTS = {
    "gpt2-xl-paper": (ARCH, 2, 2, _comm(), "zero3", 0),
    "stablelm-12b": ("stablelm-12b", 2, 2, _comm(), "zero3", 0),
    "mamba2-1.3b": ("mamba2-1.3b", 2, 2, _comm(), "zero3", 0),
    "zamba2-2.7b": ("zamba2-2.7b", 2, 2, _comm(), "zero3", 0),
    "deepseek-moe-16b/zero3": ("deepseek-moe-16b", 2, 2, _comm(), "zero3",
                               0),
    "deepseek-moe-16b/expert_parallel": ("deepseek-moe-16b", 2, 2, _comm(),
                                         "expert_parallel", 0),
    "psum": (ARCH, 1, 2, _comm(wire="psum"), "zero3", 0),
    "ring-sharded": (ARCH, 1, 2, _comm(wire="ring-sharded"), "zero3", 0),
    "fp16": (ARCH, 1, 2, _comm(wire="fp16"), "zero3", 0),
    "zbit8": (ARCH, 1, 2, _comm(zbits=8), "zero3", 0),
    "adam8": (ARCH, 2, 2, _comm(), "zero3", 8),
}
STRUCT_SAMPLES, STRUCT_SEQ, STRUCT_BATCH = 8, 16, 4


def _layout(arch, data, stages, comm, moe_mode, bits, samples, seq):
    return PS.Layout(tget(arch, smoke=True),
                     PL.PipelineConfig(microbatches=M, comm=comm,
                                       moe_mode=moe_mode),
                     adamw.AdamWConfig(state_bits=bits), data, stages,
                     samples, seq)


def _items(tree) -> list:
    """Sorted [key, shape, dtype] triples of a port structure."""
    return json.loads(json.dumps(ck.checkpoint._struct_items(tree)))


def _spec(initial_params):
    return {"arch": ARCH, "smoke": True, "num_layers": 0,
            "comm": _comm().to_json(), "device": "cpu", "data_par": D,
            "stages": K, "microbatches": M, "steps": STEPS, "batch": BATCH,
            "warmup_epochs": 1, "seed": 0,
            "optimizer": {"lr": LR, "warmup_steps": 1,
                          "schedule": "constant"},
            "dataset": {"num_samples": SAMPLES, "seq_len": SEQ,
                        "vocab_size": tget(ARCH, smoke=True).vocab_size},
            "initial_params": initial_params}


def explicit_batches():
    rng = np.random.default_rng(11)
    vocab = tget(ARCH, smoke=True).vocab_size
    return [{"tokens": rng.integers(0, vocab, (BATCH, SEQ), dtype=np.int32),
             "targets": rng.integers(0, vocab, (BATCH, SEQ), dtype=np.int32),
             "mask": (rng.random((BATCH, SEQ)) < 0.9).astype(np.float32),
             "sample_ids": SAMPLE_IDS.copy()} for _ in range(STEPS)]


def explicit_worker(rank, world, spec, batches, save_dir, resume_dir):
    """Train on ``batches`` (the first `WARM` with the warm-up step),
    from ``resume_dir``'s newest checkpoint if given, committing step
    `SAVE_AT` into ``save_dir`` if given; the losses of the steps run,
    the start, the restore's report and whether the message rows past
    the JAX layout's were zero after it."""
    trainer, _ = PL.build_rank(rank, world, spec)
    out = {"start": 0, "restore": None, "losses": []}
    if resume_dir:
        out["restore"] = PS.restore(trainer, resume_dir)
        out["start"] = out["restore"]["step"]
        n = PS.layout_of(trainer).n_loc
        out["extra_rows_zero"] = all(
            not t[n:].any() for buf in (trainer.m_out, trainer.m_in)
            if buf is not None for t in buf.values())
    for i in range(out["start"], len(batches)):
        out["losses"].append(trainer.step(PL.rank_batch(trainer, batches[i]),
                                          i, warmup=i < WARM))
        if save_dir and i + 1 == SAVE_AT:
            PS.save(trainer, save_dir, SAVE_AT)
    return out


# ---------------------------------------------------------------------------
# the JAX side (this file as a script)
# ---------------------------------------------------------------------------

def _jax_comm(comm):
    from repro.comm.config import CommConfig as JComm
    return JComm.from_json(comm.to_json())


def _jax_launcher_state(cfg, pcfg, mesh, data, stages, samples, seq):
    """The JAX launcher's ``--distributed`` state (`repro.launch.train`,
    lines 163-193), its ``jax.random.PRNGKey(0)`` parameters."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as Mo
    from repro.optim import adamw as jadamw
    from repro.training import pipeline as JPL
    comm = pcfg.comm
    params = JPL.to_pipeline_params(
        cfg, Mo.init_params(cfg, jax.random.PRNGKey(0)), stages)
    if comm.dp.bits and comm.dp_wire_spec.sharded:
        opt_state = JPL.init_sharded_opt(pcfg, params, data)
    else:
        opt_state = jadamw.init_opt_state(params)
    state = {"params": params, "opt": opt_state}
    if comm.dp.bits:
        state["dp_error"] = JPL.init_dp_error(pcfg, params, data)
    if comm.mode == "aqsgd":
        n_loc = samples // data
        structs = JPL.buffer_structs(pcfg, stages, data * n_loc, seq,
                                     cfg.d_model)
        zeros = lambda s: jnp.zeros(s.shape, s.dtype)  # noqa: E731
        state["m_out"] = jax.tree.map(zeros, structs)
        state["m_in"] = jax.tree.map(zeros, structs)
    return state


def _jax_items(tree) -> list:
    import jax
    from repro.checkpoint.checkpoint import _leaf_key
    return sorted([_leaf_key(p), [int(s) for s in leaf.shape],
                   str(np.dtype(leaf.dtype))]
                  for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0])


def _jax_structs() -> dict:
    """{case: (fingerprint, items)} of the JAX launcher's state."""
    import jax
    from repro.checkpoint.checkpoint import tree_fingerprint
    from repro.configs.base import get_config as jget
    from repro.launch.mesh import make_debug_mesh
    from repro.optim import adamw as jadamw
    from repro.training import pipeline as JPL
    out = {}
    for name, (arch, data, stages, comm, mode, bits) in STRUCTS.items():
        cfg = jget(arch, smoke=True)
        mesh = make_debug_mesh(data, stages)
        pcfg = JPL.PipelineConfig(microbatches=M, comm=_jax_comm(comm),
                                  moe_mode=mode)
        if bits:
            _, meta = JPL.make_train_step(
                cfg, pcfg, mesh, jadamw.AdamWConfig(state_bits=bits),
                global_batch=STRUCT_BATCH, seq_len=STRUCT_SEQ,
                buffer_samples=STRUCT_SAMPLES // data)
            state = JPL.make_state_structs(
                cfg, pcfg, meta, mesh, global_batch=STRUCT_BATCH,
                seq_len=STRUCT_SEQ, opt_state_bits=bits)[0]
        else:
            state = jax.eval_shape(lambda: _jax_launcher_state(
                cfg, pcfg, mesh, data, stages, STRUCT_SAMPLES, STRUCT_SEQ))
        out[name] = (tree_fingerprint(state), _jax_items(state))
    return out


def _jax_runs(batches_path, port_dir, jax_dir, ready):
    """JAX's uninterrupted run (committing step `SAVE_AT` into
    ``jax_dir``) and its run from the port's checkpoint in
    ``port_dir``, once the file ``ready`` exists: their losses."""
    import jax
    from repro import checkpoint as jck
    from repro.configs.base import get_config as jget
    from repro.launch.mesh import make_debug_mesh
    from repro.optim import adamw as jadamw
    from repro.training import pipeline as JPL
    cfg = jget(ARCH, smoke=True)
    comm = _jax_comm(_comm())
    mesh = make_debug_mesh(D, K)
    opt = jadamw.AdamWConfig(lr=LR, warmup_steps=1, schedule="constant")
    step_fn = {w: JPL.make_train_step(
        cfg, JPL.PipelineConfig(microbatches=M, warmup=w, comm=comm), mesh,
        opt, global_batch=BATCH, seq_len=SEQ,
        buffer_samples=SAMPLES // D)[0] for w in (True, False)}
    pcfg = JPL.PipelineConfig(microbatches=M, comm=comm)
    state = _jax_launcher_state(cfg, pcfg, mesh, D, K, SAMPLES, SEQ)
    like = jax.eval_shape(lambda: state)
    data = np.load(batches_path)

    def run(state, steps, save_dir=""):
        losses = []
        for i in steps:
            batch = {k: data[f"{i}/{k}"].reshape(M, BATCH // M,
                                                  *data[f"{i}/{k}"].shape[1:])
                     for k in ("tokens", "targets", "mask", "sample_ids")}
            state, met = step_fn[i < WARM](state, batch,
                                           jax.random.fold_in(
                                               jax.random.PRNGKey(1), i))
            losses.append(float(met["loss"]))
            if i + 1 == SAVE_AT and save_dir:
                jck.save_state(save_dir, state, step=SAVE_AT, comm=comm,
                               extra={"data_position": SAVE_AT}, keep=3)
        return losses

    base = run(state, range(STEPS), jax_dir)
    deadline = time.time() + TIMEOUT
    while not os.path.exists(ready):
        if time.time() > deadline:
            raise TimeoutError(f"{ready} never appeared")
        time.sleep(0.2)
    restored, body = jck.restore_state(port_dir, like, comm=comm)
    return {"base": base, "from_port": run(restored, range(int(body["step"]),
                                                          STEPS)),
            "from_port_step": int(body["step"])}


def _jax_main(workdir):
    job = json.loads(open(os.path.join(workdir, "job.json")).read())
    out = {"structs": _jax_structs()}
    out.update(_jax_runs(**job))
    with open(os.path.join(workdir, "jax.json"), "w") as f:
        json.dump(out, f)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    from repro.configs.base import get_config as jget
    from repro.models import model as Mo
    np_params = jax.tree.map(np.asarray, Mo.init_params(
        jget(ARCH, smoke=True), jax.random.PRNGKey(0)))
    spec = _spec(to_pipeline_params(np_params, tget(ARCH, smoke=True), K))
    batches = explicit_batches()
    work = tmp_path_factory.mktemp("dist_ckpt")
    dirs = {k: str(work / k) for k in ("port", "jax")}
    np.savez(work / "batches.npz", **{f"{i}/{k}": v
                                      for i, b in enumerate(batches)
                                      for k, v in b.items()})
    (work / "job.json").write_text(json.dumps({
        "batches_path": str(work / "batches.npz"), "port_dir": dirs["port"],
        "jax_dir": dirs["jax"], "ready": str(work / "ready")}))
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=src,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen(
        [sys.executable, __file__, str(work)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port = spawn(explicit_worker, D * K,
                     (spec, batches, dirs["port"], ""), timeout=TIMEOUT,
                     store_dir=tmp_path_factory.mktemp("mesh1"))
        (work / "ready").write_text("")
        log, _ = jax_proc.communicate(timeout=TIMEOUT)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, log
    stale = str(work / "jax_stale_rows")
    shutil.copytree(dirs["jax"], stale)
    lo = PS.spec_layout(spec)
    gen = torch.Generator().manual_seed(5)
    ck.save_state(PS.rows_dir(stale),
                  {k: torch.randn(v.shape, generator=gen).to(v.dtype)
                   for k, v in PS.rows_structs(lo).items()},
                  step=SAVE_AT, comm=_comm(),
                  extra={"data_position": SAVE_AT, "first_row": lo.n_loc,
                         PS.STAMP: "0" * 32})
    from_jax = spawn(explicit_worker, D * K, (spec, batches, "", stale),
                     timeout=TIMEOUT,
                     store_dir=tmp_path_factory.mktemp("mesh2"))
    return {"port": port, "from_jax": from_jax, "dirs": dirs,
            "jax": json.loads((work / "jax.json").read_text())}


@pytest.mark.parametrize("case", list(STRUCTS))
def test_global_structure_matches_jax(case, runs):
    arch, data, stages, comm, mode, bits = STRUCTS[case]
    tree = PS.global_structs(_layout(arch, data, stages, comm, mode, bits,
                                     STRUCT_SAMPLES, STRUCT_SEQ))
    fingerprint, items = runs["jax"]["structs"][case]
    assert _items(tree) == items
    assert ck.tree_fingerprint(tree) == fingerprint


def test_uninterrupted_runs_agree(runs):
    for r in runs["port"]:
        assert r["losses"] == runs["port"][0]["losses"]
    np.testing.assert_allclose(runs["port"][0]["losses"],
                               runs["jax"]["base"], rtol=2e-4)


def test_port_resumes_jax_checkpoint(runs):
    """JAX -> port: the port's steps 2-3 from JAX's step-2 checkpoint
    against JAX's uninterrupted steps; JAX writes no sidecar, and the
    stale one beside its step is not taken."""
    for r in runs["from_jax"]:
        assert r["start"] == SAVE_AT and r["restore"]["rows"] is False
        assert r["extra_rows_zero"] is True
        assert r["losses"] == runs["from_jax"][0]["losses"]
    np.testing.assert_allclose(runs["from_jax"][0]["losses"],
                               runs["jax"]["base"][SAVE_AT:], rtol=2e-4)


def test_jax_resumes_port_checkpoint(runs):
    """Port -> JAX: JAX's steps 2-3 from the port's step-2 checkpoint
    (which passed JAX's fingerprint and comm checks) against the
    port's uninterrupted steps."""
    assert runs["jax"]["from_port_step"] == SAVE_AT
    np.testing.assert_allclose(runs["jax"]["from_port"],
                               runs["port"][0]["losses"][SAVE_AT:],
                               rtol=2e-4)


def test_both_packages_write_one_layout(runs):
    """The two step-2 manifests: the same fingerprint, the same arrays
    (keys, shapes, dtypes), JAX's ``extra`` (the port's with its
    sidecar's stamp); the port's sidecar beside
    its main step, none beside JAX's."""
    body = {}
    for who, d in runs["dirs"].items():
        path = os.path.join(d, "step_%08d" % SAVE_AT, ck.MANIFEST_NAME)
        body[who] = json.loads(open(path).read())["body"]
    assert body["port"]["fingerprint"] == body["jax"]["fingerprint"]
    assert body["port"]["comm"] == body["jax"]["comm"]
    # JAX's ``extra``, and the stamp the port's sidecar carries
    side = ck.read_manifest(PS.rows_dir(runs["dirs"]["port"]), SAVE_AT)
    stamp = side["extra"][PS.STAMP]
    assert len(stamp) == 32 and side["extra"] == {
        "data_position": SAVE_AT, "first_row": SAMPLES // D, PS.STAMP: stamp}
    assert body["jax"]["extra"] == {"data_position": SAVE_AT}
    assert body["port"]["extra"] == {"data_position": SAVE_AT,
                                     PS.STAMP: stamp}
    for who in body:
        body[who] = {k: (v["shape"], v["dtype"], v["stored_dtype"])
                     for k, v in body[who]["arrays"].items()}
    assert body["port"] == body["jax"]
    assert sorted(os.listdir(runs["dirs"]["port"])) == [
        "step_%08d" % SAVE_AT, PS.ROWS_DIR]
    assert sorted(os.listdir(runs["dirs"]["jax"])) == ["step_%08d" % SAVE_AT]


if __name__ == "__main__":
    _jax_main(sys.argv[1])
