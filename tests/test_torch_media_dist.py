"""The audio and vlm families in the distributed trainer against the
JAX package (the model, serving and the simulated trainer are
tests/test_torch_audio.py's and tests/test_torch_vlm.py's).

* the DP bucket: every stage parameter sits where JAX's
  ``flatten_bucket`` of the pipeline tree puts it (whisper's stacked
  encoder leaves after ``embed``, in one slot that every stage's copy
  writes; pixtral's untied head on the last stage);
* one spawn of a 2 x 2 gloo mesh (one torch thread a rank, a join
  timeout; the ranks run tests/test_torch_pipeline.py's JAX-free
  `run_scenarios`) running both archs at SMOKE size on batches that
  carry frames (4, 32, 256) or patches (4, 16, 256): in fp32 the losses
  along JAX ``loss_fn`` and AdamW's trajectory (rtol 2e-4) and each
  stage's first gradient against ``jax.grad`` (the encoder's summed over
  the stages, as every stage holds it); aqsgd with the 4-bit ring,
  deterministic, against the JAX package's pipeline ``train_step`` on
  a 2 x 2 mesh of host devices fed the same batches, run meanwhile in a
  subprocess (this file as a script), rtol 2e-4, and for pixtral, whose
  untied head makes its later losses move under f32 noise as
  stablelm-12b's do, within twice the spread of the port's runs from
  weights moved by 1e-7 of their size where that is wider
  (tests/test_torch_pipeline.py's yardstick); the encoder's copies
  bit-equal on every stage after every step, as are the message
  buffers.
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
from repro.core import grad_compress as JG
from repro.launch.mesh import make_debug_mesh
from repro.optim import adamw as jadamw
from repro.training import pipeline as JPL
from repro_torch.launch.mesh import spawn
from repro_torch.training import pipeline as PL
from repro_torch.weights import stage_state_dict, to_pipeline_params
from test_torch_audio import media_inputs
from test_torch_hybrid_dist import aqsgd_det_comm
from test_torch_pipeline import MOVE, _moved, run_scenarios
from test_torch_ssm import (DIST_RTOL, SPAWN_TIMEOUT, arch_params,
                            dist_batches, dist_spec, fp32_comm,
                            jax_reference)

ARCHS = ("whisper-small", "pixtral-12b")
D, K = 2, 2
# the aqsgd runs again from weights moved by MOVE (numpy seeds): the
# spread of an untied model's loss stream under f32 noise
MOVED_SEEDS = {"pixtral-12b": (1, 2, 3)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stage_kw(tcfg, stage, k):
    return dict(embed=stage.embed is not None, final_norm=k == K - 1,
                head=stage.head is not None,
                encoder=stage.enc_norm is not None)


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_bucket_matches_jax(arch):
    jcfg, tcfg, params, np_params = arch_params(arch, {})
    jpipe = jax.tree.map(np.asarray, JPL.to_pipeline_params(jcfg, params, K))
    pipe = to_pipeline_params(np_params, tcfg, K)
    lay = PL.stage_layout(tcfg, K)
    bucket = PL.PipelineBucket(tcfg, lay, 512)
    jlay = JG.bucket_layout(jpipe, 512)
    assert bucket.shape == (jlay.rows, jlay.group_d)
    jflat = np.asarray(JG.flatten_bucket(jpipe, jlay)).reshape(-1)
    for k in range(K):
        stage = PL.Stage(tcfg, lay, k).load_pipeline_params(pipe, lay)
        names = {n for n, _ in stage.named_parameters()}
        assert any(n.startswith("enc_layers.") for n in names) == \
            (tcfg.family == "audio")
        state = stage_state_dict(pipe, tcfg, K, k, **_stage_kw(tcfg, stage,
                                                                k))
        assert set(state) == names
        for name, p in stage.named_parameters():
            off, n = bucket.slot(stage, name)
            np.testing.assert_array_equal(
                jflat[off:off + n], p.detach().numpy().reshape(-1),
                err_msg=name)


def _batches(jcfg):
    """dist_batches' steps with each step's frames or patches."""
    return [dict(b, **media_inputs(jcfg, b["tokens"].shape[0], 20 + i))
            for i, b in enumerate(dist_batches(jcfg.vocab_size))]


def _jax_pipeline_losses(batches_dir, out_path):
    """The JAX package's pipeline `train_step` on a 2 x 2 mesh of host
    devices (XLA_FLAGS must force 4 before JAX starts) for each arch,
    SMOKE from `arch_params`' weights, on the batches saved under
    ``batches_dir``: the warm-up step, then compressed steps.  Writes
    {arch: losses} as JSON to ``out_path``."""
    out = {}
    comm = JComm.from_json(aqsgd_det_comm().to_json())
    mesh = make_debug_mesh(D, K)
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, schedule="constant")
    for arch in ARCHS:
        jcfg, _, params, _ = arch_params(arch, {})
        spec = dist_spec(arch, aqsgd_det_comm(), None)
        ds = spec["dataset"]
        trunk = ds["seq_len"] + jcfg.num_patches
        m, gb = spec["microbatches"], spec["batch"]
        steps = {w: JPL.make_train_step(
            jcfg, JPL.PipelineConfig(microbatches=m, warmup=w, comm=comm),
            mesh, opt, global_batch=gb, seq_len=trunk,
            buffer_samples=ds["num_samples"] // D)[0] for w in (True, False)}
        pcfg = JPL.PipelineConfig(microbatches=m, comm=comm)
        pipe = JPL.to_pipeline_params(jcfg, params, K)
        buf = JPL.buffer_structs(pcfg, K, ds["num_samples"], trunk,
                                 jcfg.d_model)
        state = {"params": pipe, "opt": jadamw.init_opt_state(pipe),
                 "dp_error": JPL.init_dp_error(pcfg, pipe, D),
                 "m_out": jnp.zeros(buf.shape, buf.dtype),
                 "m_in": jnp.zeros(buf.shape, buf.dtype)}
        data = np.load(os.path.join(batches_dir, f"{arch}.npz"))
        keys = sorted({n.split("/")[1] for n in data.files})
        losses = []
        for i in range(spec["steps"]):
            batch = {k: data[f"{i}/{k}"].reshape(
                m, gb // m, *data[f"{i}/{k}"].shape[1:]) for k in keys}
            state, met = steps[i < 1](state, batch, jax.random.PRNGKey(i))
            losses.append(float(met["loss"]))
        out[arch] = losses
    with open(out_path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax")
    explicit, ref = [], {}
    for arch in ARCHS:
        jcfg, tcfg, params, np_params = arch_params(arch, {})
        batches = _batches(jcfg)
        pipe = to_pipeline_params(np_params, tcfg, K)
        explicit += [(dist_spec(arch, fp32_comm(), pipe), batches, 0),
                     (dist_spec(arch, aqsgd_det_comm(), pipe), batches, 1)]
        explicit += [(dist_spec(arch, aqsgd_det_comm(), _moved(pipe, seed)),
                      batches, 1) for seed in MOVED_SEEDS.get(arch, ())]
        ref[arch] = (jcfg, tcfg, params, batches)
        np.savez(tmp / f"{arch}.npz", **{f"{i}/{k}": v
                                         for i, b in enumerate(batches)
                                         for k, v in b.items()})
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=src,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_proc = subprocess.Popen(
        [sys.executable, __file__, str(tmp), str(tmp / "losses.json")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        out = spawn(run_scenarios, D * K, ([], explicit),
                    timeout=SPAWN_TIMEOUT,
                    store_dir=tmp_path_factory.mktemp("mesh"))
        log, _ = jax_proc.communicate(timeout=SPAWN_TIMEOUT)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, log
    jax_losses = json.loads((tmp / "losses.json").read_text())
    runs, at = {}, 0
    for arch in ARCHS:
        moved = len(MOVED_SEEDS.get(arch, ()))
        runs[arch] = {"fp32": [r[at] for r in out],
                      "aqsgd": [r[at + 1] for r in out],
                      "moved": [out[0][at + 2 + j]["losses"]
                                for j in range(moved)],
                      "jax-pipeline": jax_losses[arch], "ref": ref[arch]}
        at += 2 + moved
    return runs


@pytest.mark.parametrize("arch", ARCHS)
def test_distributed_fp32_matches_jax(dist_runs, arch):
    runs = dist_runs[arch]
    jcfg, tcfg, params, batches = runs["ref"]
    want, grads = jax_reference(jcfg, params, batches)
    lay = PL.stage_layout(tcfg, K)
    for r in runs["fp32"]:
        assert r["losses"] == runs["fp32"][0]["losses"]
        k = r["model_rank"]
        g = stage_state_dict(to_pipeline_params(grads[0], tcfg, K), tcfg, K,
                             k, **_stage_kw(tcfg, PL.Stage(
                                 tcfg, lay, k, device="meta"), k))
        assert set(r["grads"][0]) == set(g)
        for n in g:
            scale = float(np.abs(g[n]).max())
            np.testing.assert_allclose(r["grads"][0][n], g[n], rtol=1e-3,
                                       atol=1e-4 * scale, err_msg=n)
    np.testing.assert_allclose(runs["fp32"][0]["losses"], want,
                               rtol=DIST_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_distributed_aqsgd_matches_jax_pipeline(dist_runs, arch):
    res = dist_runs[arch]["aqsgd"]
    for r in res:
        assert r["losses"] == res[0]["losses"]
    got = np.asarray(res[0]["losses"])
    limit = np.full(got.shape, DIST_RTOL)
    if dist_runs[arch]["moved"]:
        moved = np.asarray(dist_runs[arch]["moved"])
        spread = (np.abs(moved - got) / np.abs(got)).max(axis=0)
        limit = np.maximum(limit, 2 * spread)
    want = np.asarray(dist_runs[arch]["jax-pipeline"])
    gap = np.abs(got - want) / np.abs(want)
    print(f"{arch} pipeline: gap to JAX {gap.tolist()} limit "
          f"{limit.tolist()} (spread under {MOVE} moves)")
    assert (gap <= limit).all(), (gap, limit)


@pytest.mark.parametrize("arch,run", [(a, r) for a in ARCHS
                                      for r in ("fp32", "aqsgd")])
def test_replicas_stay_equal(dist_runs, arch, run):
    """Every stage holds whisper's encoder; after every step its copies
    are bit-equal (the replica check ships stage 0's to the others), as
    are the message buffers and a tied embedding."""
    audio = arch == "whisper-small"
    for r in dist_runs[arch][run]:
        for rep in r["replicas"]:
            if r["model_rank"] > 0:
                assert rep["encoder_equal"] is (True if audio else None), rep
                assert rep["embed_equal"] is (True if audio else None), rep
            assert rep["m_in_equal"] in (None, True), rep
            if run == "aqsgd" and r["model_rank"] > 0:
                assert rep["m_in_equal"] is True, rep


if __name__ == "__main__":
    _jax_pipeline_losses(sys.argv[1], sys.argv[2])
