"""The moe family's weights, configs and simulated trainer against the
JAX package, at SMOKE shapes, one torch thread (the MoE FFN, the model
and serving are tests/test_torch_moe.py's; the distributed trainer is
tests/test_torch_moe_dist.py's).

* the weights' round trip and ``jax.tree.leaves`` order, JAX's
  ``prefix`` list included, for each arch; the distributed trainer's
  bucket laid out as JAX's ``flatten_bucket`` lays out the pipeline
  tree (the prefix's leaves after the head, the 5-D expert stacks), at
  2 stages and at 5 layers over 3 stages with dead padded layers;
* deepseek-moe-16b's simulated trainer: loss streams against JAX
  ``train`` without and with the 4-bit ring over 2 workers
  (tests/test_torch_train.py's tolerances), and one step's metrics:
  the aux the router's with one worker, 0.0 with two, as JAX's;
* a deepseek-moe-16b simulated state written by either package
  restored in the other bit for bit (tests/test_torch_checkpoint.py's
  checks);
* the three configs field for field with JAX's, their parameter counts
  total and active, and so the audio and vlm configs (whisper-small,
  pixtral-12b), which the model and the distributed trainer take.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro.comm.config import CommConfig as JComm
from repro.comm.config import PlaneConfig as JPlane
from repro.configs.base import get_config as jget
from repro.core import grad_compress as JG
from repro.data import pipeline as JD
from repro.optim import adamw as JO
from repro.training import pipeline as JPL
from repro.training import simulated as JS
from repro_torch import checkpoint as ck
from repro_torch.comm.config import CommConfig as TComm
from repro_torch.comm.config import PlaneConfig as TPlane
from repro_torch.configs.base import get_config as tget
from repro_torch.data import pipeline as TD
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TO
from repro_torch.training import pipeline as PL
from repro_torch.training import simulated as TS
from repro_torch.weights import (from_jax_params, jax_leaf_names,
                                 jax_leaves, load_jax_params,
                                 stage_state_dict, to_jax_params,
                                 to_pipeline_params)
from test_torch_checkpoint import (DC, _configs, assert_same_kind,
                                   assert_trees_bit_equal)
from test_torch_ssm import arch_params
from test_torch_train_attention import LATER_STEP_RTOL, LOSS_RTOL, _comm

ARCHS = ["deepseek-moe-16b", "mixtral-8x22b", "moonshot-v1-16b-a3b"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return arch_params(request.param, {})


def test_weights_round_trip_and_leaf_order(arch):
    jcfg, tcfg, params, np_params = arch
    model = from_jax_params(np_params, tcfg)
    back = jax.tree.map(lambda t: t.numpy(), to_jax_params(model))
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    jax.tree.map(np.testing.assert_array_equal, back, np_params)
    named = dict(model.named_parameters())
    jleaves = jax.tree.leaves(params)
    leaves = jax_leaves(named)
    assert len(leaves) == len(jleaves)
    for mine, want in zip(leaves, jleaves):
        mine = torch.stack(mine) if isinstance(mine, list) else mine
        np.testing.assert_array_equal(mine.detach().numpy(),
                                      np.asarray(want))
    keys = [k for k, _ in jax_leaf_names(named)]
    assert "layers.ffn.w_gate" in keys
    assert any(k.startswith("prefix.0.") for k in keys) == \
        bool(tcfg.first_dense_layers)


@pytest.mark.parametrize("name,layers,kk", [(a, 0, 2) for a in ARCHS]
                         + [("deepseek-moe-16b", 5, 3)])
def test_pipeline_bucket_matches_jax(name, layers, kk):
    """Every stage parameter sits where JAX's ``flatten_bucket`` of the
    pipeline tree puts it: the prefix's leaves after the head, the 5-D
    expert stacks (K, lps, E, d, ff) stage-major; at 5 layers (4 past
    the prefix) over 3 stages with dead padded layers."""
    jcfg, tcfg, params, np_params = arch_params(
        name, {"num_layers": layers} if layers else {})
    jpipe = jax.tree.map(np.asarray, JPL.to_pipeline_params(jcfg, params, kk))
    pipe = to_pipeline_params(np_params, tcfg, kk)
    assert pipe["stages"]["ffn.w_gate"].shape == \
        jpipe["stages"]["ffn"]["w_gate"].shape
    lay = PL.stage_layout(tcfg, kk)
    assert (lay.lps, lay.n_padded) == (JPL.stage_layout(jcfg, kk).lps,
                                       JPL.stage_layout(jcfg, kk).n_padded)
    bucket = PL.PipelineBucket(tcfg, lay, 512)
    jlay = JG.bucket_layout(jpipe, 512)
    assert bucket.shape == (jlay.rows, jlay.group_d)
    jflat = np.asarray(JG.flatten_bucket(jpipe, jlay)).reshape(-1)
    for k in range(kk):
        stage = PL.Stage(tcfg, lay, k).load_pipeline_params(pipe, lay)
        names = {n for n, _ in stage.named_parameters()}
        assert any(n.startswith("prefix.") for n in names) == \
            (k == 0 and bool(tcfg.first_dense_layers))
        state = stage_state_dict(pipe, tcfg, kk, k,
                                 embed=stage.embed is not None,
                                 final_norm=k == kk - 1,
                                 head=stage.head is not None,
                                 prefix=bool(stage.prefix))
        assert set(state) == names
        for name, p in stage.named_parameters():
            off, n = bucket.slot(stage, name)
            np.testing.assert_array_equal(
                jflat[off:off + n], p.detach().numpy().reshape(-1))


# ---------------------------------------------------------------------------
# the simulated trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 2])
def test_trainer_loss_stream_matches_jax(workers):
    """deepseek-moe-16b SMOKE, 3 steps over 8 samples of 32 tokens at
    batch 4, 2 stage groups, aqsgd fw 4 / bw 8, deterministic: without
    the DP wire (the metrics' aux is the router's, JAX's), and with the
    4-bit ring over 2 workers (aux 0.0 in both packages)."""
    jcfg, tcfg, params, np_params = arch_params("deepseek-moe-16b", {})
    steps = 3
    dc = dict(num_samples=8, seq_len=32, vocab_size=jcfg.vocab_size)

    def comm(C, P):
        c = _comm(C, P, "aqsgd")
        return c if workers > 1 else C(mode="aqsgd", fw=c.fw, bw=c.bw)

    jt = JS.SimTrainConfig(num_stages=2, comm=comm(JComm, JPlane),
                           dp_workers=workers,
                           optimizer=JO.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                    total_steps=steps))
    tt = TS.SimTrainConfig(num_stages=2, dp_workers=workers,
                           comm=comm(TComm, TPlane),
                           optimizer=TO.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                    total_steps=steps))
    _, jl = JS.train(jcfg, jt, JD.Dataset(JD.DatasetConfig(**dc)),
                     num_steps=steps, batch_size=4, initial_params=params)
    state, tl = TS.train(tcfg, tt, TD.Dataset(TD.DatasetConfig(**dc)),
                         num_steps=steps, batch_size=4,
                         initial_params=np_params, device="cpu")
    np.testing.assert_allclose(tl[0], jl[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tl[1:], jl[1:], rtol=LATER_STEP_RTOL)
    # one more step in each package from the same state: the metrics
    jstate = JS.init_train_state(jcfg, jt, 8, 32, jax.random.PRNGKey(0))
    jstate["params"] = params
    batch = next(JD.Dataset(JD.DatasetConfig(**dc)).batches(4, 1))
    _, jmet = JS.train_step(jstate, {k: jnp.asarray(v) for k, v in
                                     batch.items()}, jax.random.PRNGKey(1),
                            mcfg=jcfg, tcfg=jt)
    tstate = TS.init_train_state(tcfg, tt, 8, 32, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    load_jax_params(tstate["model"], np_params)
    _, tmet = TS.train_step(tstate, TS.device_batch(batch, "cpu"),
                            torch.Generator().manual_seed(1), mcfg=tcfg,
                            tcfg=tt)
    if workers > 1:
        assert tmet["aux"] == float(jmet["aux"]) == 0.0
    else:
        assert float(jmet["aux"]) > 0
        assert abs(float(tmet["aux"]) - float(jmet["aux"])) <= \
            LOSS_RTOL * float(jmet["aux"])
    assert abs(float(tmet["ce"]) - float(jmet["ce"])) <= \
        LOSS_RTOL * float(jmet["ce"])


def test_sim_state_restores_across_packages(tmp_path):
    """deepseek-moe-16b: the port's simulated state after 2 steps
    restores in JAX against its `init_train_state` structure (the
    ``prefix`` list and the expert stacks) bit for bit with JAX's
    fingerprint; JAX's after 2 deterministic steps restores in the port
    bit for bit, and a third step in each package gives losses within
    the later-step tolerance."""
    arch_name = "deepseek-moe-16b"
    jcfg, tcfg = jget(arch_name, smoke=True), tget(arch_name, smoke=True)
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
    assert isinstance(tree["params"]["prefix"], list)
    ck.save_state(str(tmp_path / "port"), tree, step=2, comm=tt.comm)
    like = jax.eval_shape(lambda: JS.init_train_state(
        jcfg, jt, DC["num_samples"], DC["seq_len"], jax.random.PRNGKey(0)))
    out, body = jck.restore_state(str(tmp_path / "port"), like,
                                  comm=jt.comm)
    assert body["fingerprint"] == jck.tree_fingerprint(like) \
        == ck.tree_fingerprint(tree)
    assert_trees_bit_equal(tree, jax.tree.map(np.asarray, out))
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
# configs and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_configs_match_jax(name):
    """CONFIG and SMOKE field for field, and the parameter counts."""
    for smoke in (False, True):
        jc, tc = jget(name, smoke=smoke), tget(name, smoke=smoke)
        for f in tc.__dataclass_fields__:
            assert getattr(tc, f) == getattr(jc, f), f
        assert tc.params_count() == jc.params_count()
        assert tc.active_params_count() == jc.active_params_count()
        assert tc.has_moe and tc.layer_is_moe(tc.first_dense_layers)


@pytest.mark.parametrize("name", ["whisper-small", "pixtral-12b"])
def test_audio_and_vlm_still_refused(name):
    """The audio and vlm configs, once refused, are ported: CONFIG and
    SMOKE field for field with JAX's (the encoder and patch fields
    included), their parameter counts total and active JAX's, and the
    model and the distributed trainer take their families."""
    for smoke in (False, True):
        jc, tc = jget(name, smoke=smoke), tget(name, smoke=smoke)
        for f in tc.__dataclass_fields__:
            assert getattr(tc, f) == getattr(jc, f), f
        assert tc.params_count() == jc.params_count()
        assert tc.active_params_count() == jc.active_params_count()
    cfg = tget(name, smoke=True)
    assert bool(cfg.encoder_layers) == (name == "whisper-small")
    assert bool(cfg.num_patches) == (name == "pixtral-12b")
    TM.Transformer(cfg, device="meta")
    assert PL.stage_layout(cfg, 2).lps == JPL.stage_layout(
        jget(name, smoke=True), 2).lps
