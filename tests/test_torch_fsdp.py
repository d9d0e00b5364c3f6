"""FSDP (ZeRO-3) in the port's distributed trainer
(`repro_torch.training.pipeline.StageFsdp`), on the CPU.

* The shard rule: for every config, full and SMOKE, at D = 2, 3 and 4
  data ranks, the port's pipeline-layout shapes equal JAX
  ``jax.eval_shape``'s (so the port keeps every leaf in the JAX
  orientation), and its `fsdp_dim`, `_stage_fsdp_dim`, `fsdp_dims_tree`
  (the stage layers' and the shared block's) and `expert_axes` equal the
  JAX package's on them; the stage's `LeafShard`s cut each leaf at the
  dim the JAX one says.
* One spawn of a 2 x 2 gloo mesh at SMOKE size (4 layers, 2
  microbatches, 2 steps: the warm-up and one compressed, aqsgd fw 4 / bw
  8 and the 4-bit DP wire, deterministic) runs each spec beside its
  whole-stage twin (the spec's private ``_whole_stage``): gpt2-xl-paper
  on ``ring``, ``ring-sharded``, ``fp16`` and with 8-bit moments,
  mamba2-1.3b, zamba2-2.7b, deepseek-moe-16b in ``zero3`` and in
  ``expert_parallel``, whisper-small and pixtral-12b.  On every rank:
  the losses equal the twin's bit for bit; the ``fsdp`` plane's bytes
  equal `fsdp_gather_bytes` at every step (the twin's are 0); the
  resident parameter and moment bytes equal `rank_param_bytes` (the
  twin's the whole stage's where the wire keeps no bucket); the
  replicas hold; with 8-bit moments every moment's codes and scales
  are the twin's part of them, the leaves split along their last dim
  (whose rows' scales take a MAX over the data group, the ``opt``
  plane) included.  The gathers come in the JAX package's units: each
  rank's calls by unit equal `fsdp_gathers`' at every step (the hybrid's
  shared block once a microbatch, a ``zero3`` MoE layer's experts one
  at a time), and its largest gathered buffer `fsdp_largest_gather`,
  in ``zero3`` no gather holding more than one expert's three weights.

This module imports no JAX at import time: each spawned rank imports it
for its worker function.
"""
import numpy as np
import pytest
import torch

from repro_torch.comm.config import CommConfig, PlaneConfig
from repro_torch.configs.base import ARCHS, get_config as tget
from repro_torch.data.pipeline import with_stub_media
from repro_torch.launch.mesh import spawn
from repro_torch.training import pipeline as PL


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LAYERS, D, K, M = 4, 2, 2, 2
BATCH, SEQ, SAMPLES, STEPS = 4, 32, 4, 2
SPAWN_TIMEOUT = 240.0


# ---------------------------------------------------------------------------
# the shard rule against the JAX package's
# ---------------------------------------------------------------------------

def _jax_shapes(arch, smoke, num_stages):
    """The JAX pipeline tree's flat {name: shape} from ``jax.eval_shape``,
    and the JAX pipeline module."""
    import jax
    from repro.configs.base import get_config as jget
    from repro.models import model as Mo
    from repro.training import pipeline as JPL
    cfg = jget(arch, smoke=smoke)
    tree = jax.eval_shape(lambda: JPL.to_pipeline_params(
        cfg, Mo.init_params(cfg, jax.random.PRNGKey(0)), num_stages))
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                        for p in path)
        flat[name] = leaf
    return flat, JPL, tree


def test_archs_are_the_jax_packages():
    from repro.configs.base import ARCHS as JARCHS
    assert set(ARCHS) == set(JARCHS)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("dsize", [2, 3, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_dims_match_jax(arch, dsize, smoke):
    cfg = tget(arch, smoke=smoke)
    lay = PL.stage_layout(cfg, K)
    flat, JPL, tree = _jax_shapes(arch, smoke, K)
    shapes = PL.pipeline_shapes(cfg, lay)
    assert shapes == {n: tuple(x.shape) for n, x in flat.items()}
    dims = PL.shard_dims(cfg, lay, dsize)
    for name, leaf in flat.items():
        want = JPL._stage_fsdp_dim(leaf, dsize) \
            if name.startswith("stages.") \
            else JPL.fsdp_dim(leaf.shape, dsize, 0)
        assert dims[name] == want, name
        assert PL.fsdp_dim(leaf.shape, dsize, 0) \
            == JPL.fsdp_dim(leaf.shape, dsize, 0)
    stages = {n[len("stages."):]: s for n, s in shapes.items()
              if n.startswith("stages.")}
    jstages = {n[len("stages."):]: x for n, x in flat.items()
               if n.startswith("stages.")}
    for name, shape in stages.items():
        assert PL._is_expert_leaf(shape, True) \
            == JPL._is_expert_leaf(jstages[name], True)
    want = JPL.fsdp_dims_tree(tree["stages"], dsize, 2, shift=2,
                              stage=True)
    got = PL.fsdp_dims_tree(stages, dsize, 2, shift=2, stage=True)
    assert got == {n: v for n, v in _flat(want).items()}
    if "shared_block" in tree:
        got = PL.fsdp_dims_tree({n[len("shared_block."):]: s
                                 for n, s in shapes.items()
                                 if n.startswith("shared_block.")},
                                dsize, 0)
        assert got == _flat(JPL.fsdp_dims_tree(tree["shared_block"], dsize,
                                               0))
    assert PL.expert_axes(stages, dsize) \
        == JPL.expert_axes(tree["stages"], dsize)
    # the stage's leaves cut where the JAX dims say
    for k in range(K):
        st = PL.Stage(cfg, lay, k, device="meta")
        shards = PL.stage_shards(st, lay, dsize)
        for name, p in st.named_parameters():
            spec = shards.get(name)
            top, _, rest = name.partition(".")
            if top == "layers":
                fd = dims["stages." + rest.split(".", 1)[1]]
                want = None if fd is None else fd - 2
            elif top == "enc_layers":
                fd = dims["enc_layers." + rest.split(".", 1)[1]]
                want = None if fd is None else ("owner" if fd == 0
                                                else fd - 1)
            else:
                want = dims[name]
            got = None if spec is None else (
                "owner" if spec.owner is not None else spec.dim)
            assert got == want, (name, got, want)
            if spec is not None and spec.dim is not None:
                assert sum(spec.numel_on(r) for r in range(dsize)) \
                    == p.numel()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# ---------------------------------------------------------------------------
# the 2 x 2 mesh: sharded against whole-stage, bit for bit
# ---------------------------------------------------------------------------

def _comm(wire="ring"):
    return CommConfig(mode="aqsgd", fw=PlaneConfig(bits=4, stochastic=False),
                      bw=PlaneConfig(bits=8, stochastic=False),
                      dp=PlaneConfig(bits=4, wire=wire, stochastic=False))


# name -> (arch, DP wire, state_bits, `PipelineConfig` fields)
CASES = {
    "gpt2/ring": ("gpt2-xl-paper", "ring", 0, {}),
    "gpt2/ring-sharded": ("gpt2-xl-paper", "ring-sharded", 0, {}),
    "gpt2/fp16": ("gpt2-xl-paper", "fp16", 0, {}),
    "gpt2/adam8": ("gpt2-xl-paper", "ring", 8, {}),
    "mamba2": ("mamba2-1.3b", "ring", 0, {}),
    "zamba2": ("zamba2-2.7b", "ring", 0, {}),
    "moe/zero3": ("deepseek-moe-16b", "ring", 0, {"moe_mode": "zero3"}),
    "moe/ep": ("deepseek-moe-16b", "ring", 0,
               {"moe_mode": "expert_parallel"}),
    "whisper": ("whisper-small", "ring", 0, {}),
    "pixtral": ("pixtral-12b", "ring", 0, {}),
}


def _spec(arch, wire, state_bits, pipe, whole):
    spec = {"arch": arch, "smoke": True, "num_layers": LAYERS,
            "comm": _comm(wire).to_json(), "device": "cpu", "data_par": D,
            "stages": K, "microbatches": M, "steps": STEPS, "batch": BATCH,
            "warmup_epochs": 1, "seed": 0, "pipeline": dict(pipe),
            "optimizer": {"lr": 1e-3, "warmup_steps": 1,
                          "schedule": "constant", "state_bits": state_bits},
            "dataset": {"num_samples": SAMPLES, "seq_len": SEQ,
                        "vocab_size": tget(arch, smoke=True).vocab_size}}
    if whole:
        spec["_whole_stage"] = True
    return spec


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def fsdp_worker(rank, world, specs):
    """Each spec in turn on this rank: its losses, bytes a step by plane,
    resident parameter and moment bytes, replica checks, and with 8-bit
    moments the moments and the stage's shard specs."""
    out = []
    for spec in specs:
        trainer, ds = PL.build_rank(rank, world, spec)
        tr = trainer.mesh.transport
        fs = trainer.stage.fsdp
        res = {"model_rank": trainer.mesh.model_rank, "losses": [],
               "bytes": [], "replicas": [], "gathers": [], "largest": []}
        for i, batch in enumerate(ds.batches(spec["batch"], spec["steps"])):
            batch = with_stub_media(trainer.cfg, batch, seed=spec["seed"],
                                    step=i)
            tr.reset()
            res["losses"].append(trainer.step(PL.rank_batch(trainer, batch),
                                              i, warmup=i == 0))
            res["bytes"].append({p: tr.bytes_sent(p)
                                 for p in ("fsdp", "opt", "ep")})
            res["gathers"].append({} if fs is None else dict(fs.gathers))
            res["largest"].append(tr.largest_gather("fsdp"))
            res["replicas"].append(PL.check_replicas(trainer))
        res["resident"] = PL.resident_param_bytes(trainer)
        if spec["optimizer"]["state_bits"]:
            res["opt"] = _numpy({"mu": trainer.opt["mu"],
                                 "nu": trainer.opt["nu"]})
            res["shards"] = {} if fs is None else {
                n: (s.dim, s.owner) for n, s in fs.shards.items()}
            res["data_rank"] = trainer.mesh.data_rank
        out.append(res)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    specs = [_spec(*case, whole) for case in CASES.values()
             for whole in (False, True)]
    out = spawn(fsdp_worker, D * K, (specs,), timeout=SPAWN_TIMEOUT,
                store_dir=str(tmp_path_factory.mktemp("fsdp")))
    return {name: ([r[2 * i] for r in out], [r[2 * i + 1] for r in out])
            for i, name in enumerate(CASES)}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_equals_whole_stage(runs, name):
    arch, wire, bits, pipe = CASES[name]
    cfg = tget(arch, smoke=True).with_(num_layers=LAYERS)
    lay = PL.stage_layout(cfg, K)
    pcfg = PL.PipelineConfig(microbatches=M, comm=_comm(wire), **pipe)
    sharded, whole = runs[name]
    for sh, wh in zip(sharded, whole):
        assert len(sh["losses"]) == STEPS
        assert np.isfinite(sh["losses"]).all()
        assert sh["losses"] == wh["losses"] == sharded[0]["losses"]
        k = sh["model_rank"]
        want = PL.fsdp_gather_bytes(cfg, pcfg, lay, k, D, M)
        assert want > 0
        assert [b["fsdp"] for b in sh["bytes"]] == [want] * STEPS
        assert [b["fsdp"] for b in wh["bytes"]] == [0] * STEPS
        assert [b["ep"] for b in sh["bytes"]] \
            == [b["ep"] for b in wh["bytes"]]
        assert sh["resident"] == PL.rank_param_bytes(cfg, pcfg, lay, k, D,
                                                     bits)
        if wire != "ring-sharded":
            assert wh["resident"] == PL.rank_param_bytes(cfg, pcfg, lay, k,
                                                         1, bits)
            assert sh["resident"] < wh["resident"]
        for rep in sh["replicas"]:
            if k == K - 1:
                assert rep["m_in_equal"] is True
                assert rep["embed_equal"] is (True if cfg.tie_embeddings
                                              else None)
                assert rep["shared_equal"] is (True if cfg.family == "hybrid"
                                               else None)
                assert rep["encoder_equal"] is (True if cfg.family == "audio"
                                                else None)


@pytest.mark.parametrize("name", list(CASES))
def test_gathers_in_the_reference_units(runs, name):
    """Every step on every rank: the calls by unit equal `fsdp_gathers`'
    (M times a microbatch's), the largest gathered buffer equals
    `fsdp_largest_gather`; the shared block is gathered once a
    microbatch, a ``zero3`` MoE layer's expert stacks are no layer
    unit's and each of their gathers holds one expert's three weights;
    the whole-stage twin gathers nothing."""
    arch, wire, bits, pipe = CASES[name]
    cfg = tget(arch, smoke=True).with_(num_layers=LAYERS)
    lay = PL.stage_layout(cfg, K)
    pcfg = PL.PipelineConfig(microbatches=M, comm=_comm(wire), **pipe)
    sharded, whole = runs[name]
    for sh, wh in zip(sharded, whole):
        k = sh["model_rank"]
        units = PL.fsdp_gathers(cfg, pcfg, lay, k, D)
        assert sh["gathers"] == [{u: M * c for u, (c, _, _)
                                  in units.items()}] * STEPS
        largest = PL.fsdp_largest_gather(cfg, pcfg, lay, k, D)
        assert largest > 0
        assert sh["largest"] == [largest] * STEPS
        assert wh["gathers"] == [{}] * STEPS and wh["largest"] == [0] * STEPS
        if cfg.family == "hybrid":
            assert units["shared_block"][0] == 1
        experts = [u for u in units if u.startswith("experts.")]
        assert bool(experts) == cfg.has_moe
        for u in experts:
            calls, sent, gathered = units[u]
            if pipe["moe_mode"] == "zero3":
                assert gathered == 4 * 3 * cfg.d_model * cfg.moe_d_ff
                assert sent == gathered // D
                assert calls % cfg.n_experts == 0
            else:
                assert gathered is None


def test_adam8_codes_are_the_whole_stages(runs):
    """8-bit moments: each rank's codes and scales are its part of the
    whole-stage twin's (rows split along the last dim keep the twin's
    scales), and the MAX all-reduce of those rows' maxima runs a step."""
    sharded, whole = runs["gpt2/adam8"]
    split_last = 0
    for sh, wh in zip(sharded, whole):
        assert all(b["opt"] > 0 for b in sh["bytes"][1:])
        r = sh["data_rank"]
        for moment in ("mu", "nu"):
            for name, enc in sh["opt"][moment].items():
                dim, owner = sh["shards"].get(name, (None, None))
                assert owner is None
                twin = wh["opt"][moment][name]
                codes, scale = twin["codes"], twin["scale"]
                if dim is not None:
                    n = codes.shape[dim] // D
                    codes = np.take(codes, range(r * n, (r + 1) * n), dim)
                    if dim < codes.ndim - 1:
                        scale = np.take(scale, range(r * n, (r + 1) * n),
                                        dim)
                    else:
                        split_last += 1
                np.testing.assert_array_equal(enc["codes"], codes, name)
                np.testing.assert_array_equal(enc["scale"].view(np.int32),
                                              scale.view(np.int32), name)
    assert split_last > 0
