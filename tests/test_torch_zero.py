"""The rest of the DP wires and the optimizer, the port against the JAX
package: the ZeRO wire (``ring-sharded``), the ``fp16`` wire, the
bucket-space and 8-bit AdamW, the full wire registry and the comm
config's remaining surface.  Inputs are numpy arrays from a seed.

* `compress_reduce_scatter` equals JAX's (jitted, Pallas backend in
  interpret mode, deterministic) bit for bit over n = 2/3/5 workers with
  ragged segments: carries and segment means, whose live rows are
  those of `compress_allreduce`'s mean; the rows past the bucket are
  signed zeros, compared by magnitude as JAX's own test does.
* Over 3 gloo processes (one spawn; n = 3 over the world and n = 2
  over ranks {0, 1}): `ring_ef_reduce_scatter_bucket` with 1 and 2
  chunks equals the simulator bit for bit with the noise handed to
  both, two steps; its bytes and manifest are the registry's; the
  segments' all-gather lands every member's segment in its slot with
  the bytes of `param_gather_bytes`; the fp16 wire equals its
  simulator bit for bit at n = 2; at n = 3, where gloo may add in
  another order, each element is the f16 sum in one of the orders of
  adding (which lie up to 2 f16 ulps of the sum apart);
  `quantized_psum_mean` equals JAX's under ``vmap``.
* f16 sums: XLA on the CPU adds JAX's ``jnp.sum(h, axis=0,
  dtype=float16)`` in worker order, rounding each add to f16 (it does
  not accumulate in f32), and divides by n as a multiply by
  ``f32(1/n)``; the port's simulator does the same, so it equals JAX's
  bit for bit at every n.
* AdamW: `apply_bucket_updates` gives the bits of the port's per-leaf
  `apply_updates` elementwise over chained steps, and JAX's within
  `test_adamw_chained_steps_match_jax`'s tolerances.  8-bit moments:
  `_q_enc`/`_q_dec` equal JAX's bit for bit; over 4 chained steps the
  codes equal JAX's except where a value lies within ``TIE`` code units
  of a rounding tie (the per-leaf update differs from JAX's at the ulp
  level) or already differed a step before, never by more than one
  code; scales within 1e-6 relative; parameters within the f32
  tolerances.
* The simulated trainer: ``ring-sharded`` gives the ``ring`` wire's
  loss stream bit for bit (stochastic, the port's own noise; and
  deterministic), and the deterministic stream of each against JAX's
  `sim.train` from the same weights (tests/test_grad_compress.py's
  setup) within tests/test_torch_train.py's tolerances; ``fp16``
  likewise.
* The registry: every plane's names, flags and byte models equal
  JAX's over a sweep of shapes, bits and n; the audited totals (b = 2,
  4 ranks, (128, 256)): ring 18944, ring-sharded 6656, psum 131584,
  fp16 65536 B; every manifest sums to its `wire_bytes`.  `Codec`,
  `to_flags`, `from_legacy` and the refused legacy kwargs as in
  tests/test_comm.py.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import config as JCC
from repro.comm import wires as JW
from repro.configs.base import get_config as jget
from repro.core import aqsgd as JA
from repro.core import collectives as JC
from repro.core import grad_compress as JG
from repro.core import quantization as JQ
from repro.data import pipeline as JD
from repro.models import model as Mo
from repro.optim import adamw as JO
from repro.training import simulated as JS
from repro_torch.comm import config as TCC
from repro_torch.comm import wires as TW
from repro_torch.comm.codec import Codec
from repro_torch.core import aqsgd as TA
from repro_torch.core import boundary as TB
from repro_torch.core import collectives as TC
from repro_torch.core import grad_compress as TG
from repro_torch.core import quantization as TQ
from repro_torch.data import pipeline as TD
from repro_torch.launch.mesh import spawn
from repro_torch.optim import adamw as TO
from repro_torch.training import pipeline as TPL
from repro_torch.training import simulated as TS

from test_torch_mesh import zero_worker


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the bucket width of the JAX comparisons: at 128 and wider, jitted JAX
# on the CPU contracts the carry ``v - p * f32(1/lv)`` into one FMA on
# both backends (ROADMAP queue C); at 64 it rounds q first, as the port
GROUP = 64
SPAWN_TIMEOUT = 120
# tests/test_torch_train.py's loss-stream tolerances
LOSS_RTOL, LATER_STEP_RTOL = 1e-5, 1e-3
# an 8-bit moment code may differ from JAX's where the value before
# rounding lies within TIE code units of a half-code tie
TIE = 1e-3


def _t(x):
    return torch.tensor(np.asarray(x))


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _trees(seed, n):
    """n gradient trees of 10028 elements (157 rows of 64: a multiple
    of none of 2, 3, 5), as lists of numpy leaves."""
    rng = np.random.default_rng(seed)
    return [[(rng.standard_normal(shape) * sd).astype(np.float32)
             for shape, sd in (((57, 33), 1.0), ((19,), 1.0),
                               ((4064, 2), 0.3))] for _ in range(n)]


def _torch_tree(tree):
    return [torch.from_numpy(a.copy()) for a in tree]


# ---------------------------------------------------------------------------
# compress_reduce_scatter against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 5])
def test_compress_reduce_scatter_matches_jax(n):
    bits = 4
    trees = _trees(40 + n, n)
    jlay = JG.bucket_layout(trees[0], GROUP)
    tlay = TG.bucket_layout(_torch_tree(trees[0]), GROUP)
    rng = np.random.default_rng(n)
    err = (rng.standard_normal((n, jlay.rows, GROUP)) * 1e-3).astype(
        np.float32)
    segs_j, err_j = jax.jit(lambda gl, e: JG.compress_reduce_scatter(
        gl, e, bits, jax.random.PRNGKey(0), stochastic=False,
        backend="pallas", layout=jlay))(trees, err)
    mean_j, err_full_j = jax.jit(lambda gl, e: JG.compress_allreduce(
        gl, e, bits, jax.random.PRNGKey(0), stochastic=False,
        backend="pallas", layout=jlay))(trees, err)
    segs, new_err = TG.compress_reduce_scatter(
        [_torch_tree(t) for t in trees], _t(err), bits, stochastic=False,
        layout=tlay)
    seg = -(-jlay.rows // n)
    assert segs.shape == (n, seg, GROUP)
    np.testing.assert_array_equal(_bits(err_j), _bits(new_err.numpy()))
    np.testing.assert_array_equal(_bits(err_full_j), _bits(new_err.numpy()))
    live = tlay.rows * GROUP
    np.testing.assert_array_equal(_bits(segs_j).reshape(-1)[:live],
                                  _bits(segs.numpy()).reshape(-1)[:live])
    flat_mean = np.asarray(JG.flatten_bucket(mean_j, jlay)).reshape(-1)
    np.testing.assert_array_equal(
        _bits(flat_mean)[:tlay.total],
        _bits(segs.numpy()).reshape(-1)[:tlay.total])
    pad = seg * n - tlay.rows
    assert pad == (seg * n - jlay.rows)
    if pad:
        np.testing.assert_array_equal(np.abs(segs.numpy()[-1, seg - pad:]),
                                      np.zeros((pad, GROUP), np.float32))
        np.testing.assert_array_equal(
            np.abs(np.asarray(segs_j)[-1, seg - pad:]),
            np.abs(segs.numpy()[-1, seg - pad:]))


# ---------------------------------------------------------------------------
# the wires over gloo against the simulators, one spawn
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    bits = 4
    lay = TG.bucket_layout(_torch_tree(_trees(0, 1)[0]), GROUP)
    inputs = {"shape": (lay.rows, GROUP), "bits": bits, "v": {},
              "noise": {}}
    for n in (2, 3):
        inputs["v"][n] = [[TG.flatten_bucket(_torch_tree(t), lay).numpy()
                           for t in _trees(100 * n + step, n)]
                          for step in range(2)]
        inputs["noise"][n] = []
        for step in range(2):
            g = torch.Generator().manual_seed(7 + step)
            inputs["noise"][n].append([
                torch.rand(lay.rows, GROUP, generator=g).numpy()
                for _ in range(n)])
    rng = np.random.default_rng(9)
    inputs["x"] = (rng.standard_normal((3, 5, 24)) * 2).astype(np.float32)
    out = spawn(zero_worker, 3, (inputs,), timeout=SPAWN_TIMEOUT,
                store_dir=tmp_path_factory.mktemp("mesh"))
    return inputs, lay, out


def _sim_steps(inputs, lay, n, sim):
    """Two steps of a simulator on the spawn's buckets and noise:
    [(per-worker result, carries)] (a tree of one leaf: the bucket)."""
    err, got = torch.zeros(n, *inputs["shape"]), []
    for step in range(2):
        trees = [[torch.from_numpy(v)] for v in inputs["v"][n][step]]
        g = torch.Generator().manual_seed(7 + step)
        res, err = sim(trees, err, inputs["bits"], stochastic=True,
                       generator=g, backend="reference",
                       layout=TG.bucket_layout(trees[0], GROUP))
        got.append((res, err))
    return got


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("n", [2, 3])
def test_reduce_scatter_wire_matches_simulator(gloo, n, chunks):
    inputs, lay, out = gloo
    spec = TW.get_wire("ring-sharded")
    sim = _sim_steps(inputs, lay, n, TG.compress_reduce_scatter)
    for r in range(n):
        for step, (mean, err, nbytes, manifest) in enumerate(
                out[r][(n, "ring-sharded", chunks)]):
            segs, errs = sim[step]
            np.testing.assert_array_equal(_bits(mean),
                                          _bits(segs[r].numpy()))
            np.testing.assert_array_equal(_bits(err), _bits(errs[r].numpy()))
            assert nbytes == spec.wire_bytes(inputs["shape"], 4, n) \
                == TC.ring_wire_bytes(inputs["shape"], 4, n, sharded=True)
            if chunks == 1:
                assert manifest == spec.expected_collectives(
                    inputs["shape"], 4, n)


@pytest.mark.parametrize("n", [2, 3])
def test_fp16_wire_against_simulator(gloo, n):
    """n = 2: bit for bit (one f16 add rounds the same in either order);
    n = 3: gloo may add in another order, so each element is the f16 sum
    in one of the three orders of adding (the simulator's is the first),
    which can lie 2 f16 ulps of the sum apart."""
    inputs, lay, out = gloo
    sim = _sim_steps(inputs, lay, n, TW.fp16_sim_allreduce)
    spec = TW.get_wire("fp16")
    for r in range(n):
        for step, (mean, err, nbytes, manifest) in enumerate(
                out[r][(n, "fp16", 1)]):
            tree, errs = sim[step]
            want = tree[0].numpy()
            np.testing.assert_array_equal(_bits(err), _bits(errs[r].numpy()))
            assert nbytes == spec.wire_bytes(inputs["shape"], 4, n) \
                == lay.rows * GROUP * 2
            assert manifest == [("all-reduce", "f16", lay.rows * GROUP * 2,
                                 1)]
            if n == 2:
                np.testing.assert_array_equal(_bits(mean), _bits(want))
            else:
                v = np.stack(inputs["v"][n][step]) + (
                    0 if step == 0 else sim[0][1].numpy())
                h = v.astype(np.float16)
                rcp = np.float32(1.0) / np.float32(n)
                # the f16 sum in each order of adding three terms (f16
                # adds commute, so these are all of them)
                orders = [((h[a] + h[b]) + h[c]).astype(np.float32) * rcp
                          for a, b, c in ((0, 1, 2), (1, 2, 0), (2, 0, 1))]
                assert np.array_equal(orders[0], want)
                assert np.all(np.any([o == mean for o in orders], axis=0))


@pytest.mark.parametrize("n", [2, 3])
def test_segment_all_gather(gloo, n):
    _, _, out = gloo
    for r in range(n):
        gathered, nbytes, manifest = out[r][(n, "gather")]
        np.testing.assert_array_equal(
            gathered, np.broadcast_to(np.arange(n, dtype=np.float32)
                                      [:, None, None], (n, 3, 4)))
        assert nbytes == TC.param_gather_bytes((3 * n, 4), n) \
            == (n - 1) * 3 * 4 * 4
        assert manifest == [("all-gather", "f32", (n - 1) * 48, 1)]


@pytest.mark.parametrize("n", [2, 3])
def test_quantized_psum_mean_matches_jax(gloo, n):
    inputs, _, out = gloo
    x = inputs["x"][:n]
    want = jax.jit(jax.vmap(lambda xi: JC.quantized_psum_mean(
        xi, "i", 4, jax.random.PRNGKey(0), stochastic=False,
        backend="reference"), axis_name="i"))(x)
    for r in range(n):
        np.testing.assert_array_equal(_bits(out[r][(n, "psum-mean")]),
                                      _bits(want[r]))


# ---------------------------------------------------------------------------
# the fp16 simulator against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 5])
def test_fp16_sim_allreduce_matches_jax(n):
    trees = _trees(60 + n, n)
    jlay = JG.bucket_layout(trees[0], GROUP)
    err = (np.random.default_rng(n).standard_normal(
        (n, jlay.rows, GROUP)) * 1e-3).astype(np.float32)
    mean_j, err_j = jax.jit(lambda gl, e: JW.fp16_sim_allreduce(
        gl, e, 4, jax.random.PRNGKey(0), layout=jlay))(trees, err)
    mean, new_err = TW.fp16_sim_allreduce(
        [_torch_tree(t) for t in trees], _t(err), 4,
        layout=TG.bucket_layout(_torch_tree(trees[0]), GROUP))
    np.testing.assert_array_equal(_bits(err_j), _bits(new_err.numpy()))
    for a, b in zip(mean_j, mean):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))


# ---------------------------------------------------------------------------
# AdamW: bucket space and 8-bit moments
# ---------------------------------------------------------------------------

def _adam_params(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((64, 33)).astype(np.float32),
            "b": rng.standard_normal((129,)).astype(np.float32)}


def test_bucket_adamw_matches_leaf_adamw_and_jax():
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6)
    tcfg, jcfg = TO.AdamWConfig(**cfg), JO.AdamWConfig(**cfg)
    p = _adam_params(50)
    lay = TG.bucket_layout([_t(p[k]) for k in sorted(p)], GROUP)
    n = 3
    seg = TG.ring_segment_rows(lay.rows, n)
    tp = {k: _t(v) for k, v in p.items()}
    ts = TO.init_opt_state(tp)
    pb = TG.flatten_bucket([tp[k] for k in sorted(tp)], lay,
                           rows=n * seg).reshape(n, seg, GROUP)
    bs = TO.init_bucket_opt_state(n, seg, GROUP)
    jpb = np.asarray(pb).copy()
    js = JO.init_bucket_opt_state(n, seg, GROUP)
    jstep = jax.jit(lambda p, g, s: JO.apply_bucket_updates(jcfg, p, g, s))
    rng = np.random.default_rng(51)
    for _ in range(4):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p.items()}
        gb = TG.flatten_bucket([_t(g[k]) for k in sorted(g)], lay,
                               rows=n * seg).reshape(n, seg, GROUP)
        ts = TO.apply_updates(tcfg, tp, {k: _t(v) for k, v in g.items()}, ts)
        bs = TO.apply_bucket_updates(tcfg, pb, gb, bs)
        jpb, js = jstep(jpb, gb.numpy(), js)
        flat = pb.reshape(-1)[:lay.total]
        want = TG.flatten_bucket([tp[k] for k in sorted(tp)], lay
                                 ).reshape(-1)[:lay.total]
        assert torch.equal(flat.view(torch.int32), want.view(torch.int32))
        np.testing.assert_allclose(pb.numpy(), np.asarray(jpb), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(bs["nu"].numpy(), np.asarray(js["nu"]),
                                   rtol=1e-6)
    assert bs["step"] == ts["step"] == int(js["step"]) == 4
    with pytest.raises(ValueError, match="state_bits"):
        TO.apply_bucket_updates(TO.AdamWConfig(state_bits=8), pb, gb, bs)


def test_q_enc_dec_match_jax():
    x = (np.random.default_rng(3).standard_normal((17, 40)) * 1e-3
         ).astype(np.float32)
    x[3] = 0.0
    j = jax.jit(lambda x: JO._q_enc(x, 8))(x)
    t = TO._q_enc(_t(x), 8)
    np.testing.assert_array_equal(np.asarray(j["codes"]), t["codes"].numpy())
    np.testing.assert_array_equal(_bits(j["scale"]), _bits(t["scale"]))
    np.testing.assert_array_equal(
        _bits(jax.jit(lambda e: JO._q_dec(e, x.shape, 8))(j)),
        _bits(TO._q_dec(t, 8).numpy()))
    zj = JO.init_opt_state({"w": jnp.zeros((4, 6))}, state_bits=8)
    zt = TO.init_opt_state({"w": torch.zeros(4, 6)}, state_bits=8)
    for m in ("mu", "nu"):
        np.testing.assert_array_equal(np.asarray(zj[m]["w"]["codes"]),
                                      zt[m]["w"]["codes"].numpy())
        np.testing.assert_array_equal(_bits(zj[m]["w"]["scale"]),
                                      _bits(zt[m]["w"]["scale"]))


def _tie_distance(x, scale, lv=255):
    """Distance in code units of each value's grid position (float64)
    from the nearest half-code tie."""
    y = (x.astype(np.float64) / scale + 1.0) * (0.5 * lv)
    return np.abs(y - np.floor(y) - 0.5)


def test_adamw_8bit_chained_steps_match_jax():
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, state_bits=8)
    tcfg, jcfg = TO.AdamWConfig(**cfg), JO.AdamWConfig(**cfg)
    p = _adam_params(70)
    jp, js = p, JO.init_opt_state(p, state_bits=8)
    tp = {k: _t(v) for k, v in p.items()}
    ts = TO.init_opt_state(tp, state_bits=8)
    step = jax.jit(lambda p, g, s: JO.apply_updates(jcfg, p, g, s))
    rng = np.random.default_rng(71)
    b1, b2 = 0.9, 0.999
    differed = {m: {k: np.zeros(v.shape, bool) for k, v in p.items()}
                for m in ("mu", "nu")}
    for _ in range(4):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p.items()}
        # the moments before rounding, from JAX's incoming state, float64
        pre = {}
        for k in p:
            mu = np.asarray(JO._q_dec(js["mu"][k], None, 8), np.float64)
            nu = np.asarray(JO._q_dec(js["nu"][k], None, 8), np.float64) ** 2
            g64 = g[k].astype(np.float64)
            pre[("mu", k)] = b1 * mu + (1 - b1) * g64
            pre[("nu", k)] = np.sqrt(b2 * nu + (1 - b2) * g64 ** 2)
        jp, js = step(jp, g, js)
        ts = TO.apply_updates(tcfg, tp, {k: _t(v) for k, v in g.items()}, ts)
        for k in p:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
            for m in ("mu", "nu"):
                jc = np.asarray(js[m][k]["codes"]).astype(np.int32)
                tc = ts[m][k]["codes"].numpy().astype(np.int32)
                jscale = np.asarray(js[m][k]["scale"])
                np.testing.assert_allclose(ts[m][k]["scale"].numpy(), jscale,
                                           rtol=1e-6)
                diff = jc != tc
                near = _tie_distance(pre[(m, k)], jscale) <= TIE
                assert np.all(~diff | near | differed[m][k]), (m, k)
                assert np.abs(jc - tc).max() <= 1, (m, k)
                differed[m][k] |= diff
    assert ts["step"] == int(js["step"]) == 4


# ---------------------------------------------------------------------------
# the simulated trainer: ring-sharded and fp16 streams
# ---------------------------------------------------------------------------

STREAM_STEPS = 4


@pytest.fixture(scope="module")
def sim_setup():
    """tests/test_grad_compress.py's setup: gpt2-xl-paper SMOKE at 2
    layers, 8 samples of 16 tokens, batch 4 over 2 workers, lr 1e-3."""
    jcfg = jget("gpt2-xl-paper", smoke=True).with_(num_layers=2)
    params = Mo.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, params, jax.tree.map(np.asarray, params)


def _comm(mod, wire, stochastic):
    P = mod.PlaneConfig
    kw = dict(stochastic=stochastic)
    return mod.CommConfig(mode="aqsgd", fw=P(bits=4, **kw),
                          bw=P(bits=8, **kw), dp=P(bits=4, wire=wire, **kw))


def _port_stream(sim_setup, wire, stochastic):
    jcfg, _, np_params = sim_setup
    tcfg = TS.SimTrainConfig(
        num_stages=2, comm=_comm(TCC, wire, stochastic), dp_workers=2,
        optimizer=TO.AdamWConfig(lr=1e-3, warmup_steps=1,
                                 total_steps=STREAM_STEPS))
    from repro_torch.configs.base import get_config as tget
    cfg = tget("gpt2-xl-paper", smoke=True).with_(num_layers=2)
    ds = TD.Dataset(TD.DatasetConfig(num_samples=8, seq_len=16,
                                     vocab_size=cfg.vocab_size))
    state, losses = TS.train(cfg, tcfg, ds, num_steps=STREAM_STEPS,
                             batch_size=4, initial_params=np_params,
                             device="cpu")
    return losses, state


def _jax_stream(sim_setup, wire):
    jcfg, params, _ = sim_setup
    tcfg = JS.SimTrainConfig(
        num_stages=2, comm=_comm(JCC, wire, False), dp_workers=2,
        optimizer=JO.AdamWConfig(lr=1e-3, warmup_steps=1,
                                 total_steps=STREAM_STEPS))
    ds = JD.Dataset(JD.DatasetConfig(num_samples=8, seq_len=16,
                                     vocab_size=jcfg.vocab_size))
    _, losses = JS.train(jcfg, tcfg, ds, num_steps=STREAM_STEPS,
                         batch_size=4, initial_params=params)
    return losses


def test_sim_ring_sharded_equals_ring_stochastic(sim_setup):
    ring, _ = _port_stream(sim_setup, "ring", True)
    sharded, state = _port_stream(sim_setup, "ring-sharded", True)
    assert sharded == ring
    assert state["opt"]["mu"].ndim == 3 and state["opt"]["step"] == 4


@pytest.mark.parametrize("wire", ["ring-sharded", "fp16"])
def test_sim_stream_matches_jax(sim_setup, wire):
    tl, state = _port_stream(sim_setup, wire, False)
    if wire == "ring-sharded":
        assert tl == _port_stream(sim_setup, "ring", False)[0]
    jl = _jax_stream(sim_setup, wire)
    np.testing.assert_allclose(tl[0], jl[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tl[1:], jl[1:], rtol=LATER_STEP_RTOL)
    assert torch.isfinite(state["dp_error"]).all()


def test_sim_refuses_8bit_moments():
    with pytest.raises(ValueError, match="distributed trainer"):
        TS.SimTrainConfig(optimizer=TO.AdamWConfig(state_bits=8))


# ---------------------------------------------------------------------------
# quantization.qdq
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_row", [True, False])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_qdq_matches_jax(bits, per_row):
    x = (np.random.default_rng(bits).standard_normal((6, 3, 50)) * 3
         ).astype(np.float32)
    want = jax.jit(lambda x: JQ.qdq(x, bits, stochastic=False,
                                    per_row=per_row))(x)
    got = TQ.qdq(_t(x), bits, per_row=per_row)
    np.testing.assert_array_equal(_bits(want), _bits(got.numpy()))
    u = np.random.default_rng(1).random(x.shape).astype(np.float32)
    codes, scale = JQ.quantize(x, bits, noise=u)
    want = jax.jit(lambda c, s: JQ.dequantize(c, s, bits))(codes, scale)
    np.testing.assert_array_equal(
        _bits(want), _bits(TQ.qdq(_t(x), bits, noise=_t(u)).numpy()))


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

def test_registry_matches_jax():
    for plane in JW.PLANES:
        assert TW.wire_names(plane) == JW.wire_names(plane), plane
        for name in TW.wire_names(plane):
            js, ts = JW.get_wire(name, plane), TW.get_wire(name, plane)
            for flag in ("sharded", "network", "chunkable", "psum_lowered"):
                assert getattr(js, flag) == getattr(ts, flag), (name, flag)
            assert (js.collective is None) == (ts.collective is None)
            shapes = [(128, 256), (877132, 512), (37, 64), (5, 13)] \
                if plane != "kv-cache" else [(8, 1, 4, 64), (2, 3, 5, 32)]
            if plane == "fw-activation":
                shapes.append((8, 64, 512))
            for shape in shapes:
                for bits in ((0, 2, 4, 8) if plane == "kv-cache"
                             else (2, 4, 8)):
                    for n in (1, 2, 3, 4, 5, 8):
                        assert ts.wire_bytes(shape, bits, n) == \
                            js.wire_bytes(shape, bits, n), \
                            (plane, name, shape, bits, n)
                        if ts.collective is not None and n > 1:
                            man = ts.expected_collectives(shape, bits, n)
                            assert sum(b * c for _, _, b, c in man) == \
                                ts.wire_bytes(shape, bits, n)
                            assert sorted(map(tuple, js.expected_collectives(
                                shape, bits, n))) == man, (name, shape)
    audited = {"ring": 18944, "ring-sharded": 6656, "psum": 131584,
               "fp16": 65536}
    for name, nbytes in audited.items():
        assert TW.get_wire(name).wire_bytes((128, 256), 2, 4) == nbytes
    assert TC.WIRES == JC.WIRES


def test_registry_lookups_and_registration():
    with pytest.raises(ValueError, match="did you mean 'ring-sharded'"):
        TCC.CommConfig(dp=TCC.PlaneConfig(bits=4, wire="ring-shraded"))
    with pytest.raises(ValueError, match="did you mean 'ring'"):
        TW.get_wire("rng")
    with pytest.raises(ValueError, match="registered wires: ring"):
        TW.get_wire("qsgd-topk-v2")
    assert TW.unknown_wire_message("hmb", "z-buffer") == \
        JW.unknown_wire_message("hmb", "z-buffer")
    with pytest.raises(ValueError, match="already registered"):
        TW.register_wire("ring", summary="dup", wire_bytes=lambda s, b, n: 0)
    with pytest.raises(ValueError, match="unknown plane"):
        TW.register_wire("x", plane="nope", summary="",
                         wire_bytes=lambda s, b, n: 0)
    assert TW.get_wire("ring-sharded").sim_allreduce \
        is TG.compress_reduce_scatter
    assert TW.get_wire("ring-sharded").collective \
        is TC.ring_ef_reduce_scatter_bucket


def test_registry_completeness_lint_passes_on_the_port():
    import glob
    import os
    from repro.analysis.lint import get_rule, lint_text
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rule = [get_rule("registry-completeness")]
    checked = 0
    for f in glob.glob(os.path.join(root, "src", "repro_torch", "**",
                                    "*.py"), recursive=True):
        with open(f) as fh:
            text = fh.read()
        checked += "register_wire(" in text
        rel = os.path.relpath(f, root).replace(os.sep, "/")
        assert lint_text(text, rel, rule) == [], rel
    assert checked >= 1


# ---------------------------------------------------------------------------
# the comm config's remaining surface (tests/test_comm.py's cases)
# ---------------------------------------------------------------------------

def _configs(mod):
    C, P = mod.CommConfig, mod.PlaneConfig
    return [C(), C(mode="fp32"), C(dp=P(bits=4)), C(dp=P(bits=4, wire="fp16")),
            C(mode="directq", fw=P(bits=2), bw=P(bits=4), zbuf=P(bits=2),
              dp=P(bits=8, wire="ring-sharded", group_d=256)),
            C(dp=P(bits=4, chunks=2)),
            C(dp=P(bits=4, wire="ring-sharded", chunks=4)),
            C(fw=P(bits=4, stochastic=False), bw=P(bits=8, stochastic=False),
              dp=P(bits=4, stochastic=False, error_feedback=False,
                   wire="psum"))]


@pytest.mark.parametrize("i", range(8))
def test_to_flags_round_trip_and_matches_jax(i):
    cfg, jcfg = _configs(TCC)[i], _configs(JCC)[i]
    assert cfg.to_flags() == jcfg.to_flags()
    assert cfg.to_json() == jcfg.to_json()
    ap = argparse.ArgumentParser()
    TCC.add_cli_args(ap)
    assert TCC.from_args(ap.parse_args(cfg.to_flags())) == cfg
    assert TCC.CommConfig.from_json(cfg.to_json()) == cfg


def test_to_flags_raises_on_flat_inexpressible():
    C, P = TCC.CommConfig, TCC.PlaneConfig
    with pytest.raises(ValueError, match="buffer_dtype"):
        C(buffer_dtype="bfloat16").to_flags()
    with pytest.raises(ValueError, match="group_d"):
        C(fw=P(bits=4, group_d=64)).to_flags()
    with pytest.raises(ValueError, match="backends differ"):
        C(fw=P(bits=4, backend="reference")).to_flags()
    with pytest.raises(ValueError, match="not supported by wire 'fp16'"):
        C(dp=P(bits=4, wire="fp16", chunks=2))


def test_dp_wire_flag_choices_from_registry():
    ap = argparse.ArgumentParser()
    TCC.add_cli_args(ap)
    action = next(a for a in ap._actions if a.dest == "dp_wire")
    assert list(action.choices) == TW.wire_names("dp-grad") == \
        ["ring", "psum", "ring-sharded", "fp16"]
    for name in action.choices:
        assert TW.get_wire(name).summary in action.help


def test_from_legacy_and_with_match_jax():
    cc_t = TA.CompressionConfig(mode="directq", fw_bits=2, bw_bits=4,
                                buffer_bits=2, stochastic=False,
                                backend="reference")
    cc_j = JA.CompressionConfig(mode="directq", fw_bits=2, bw_bits=4,
                                buffer_bits=2, stochastic=False,
                                backend="reference")
    t = TCC.CommConfig.from_legacy(cc_t, dp_grad_bits=4,
                                   dp_wire="ring-sharded")
    j = JCC.CommConfig.from_legacy(cc_j, dp_grad_bits=4,
                                   dp_wire="ring-sharded")
    assert t.to_json() == j.to_json()
    assert t.activation == cc_t
    cc32 = TA.CompressionConfig(bw_bits=32)
    assert TCC.CommConfig.from_legacy(cc32).activation == cc32
    assert t.with_(mode="fp32").mode == "fp32"
    assert t.dp.with_(bits=8).bits == 8


def test_codec_wraps_boundary_ops():
    codec = TCC.PlaneConfig(bits=4, stochastic=False,
                            backend="reference").codec()
    assert codec == Codec(bits=4, stochastic=False, backend="reference")
    x = torch.randn(8, 64, generator=torch.Generator().manual_seed(0))
    packed, scale = codec.encode(x)
    pb, sb = TB.encode(x, bits=4, backend="reference")
    assert torch.equal(packed, pb) and torch.equal(scale, sb)
    assert torch.equal(codec.decode(packed, scale, d=64),
                       TB.decode(pb, sb, bits=4, d=64, backend="reference"))
    assert torch.equal(codec.roundtrip(x), TB.roundtrip(x, bits=4))
    m = torch.zeros(8, 64)
    p2, s2, m2 = codec.encode_delta(x, m)
    assert torch.equal(codec.decode_accumulate(p2, s2, m), m2)
    assert codec.wire_bytes((8, 64)) == 8 * (64 // 2) + 8 * 4
    assert Codec(bits=0).wire_bytes((8, 64)) == 8 * 64 * 4
    err = codec.init_state([torch.zeros(100, 3)], group_d=32)
    assert err.shape == (-(-300 // 32), 32)
    stoch = Codec(bits=4).encode(x, generator=torch.Generator().manual_seed(1))
    assert stoch[0].shape == packed.shape


def test_pipeline_config_legacy_kwargs_refused():
    with pytest.raises(TypeError, match=r"dp_wire=.*removed.*"
                                        r"comm=CommConfig"):
        # repro-lint: disable=no-legacy-comm-kwargs (pins the error)
        TPL.PipelineConfig(dp_grad_bits=4, dp_wire="ring-sharded",
                           buffer_bits=2)
    with pytest.raises(TypeError, match="compression=.*from_legacy"):
        # repro-lint: disable=no-legacy-comm-kwargs (pins the error)
        TPL.PipelineConfig(compression=TA.CompressionConfig(mode="fp32"))
    new = TPL.PipelineConfig(comm=TCC.CommConfig(
        zbuf=TCC.PlaneConfig(bits=2),
        dp=TCC.PlaneConfig(bits=4, wire="ring-sharded")))
    assert new.comm.dp.wire == "ring-sharded" and new.comm.zbuf.bits == 2
    for name in ("compression", "buffer_bits", "dp_grad_bits",
                 "dp_grad_group", "dp_wire"):
        assert getattr(new, name, None) is None
    rep = dataclasses.replace(new, warmup=True)
    assert rep.comm == new.comm and rep.warmup
    via_legacy = TPL.PipelineConfig(comm=TCC.CommConfig.from_legacy(
        None, dp_grad_bits=4, dp_wire="ring-sharded", buffer_bits=2))
    assert via_legacy.comm == new.comm
    for msg_j, msg_t in ((JCC, TCC),):
        with pytest.raises(TypeError) as ej:
            msg_j.reject_legacy_comm("X", {"dp_wire": "fp16"})
        with pytest.raises(TypeError) as et:
            msg_t.reject_legacy_comm("X", {"dp_wire": "fp16"})
        assert str(et.value) == str(ej.value).replace("(repro.comm)",
                                                      "(repro_torch.comm)")


def test_sim_config_legacy_kwargs_refused():
    with pytest.raises(TypeError, match="dp_sharded=.*removed"):
        # repro-lint: disable=no-legacy-comm-kwargs (pins the error)
        TS.SimTrainConfig(
            compression=TA.CompressionConfig(mode="directq", fw_bits=2,
                                             bw_bits=4),
            dp_grad_bits=4, dp_workers=2, dp_sharded=True)
    new = TS.SimTrainConfig(
        comm=TCC.CommConfig(mode="directq", fw=TCC.PlaneConfig(bits=2),
                            bw=TCC.PlaneConfig(bits=4),
                            dp=TCC.PlaneConfig(bits=4, wire="ring-sharded")),
        dp_workers=2)
    assert new.comm.dp_wire_spec.sharded is True
    via_legacy = TS.SimTrainConfig(
        comm=TCC.CommConfig.from_legacy(
            TA.CompressionConfig(mode="directq", fw_bits=2, bw_bits=4),
            dp_grad_bits=4, dp_wire="ring-sharded"), dp_workers=2)
    assert via_legacy.comm == new.comm
