"""The port's training path against the JAX package.

Both packages get the same numpy inputs and, for the model, the same
``gpt2-xl-paper`` SMOKE weights (moved with
`repro_torch.weights.from_jax_params`).  JAX runs jitted, as its
trainer does.

* Data streams, buffers, the boundary's forward messages and its
  straight-through backward gradient are bit-equal (deterministic
  rounding; the 8-bit backward round trip).
* The model's loss and the trainer's loss stream are compared within a
  tolerance, because the two packages compute the same f32 model with
  different kernels (XLA's and PyTorch's matmuls, JAX's blockwise
  attention against a one-shot softmax) that agree to ~1e-7 relative.
  fp32, one worker: every step within 1e-5 relative (measured <= 9e-8).
  aqsgd fw 4 / bw 8 with 4-bit DP gradients over 2 workers: step 1
  within 1e-5 (measured 0), later steps within 1e-3 (measured <= 5e-5):
  from step 1 on, an ulp-level difference in the weights can put a
  value on the other side of a 4-bit rounding boundary, and each such
  flip moves a code by a whole grid step.
* What the trainer does with the workers' gradients (the DP wire, the
  mean mapped back onto parameter names, AdamW, the buffer writes) is
  held step by step with bit-equal injected gradients: the carry and
  buffers bit-equal, the parameters within 8 ulp.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.config import CommConfig as JComm
from repro.comm.config import PlaneConfig as JPlane
from repro.configs.base import get_config as jget
from repro.core import aqsgd as JA
from repro.data import pipeline as JD
from repro.models import model as Mo
from repro.optim import adamw as JO
from repro.training import simulated as JS
from repro_torch.comm.config import CommConfig as TComm
from repro_torch.comm.config import PlaneConfig as TPlane
from repro_torch.configs.base import get_config as tget
from repro_torch.core import aqsgd as TA
from repro_torch.data import pipeline as TD
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TO
from repro_torch.training import simulated as TS
from repro_torch.weights import from_jax_params, jax_leaf_names, \
    load_jax_params


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCH = "gpt2-xl-paper"
LOSS_RTOL = 1e-5
LATER_STEP_RTOL = 1e-3


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def shared():
    """SMOKE weights at the JAX package's init scales (N(0, 0.02)
    embedding, N(0, 1/fan_in) projections, zero norms), drawn with
    numpy: tracing `init_params` only for the tree's shapes is quicker
    than running it."""
    cfg = jget(ARCH, smoke=True)
    shapes = jax.eval_shape(lambda: Mo.init_params(cfg,
                                                   jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return np.zeros(s.shape, np.float32)
        std = 0.02 if "embed" in name else s.shape[-2] ** -0.5
        return (rng.standard_normal(s.shape) * std).astype(np.float32)

    np_params = jax.tree_util.tree_map_with_path(draw, shapes)
    params = jax.tree.map(jnp.asarray, np_params)
    return cfg, tget(ARCH, smoke=True), params, np_params


# ---------------------------------------------------------------------------
# data, optimizer, buffers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["synthetic-lm", "textfile"])
def test_dataset_streams_match_jax(kind, tmp_path):
    path = None
    if kind == "textfile":
        path = tmp_path / "corpus.txt"
        path.write_bytes(bytes(range(256)) * 3 + b"slow networks")
        path = str(path)
    kw = dict(num_samples=12, seq_len=16, vocab_size=97, kind=kind,
              path=path, seed=3)
    jd, td = JD.Dataset(JD.DatasetConfig(**kw)), TD.Dataset(
        TD.DatasetConfig(**kw))
    np.testing.assert_array_equal(jd.tokens, td.tokens)
    jb, tb = list(jd.batches(5, 7)), list(td.batches(5, 7))
    assert len(jb) == len(tb) == 7
    for a, b in zip(jb, tb):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_adamw_chained_steps_match_jax():
    rng = np.random.default_rng(0)
    p = {"a": rng.standard_normal((6, 5)).astype(np.float32),
         "b": rng.standard_normal((7,)).astype(np.float32)}
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6)
    jcfg, tcfg = JO.AdamWConfig(**cfg), TO.AdamWConfig(**cfg)
    jp, js = p, JO.init_opt_state(p)
    tp = {k: _t(v) for k, v in p.items()}
    ts = TO.init_opt_state(tp)
    step = jax.jit(lambda p, g, s: JO.apply_updates(jcfg, p, g, s))
    for i in range(4):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p.items()}
        jp, js = step(jp, g, js)
        ts = TO.apply_updates(tcfg, tp, {k: _t(v) for k, v in g.items()}, ts)
        assert np.float32(TO.lr_at(tcfg, i + 1)) == \
            np.float32(JO.lr_at(jcfg, i + 1))
        for k in p:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(ts["nu"][k].numpy(),
                                       np.asarray(js["nu"][k]), rtol=1e-6)
    assert ts["step"] == int(js["step"]) == 4


@pytest.mark.parametrize("buffer_bits", [0, 8])
def test_buffers_match_jax(buffer_bits):
    """init/write/read of the message buffers, raw and z-bit."""
    nb, ns, seq, d = 2, 6, 3, 64
    jcc = JA.CompressionConfig(buffer_bits=buffer_bits)
    tcc = TA.CompressionConfig(buffer_bits=buffer_bits)
    jb = JA.init_buffers(jcc, nb, ns, seq, d)
    tb = TA.init_buffers(tcc, nb, ns, seq, d)
    assert TA.buffer_nbytes(tcc, nb, ns, seq, d) == \
        JA.buffer_nbytes(jcc, nb, ns, seq, d)
    ids = np.array([4, 1, 3], np.int32)
    m_new = np.random.default_rng(1).standard_normal((3, seq, d)).astype(
        np.float32)
    jb = jax.jit(lambda b, m: JA.write_buffer(jcc, b, 1, ids, m))(jb, m_new)
    TA.write_buffer(tcc, tb, 1, _t(ids).long(), _t(m_new))
    for k in jb:
        np.testing.assert_array_equal(np.asarray(jb[k]), tb[k].numpy())
    want = jax.jit(lambda b: JA.read_buffer(jcc, b, 1, ids, d))(jb)
    np.testing.assert_array_equal(
        np.asarray(want), TA.read_buffer(tcc, tb, 1, _t(ids).long(), d))


# ---------------------------------------------------------------------------
# the boundary: forward messages and the straight-through backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["aqsgd", "directq"])
def test_apply_boundary_forward_and_backward_match_jax(mode):
    """Deterministic, fw 4 / bw 8: the message, the stored buffer and
    the gradient reaching the sending stage are bit-equal."""
    rng = np.random.default_rng(2)
    b, s, d = 3, 5, 64
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    m = h + 0.1 * rng.standard_normal((b, s, d)).astype(np.float32)
    seen = np.array([True, False, True])
    w = rng.standard_normal((b, s, d)).astype(np.float32)
    kw = dict(mode=mode, fw_bits=4, bw_bits=8, stochastic=False)
    jcc, tcc = JA.CompressionConfig(**kw), TA.CompressionConfig(**kw)
    key = jax.random.PRNGKey(0)

    def jloss(h):
        out, m_new = JA.apply_boundary(jcc, h, key, m, seen)
        return jnp.sum(jnp.tanh(out) * w), (out, m_new)

    (_, (jout, jm)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(h)
    th = _t(h).requires_grad_(True)
    tout, tm = TA.apply_boundary(tcc, th, _t(m), _t(seen))
    np.testing.assert_array_equal(np.asarray(jout), tout.detach().numpy())
    if mode == "aqsgd":
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    else:
        assert jm is None and tm is None
    # feed the port JAX's upstream gradient tanh'(out) * w, so only the
    # boundary's backward is compared
    g_up = jax.jit(jax.grad(lambda o: jnp.sum(jnp.tanh(o) * w)))(jout)
    tout.backward(_t(g_up))
    np.testing.assert_array_equal(np.asarray(jg), th.grad.numpy())


# ---------------------------------------------------------------------------
# the model's loss and the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_stages", [1, 2])
def test_loss_fn_matches_jax(shared, num_stages):
    jcfg, tcfg, params, np_params = shared
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": np.ones((2, 16), np.float32)}
    want, _ = jax.jit(lambda p, b: Mo.loss_fn(
        p, jcfg, b, num_stages=num_stages))(params, batch)
    model = from_jax_params(np_params, tcfg)
    got, met = TM.loss_fn(model, {"tokens": _t(batch["tokens"]).long(),
                                  "targets": _t(batch["targets"]).long(),
                                  "mask": _t(batch["mask"])},
                          num_stages=num_stages)
    assert abs(got.item() - float(want)) <= LOSS_RTOL * abs(float(want))
    assert met["ce"] is got and met["aux"] == 0.0


def _streams(shared, mode, workers, steps=4):
    jcfg, tcfg, params, np_params = shared

    def comm(C, P):
        det = dict(stochastic=False)
        if mode == "fp32":
            return C(mode="fp32", fw=P(bits=0, **det), bw=P(bits=0, **det))
        return C(mode="aqsgd", fw=P(bits=4, **det), bw=P(bits=8, **det),
                 dp=P(bits=4, **det))

    dc = dict(num_samples=8, seq_len=32, vocab_size=jcfg.vocab_size)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=steps)
    jt = JS.SimTrainConfig(num_stages=2, comm=comm(JComm, JPlane),
                           dp_workers=workers,
                           optimizer=JO.AdamWConfig(**opt))
    _, jl = JS.train(jcfg, jt, JD.Dataset(JD.DatasetConfig(**dc)),
                     num_steps=steps, batch_size=4, initial_params=params)
    tt = TS.SimTrainConfig(num_stages=2, comm=comm(TComm, TPlane),
                           dp_workers=workers,
                           optimizer=TO.AdamWConfig(**opt))
    state, tl = TS.train(tcfg, tt, TD.Dataset(TD.DatasetConfig(**dc)),
                         num_steps=steps, batch_size=4,
                         initial_params=np_params, device="cpu")
    return jl, tl, state


def test_trainer_fp32_loss_stream_matches_jax(shared):
    jl, tl, _ = _streams(shared, "fp32", 1)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)


def test_trainer_aqsgd_dp4_loss_stream_matches_jax(shared):
    """2 workers, 2 stage groups, 4 steps over 8 samples at batch 4:
    the second epoch (steps 3, 4) runs the delta path."""
    jl, tl, state = _streams(shared, "aqsgd", 2)
    np.testing.assert_allclose(tl[0], jl[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tl[1:], jl[1:], rtol=LATER_STEP_RTOL)
    assert state["buffers"]["seen"].all()
    assert state["dp_error"].shape[0] == 2
    assert torch.isfinite(state["dp_error"]).all()


def _flat(tree, prefix=""):
    """{'a': {'b': x}} -> {'a.b': x}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _as_jax_leaves(named, key, names):
    """One JAX leaf from the port's tensors (``layers.*`` stacked)."""
    if key.startswith("layers."):
        return np.stack([named[n].detach().numpy() for n in names])
    return named[names[0]].detach().numpy()


def test_trainer_update_path_matches_jax(shared, monkeypatch):
    """What the trainer does with the workers' gradients, held against
    JAX `train_step` step by step: 2 workers, aqsgd with 2 stage groups,
    4-bit DP gradients, deterministic, 3 steps (the third revisits a
    sample).  Each package's per-worker loss is replaced by one whose
    gradient is a fixed tree, its sign and size set per worker by the
    worker's sample ids, so both see bit-equal gradients and messages
    and only the update path is compared: the DP wire, the payload
    guard, the mean mapped back onto parameter names, AdamW and the
    buffer writes.  (With the real model the packages' gradients differ
    at the ulp level, the 8-bit backward round trip turns that into
    code flips, and after step 1 the carries differ in 97% of their
    elements by up to 1.1e-2.)

    The carry, the buffers and the loss are bit-equal every step (JAX
    on its Pallas backend, trap 2 of ROADMAP queue C); the first
    moment after step 1, ``(1 - beta1) * mean``, is bit-equal too, so
    every name receives its own leaf of the mean.  AdamW fuses
    differently under XLA, so the parameters are held within 8 ulp of
    the larger of |p| before and after the step and the learning rate
    (measured <= 4), and the second moment within 1e-6 relative."""
    jcfg, tcfg, params, np_params = shared
    shapes = jax.tree.map(lambda a: a.shape, np_params)
    rng = np.random.default_rng(7)

    def draw(_):
        return jax.tree.map(
            lambda s: (rng.standard_normal(s)
                       * 10.0 ** rng.integers(-4, 0)).astype(np.float32),
            shapes, is_leaf=lambda s: isinstance(s, tuple))

    base1, base2 = _flat(draw(0)), _flat(draw(1))
    pick = {k: rng.random(v.shape) < 0.5 for k, v in base1.items()}
    seq = 32
    m_base = rng.standard_normal((seq, jcfg.d_model)).astype(np.float32)

    def j_loss(p, mcfg, tcfg_, batch, m_all, seen_all, key):
        ids = batch["sample_ids"]
        c1 = jnp.sum(ids).astype(jnp.float32) + 1.0
        c2 = ids[0].astype(jnp.float32) - 3.5
        flat = _flat(p)
        dot = sum(jnp.sum(x * jax.lax.stop_gradient(
            jnp.where(pick[k], base1[k] * c1, base2[k] * c2)))
            for k, x in flat.items())
        msgs = tuple((ids.astype(jnp.float32)[:, None, None] + j + 1)
                     * m_base for j in range(tcfg_.num_stages - 1))
        return c1 + (dot - jax.lax.stop_gradient(dot)), \
            {"ce": c1, "aux": 0.0, "boundary_state": msgs}

    def t_loss(model, tcfg_, batch, m_all, seen_all, generator):
        ids = batch["sample_ids"]
        c1, c2 = ids.sum().float() + 1.0, ids[0].float() - 3.5
        grads = {}
        for key, names in jax_leaf_names(dict(model.named_parameters())):
            g = torch.where(_t(pick[key]), _t(base1[key]) * c1,
                            _t(base2[key]) * c2)
            grads.update({n: g[i] for i, n in enumerate(names)}
                         if key.startswith("layers.") else {names[0]: g})
        msgs = tuple((ids.float()[:, None, None] + j + 1) * _t(m_base)
                     for j in range(tcfg_.num_stages - 1))
        return c1, {"ce": c1, "boundary_state": msgs}, grads

    monkeypatch.setattr(JS, "_loss_with_boundaries", j_loss)
    monkeypatch.setattr(TS, "_loss_and_grads", t_loss)
    det = dict(stochastic=False)
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    jt = JS.SimTrainConfig(
        num_stages=2, dp_workers=2, optimizer=JO.AdamWConfig(**opt),
        comm=JComm(mode="aqsgd", fw=JPlane(bits=4, **det),
                   bw=JPlane(bits=8, **det),
                   dp=JPlane(bits=4, backend="pallas", **det)))
    tt = TS.SimTrainConfig(
        num_stages=2, dp_workers=2, optimizer=TO.AdamWConfig(**opt),
        comm=TComm(mode="aqsgd", fw=TPlane(bits=4, **det),
                   bw=TPlane(bits=8, **det), dp=TPlane(bits=4, **det)))
    # a fresh trace of the step, so no cached one sees the patched loss
    jstep = jax.jit(functools.partial(JS.train_step.__wrapped__,
                                      mcfg=jcfg, tcfg=jt))
    js = JS.init_train_state(jcfg, jt, 8, seq, jax.random.PRNGKey(0))
    js["params"] = params
    ts = TS.init_train_state(tcfg, tt, 8, seq,
                             generator=torch.Generator().manual_seed(0),
                             device="cpu")
    load_jax_params(ts["model"], np_params)
    gen = torch.Generator().manual_seed(1)
    before = _flat(np_params)
    batches = JD.Dataset(JD.DatasetConfig(
        num_samples=8, seq_len=seq, vocab_size=jcfg.vocab_size)
    ).batches(4, 3)
    for step, b in enumerate(batches):
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()},
                       jax.random.PRNGKey(step))
        ts, tm = TS.train_step(ts, TS.device_batch(b, "cpu"), gen,
                               mcfg=tcfg, tcfg=tt)
        assert float(tm["loss"]) == float(jm["loss"])
        np.testing.assert_array_equal(
            np.asarray(js["dp_error"]).view(np.int32),
            ts["dp_error"].numpy().view(np.int32))
        for k in js["buffers"]:
            np.testing.assert_array_equal(np.asarray(js["buffers"][k]),
                                          ts["buffers"][k].numpy())
        named = dict(ts["model"].named_parameters())
        after, mu, nu = (_flat(js["params"]), _flat(js["opt"]["mu"]),
                         _flat(js["opt"]["nu"]))
        for key, names in jax_leaf_names(named):
            got = _as_jax_leaves(named, key, names)
            ulp = np.spacing(np.maximum(np.maximum(
                np.abs(after[key]), np.abs(before[key])), opt["lr"]))
            assert (np.abs(got - after[key]) <= 8 * ulp).all(), key
            if step == 0:
                np.testing.assert_array_equal(
                    _as_jax_leaves(ts["opt"]["mu"], key, names), mu[key])
                np.testing.assert_allclose(
                    _as_jax_leaves(ts["opt"]["nu"], key, names), nu[key],
                    rtol=1e-6)
        before = after


def test_train_launcher_on_cpu(capsys):
    tlaunch.main(["--device", "cpu", "--smoke", "--stages", "2",
                  "--dp-grad-bits", "4", "--steps", "2", "--seq", "16",
                  "--samples", "8"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "final loss" in out
    with pytest.raises(SystemExit):
        tlaunch.main(["--device", "cpu", "--smoke", "--distributed",
                      "--fault", "1:dp:nan-scale"])
    assert "multi-process pipeline" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.main(["--smoke", "--stages", "2", "--steps", "1"])
