"""The ssm family (``mamba2-1.3b``) and the Mamba2 (SSD) mixer of
`repro_torch.models.ssm` against the JAX package.

The mixer, on the same numpy inputs as JAX's, at f32 rtol = atol =
1e-5:

* `ssd_chunked` over tests/test_model_internals.py's ``(l, chunk)``
  sweep (ragged tails, padded at dt = 0, included), and split in two
  with the first half's final state as the second's initial state;
* `_segsum` and `_causal_conv` (the taps added in JAX's order, in f32);
* `mamba2_forward`'s output and its state dict (the SSD state and the
  raw pre-conv tail), from zeros and from an initial state, and
  `mamba2_decode_step`, with the JAX package's init (`init_mamba2`'s
  closed-form ``dt_bias``, ``A_log`` and ``D``) and random norm scales
  and conv bias.

The model, on SMOKE weights from JAX ``init_params`` (norm scales and
the conv bias made random so they count), through `ARCH_CASES`, which
tests/test_torch_hybrid.py runs again for ``zamba2-2.7b``:

* `loss_fn` and every parameter's gradient against
  ``jax.value_and_grad`` (loss rtol 1e-5; gradients
  tests/test_torch_train_attention.py's tolerances) at 1 and 2 stage
  groups, remat off and on; remat on and off bit-equal;
* serving: prefill logits within 2e-5 of JAX's, teacher-forced decode
  steps within 5e-3 (tests/test_torch_slice.py's tolerances), with raw
  f32 caches; prefill then decode equal to the full forward, as JAX's
  ``test_prefill_then_decode_matches_full_forward``; greedy streams
  with 2 stage groups and the 4-bit aqsgd hop equal to JAX's
  `forward_with_caches` token for token;
* the kv-bits rules of JAX ``quantize_caches``;
* the simulated trainer's loss stream against JAX ``train``: aqsgd fw
  4 / bw 8 with 4-bit DP over 2 workers, deterministic, 2 stage groups
  (tests/test_torch_train.py's tolerances);
* `from_jax_params` / `to_jax_params`, `jax_leaves` in
  ``jax.tree.leaves`` order, and the distributed trainer's bucket laid
  out as JAX's ``flatten_bucket`` lays out the pipeline tree;
* the distributed trainer (a 2 x 2 gloo mesh, one torch thread a rank,
  a join timeout) in fp32 from JAX's weights: its losses along JAX
  ``loss_fn`` and AdamW's trajectory (rtol 2e-4, as
  tests/test_torch_pipeline.py's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.config import CommConfig as JComm
from repro.comm.config import PlaneConfig as JPlane
from repro.configs.base import get_config as jget
from repro.core import grad_compress as JG
from repro.data import pipeline as JD
from repro.models import model as Mo
from repro.models import ssm as JSSM
from repro.optim import adamw as JO
from repro.serving import DeltaHopCodec as JHop
from repro.serving import KVCodec as JKV
from repro.serving import quantize_caches as jquantize
from repro.training import pipeline as JPL
from repro.training import simulated as JS
from repro_torch.comm.config import CommConfig as TComm
from repro_torch.comm.config import PlaneConfig as TPlane
from repro_torch.configs.base import get_config as tget
from repro_torch.data import pipeline as TD
from repro_torch.launch.mesh import spawn
from repro_torch.models import model as TM
from repro_torch.models import ssm as TSSM
from repro_torch.optim import adamw as TO
from repro_torch.serving import DeltaHopCodec as THop
from repro_torch.serving import KVCodec as TKV
from repro_torch.training import pipeline as PL
from repro_torch.training import simulated as TS
from repro_torch.weights import (from_jax_params, jax_leaf_names,
                                 jax_leaves, stage_state_dict,
                                 to_jax_params, to_pipeline_params)
from test_torch_pipeline import run_scenarios
from test_torch_train_attention import (GRAD_ATOL, GRAD_RTOL,
                                        LATER_STEP_RTOL, LOSS_RTOL, _batch,
                                        _bits_equal, _comm, _port_grad, _t,
                                        _tbatch)

TOL = 1e-5
PREFILL_ATOL, DECODE_ATOL = 2e-5, 5e-3
DIST_RTOL = 2e-4
SPAWN_TIMEOUT = 240
ARCH = "mamba2-1.3b"
# the arch-bound tests' cases: (arch, SMOKE config fields replaced)
ARCH_CASES = [(ARCH, {})]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

def _ssd_inputs(b, l, h, p, n, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    xh = rng.standard_normal((b, l, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(f)
    A = (-np.exp(rng.standard_normal(h) * 0.5)).astype(f)
    Bc = rng.standard_normal((b, l, n)).astype(f)
    Cc = rng.standard_normal((b, l, n)).astype(f)
    return xh, dt, A, Bc, Cc


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("l,chunk", [(16, 4), (17, 4), (8, 8), (12, 16)])
def test_ssd_chunked_matches_jax(l, chunk):
    args = _ssd_inputs(2, l, 3, 4, 8, seed=l + chunk)
    jy, jfin = jax.jit(JSSM.ssd_chunked, static_argnums=5)(*args, chunk)
    ty, tfin = TSSM.ssd_chunked(*(_t(a) for a in args), chunk)
    _close(ty, jy)
    _close(tfin, jfin)
    assert ty.shape == (2, l, 3, 4) and tfin.dtype == torch.float32


def test_ssd_initial_state_continuation_matches_jax():
    """ssd(x[:12]) then ssd(x[12:], init=state), in both packages; the
    port's two halves also equal its one pass (test_model_internals'
    tolerance)."""
    xh, dt, A, Bc, Cc = _ssd_inputs(1, 24, 2, 4, 8, seed=3)
    l1, chunk = 12, 4
    first = [a[:, :l1] for a in (xh, dt)], [a[:, :l1] for a in (Bc, Cc)]
    second = [a[:, l1:] for a in (xh, dt)], [a[:, l1:] for a in (Bc, Cc)]
    jssd = jax.jit(JSSM.ssd_chunked, static_argnums=5)
    jy1, js1 = jssd(*first[0], A, *first[1], chunk)
    jy2, js2 = jssd(*second[0], A, *second[1], chunk, js1)
    t = lambda xs: [_t(a) for a in xs]
    ty1, ts1 = TSSM.ssd_chunked(*t(first[0]), _t(A), *t(first[1]), chunk)
    ty2, ts2 = TSSM.ssd_chunked(*t(second[0]), _t(A), *t(second[1]), chunk,
                                initial_state=ts1)
    _close(ty2, jy2)
    _close(ts2, js2)
    ty, tfin = TSSM.ssd_chunked(*(_t(a) for a in (xh, dt, A, Bc, Cc)), chunk)
    _close(torch.cat([ty1, ty2], 1), ty, 1e-4)
    _close(ts2, tfin, 1e-4)


def test_segsum_and_causal_conv_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 7)).astype(np.float32)
    want = np.asarray(jax.jit(JSSM._segsum)(x))
    got = TSSM._segsum(_t(x)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin])
    xbc = rng.standard_normal((2, 13, 24)).astype(np.float32)
    w = rng.standard_normal((24, 4)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    _close(TSSM._causal_conv(_t(xbc), _t(w), _t(b)),
           jax.jit(JSSM._causal_conv)(xbc, w, b))


def _mixer(cfg):
    """JAX ``init_mamba2`` leaves, the conv bias and the norm scale made
    random, as numpy; and the port's mixer holding them."""
    p = jax.tree.map(np.asarray, JSSM.init_mamba2(jax.random.PRNGKey(2),
                                                  jget(ARCH, smoke=True)))
    rng = np.random.default_rng(6)
    p["conv_b"] = (rng.standard_normal(p["conv_b"].shape) * 0.1).astype(
        np.float32)
    p["norm"] = {"scale": (rng.standard_normal(p["norm"]["scale"].shape)
                           * 0.1).astype(np.float32)}
    m = TSSM.Mamba2(cfg)
    m.load_state_dict({"in_proj": _t(p["in_proj"]),
                       "conv_w": _t(p["conv_w"]), "conv_b": _t(p["conv_b"]),
                       "dt_bias": _t(p["dt_bias"]), "A_log": _t(p["A_log"]),
                       "D": _t(p["D"]), "norm.scale": _t(p["norm"]["scale"]),
                       "out_proj": _t(p["out_proj"])})
    return p, m


@pytest.mark.parametrize("initial", [False, True])
def test_mamba2_forward_matches_jax(initial):
    """Over 45 tokens (a ragged last chunk of SMOKE's 32): the output and
    the state dict; with ``initial`` from a random SSD state."""
    jcfg, tcfg = jget(ARCH, smoke=True), tget(ARCH, smoke=True)
    p, m = _mixer(tcfg)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 45, jcfg.d_model)).astype(np.float32)
    st = (rng.standard_normal((2, jcfg.ssm_heads, jcfg.ssm_headdim,
                               jcfg.ssm_state)) * 0.1).astype(np.float32) \
        if initial else None
    jout, jst = jax.jit(lambda p, x, s: JSSM.mamba2_forward(
        p, x, jcfg, initial_state=s))(p, x, st)
    with torch.no_grad():
        tout, tst = TSSM.mamba2_forward(m, _t(x), tcfg, initial_state=None
                                        if st is None else _t(st))
    _close(tout, jout)
    _close(tst["ssm"], jst["ssm"])
    assert tst["conv"].shape == (2, jcfg.ssm_conv_width - 1,
                                 jcfg.d_inner + 2 * jcfg.ssm_state)
    _close(tst["conv"], jst["conv"])


def test_mamba2_decode_step_matches_jax():
    jcfg, tcfg = jget(ARCH, smoke=True), tget(ARCH, smoke=True)
    p, m = _mixer(tcfg)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    st = rng.standard_normal((3, jcfg.ssm_heads, jcfg.ssm_headdim,
                              jcfg.ssm_state)).astype(np.float32) * 0.1
    conv = rng.standard_normal((3, jcfg.ssm_conv_width - 1,
                                jcfg.d_inner + 2 * jcfg.ssm_state)).astype(
        np.float32)
    jout = jax.jit(lambda *a: JSSM.mamba2_decode_step(p, *a[:1], jcfg,
                                                      *a[1:]))(x, st, conv)
    with torch.no_grad():
        tout = TSSM.mamba2_decode_step(m, _t(x), tcfg, _t(st), _t(conv))
    for got, want in zip(tout, jout):
        _close(got, want)


def test_mixer_init_follows_jax():
    """`Mamba2.reset_parameters`: JAX's closed-form leaves and scales."""
    cfg = tget(ARCH)
    m = TSSM.Mamba2(cfg)
    m.reset_parameters(torch.Generator().manual_seed(0))
    j = JSSM.init_mamba2(jax.random.PRNGKey(0), jget(ARCH))
    for name in ("dt_bias", "A_log", "D", "conv_b"):
        _close(getattr(m, name).detach(), j[name], 1e-6)
    assert not m.norm.scale.any()
    for name, std in (("in_proj", cfg.d_model ** -0.5),
                      ("conv_w", 1 / cfg.ssm_conv_width),
                      ("out_proj", cfg.d_inner ** -0.5)):
        got = getattr(m, name).detach().std().item()
        assert abs(got / std - 1) < 0.02, name


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def arch_params(arch, kw):
    """(JAX config, port config, JAX params, numpy params): SMOKE with
    ``kw``'s fields replaced, JAX ``init_params`` weights with every norm
    scale and conv bias random."""
    jcfg, tcfg = jget(arch, smoke=True).with_(**kw), \
        tget(arch, smoke=True).with_(**kw)
    rng = np.random.default_rng(11)

    def leaf(path, a):
        a = np.asarray(a)
        name = jax.tree_util.keystr(path)
        if "scale" in name or "conv_b" in name:
            return (rng.standard_normal(a.shape) * 0.1).astype(np.float32)
        return a

    np_params = jax.tree_util.tree_map_with_path(
        leaf, Mo.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, np_params), np_params


def case_id(case):
    return case[0] + "".join(f"-{k}{v}" for k, v in case[1].items())


@pytest.fixture(scope="module", params=ARCH_CASES, ids=case_id)
def arch(request):
    return arch_params(*request.param)


@pytest.fixture(scope="module", params=ARCH_CASES[:1], ids=case_id)
def arch0(request):
    """The first case alone: for the tests whose config fields do not
    depend on the cases' differences."""
    return arch_params(*request.param)


@pytest.mark.parametrize("num_stages,remat", [(1, False), (2, True)])
def test_loss_and_grads_match_jax(arch, num_stages, remat):
    jcfg, tcfg, params, np_params = arch
    batch = _batch(jcfg.vocab_size, 4)
    want, jgrads = jax.jit(jax.value_and_grad(lambda p: Mo.loss_fn(
        p, jcfg, batch, num_stages=num_stages, remat=remat,
        block_k=16)[0]))(params)
    model = from_jax_params(np_params, tcfg)
    got, aux = TM.loss_fn(model, _tbatch(batch), num_stages=num_stages,
                          remat=remat, block_k=16)
    assert aux["aux"] == 0.0
    assert abs(got.item() - float(want)) <= LOSS_RTOL * abs(float(want))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(got, [model.get_parameter(n)
                                      for n in names])
    for name, g in zip(names, grads):
        ref = _port_grad(name, jgrads)
        scale = float(np.abs(ref).max()) or 1.0
        np.testing.assert_allclose(g.numpy(), ref, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=name)


def test_remat_is_bit_equal(arch):
    _, tcfg, _, np_params = arch
    model = from_jax_params(np_params, tcfg)
    batch = _tbatch(_batch(tcfg.vocab_size, 9))
    params = list(model.parameters())
    out = []
    for remat in (False, True):
        loss, _ = TM.loss_fn(model, batch, num_stages=2, remat=remat,
                             block_k=16)
        out.append((loss.detach(), torch.autograd.grad(loss, params)))
    assert _bits_equal(out[0][0], out[1][0])
    assert all(_bits_equal(a, b) for a, b in zip(out[0][1], out[1][1]))


PROMPT, STEPS, B = 40, 6, 2


def _tokens(cfg, n=PROMPT + STEPS):
    return np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, n)).astype(np.int32)


def test_serving_matches_jax_teacher_forced(arch):
    """Raw f32 caches, one stage group: the prompt (past SMOKE's chunk of
    32), then decode steps fed the same tokens in both packages."""
    jcfg, tcfg, params, np_params = arch
    model = from_jax_params(np_params, tcfg)
    toks = _tokens(jcfg)
    jc = Mo.init_caches(jcfg, B, PROMPT + STEPS, jnp.float32)
    tc = model.init_caches(B, PROMPT + STEPS, torch.float32)
    step = jax.jit(lambda c, t: Mo.forward_with_caches(params, jcfg, t, c))
    for i in range(STEPS + 1):
        x = toks[:, :PROMPT] if i == 0 else \
            toks[:, PROMPT + i - 1:PROMPT + i]
        jl, jc = step(jc, x)
        tl, tc = model.forward_with_caches(_t(x).long(), tc)
        _close(tl, jl, PREFILL_ATOL if i == 0 else DECODE_ATOL)
    assert tc["pos"] == int(jc["pos"]) == PROMPT + STEPS
    for name in ("ssm", "conv", "k", "v"):
        if name in jc:
            assert tc[name].shape == jc[name].shape, name
            _close(tc[name], jc[name], DECODE_ATOL)


def test_prefill_then_decode_matches_full_forward(arch):
    """As JAX's test of that name: the logits of prefill(t0..t15) and
    decode steps t16..t23 equal the training forward's over the whole
    sequence (tests/test_model_internals.py's tolerance)."""
    _, tcfg, _, np_params = arch
    model = from_jax_params(np_params, tcfg)
    toks = torch.tensor(_tokens(tcfg, 24)).long()
    with torch.no_grad():
        h = model.embed_tokens(toks)
        pos = torch.arange(24, dtype=torch.int32).expand(B, 24)
        h, _, _ = model.trunk_forward(h, pos)
        want = model.lm_logits(h)
        caches = model.init_caches(B, 24, torch.float32)
        got, caches = model.forward_with_caches(toks[:, :16], caches)
        _close(got, want[:, :16], 2e-4)
        for i in range(16, 24):
            got, caches = model.forward_with_caches(toks[:, i:i + 1],
                                                    caches)
            _close(got[:, 0], want[:, i], 2e-4)


def test_greedy_staged_stream_matches_jax(arch):
    """2 stage groups (mamba2's SMOKE: 2 layers; zamba2's: 2 blocks) and
    the 4-bit aqsgd hop, greedy: the same tokens as JAX's
    `forward_with_caches` at every step."""
    jcfg, tcfg, params, np_params = arch
    model = from_jax_params(np_params, tcfg)
    prompt = _tokens(jcfg)[:, :PROMPT]
    jhop, thop = JHop(mode="aqsgd", bits=4), THop(mode="aqsgd", bits=4)
    jc = Mo.init_caches(jcfg, B, PROMPT + STEPS, jnp.float32)
    jc["hop_m"] = jhop.init_state(1, B, jcfg.d_model)["m"]
    tc = model.init_caches(B, PROMPT + STEPS, torch.float32)
    tc["hop_m"] = thop.init_state(1, B, tcfg.d_model)["m"]
    jsteps = {pre: jax.jit(lambda c, t, pre=pre: Mo.forward_with_caches(
        params, jcfg, t, c, num_stages=2,
        boundary_fn=jhop.boundary_fn(prefill=pre))) for pre in (True, False)}
    jt, tt = prompt, _t(prompt).long()
    jtoks, ttoks = [], []
    for i in range(STEPS):
        jl, jc = jsteps[i == 0](jc, jt)
        tl, tc = model.forward_with_caches(
            tt, tc, num_stages=2, boundary_fn=thop.boundary_fn(
                prefill=i == 0))
        jt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        tt = torch.argmax(tl[:, -1], -1)[:, None]
        jtoks.append(jt[:, 0].tolist())
        ttoks.append(tt[:, 0].tolist())
    assert ttoks == jtoks
    _close(tc["hop_m"], jc["hop_m"], DECODE_ATOL)


def test_kv_bits_follow_the_family_rules(arch0):
    """JAX ``quantize_caches``: the ssm family has nothing to quantize
    (an 8-bit codec passes through, no KV store); the hybrid family
    refuses kv bits with JAX's message."""
    jcfg, tcfg, _, np_params = arch0
    model = from_jax_params(np_params, tcfg)
    jraw = Mo.init_caches(jcfg, B, 8, jnp.float32)
    if jcfg.family == "ssm":
        jq = jquantize(jcfg, jraw, JKV(bits=8))
        tq = model.init_caches(B, 8, torch.float32, kv_codec=TKV(bits=8))
        assert sorted(tq) == sorted(jq) == ["conv", "pos", "ssm"]
        return
    with pytest.raises(NotImplementedError) as want:
        jquantize(jcfg, jraw, JKV(bits=8))
    with pytest.raises(NotImplementedError) as got:
        model.init_caches(B, 8, torch.float32, kv_codec=TKV(bits=8))
    assert str(got.value) == str(want.value)
    assert sorted(model.init_caches(B, 8, kv_codec=TKV(bits=0))) == \
        sorted(jraw)


def test_trainer_loss_stream_matches_jax(arch0):
    """3 steps over 8 samples of 32 tokens at batch 4, 2 stage groups,
    aqsgd fw 4 / bw 8 with 4-bit DP over 2 workers, deterministic;
    step 3 (the second epoch) runs the delta path."""
    jcfg, tcfg, params, np_params = arch0
    steps = 3
    dc = dict(num_samples=8, seq_len=32, vocab_size=jcfg.vocab_size)
    jt = JS.SimTrainConfig(num_stages=2, comm=_comm(JComm, JPlane, "aqsgd"),
                           dp_workers=2,
                           optimizer=JO.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                    total_steps=steps))
    _, jl = JS.train(jcfg, jt, JD.Dataset(JD.DatasetConfig(**dc)),
                     num_steps=steps, batch_size=4, initial_params=params)
    tt = TS.SimTrainConfig(num_stages=2, dp_workers=2,
                           comm=_comm(TComm, TPlane, "aqsgd"),
                           optimizer=TO.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                    total_steps=steps))
    state, tl = TS.train(tcfg, tt, TD.Dataset(TD.DatasetConfig(**dc)),
                         num_steps=steps, batch_size=4,
                         initial_params=np_params, device="cpu")
    np.testing.assert_allclose(tl[0], jl[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tl[1:], jl[1:], rtol=LATER_STEP_RTOL)
    # the checkpoint tree carries every leaf of JAX's params
    tree = to_jax_params(state["model"])
    assert jax.tree.structure(jax.tree.map(np.asarray, tree)) == \
        jax.tree.structure(params)


def test_weights_round_trip_and_leaf_order(arch0):
    jcfg, tcfg, params, np_params = arch0
    model = from_jax_params(np_params, tcfg)
    back = jax.tree.map(lambda t: t.numpy(), to_jax_params(model))
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
    assert keys[:2] == ["embed", "final_norm.scale"]


def test_pipeline_bucket_matches_jax(arch0):
    """K = 2 and 3 stages over the SMOKE layers (3 leaves zero-padded
    layers for mamba2): every stage parameter sits where JAX's
    ``flatten_bucket`` of the pipeline tree puts it (a hybrid's shared
    block in one slot, every stage's copy)."""
    jcfg, tcfg, params, np_params = arch0
    for kk in (2, 3):
        jpipe = jax.tree.map(np.asarray, JPL.to_pipeline_params(
            jcfg, params, kk))
        pipe = to_pipeline_params(np_params, tcfg, kk)
        lay = PL.stage_layout(tcfg, kk)
        bucket = PL.PipelineBucket(tcfg, lay, 512)
        jlay = JG.bucket_layout(jpipe, 512)
        assert bucket.shape == (jlay.rows, jlay.group_d)
        jflat = np.asarray(JG.flatten_bucket(jpipe, jlay)).reshape(-1)
        for k in range(kk):
            stage = PL.Stage(tcfg, lay, k).load_pipeline_params(pipe, lay)
            names = {n for n, _ in stage.named_parameters()}
            assert any(n.startswith("shared_block.") for n in names) == \
                (tcfg.family == "hybrid")
            state = stage_state_dict(pipe, tcfg, kk, k,
                                     embed=stage.embed is not None,
                                     final_norm=k == kk - 1,
                                     shared=tcfg.family == "hybrid")
            assert set(state) == names
            for name, p in stage.named_parameters():
                off, n = bucket.slot(stage, name)
                np.testing.assert_array_equal(
                    jflat[off:off + n], p.detach().numpy().reshape(-1))


# ---------------------------------------------------------------------------
# the distributed trainer (a 2 x 2 gloo mesh)
# ---------------------------------------------------------------------------

D, K, M = 2, 2, 2
DIST_BATCH, DIST_SEQ, DIST_SAMPLES, DIST_STEPS = 4, 32, 4, 3


def dist_batches(vocab):
    """DIST_STEPS global batches, made from a seed; a data rank's two
    samples of a step are its slots 0 and 1."""
    rng = np.random.default_rng(7)
    return [{"tokens": rng.integers(0, vocab, (DIST_BATCH, DIST_SEQ),
                                    dtype=np.int32),
             "targets": rng.integers(0, vocab, (DIST_BATCH, DIST_SEQ),
                                     dtype=np.int32),
             "mask": (rng.random((DIST_BATCH, DIST_SEQ)) < 0.9).astype(
                 np.float32),
             "sample_ids": np.array([0, 0, 1, 1], np.int32)}
            for _ in range(DIST_STEPS)]


def dist_spec(arch, comm, pipe):
    """The distributed run's spec (SMOKE), from a pipeline tree
    ``pipe``."""
    cfg = tget(arch, smoke=True)
    return {"arch": arch, "smoke": True, "num_layers": cfg.num_layers,
            "comm": comm.to_json(), "device": "cpu",
            "data_par": D, "stages": K, "microbatches": M,
            "steps": DIST_STEPS, "batch": DIST_BATCH, "warmup_epochs": 1,
            "seed": 0,
            "optimizer": {"lr": 1e-3, "warmup_steps": 1,
                          "schedule": "constant", "state_bits": 0},
            "dataset": {"num_samples": DIST_SAMPLES, "seq_len": DIST_SEQ,
                        "vocab_size": cfg.vocab_size},
            "initial_params": pipe}


def jax_reference(jcfg, params, batches):
    """fp32 by the JAX package on one device: each step's ``loss_fn``
    loss and ``jax.grad`` gradient along JAX AdamW's trajectory."""
    opt_cfg = JO.AdamWConfig(lr=1e-3, warmup_steps=1, schedule="constant")
    opt = JO.init_opt_state(params)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: Mo.loss_fn(p, jcfg, b)[0]))
    losses, grads = [], []
    for batch in batches:
        b = {k: v for k, v in batch.items() if k != "sample_ids"}
        loss, g = grad_fn(params, b)
        params, opt = JO.apply_updates(opt_cfg, params, g, opt)
        losses.append(float(loss))
        grads.append(jax.tree.map(np.asarray, g))
    return losses, grads


def fp32_comm():
    return TComm(mode="fp32", fw=TPlane(bits=0), bw=TPlane(bits=8))


def test_distributed_fp32_matches_jax(tmp_path):
    jcfg, tcfg, params, np_params = arch_params(ARCH, {})
    batches = dist_batches(jcfg.vocab_size)
    pipe = to_pipeline_params(np_params, tcfg, K)
    out = spawn(run_scenarios, D * K,
                ([], [(dist_spec(ARCH, fp32_comm(), pipe), batches, 0)]),
                timeout=SPAWN_TIMEOUT, store_dir=str(tmp_path))
    want, _ = jax_reference(jcfg, params, batches)
    for r in out:
        np.testing.assert_allclose(r[0]["losses"], want, rtol=DIST_RTOL)
        assert all(rep["shared_equal"] is None for rep in r[0]["replicas"])
