"""The moe family (``mixtral-8x22b``, ``deepseek-moe-16b``,
``moonshot-v1-16b-a3b``) and `repro_torch.models.moe` against the JAX
package, at SMOKE shapes, one torch thread.

The MoE FFN on the same numpy inputs and weights (JAX ``init_moe``):

* `router_probs`, `moe_ffn` (its output and aux) and
  `moe_dense_reference` for all three SMOKE configs (no drops at their
  ``capacity_factor`` 8), outputs within 1e-5;
* the drop path at ``capacity_factor`` 1.25, one dispatch and
  ``per_sequence``: the routing (``top_i``) equal where the k-th and
  (k+1)-th probabilities lie apart (asserted of these seeds), and the
  keep mask equal to the one JAX's code computes, with drops;
* the uniform decode step's drop case: two rows that pick the same
  experts, capacity 1, the second row's slots dropped in both packages;
* the CPU backward bit-reproducible over 8 threads (the dispatch
  gathers a token's k copies through an ``expand``, whose backward is
  a sum, not an accumulating ``index_put_``).

The model, on SMOKE weights from JAX ``init_params`` (norm scales
random): `loss_fn` (ce, aux and the total) and every gradient against
``jax.value_and_grad`` at 1 and 2 stage groups, remat off and on
(tests/test_torch_train_attention.py's tolerances); greedy streams with
2 stage groups, the 4-bit aqsgd hop and the 8-bit KV cache (the dense
prefix's ``pk``/``pv`` raw) token for token; a uniform decode step
that drops; the continuous batcher's streams against JAX's batcher
token for token with raw caches; the cache layout against JAX's
``quantize_caches``.  deepseek-moe-16b and mixtral-8x22b run every
case; moonshot-v1-16b-a3b, which differs from deepseek-moe-16b only in
depth, vocabulary and RoPE theta, runs the FFN case, one loss case
and the greedy stream.  The weights, the simulated trainer and the configs
are tests/test_torch_moe_train.py's, the distributed trainer
tests/test_torch_moe_dist.py's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.models import model as Mo
from repro.models import moe as JM
from repro.serving import ContinuousBatcher as JBatcher
from repro.serving import DeltaHopCodec as JHop
from repro.serving import KVCodec as JKV
from repro.serving import quantize_caches as jquantize
from repro_torch.configs.base import get_config as tget
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoE
from repro_torch.serving import ContinuousBatcher as TBatcher
from repro_torch.serving import DeltaHopCodec as THop
from repro_torch.serving import KVCodec as TKV
from repro_torch.weights import from_jax_params
from test_torch_ssm import DECODE_ATOL, PREFILL_ATOL, arch_params
from test_torch_train_attention import (GRAD_ATOL, GRAD_RTOL, LOSS_RTOL,
                                        _batch, _bits_equal, _t, _tbatch)

ARCHS = ["deepseek-moe-16b", "mixtral-8x22b", "moonshot-v1-16b-a3b"]
# every model case; moonshot-v1-16b-a3b (deepseek's layout) runs some
FULL = ARCHS[:2]
TOL = 1e-5
# the least gap between the k-th and (k+1)-th router probability of a
# token at which both packages must pick the same experts
MARGIN = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------

def _moe(arch, **kw):
    """(JAX config, JAX ``init_moe`` leaves as numpy, the port's `MoE`
    holding them)."""
    jc = jget(arch, smoke=True).with_(**kw)
    p = jax.tree.map(np.asarray, JM.init_moe(
        jax.random.PRNGKey(4), jc.d_model, jc.n_experts, jc.moe_d_ff,
        jc.n_shared_experts, gated=jc.mlp_gated))
    m = TMoE.MoE(tget(arch, smoke=True).with_(**kw))
    state = {k: p[k] for k in ("router", "w_gate", "w_up", "w_down")}
    state.update({f"shared.{k}": v for k, v in p.get("shared", {}).items()})
    m.load_state_dict({k: _t(v) for k, v in state.items()})
    return jc, p, m


def _x(b, s, d, seed, skew=0.0):
    """Random rows, all shifted by one random vector times ``skew`` (so
    the router favours some experts and a dispatch drops)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)) + skew * rng.standard_normal(d)
    return x.astype(np.float32)


def _jax_keep(p, x, top_k, capacity_factor, per_sequence):
    """JAX ``moe_ffn``'s routing, its own lines: (top_i, keep) a
    dispatch, stacked over the sequences with ``per_sequence``."""
    def one(xx):
        t = xx.shape[0] * xx.shape[1]
        e = p["router"].shape[-1]
        probs = JM.router_probs(p, xx.reshape(t, -1))
        _, top_i = jax.lax.top_k(probs, top_k)
        cap = int(np.ceil(t * top_k / e * capacity_factor))
        flat_e = top_i.reshape(-1)
        order = jnp.argsort(flat_e)
        se = flat_e[order]
        counts = jnp.bincount(flat_e, length=e)
        starts = jnp.cumsum(counts) - counts
        pos = jnp.arange(t * top_k) - starts[se]
        return top_i, pos < cap
    if per_sequence:
        return jax.vmap(lambda xb: one(xb[None]))(x)
    top_i, keep = one(x)
    return top_i[None], keep[None]


def _margins(probs, k):
    """Each token's gap between its k-th and (k+1)-th probability."""
    s = np.sort(np.asarray(probs), axis=-1)[..., ::-1]
    return s[..., k - 1] - s[..., k] if s.shape[-1] > k else \
        np.full(s.shape[:-1], np.inf)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch):
    """No drops (SMOKE's capacity_factor 8): the router's probabilities,
    the output and aux, and the drop-free reference, within 1e-5."""
    jc, p, m = _moe(arch)
    x = _x(2, 12, jc.d_model, 1)
    xf = x.reshape(-1, jc.d_model)
    _close(TMoE.router_probs(m, _t(xf)), JM.router_probs(p, xf))
    jo, ja = jax.jit(lambda p, x: JM.moe_ffn(
        p, x, top_k=jc.top_k, capacity_factor=jc.capacity_factor))(p, x)
    with torch.no_grad():
        to, ta = TMoE.moe_ffn(m, _t(x), top_k=jc.top_k,
                              capacity_factor=jc.capacity_factor)
        tr = TMoE.moe_dense_reference(m, _t(x), top_k=jc.top_k)
    _close(to, jo)
    _close(ta, ja)
    _close(tr, JM.moe_dense_reference(p, x, top_k=jc.top_k))
    _close(to, tr)
    assert to.shape == x.shape and ta.shape == ()


@pytest.mark.parametrize("per_sequence", [False, True])
@pytest.mark.parametrize("arch", FULL)
def test_drop_path_matches_jax(arch, per_sequence):
    """``capacity_factor`` 1.25, as the full configs: the routing equal
    wherever the k-th and (k+1)-th probabilities lie MARGIN apart (all
    tokens, at these seeds), the keep mask equal with drops in it, and
    the output and aux within 1e-5."""
    jc, p, m = _moe(arch, capacity_factor=1.25)
    x = _x(3, 16, jc.d_model, 2, skew=1.0)
    jtop, jkeep = _jax_keep(p, x, jc.top_k, 1.25, per_sequence)
    groups = 3 if per_sequence else 1
    xg = _t(x).reshape(groups, -1, jc.d_model)
    cap = TMoE.capacity(xg.shape[1], jc.top_k, jc.n_experts, 1.25)
    with torch.no_grad():
        r = TMoE.route(m, xg, jc.top_k, cap)
    assert (_margins(r["probs"], jc.top_k) > MARGIN).all()
    np.testing.assert_array_equal(r["top_i"].numpy(), np.asarray(jtop))
    np.testing.assert_array_equal(r["keep"].numpy(), np.asarray(jkeep))
    assert not r["keep"].all()
    jo, ja = jax.jit(lambda p, x: JM.moe_ffn(
        p, x, top_k=jc.top_k, capacity_factor=1.25,
        per_sequence=per_sequence))(p, x)
    with torch.no_grad():
        to, ta = TMoE.moe_ffn(m, _t(x), top_k=jc.top_k, capacity_factor=1.25,
                              per_sequence=per_sequence)
    _close(to, jo)
    _close(ta, ja)


def test_decode_rows_that_pick_one_expert_drop_like_jax():
    """A uniform decode step's dispatch runs over its B rows: two equal
    rows pick the same experts, and at capacity ceil(2 k / E 1.25) = 1
    the second row's slots drop (its routed output is zero), as in
    JAX; per row (the pool's dispatch) nothing drops."""
    jc, p, m = _moe("mixtral-8x22b", capacity_factor=1.25, n_experts=8)
    row = _x(1, 1, jc.d_model, 3)
    x = np.concatenate([row, row])
    assert TMoE.capacity(2, jc.top_k, 8, 1.25) == 1
    jo, ja = JM.moe_ffn(p, x, top_k=jc.top_k, capacity_factor=1.25)
    with torch.no_grad():
        to, ta = TMoE.moe_ffn(m, _t(x), top_k=jc.top_k, capacity_factor=1.25)
        alone, _ = TMoE.moe_ffn(m, _t(x), top_k=jc.top_k,
                                capacity_factor=1.25, per_sequence=True)
    _close(to, jo)
    _close(ta, ja)
    assert not to[1].any() and to[0].abs().max() > 0
    _close(alone[1], alone[0], 0)


def test_moe_backward_is_reproducible():
    """The MoE FFN's gradients (x's, every weight's) are the same bits
    on every call over 8 threads, at a capacity that drops."""
    jc, _, m = _moe("deepseek-moe-16b", capacity_factor=1.25)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 32, jc.d_model, generator=gen, requires_grad=True)
    g = torch.randn(4, 32, jc.d_model, generator=gen)
    params = [x, *m.parameters()]
    torch.set_num_threads(8)
    try:
        runs = []
        for _ in range(10):
            out, aux = TMoE.moe_ffn(m, x, top_k=jc.top_k,
                                    capacity_factor=1.25)
            runs.append(torch.autograd.grad((out * g).sum() + aux, params))
    finally:
        torch.set_num_threads(1)
    for run in runs[1:]:
        assert all(_bits_equal(a, b) for a, b in zip(runs[0], run))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _arch(name):
    return arch_params(name, {})


def _jax_grad(name, grads):
    """The JAX gradient leaf of a port parameter name (``layers.<i>``
    indexes the stacked leaf, ``prefix.<i>`` the list)."""
    parts = name.split(".")
    if parts[0] == "layers":
        node = grads["layers"]
        for p in parts[2:]:
            node = node[p]
        return np.asarray(node)[int(parts[1])]
    node = grads
    for p in parts:
        node = node[int(p)] if p.isdigit() else node[p]
    return np.asarray(node)


@pytest.mark.parametrize("name,num_stages,remat",
                         [(a, 1, False) for a in FULL]
                         + [(a, 2, True) for a in ARCHS])
def test_loss_and_grads_match_jax(name, num_stages, remat):
    jcfg, tcfg, params, np_params = _arch(name)
    batch = _batch(jcfg.vocab_size, 4)
    (want, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: Mo.loss_fn(p, jcfg, batch, num_stages=num_stages,
                             remat=remat, block_k=16), has_aux=True))(params)
    model = from_jax_params(np_params, tcfg)
    got, met = TM.loss_fn(model, _tbatch(batch), num_stages=num_stages,
                          remat=remat, block_k=16)
    for a, b in ((got, want), (met["ce"], jmet["ce"]),
                 (met["aux"], jmet["aux"])):
        assert abs(a.item() - float(b)) <= LOSS_RTOL * abs(float(b))
    assert met["aux"].item() > 0
    names = [n for n, _ in model.named_parameters()]
    assert any(n.startswith("prefix.") for n in names) == \
        bool(tcfg.first_dense_layers)
    grads = torch.autograd.grad(got, [model.get_parameter(n)
                                      for n in names])
    for name, g in zip(names, grads):
        ref = _jax_grad(name, jgrads)
        scale = float(np.abs(ref).max()) or 1.0
        np.testing.assert_allclose(g.numpy(), ref, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=name)


PROMPT, STEPS, B = 24, 6, 2


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_staged_stream_with_kv8_matches_jax(name):
    """2 stage groups over the MoE layers, the 4-bit aqsgd hop and the
    8-bit KV cache, greedy: the prefill's logits, then the same tokens
    as JAX's `forward_with_caches` at every step; the raw prefix caches
    and the hop buffer within the decode tolerance."""
    jcfg, tcfg, params, np_params = _arch(name)
    model = from_jax_params(np_params, tcfg)
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    jhop, thop = JHop(mode="aqsgd", bits=4), THop(mode="aqsgd", bits=4)
    jkv, tkv = JKV(bits=8), TKV(bits=8)
    n = PROMPT + STEPS
    jc = jquantize(jcfg, Mo.init_caches(jcfg, B, n, jnp.float32), jkv)
    jc["hop_m"] = jhop.init_state(1, B, jcfg.d_model)["m"]
    tc = model.init_caches(B, n, torch.float32, kv_codec=tkv)
    tc["hop_m"] = thop.init_state(1, B, tcfg.d_model)["m"]
    jsteps = {pre: jax.jit(lambda c, t, pre=pre: Mo.forward_with_caches(
        params, jcfg, t, c, num_stages=2, kv_codec=jkv,
        boundary_fn=jhop.boundary_fn(prefill=pre))) for pre in (True, False)}
    jt, tt = prompt, _t(prompt).long()
    jtoks, ttoks = [], []
    for i in range(STEPS):
        jl, jc = jsteps[i == 0](jc, jt)
        tl, tc = model.forward_with_caches(
            tt, tc, num_stages=2, kv_codec=tkv,
            boundary_fn=thop.boundary_fn(prefill=i == 0))
        if i == 0:
            _close(tl, jl, PREFILL_ATOL)
        jt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        tt = torch.argmax(tl[:, -1], -1)[:, None]
        jtoks.append(jt[:, 0].tolist())
        ttoks.append(tt[:, 0].tolist())
    assert ttoks == jtoks
    names = ["hop_m"] + (["pk", "pv"] if tcfg.first_dense_layers else [])
    for name in names:
        _close(tc[name], jc[name], DECODE_ATOL)


def test_decode_step_drops_like_jax():
    """A uniform decode step at ``capacity_factor`` 1.25 and 8 experts
    (capacity 1 over B = 2 rows) from two equal prompts: in JAX the
    second row's routed slots drop, so its logits differ from the
    first's; the port's logits are JAX's within the decode tolerance."""
    jcfg, tcfg, params, np_params = arch_params(
        "mixtral-8x22b", {"capacity_factor": 1.25, "n_experts": 8})
    model = from_jax_params(np_params, tcfg)
    prompt = np.repeat(np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (1, 10)).astype(np.int32), 2, axis=0)
    jc = Mo.init_caches(jcfg, 2, 12, jnp.float32)
    tc = model.init_caches(2, 12, torch.float32)
    for toks in (prompt, prompt[:, -1:]):
        jl, jc = Mo.forward_with_caches(params, jcfg, toks, jc)
        tl, tc = model.forward_with_caches(_t(toks).long(), tc)
    _close(tl, jl, DECODE_ATOL)
    assert np.abs(np.asarray(jl[0]) - np.asarray(jl[1])).max() > 1e-3
    _close(tl[1], jl[1], DECODE_ATOL)


@pytest.mark.parametrize("name", FULL)
def test_batcher_streams_match_jax(name):
    """Raw f32 caches, one stage: four requests of 5 and 9 tokens (JAX
    compiles a prefill a prompt length) over 2 slots, token for token
    against JAX's `ContinuousBatcher` (its pooled step vmaps a one-row
    step, so the port's dispatches per row)."""
    jcfg, tcfg, params, np_params = _arch(name)
    model = from_jax_params(np_params, tcfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, int(n)).tolist()
               for n in (5, 9, 9, 5)]
    jb = JBatcher(params, jcfg, num_slots=2, cache_len=16, dtype=jnp.float32)
    tb = TBatcher(model, num_slots=2, cache_len=16, dtype=torch.float32)
    for p in prompts:
        jb.submit(p, max_new_tokens=5)
        tb.submit(p, max_new_tokens=5)
    want = [r.tokens for r in jb.run()]
    got = tb.run()
    assert [r.tokens for r in got] == want
    assert all(r.state == "DONE" and len(r.tokens) == 5 for r in got)


@pytest.mark.parametrize("name", FULL)
def test_caches_follow_jax_quantize_caches(name):
    """`init_caches` with an 8-bit codec lays the trunk's stores out as
    JAX's ``quantize_caches`` does and keeps the prefix's raw; the
    per-token bytes the serve launcher prints are the stores' own."""
    jcfg, tcfg, _, np_params = _arch(name)
    model = from_jax_params(np_params, tcfg)
    jq = jquantize(jcfg, Mo.init_caches(jcfg, B, 8, jnp.float32),
                   JKV(bits=8))
    q = model.init_caches(B, 8, torch.float32, kv_codec=TKV(bits=8))
    assert set(q) == set(jq)
    assert ("pk" in q) == bool(tcfg.first_dense_layers)
    for name in set(jq) - {"pos"}:
        assert tuple(q[name].shape) == jq[name].shape, name
        assert str(q[name].dtype).split(".")[-1] == str(jq[name].dtype)


