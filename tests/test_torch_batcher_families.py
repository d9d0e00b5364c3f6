"""The port's continuous batcher on the ssm, hybrid, audio and vlm
families (mamba2-1.3b, zamba2-2.7b, whisper-small, pixtral-12b) against
the JAX package's `ContinuousBatcher` at SMOKE size.

The JAX batcher `vmap`s one row's `forward_with_caches` over every cache
leaf at the slot axis, so it carries ssm states, conv windows and an
audio model's cross caches with the KV rows; the port's pooled step
runs the whole pool with per-row heads (`Transformer.forward_with_caches`
with ``caches["pos"]`` a (B,) tensor).  Neither passes a request frames
or patches: whisper's cross caches stay zero, pixtral serves text only.
Both packages hold the same weights (tests/test_torch_ssm.py's
`arch_params`: JAX's init with random norm scales and conv biases) and
serve the same numpy-drawn prompts of two lengths (JAX compiles a
prefill per length).

Tolerances, those of tests/test_torch_batcher.py.  With a raw f32 pool
the greedy streams are equal token for token.  One pooled step from a
bf16 pool (the launcher's dtype) carried JAX -> port as numpy, with the
4-bit aqsgd hop over 2 stages and the 8-bit KV cache where the family
takes one (whisper, pixtral; mamba2's passes through, zamba2 keeps raw
k and v): logits within ``DECODE_ATOL``, every KV code within one step
and at most ``MAX_FLIP_FRACTION`` of them flipped, f32 state (ssm
states, KV scales, the hop's references) within a relative
``STATE_RTOL`` of the leaf's largest value, and bf16 rows (conv windows,
the hybrid's raw k and v) within that or one bf16 step (``BF16_STEP``
relative) of JAX's: values whose f32 sums differ by ulps round to
neighbouring bf16 values at a near-tie.  The pool after admission is
held to the same.

Run: ``PYTHONPATH=src python -m pytest -q
tests/test_torch_batcher_families.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import faults as JF
from repro.models import model as Mo
from repro.serving import ContinuousBatcher as JBatcher
from repro.serving import DeltaHopCodec as JHop
from repro.serving import KVCodec as JKV
from repro_torch.comm import faults as TF
from repro_torch.launch import serve as tserve
from repro_torch.serving import ContinuousBatcher as TBatcher
from repro_torch.serving import DeltaHopCodec as THop
from repro_torch.serving import KVCodec as TKV
from repro_torch.weights import from_jax_params
from test_torch_ssm import arch_params


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCHS = ["mamba2-1.3b", "zamba2-2.7b", "whisper-small", "pixtral-12b"]
CACHE = 16
# two prompt lengths; the fifth request runs beside an idle slot whose
# head passes CACHE (9 + 5 ticks, then 5 more idle)
LENGTHS, MAX_NEW = (4, 9, 4, 9, 4), 6
DECODE_ATOL = 5e-3
MAX_FLIP_FRACTION = 0.005
STATE_RTOL = 1e-4
BF16_STEP = 2.0 ** -7


@functools.lru_cache(maxsize=None)
def _arch(arch):
    """(JAX cfg, JAX params, the port's model holding the same
    weights)."""
    jcfg, tcfg, params, np_params = arch_params(arch, {})
    return jcfg, params, from_jax_params(np_params, tcfg)


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(n)).tolist() for n in lengths]


def _codecs(jcfg):
    """The pooled step's codecs, JAX's and the port's: the 8-bit KV
    cache where the family takes one (mamba2's passes through), the
    4-bit aqsgd hop."""
    bits = 0 if jcfg.family == "hybrid" else 8
    return (JKV(bits=bits), JHop(mode="aqsgd", bits=4)), \
        (TKV(bits=bits), THop(mode="aqsgd", bits=4))


@functools.lru_cache(maxsize=None)
def _jax_streams(arch):
    jcfg, params, _ = _arch(arch)
    jb = JBatcher(params, jcfg, num_slots=2, cache_len=CACHE,
                  dtype=jnp.float32)
    for p in _prompts(jcfg.vocab_size, LENGTHS, 3):
        jb.submit(p, max_new_tokens=MAX_NEW)
    return [r.tokens for r in jb.run()]


@pytest.mark.parametrize("arch", ARCHS)
def test_streams_match_jax_batcher(arch):
    """Raw f32 pool, one stage: five requests over 2 slots, token for
    token against the JAX batcher; the last runs beside an idle slot
    whose head has passed the cache."""
    jcfg, _, model = _arch(arch)
    tb = TBatcher(model, num_slots=2, cache_len=CACHE, dtype=torch.float32)
    for p in _prompts(jcfg.vocab_size, LENGTHS, 3):
        tb.submit(p, max_new_tokens=MAX_NEW)
    got = tb.run()
    assert [r.tokens for r in got] == _jax_streams(arch)
    assert all(r.state == "DONE" and len(r.tokens) == MAX_NEW for r in got)
    assert int(tb.caches["pos"].max()) > CACHE


def _jax_pool_step(jcfg, params, jkv, jhop, pool, tok):
    """The reference's pooled step (its `row_step` under `vmap`),
    returning each row's logits and the new pool."""
    bfn = jhop.boundary_fn(prefill=False)
    kv = jkv if jkv.bits else None

    def row(params, row, token):
        caches = {k: (v if k == "pos" else v[:, None])
                  for k, v in row.items()}
        logits, nc = Mo.forward_with_caches(
            params, jcfg, token[None, None], caches, logits_last_only=True,
            num_stages=2, boundary_fn=bfn, kv_codec=kv)
        return logits[0, -1], {k: (v if k == "pos" else v[:, 0])
                               for k, v in nc.items()}

    axes = {k: (0 if k == "pos" else 1) for k in pool}
    return jax.jit(jax.vmap(row, in_axes=(None, axes, 0),
                            out_axes=(0, axes)))(params, pool, tok)


def _np(x):
    """A JAX leaf as numpy, bf16 widened to f32 (exact)."""
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _to_port(pool, jpool):
    """numpy leaves -> the port's tensors in the JAX leaves' dtypes."""
    return {k: torch.from_numpy(v.copy()).to(
        torch.bfloat16 if jpool[k].dtype == jnp.bfloat16 else None)
        for k, v in pool.items()}


def _assert_pool_close(tpool, jpool):
    """Every leaf of the port's pool against JAX's by the module's
    tolerances: heads equal, codes within one step (flips counted), float
    leaves within STATE_RTOL of the leaf's largest value, a bf16 leaf's
    also within one bf16 step."""
    assert set(tpool) == set(jpool)
    flips = total = 0
    for name, j in jpool.items():
        want, t = _np(j), tpool[name]
        got = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
        if name == "pos":
            np.testing.assert_array_equal(got, want)
        elif name.endswith("_codes"):
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1, name
            flips += int((diff > 0).sum())
            total += diff.size
        else:
            assert t.dtype in (torch.float32, torch.bfloat16), (name,
                                                                t.dtype)
            rtol = BF16_STEP if t.dtype == torch.bfloat16 else 0.0
            np.testing.assert_allclose(
                got, want, rtol=rtol,
                atol=STATE_RTOL * max(np.abs(want).max(), 1e-30),
                err_msg=name)
    assert flips <= MAX_FLIP_FRACTION * max(total, 1), (flips, total)


@functools.lru_cache(maxsize=None)
def _jax_admitted(arch):
    """A 3-slot bf16 pool (the launcher's dtype) of the JAX batcher with
    the pooled step's codecs, after admitting prompts of the two
    lengths: (its prompts, the pool as numpy leaves, the next tokens)."""
    jcfg, params, _ = _arch(arch)
    (jkv, jhop), _ = _codecs(jcfg)
    jb = JBatcher(params, jcfg, num_slots=3, cache_len=CACHE, kv_codec=jkv,
                  hop_codec=jhop, num_stages=2)
    prompts = _prompts(jcfg.vocab_size, LENGTHS[:3], 5)
    for p in prompts:
        jb.submit(p, max_new_tokens=MAX_NEW)
    jb._admit()
    return prompts, dict(jb.caches), np.asarray(jb._next_tok)


@pytest.mark.parametrize("arch", ARCHS)
def test_admission_fills_the_bf16_pool_as_jax(arch):
    """The port's batcher admits the same three prompts into its bf16
    pool: the conv windows (bf16), the ssm states, the hybrid's raw k
    and v, the KV codes and scales, the hop's references and the heads
    agree with the JAX batcher's pool, and so do the first tokens."""
    jcfg, _, model = _arch(arch)
    _, (tkv, thop) = _codecs(jcfg)
    prompts, jpool, jtok = _jax_admitted(arch)
    tb = TBatcher(model, num_slots=3, cache_len=CACHE, kv_codec=tkv,
                  hop_codec=thop, num_stages=2)
    for p in prompts:
        tb.submit(p, max_new_tokens=MAX_NEW)
    tb._admit()
    if jcfg.family in ("ssm", "hybrid"):
        assert tb.caches["conv"].dtype == torch.bfloat16
        assert tb.caches["ssm"].dtype == torch.float32
    if jcfg.family == "audio":
        assert tb.caches["xk"].dtype == torch.bfloat16
        assert not tb.caches["xk"].any() and not tb.caches["xv"].any()
    _assert_pool_close(tb.caches, jpool)
    assert tb._next_tok.tolist() == jtok.tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_pooled_step_matches_jax(arch):
    """One pooled step from the JAX batcher's bf16 pool after admission
    (heads 4, 9 and 4), carried to the port as numpy, slot 2 then made
    idle with its head past the cache (19 of 16), the 4-bit aqsgd hop
    over 2 stages and 8-bit KV where the family takes it: logits, greedy
    tokens where JAX's top two lie apart, and the new pool, by the
    module's tolerances."""
    jcfg, params, model = _arch(arch)
    (jkv, jhop), (tkv, thop) = _codecs(jcfg)
    _, jpool, tok = _jax_admitted(arch)
    pool = {k: _np(v) for k, v in jpool.items()}
    pool["pos"] = pool["pos"].copy()
    pool["pos"][2] = CACHE + 3
    jin = {k: jnp.asarray(pool[k]).astype(jpool[k].dtype) for k in pool}
    jlogits, jnew = _jax_pool_step(jcfg, params, jkv, jhop, jin,
                                   jnp.asarray(tok))
    jlogits = np.asarray(jlogits)
    tc = _to_port(pool, jpool)
    logits, tc = model.forward_with_caches(
        torch.from_numpy(tok).long()[:, None], tc, logits_last_only=True,
        num_stages=2, boundary_fn=thop.boundary_fn(prefill=False),
        kv_codec=tkv if tkv.bits else None)
    np.testing.assert_allclose(logits[:, 0].numpy(), jlogits, rtol=0,
                               atol=DECODE_ATOL)
    top = np.sort(jlogits, axis=-1)
    clear = top[:, -1] - top[:, -2] > DECODE_ATOL
    np.testing.assert_array_equal(logits[:, 0].argmax(-1).numpy()[clear],
                                  jlogits.argmax(-1)[clear])
    _assert_pool_close(tc, jnew)


def test_cross_attention_reads_bf16_caches_exactly():
    """whisper's cross attention over the pool's bf16 ``xk``/``xv`` gives
    the bits it gives over their f32 widening, in a decode step
    (`onehot_attention` reads k and v in f32) and in a prefill (k and v
    cast to q's dtype)."""
    _, _, model = _arch("whisper-small")
    xattn = model.layers[0].xattn
    rng = np.random.default_rng(4)
    hk, hd, se = xattn.num_kv_heads, xattn.head_dim, 32
    xk, xv = (torch.from_numpy(rng.standard_normal((2, se, hk, hd)).astype(
        np.float32)).to(torch.bfloat16) for _ in "kv")
    for s in (1, 5):
        x = torch.from_numpy(rng.standard_normal((2, s, 256)).astype(
            np.float32))
        pos = torch.arange(s, dtype=torch.int32).expand(2, s) + 3
        with torch.no_grad():
            got = xattn.cross(x, pos, xk, xv)
            want = xattn.cross(x, pos, xk.float(), xv.float())
        assert got.dtype == torch.float32
        assert torch.equal(got, want), s


def test_slot_flags_over_ssm_and_conv_leaves():
    """`faults.slot_flags` over a mamba2 pool (5-D f32 ssm states, 4-D
    bf16 conv windows, the hop's references): a NaN in one slot's ssm
    state, an inf in another's conv window and a value above the guard
    bound flag those slots, as JAX's `slot_flags` flags them."""
    jcfg, _, model = _arch("mamba2-1.3b")
    pool = model.init_caches(4, CACHE, torch.bfloat16)
    pool["pos"] = torch.zeros(4, dtype=torch.int32)
    pool["hop_m"] = torch.zeros((1, 4, 1, jcfg.d_model))
    assert pool["ssm"].dim() == 5 and pool["conv"].dtype == torch.bfloat16
    assert not TF.slot_flags(pool).any()
    pool["ssm"][1, 1, 0, 2, 3] = float("nan")
    pool["conv"][0, 3, 1, 5] = float("inf")
    assert list(TF.slot_flags(pool)) == [False, True, False, True]
    pool["hop_m"][0, 0, 0, 7] = 2 * JF.GUARD_MAX
    jpool = {k: (v.float().numpy() if v.dtype == torch.bfloat16
                 else v.numpy()) for k, v in pool.items()}
    jpool["conv"] = jnp.asarray(jpool["conv"]).astype(jnp.bfloat16)
    np.testing.assert_array_equal(TF.slot_flags(pool), JF.slot_flags(jpool))
    assert list(TF.slot_flags(pool)) == [True, True, False, True]


def test_guard_evicts_poisoned_mamba2_slot():
    """``2:kv:nan-scale`` poisons the lowest active slot's float leaves
    (its ssm states, conv windows and hop references) at tick 2: that
    request is evicted with the fault text and cut short; the others'
    streams equal the clean run's."""
    jcfg, _, model = _arch("mamba2-1.3b")
    prompts = _prompts(jcfg.vocab_size, (4, 9, 4), 11)

    def serve(plan):
        bat = TBatcher(model, num_slots=2, cache_len=CACHE,
                       hop_codec=THop(mode="aqsgd", bits=4), num_stages=2,
                       fault_plan=plan)
        for p in prompts:
            bat.submit(p, max_new_tokens=MAX_NEW)
        return bat.run()

    base = serve(None)
    assert all(r.state == "DONE" and not r.error for r in base)
    hit = serve(TF.FaultPlan.parse("2:kv:nan-scale"))
    victim = hit[0]
    assert victim.state == "DONE" and len(victim.tokens) < MAX_NEW
    assert victim.error.startswith("wire fault detected: plane=kv "
                                   "wire='paged' tick=2:")
    assert [h.tokens for h in hit[1:]] == [b.tokens for b in base[1:]]
    assert not any(h.error for h in hit[1:])


def test_hybrid_quantized_pool_refused_as_jax():
    """zamba2 with 8-bit KV: the batcher and the launcher's
    ``--continuous --kv-bits 8`` raise JAX's `quantize_caches`
    message when the pool is built."""
    jcfg, params, model = _arch("zamba2-2.7b")
    with pytest.raises(NotImplementedError) as want:
        JBatcher(params, jcfg, num_slots=2, cache_len=CACHE,
                 kv_codec=JKV(bits=8))
    with pytest.raises(NotImplementedError) as got:
        TBatcher(model, num_slots=2, cache_len=CACHE, kv_codec=TKV(bits=8))
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError) as cli:
        tserve.main(["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
                     "--continuous", "--kv-bits", "8", "--stages", "2"])
    assert str(cli.value) == str(want.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_continuous_launcher(arch, capsys):
    """The launcher's ``--continuous`` at SMOKE size: the JAX launcher's
    request draw, every request served; the cache length counts a vlm
    model's patches (JAX's launcher); the pool's state bytes (f32 ssm
    states, bf16 conv windows), KV bytes and bf16 cross caches equal
    their byte models, and the report prints them."""
    jcfg = _arch(arch)[0]
    kv = "0" if jcfg.family == "hybrid" else "8"
    out = tserve.main(["--device", "cpu", "--smoke", "--arch", arch,
                       "--stages", "2", "--mode", "aqsgd", "--fw-bits", "4",
                       "--kv-bits", kv, "--continuous", "--slots", "2",
                       "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    text = capsys.readouterr().out
    rng = np.random.default_rng(1)
    want = []
    for _ in range(4):
        n = int(rng.integers(4, 9))
        want.append(rng.integers(0, jcfg.vocab_size, n).tolist())
    reqs = out["requests"]
    assert [r.prompt for r in reqs] == want
    assert all(r.state == "DONE" and len(r.tokens) == 3 for r in reqs)
    assert out["admissions"] == 4 and out["tokens"] == 12
    cache = 8 + 3 + jcfg.num_patches
    assert out["cache_len"] == cache
    slots, hk, hd = 2, jcfg.num_kv_heads, jcfg.head_dim
    state = cross = kv_bytes = 0
    if jcfg.family in ("ssm", "hybrid"):
        conv_dim = jcfg.d_inner + 2 * jcfg.ssm_groups * jcfg.ssm_state
        ssm = jcfg.num_layers * slots * jcfg.ssm_heads * jcfg.ssm_headdim \
            * jcfg.ssm_state * 4
        conv = jcfg.num_layers * slots * (jcfg.ssm_conv_width - 1) \
            * conv_dim * 2
        state = ssm + conv
        assert f"ssm state: {state} B ({ssm} ssm f32 + {conv} conv bf16" \
            in text
    if jcfg.family == "hybrid":
        kv_bytes = 2 * jcfg.num_layers // jcfg.shared_attn_every * slots \
            * cache * hk * hd * 2
    elif jcfg.family != "ssm":
        kv_bytes = JKV(bits=8).stored_bytes((slots, cache, hk, hd)) * 2 \
            * jcfg.num_layers
    if jcfg.family == "audio":
        cross = 2 * jcfg.num_layers * slots * jcfg.encoder_seq * hk * hd * 2
        assert f"cross caches: {cross} B raw bf16" in text
    assert (out["state_bytes"], out["kv_store_bytes"], out["cross_bytes"]) \
        == (state, kv_bytes, cross)
