"""The port's continuous batcher, its per-row write heads and its slot
guard, against the JAX package.

The JAX batcher (`repro.serving.batcher`) `vmap`s a single-row decode
over a ``(num_slots,)`` position vector; the port runs one pooled step
with per-row write heads (`Transformer.forward_with_caches` with
``caches["pos"]`` a (B,) tensor, B3's append at per-row heads).  Both
hold the same SMOKE weights (moved by `weights.from_jax_params`) and
serve the same numpy-drawn prompts.  gemma2-9b runs with
``sliding_window`` 4 so that its per-row windows mask keys in decode;
the pooled step and the launcher also run deepseek-moe-16b (a row's MoE
dispatch, its dense prefix's raw ``pk``/``pv`` at per-row heads).

Tolerances.  With raw f32 caches the two packages' logits differ by
~1e-6 (other matmul kernels), so their greedy streams are held equal
token for token.  With the 8-bit KV cache and the 4-bit aqsgd hop, one
pooled step is held to tests/test_torch_slice.py's: logits within
``DECODE_ATOL``, every KV code within one step, at most
``MAX_FLIP_FRACTION`` of them flipped; the new scales and the hop's
references (f32 values from inputs that differ by ulps) within a
relative 1e-4 of the pool's largest; heads equal.  The append at
per-row heads equals JAX's ``KVCodec.append`` under ``jax.vmap`` bit
for bit, the clamp of a head past the store included.  The fault plan's
parse and text, the corruption patterns and the guard's details equal
`repro.comm.faults`'.

Run: ``PYTHONPATH=src python -m pytest -q tests/test_torch_batcher.py``.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import faults as JF
from repro.configs.base import get_config as jget
from repro.models import model as Mo
from repro.serving import ContinuousBatcher as JBatcher
from repro.serving import DeltaHopCodec as JHop
from repro.serving import KVCodec as JKV
from repro.serving import quantize_caches as jquantize
from repro_torch.comm import faults as TF
from repro_torch.configs.base import get_config as tget
from repro_torch.kernels import quant_pack as TP
from repro_torch.launch import serve as tserve
from repro_torch.serving import ContinuousBatcher as TBatcher
from repro_torch.serving import DeltaHopCodec as THop
from repro_torch.serving import KVCodec as TKV
from repro_torch.weights import from_jax_params


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BITS = [2, 4, 8]
PORT_BACKENDS = ["auto", "cuda"]
DECODE_ATOL = 5e-3
MAX_FLIP_FRACTION = 0.005
STATE_RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def _models(arch, window=None):
    """(JAX cfg, JAX params, the port's model) from one JAX init."""
    jc, tc = jget(arch, smoke=True), tget(arch, smoke=True)
    if window:
        jc, tc = jc.with_(sliding_window=window), \
            tc.with_(sliding_window=window)
    params = Mo.init_params(jc, jax.random.PRNGKey(0))
    return jc, params, from_jax_params(jax.tree.map(np.asarray, params), tc)


def _prompts(vocab, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(n)).tolist() for n in lengths]


def _tserve(model, prompts, num_slots, max_new, **kw):
    bat = TBatcher(model, num_slots=num_slots, cache_len=16, **kw)
    for p in prompts:
        bat.submit(p, max_new_tokens=max_new)
    return bat.run()


# ---------------------------------------------------------------------------
# the reference's batcher tests (tests/test_serving.py), ported
# ---------------------------------------------------------------------------

def test_batcher_mixed_lengths_match_isolated_runs():
    """Mixed-length requests decoded together in a 2-slot pool (with
    eviction and re-admission) give the tokens each gives ALONE in a
    1-slot batcher."""
    jc, _, model = _models("gemma2-9b")
    prompts = _prompts(jc.vocab_size, (3, 6, 4, 6), 7)
    alone = [_tserve(model, [p], 1, 4)[0].tokens for p in prompts]
    mixed = [r.tokens for r in _tserve(model, prompts, 2, 4)]
    assert mixed == alone
    assert all(len(t) == 4 for t in mixed)


def test_batcher_quantized_and_staged():
    """The pooled step composes the 8-bit KV codec and the delta hop;
    every request still terminates with max_new tokens."""
    jc, _, model = _models("gemma2-9b")
    reqs = _tserve(model, _prompts(jc.vocab_size, (3, 5, 4), 9), 2, 3,
                   kv_codec=TKV(bits=8),
                   hop_codec=THop(mode="aqsgd", bits=8), num_stages=2)
    assert [r.state for r in reqs] == ["DONE"] * 3
    assert all(len(r.tokens) == 3 and not r.error for r in reqs)


def test_batcher_eos_eviction():
    """EOS frees the slot early: each request finishes after one token
    at max_new_tokens 1, and at an ``eos_id`` equal to its first token
    whatever max_new_tokens says."""
    _, _, model = _models("gemma2-9b")
    bat = TBatcher(model, num_slots=1, cache_len=16)
    r1 = bat.submit([1, 2, 3], max_new_tokens=1)
    r2 = bat.submit([4, 5], max_new_tokens=1)
    assert bat.run() == [r1, r2]
    assert r1.state == r2.state == "DONE"
    assert len(r1.tokens) == len(r2.tokens) == 1
    eos = _tserve(model, [[1, 2, 3]], 1, 1, eos_id=r1.tokens[0])[0]
    assert eos.tokens == r1.tokens
    long = _tserve(model, [[1, 2, 3]], 1, 4, eos_id=r1.tokens[0])[0]
    assert long.tokens == r1.tokens and long.state == "DONE"


# ---------------------------------------------------------------------------
# against the JAX batcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,window", [("gemma2-9b", 4),
                                         ("gpt2-xl-paper", None)])
def test_streams_match_jax_batcher(arch, window):
    """Raw f32 caches, one stage: five requests of 3-9 tokens over 2
    slots (the last runs beside an idle slot whose head passes the
    cache), token for token against the JAX batcher."""
    jc, params, model = _models(arch, window)
    prompts = _prompts(jc.vocab_size, (3, 9, 6, 5, 8), 3)
    jb = JBatcher(params, jc, num_slots=2, cache_len=16, dtype=jnp.float32)
    for p in prompts:
        jb.submit(p, max_new_tokens=5)
    want = [r.tokens for r in jb.run()]
    got = _tserve(model, prompts, 2, 5, dtype=torch.float32)
    assert [r.tokens for r in got] == want
    assert all(r.state == "DONE" and len(r.tokens) == 5 for r in got)


def _jax_pool_logits(jc, params, jkv, jhop, pool, tok):
    """The reference's pooled step (its `row_step` under `vmap`),
    returning each row's logits."""
    bfn = jhop.boundary_fn(prefill=False)

    def row(params, row, token):
        caches = {k: (v if k == "pos" else v[:, None])
                  for k, v in row.items()}
        logits, _ = Mo.forward_with_caches(
            params, jc, token[None, None], caches, logits_last_only=True,
            num_stages=2, boundary_fn=bfn, kv_codec=jkv)
        return logits[0, -1]

    axes = {k: (0 if k == "pos" else 1) for k in pool}
    return jax.jit(jax.vmap(row, in_axes=(None, axes, 0)))(params, pool,
                                                          tok)


@pytest.mark.parametrize("arch,window", [("gemma2-9b", 4),
                                         ("gpt2-xl-paper", None),
                                         ("deepseek-moe-16b", None)])
def test_pooled_step_matches_jax(arch, window):
    """One pooled step with the 8-bit KV cache and the 4-bit aqsgd hop
    over 2 stages, from one pool carried JAX -> port as numpy: three
    slots filled by the JAX batcher (prompts 3, 9 and 6, two ticks, so
    heads 5, 11 and 8), then slot 2 made idle with its head past the
    cache (19 of 16).  deepseek-moe-16b: the MoE layers dispatch a row
    at a time, the dense prefix's raw ``pk``/``pv`` (f32, the pool's
    raw dtype) are written at the per-row heads and held as the scales
    are."""
    jc, params, model = _models(arch, window)
    cache_len = 16
    jkv, jhop = JKV(bits=8), JHop(mode="aqsgd", bits=4)
    jb = JBatcher(params, jc, num_slots=3, cache_len=cache_len,
                  kv_codec=jkv, hop_codec=jhop, num_stages=2,
                  dtype=jnp.float32)
    for p in _prompts(jc.vocab_size, (3, 9, 6), 5):
        jb.submit(p, max_new_tokens=8)
    jb._admit()
    jb.step()
    jb.step()
    pool = {k: np.array(v) for k, v in jb.caches.items()}
    pool["pos"][2] = cache_len + 3
    assert list(pool["pos"]) == [5, 11, cache_len + 3]
    tok = np.asarray(jb._next_tok)
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    jtoks, jnew = jb._decode(params, jpool, jnp.asarray(tok))
    jlogits = np.asarray(_jax_pool_logits(jc, params, jkv, jhop, jpool,
                                          jnp.asarray(tok)))

    tc = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    logits, tc = model.forward_with_caches(
        torch.from_numpy(tok).long()[:, None], tc, logits_last_only=True,
        num_stages=2, boundary_fn=THop(mode="aqsgd", bits=4).boundary_fn(
            prefill=False), kv_codec=TKV(bits=8))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jnew["pos"]))
    np.testing.assert_allclose(logits[:, 0].numpy(), jlogits, rtol=0,
                               atol=DECODE_ATOL)
    margin = np.sort(jlogits, axis=-1)
    clear = margin[:, -1] - margin[:, -2] > DECODE_ATOL
    np.testing.assert_array_equal(
        logits[:, 0].argmax(-1).numpy()[clear], np.asarray(jtoks)[clear])
    flips = total = 0
    for name in ("k_codes", "v_codes"):
        diff = np.abs(tc[name].numpy().astype(np.int32)
                      - np.asarray(jnew[name]).astype(np.int32))
        assert diff.max() <= 1, name
        flips += int((diff > 0).sum())
        total += diff.size
    assert flips <= MAX_FLIP_FRACTION * total, (flips, total)
    for name in ("k_scale", "v_scale", "hop_m", "pk", "pv"):
        if name not in jnew:
            continue
        assert name in tc, name
        want = np.asarray(jnew[name])
        np.testing.assert_allclose(tc[name].numpy(), want, rtol=0,
                                   atol=STATE_RTOL * np.abs(want).max())


# ---------------------------------------------------------------------------
# B3's append at per-row write heads
# ---------------------------------------------------------------------------

def _sentinel_store(codec, shape, seed):
    empty = codec.empty(shape, device="cpu")
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, empty["codes"].shape, dtype=np.uint8)
    scale = (rng.random(empty["scale"].shape) + 0.5).astype(np.float32)
    return codes, scale


# a head at 0, in the middle, at cache - 1 and past the cache (cache 8)
HEADS = np.array([0, 3, 7, 11], np.int32)
SHAPE = (4, 8, 4, 64)


@functools.lru_cache(maxsize=None)
def _jax_row_append(bits, group_d, s, seed):
    """Stores, fresh rows, and JAX's `KVCodec.append` of k then v under
    `jax.vmap` over rows, each row at its own head."""
    b, cache, hk, hd = SHAPE
    jc = JKV(bits=bits, group_d=group_d, backend="reference")
    stores = [_sentinel_store(TKV(bits=bits, group_d=group_d), SHAPE,
                              seed + i) for i in range(2)]
    rng = np.random.default_rng(seed + 2)
    fresh = [(rng.standard_normal((b, s, hk, hd)) * 3).astype(np.float32)
             for _ in range(2)]

    def row(c, sc, v, p):
        out = jc.append({"codes": c[None], "scale": sc[None]}, v[None], p)
        return out["codes"][0], out["scale"][0]

    fn = jax.jit(jax.vmap(row))
    want = [tuple(np.asarray(a) for a in fn(c, sc, f, HEADS))
            for (c, sc), f in zip(stores, fresh)]
    return stores, fresh, want


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("group_d", [0, 32])
@pytest.mark.parametrize("bits", BITS)
def test_append_at_row_heads_matches_jax_vmap(bits, group_d, s, backend):
    """`KVCodec.append_pair` with a (B,) head tensor, through
    `encode_pair_into`'s plain chain ("auto") and `quantize_pack_into`'s
    plain version ("cuda" on CPU tensors), equals JAX's per-row append
    bit for bit; the head past the store clamps to cache - s, and every
    row outside each row's append keeps its sentinel bytes."""
    stores, fresh, want = _jax_row_append(bits, group_d, s, 40 + bits + s)
    codes = tuple(torch.from_numpy(c.copy()) for c, _ in stores)
    scales = tuple(torch.from_numpy(sc.copy()) for _, sc in stores)
    heads = torch.from_numpy(HEADS)
    TKV(bits=bits, group_d=group_d, backend=backend).append_pair(
        codes, scales, tuple(map(torch.from_numpy, fresh)), heads)
    assert torch.equal(heads, torch.from_numpy(HEADS))
    cache = SHAPE[1]
    for (c0, s0), c, sc, (wc, ws) in zip(stores, codes, scales, want):
        np.testing.assert_array_equal(c.numpy(), wc)
        np.testing.assert_array_equal(sc.numpy(), ws)
        for b, h in enumerate(HEADS):
            start = min(int(h), cache - s)
            keep = np.ones(cache, dtype=bool)
            keep[start:start + s] = False
            np.testing.assert_array_equal(c.numpy()[b, keep], c0[b, keep])
            np.testing.assert_array_equal(sc.numpy()[b, keep], s0[b, keep])
            assert not np.array_equal(c.numpy()[b, ~keep], c0[b, ~keep])


def test_append_heads_wrapper_checks():
    """The wrapper checks a head tensor's dtype, shape and device (it
    never reads it); an int head must still fit the store."""
    x = tuple(torch.zeros(2, 1, 4, 64) for _ in range(2))
    packed = tuple(torch.zeros(2, 8, 4, 64, dtype=torch.uint8)
                   for _ in range(2))
    scale = tuple(torch.zeros(2, 8, 4) for _ in range(2))
    for bad, match in ((torch.zeros(2, dtype=torch.int64), "int32"),
                       (torch.zeros(3, dtype=torch.int32), r"\(2,\)"),
                       (torch.zeros(2, 1, dtype=torch.int32), r"\(2,\)"),
                       (torch.zeros(2, dtype=torch.int32, device="meta"),
                        "meta")):
        with pytest.raises(ValueError, match=match):
            TP.quantize_pack_into(x, packed, scale, bad, bits=8)
    with pytest.raises(ValueError, match="do not fit"):
        TP.quantize_pack_into(x, packed, scale, 8, bits=8)
    TP.quantize_pack_into(x, packed, scale, torch.tensor([9, -3],
                                                          dtype=torch.int32),
                          bits=8)


def test_tensor_head_takes_one_token_a_row():
    """A per-row head is a decode step's: S > 1 raises."""
    _, _, model = _models("gpt2-xl-paper")
    caches = model.init_caches(2, 16, torch.float32)
    caches["pos"] = torch.tensor([0, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="one token a row"):
        model.forward_with_caches(torch.zeros(2, 3, dtype=torch.long),
                                  caches)


def test_quantize_caches_match_jax_layout():
    """The port's one cache constructor, `Transformer.init_caches` with a
    ``kv_codec``, lays the stores out as JAX's ``quantize_caches`` over
    its ``init_caches``; without a quantizing codec it is raw."""
    jc, _, model = _models("gemma2-9b")
    jq = jquantize(jc, Mo.init_caches(jc, 2, 16, jnp.float32),
                   JKV(bits=8, group_d=32))
    q = model.init_caches(2, 16, torch.float32,
                          kv_codec=TKV(bits=8, group_d=32))
    assert set(q) == set(jq)
    for name in jq:
        if name == "pos":
            assert q["pos"] == 0
            continue
        assert tuple(q[name].shape) == jq[name].shape, name
        assert str(q[name].dtype).split(".")[-1] == str(jq[name].dtype)
        assert not q[name].any()
    raw = model.init_caches(2, 16, torch.float32, kv_codec=TKV())
    jraw = Mo.init_caches(jc, 2, 16, jnp.float32)
    assert set(raw) == set(jraw)
    assert tuple(raw["k"].shape) == jraw["k"].shape


# ---------------------------------------------------------------------------
# the faults module (tests/test_faults.py's serving part, ported)
# ---------------------------------------------------------------------------

def test_slot_flags():
    pool = {"pos": torch.zeros(3, dtype=torch.int32),
            "k": torch.zeros(2, 3, 4, 8, dtype=torch.bfloat16),
            "codes": torch.zeros(2, 3, 4, dtype=torch.uint8)}
    assert not TF.slot_flags(pool).any()
    pool["k"][1, 2, 0, 0] = float("nan")
    assert list(TF.slot_flags(pool)) == [False, False, True]
    # against JAX on the same f32 pool: NaN, inf, above the bound
    arr = np.zeros((2, 4, 3, 8), np.float32)
    arr[0, 1, 0, 0], arr[1, 3, 2, 1] = np.inf, 2e30
    arr[1, 0, 1, 1] = 1e29                       # under the bound
    jpool = {"pos": np.zeros(4, np.int32), "k": arr,
             "hop_m": np.zeros((1, 4, 1, 8), np.float32)}
    tpool = {k: torch.from_numpy(v) for k, v in jpool.items()}
    np.testing.assert_array_equal(TF.slot_flags(tpool),
                                  JF.slot_flags(jpool))
    assert list(TF.slot_flags(tpool)) == [False, True, False, True]


PLANS = ["2:kv:nan-scale", "0:dp:drop-hop,3:fw:corrupt-codes", "",
         " 1:bw:nan-scale , ,4:zbuf:drop-hop", "5:kv:corrupt-codes"]
BAD_TOKENS = ["x:kv:nan-scale", "2:kv", "2:kv:nan-scale:1",
              "2:zz:nan-scale", "2:kv:drop-hop", "2:bw:drop-hop",
              "2:kv:bogus", "-1:kv:nan-scale"]


@pytest.mark.parametrize("text", PLANS)
def test_fault_plan_parse_and_text_match_jax(text):
    tp, jp = TF.FaultPlan.parse(text), JF.FaultPlan.parse(text)
    assert tp.text() == jp.text()
    assert TF.FaultPlan.parse(tp.text()) == tp
    assert bool(tp) == bool(jp)
    assert [(f.step, f.plane, f.kind) for f in tp.faults] == \
        [(f.step, f.plane, f.kind) for f in jp.faults]
    for step in range(6):
        assert [f.text() for f in tp.at(step)] == \
            [f.text() for f in jp.at(step)]
        assert [f.text() for f in tp.at(step, "kv")] == \
            [f.text() for f in jp.at(step, "kv")]


@pytest.mark.parametrize("text", BAD_TOKENS)
def test_fault_tokens_rejected_like_jax(text):
    with pytest.raises(ValueError) as jerr:
        JF.FaultPlan.parse(text)
    with pytest.raises(ValueError) as terr:
        TF.FaultPlan.parse(text)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kind", TF.FAULT_KINDS)
def test_corrupt_array_matches_jax(kind):
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    got = TF.corrupt_array(torch.from_numpy(x), kind)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JF.corrupt_array(x, kind)))
    ints = torch.arange(6, dtype=torch.int32)
    assert TF.corrupt_array(ints, kind) is ints
    assert TF.corrupt_array(torch.zeros(4, dtype=torch.bfloat16),
                            kind).dtype == torch.bfloat16


def test_arr_detail_matches_jax():
    cases = [np.ones((2, 3), np.float32), np.array([1.0, np.nan], np.float32),
             np.array([1.0, -np.inf], np.float32),
             np.array([1.0, 2e30], np.float32),
             np.array([1.0, 1e30], np.float32), np.zeros(0, np.float32),
             np.array([1, 2], np.int32)]
    for a in cases:
        assert TF._arr_detail(torch.from_numpy(a)) == JF._arr_detail(a)
    assert TF._arr_detail(7) is None


def test_batcher_evicts_poisoned_slot_survivors_identical():
    """``2:kv:nan-scale`` poisons the lowest active slot at tick 2: its
    request is evicted with the fault text, cut short, and every other
    request's stream equals the clean run's."""
    jc, _, model = _models("gemma2-9b")
    prompts = _prompts(jc.vocab_size, (3, 5, 4), 11)

    def serve(plan):
        return _tserve(model, prompts, 2, 6, fault_plan=plan)

    base = serve(None)
    assert all(r.state == "DONE" and not r.error for r in base)
    hit = serve(TF.FaultPlan.parse("2:kv:nan-scale"))
    victim, survivors = hit[0], hit[1:]
    assert victim.state == "DONE"
    assert victim.error.startswith("wire fault detected: plane=kv "
                                   "wire='paged' tick=2:")
    assert len(victim.tokens) < 6
    for b, h in zip(base[1:], survivors):
        assert not h.error
        assert h.tokens == b.tokens


def test_batcher_admission_guard_rejects_poisoned_prefill():
    _, _, model = _models("gemma2-9b")
    poisoned = copy.deepcopy(model)
    with torch.no_grad():
        for p in poisoned.parameters():
            p.copy_(TF.corrupt_array(p, "nan-scale"))
    bat = TBatcher(poisoned, num_slots=1, cache_len=16, guard=True)
    req = bat.submit([1, 2, 3], max_new_tokens=4)
    bat.run(max_ticks=4)
    assert req.state == "DONE"
    assert req.error == ("wire fault detected: plane=kv wire='paged' "
                         "tick=0: corrupt prefill payload")
    assert bat._slots == [None]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gpt2-xl-paper", "gemma2-9b",
                                  "deepseek-moe-16b"])
def test_serve_continuous_launcher(arch):
    out = tserve.main(["--device", "cpu", "--smoke", "--arch", arch,
                       "--stages", "2", "--mode", "aqsgd", "--fw-bits", "4",
                       "--kv-bits", "8", "--continuous", "--slots", "2",
                       "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    reqs = out["requests"]
    # the JAX launcher's draw of the stream
    rng = np.random.default_rng(1)
    vocab = tget(arch, smoke=True).vocab_size
    want = []
    for _ in range(4):
        n = int(rng.integers(4, 9))
        want.append(rng.integers(0, vocab, n).tolist())
    assert [r.prompt for r in reqs] == want
    assert all(r.state == "DONE" and len(r.tokens) == 3 for r in reqs)
    assert out["num_slots"] == 2 and out["admissions"] == 4
    assert out["tokens"] == 12 and out["decode_tokens"] == 8
    assert out["cache_len"] == 11 and out["ticks"] >= 4
    assert out["prefill_s"] > 0 and out["decode_s"] > 0


def test_serve_list_wires(capsys):
    assert tserve.main(["--list-wires"]) is None
    out = capsys.readouterr().out
    assert out.splitlines()[0].split() == ["plane", "wire", "summary"]
    assert [tuple(line.split()[:2]) for line in out.splitlines()[1:]] == [
        ("fw-activation", "ppermute"), ("bw-gradient", "ppermute"),
        ("z-buffer", "hbm"), ("kv-cache", "paged"), ("dp-grad", "ring"),
        ("dp-grad", "psum"), ("dp-grad", "ring-sharded"),
        ("dp-grad", "fp16")]


@pytest.mark.parametrize("flag", ["--data-par", "--model-par"])
def test_serve_refuses_mesh_flags(flag, capsys):
    with pytest.raises(SystemExit):
        tserve.main([flag, "2", "--device", "cpu", "--smoke"])
    err = capsys.readouterr().err
    assert f"{flag}: sharded serving" in err
    assert "The rest of the distributed work" in err
