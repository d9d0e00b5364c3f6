"""The port's serving slice end to end, against the JAX package.

Each arch-bound test runs for every served arch, ``gpt2-xl-paper``,
``gemma2-9b`` and ``gemma2-27b`` (sliding windows on alternate layers,
GQA, attention and final softcaps, gated GeLU) and ``stablelm-12b``
(GQA, gated SiLU, an untied output head).  Both packages hold the same
SMOKE weights (moved with `repro_torch.weights.from_jax_params`),
prefill the same prompt (for gemma2 one of 40 tokens, past SMOKE's
window of 16, so the window masks keys in prefill and decode) and then
decode
TEACHER-FORCED: each step both get the same token ids, so a thin
argmax margin cannot fork the two streams.  The slice is the one the
chip run drives: a 2-stage delta-coded hop (aqsgd, 4 bits) and an
8-bit KV cache.  JAX is jitted, as its serving loop is.  On the CPU
the port's prefill attention is the plain version of its kernel.

Tolerances.  Prefill logits are computed from identical weights in f32
by different kernels (XLA's and PyTorch's matmuls, a blockwise vs a
one-shot softmax): they agree to ~1e-6 of logits of magnitude ~1, and
the test allows 2e-5.  The quantized state can then diverge: inputs
that differ by an ulp put a value on the other side of a rounding
boundary now and then, and one code flips.  An 8-bit KV flip moves one
k or v element by 2/255 of its row's absmax; a 4-bit hop flip moves one
hidden element by 2/15 of the delta's absmax.  Each flip is counted:
every differing KV code must differ by exactly one step, and at most
0.5% of the codes may differ (this seed: gpt2-xl-paper 0.16%,
gemma2-9b none).  Decode logits, which carry those flips, must agree
within 5e-3 (this seed: gpt2-xl-paper 4.4e-4, gemma2-9b 2.2e-6).
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.models import model as Mo
from repro.serving import DeltaHopCodec as JHop
from repro.serving import KVCodec as JKV
from repro.serving import quantize_caches as jquantize
from repro_torch.configs.base import get_config as tget
from repro_torch.launch import serve as tserve
from repro_torch.serving import DeltaHopCodec as THop
from repro_torch.serving import KVCodec as TKV
from repro_torch.weights import from_jax_params


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = pathlib.Path(__file__).resolve().parent.parent
ARCHS = ("gpt2-xl-paper", "gemma2-9b", "stablelm-12b", "gemma2-27b")
B, STEPS = 2, 6
PROMPT = {"gpt2-xl-paper": 8, "gemma2-9b": 40, "stablelm-12b": 8,
          "gemma2-27b": 40}
PREFILL_ATOL = 2e-5
DECODE_ATOL = 5e-3
MAX_FLIP_FRACTION = 0.005


@pytest.fixture(scope="module", params=ARCHS)
def shared(request):
    arch = request.param
    cfg = jget(arch, smoke=True)
    params = Mo.init_params(cfg, jax.random.PRNGKey(0))
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            tget(arch, smoke=True))
    return cfg, params, model


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_jax(arch):
    for smoke in (False, True):
        jc, tc = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
        for f in ("name", "family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "head_dim", "d_ff", "vocab_size",
                  "rope_theta", "sliding_window", "local_global_period",
                  "attn_softcap", "final_softcap", "act", "mlp_gated",
                  "norm_eps", "tie_embeddings", "dtype"):
            assert getattr(tc, f) == getattr(jc, f), f
        assert tc.torch_dtype == torch.float32
        for i in range(jc.num_layers):
            assert tc.layer_window(i, 8192) == jc.layer_window(i, 8192)
    with pytest.raises(KeyError):
        tget("no-such-arch")                  # not a config of either


def test_from_jax_params_unstacks_every_leaf(shared):
    cfg, params, model = shared
    sd = model.state_dict()
    per_layer = 9 if cfg.mlp_gated else 8     # + ffn.w_gate
    top = 2 if cfg.tie_embeddings else 3      # embed, final_norm (+ head)
    assert len(sd) == top + cfg.num_layers * per_layer
    assert set(params["layers"]["ffn"]) == \
        ({"w_gate"} if cfg.mlp_gated else set()) | {"w_up", "w_down"}
    for i in range(cfg.num_layers):
        np.testing.assert_array_equal(
            sd[f"layers.{i}.attn.wq"].numpy(),
            np.asarray(params["layers"]["attn"]["wq"][i]))
        np.testing.assert_array_equal(
            sd[f"layers.{i}.ffn.w_down"].numpy(),
            np.asarray(params["layers"]["ffn"]["w_down"][i]))
        kd = cfg.num_kv_heads * cfg.head_dim
        for name in ("wk", "wv"):                # GQA: (d, Hk * hd)
            assert sd[f"layers.{i}.attn.{name}"].shape == (cfg.d_model, kd)
            np.testing.assert_array_equal(
                sd[f"layers.{i}.attn.{name}"].numpy(),
                np.asarray(params["layers"]["attn"][name][i]))
        if cfg.mlp_gated:
            np.testing.assert_array_equal(
                sd[f"layers.{i}.ffn.w_gate"].numpy(),
                np.asarray(params["layers"]["ffn"]["w_gate"][i]))
    np.testing.assert_array_equal(sd["embed"].numpy(),
                                  np.asarray(params["embed"]))
    if not cfg.tie_embeddings:
        np.testing.assert_array_equal(sd["head"].numpy(),
                                      np.asarray(params["head"]))


def _jax_step(cfg, codec, hop, prefill):
    bfn = hop.boundary_fn(prefill=prefill)
    return jax.jit(lambda p, c, t: Mo.forward_with_caches(
        p, cfg, t, c, logits_last_only=True, num_stages=2,
        boundary_fn=bfn, kv_codec=codec))


def test_slice_matches_jax_teacher_forced(shared):
    cfg, params, model = shared
    prompt = PROMPT[cfg.name]
    cache_len = prompt + STEPS
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, prompt + STEPS)).astype(np.int32)

    jkv, jhop = JKV(bits=8), JHop(mode="aqsgd", bits=4)
    jc = jquantize(cfg, Mo.init_caches(cfg, B, cache_len, jnp.float32), jkv)
    jc["hop_m"] = jhop.init_state(1, B, cfg.d_model)["m"]
    tkv, thop = TKV(bits=8), THop(mode="aqsgd", bits=4)
    tc = model.init_caches(B, cache_len, torch.float32, kv_codec=tkv)
    tc["hop_m"] = thop.init_state(1, B, cfg.d_model)["m"]

    jl, jc = _jax_step(cfg, jkv, jhop, True)(params, jc, toks[:, :prompt])
    tl, tc = model.forward_with_caches(
        torch.from_numpy(toks[:, :prompt]).long(), tc, logits_last_only=True,
        num_stages=2, boundary_fn=thop.boundary_fn(prefill=True),
        kv_codec=tkv)
    assert tl.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=PREFILL_ATOL)
    np.testing.assert_allclose(tc["hop_m"].numpy(), np.asarray(jc["hop_m"]),
                               rtol=0, atol=PREFILL_ATOL)

    decode = _jax_step(cfg, jkv, jhop, False)
    for i in range(STEPS):
        t = toks[:, prompt + i:prompt + i + 1]
        jl, jc = decode(params, jc, t)
        tl, tc = model.forward_with_caches(
            torch.from_numpy(t).long(), tc, logits_last_only=True,
            num_stages=2, boundary_fn=thop.boundary_fn(prefill=False),
            kv_codec=tkv)
        assert torch.isfinite(tl).all()
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=DECODE_ATOL)
    assert tc["pos"] == int(jc["pos"]) == cache_len

    flips = total = 0
    for name in ("k_codes", "v_codes"):
        jcodes = np.asarray(jc[name]).astype(np.int32)
        tcodes = tc[name].numpy().astype(np.int32)
        diff = np.abs(jcodes - tcodes)
        assert diff.max() <= 1, name          # a flip, never a wrong code
        flips += int((diff > 0).sum())
        total += diff.size
    assert flips <= MAX_FLIP_FRACTION * total, (flips, total)


def test_fp32_hop_staging_is_exact(shared):
    """num_stages 2 with the fp32 pass-through hop is the identical
    computation to one stage: the stage cut adds no numerics."""
    cfg, _, model = shared
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, 6)))
    hop = THop(mode="fp32")

    def run(num_stages, prefill_fn, decode_fn):
        c = model.init_caches(B, 8, torch.float32)
        c["hop_m"] = hop.init_state(num_stages - 1, B, cfg.d_model)["m"]
        pl, c = model.forward_with_caches(toks, c, logits_last_only=True,
                                          num_stages=num_stages,
                                          boundary_fn=prefill_fn)
        dl, c = model.forward_with_caches(toks[:, :1], c,
                                          logits_last_only=True,
                                          num_stages=num_stages,
                                          boundary_fn=decode_fn)
        return pl, dl

    base = run(1, None, None)
    staged = run(2, hop.boundary_fn(prefill=True),
                 hop.boundary_fn(prefill=False))
    for x, y in zip(base, staged):
        assert torch.equal(x, y)


@pytest.mark.parametrize("arch,prompt,kv_per_token", [
    ("gpt2-xl-paper", 6, 1088), ("gemma2-9b", 20, 544),
    ("stablelm-12b", 6, 544), ("gemma2-27b", 20, 544)])
def test_serve_entry_point_on_cpu(capsys, arch, prompt, kv_per_token):
    """The launcher on the CPU (gemma2: a prompt past SMOKE's window);
    the bytes it prints and the stores it fills are the JAX models'."""
    out = tserve.main(["--arch", arch, "--smoke", "--stages", "2", "--mode",
                       "aqsgd", "--fw-bits", "4", "--kv-bits", "8",
                       "--batch", "2", "--prompt-len", str(prompt), "--gen",
                       "3", "--device", "cpu"])
    cfg = jget(arch, smoke=True)
    assert out["tokens"].shape == (2, 3)
    assert out["logits"].shape == (2, 1, cfg.vocab_size)
    assert torch.isfinite(out["logits"]).all()
    text = capsys.readouterr().out
    hop = JHop(mode="aqsgd", bits=4).hop_bytes(2, cfg.d_model)
    kv = JKV(bits=8).stored_bytes((1, 1, cfg.num_kv_heads, cfg.head_dim)) \
        * 2 * cfg.num_layers
    assert hop == 264 and kv == kv_per_token
    assert f"decode hop [aqsgd]: {hop} B/token/boundary" in text
    assert f"kv cache: {kv} B/token stored" in text
    assert out["kv_store_bytes"] == kv * out["cache_len"] * 2   # batch 2


def test_entry_point_without_a_card_raises(monkeypatch):
    """With no device requested the entry point runs on CUDA; with no
    card it raises instead of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--smoke", "--gen", "1"])


def _imported_roots(path: pathlib.Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "repro"}
        assert not bad, (f.relative_to(ROOT), bad)
