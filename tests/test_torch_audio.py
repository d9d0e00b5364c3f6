"""The audio family (``whisper-small``) through the port's model,
serving and simulated trainer, against the JAX package at SMOKE shapes
(one torch thread; the distributed trainer is
tests/test_torch_media_dist.py's).  The arch-bound tests take the
``media`` fixture; tests/test_torch_vlm.py imports them and gives them
``pixtral-12b``.

* B10's plain version and the training attention in the calls the
  encoder and cross attention make: non-causal over a call's own keys,
  cross keys of another length (Sq > Sk and Sq < Sk, keys past a
  multiple of the backward's key block), forward and lse against JAX's
  ``flash_attention`` and ``_make_flash(...).fwd`` (1e-5), dq/dk/dv
  against ``jax.vjp`` of its ``custom_vjp`` (rtol 1e-4, atol 1e-5); the
  wrapper still raises where a row could see no key;
* the weights' round trip and ``jax.tree.leaves`` order with the new
  leaves (``enc_layers`` stacked, ``enc_norm``, ``xattn``, ``norm_x``);
* `encode_audio` against JAX's (1e-5);
* logits of the training forward and ``loss_fn`` with every gradient
  against ``jax.value_and_grad`` on tests/test_smoke_archs.py's shapes
  (B 2, S 32: whisper's 32 text rows over 32 frames, pixtral's 16
  patches and 16 text rows), at 1 and 2 stage groups, remat off and on
  (the loss rtol 1e-5, gradients rtol 1e-3 and atol 1e-4 of each one's
  largest, tests/test_torch_train_attention.py's);
* serving: greedy streams token for token with raw f32 caches, and
  teacher-forced with the 8-bit KV cache and the 4-bit aqsgd hop at 2
  stage groups (tests/test_torch_slice.py's tolerances and flip count);
  the cross caches raw and equal to JAX's within the prefill tolerance;
* the simulated trainer's loss stream (aqsgd fw 4 / bw 8 and 4-bit DP
  over 2 workers, deterministic) against JAX's ``train_step`` fed the
  same numpy frames or patches (tests/test_torch_train.py's
  tolerances);
* the launchers on the CPU: serving with the hop's, KV's and cross
  caches' bytes; the training launcher's refusals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.config import CommConfig as JComm
from repro.comm.config import PlaneConfig as JPlane
from repro.models import layers as JL
from repro.models import model as Mo
from repro.optim import adamw as JO
from repro.serving import DeltaHopCodec as JHop
from repro.serving import KVCodec as JKV
from repro.serving import quantize_caches as jquantize
from repro.training import simulated as JS
from repro_torch.comm.config import CommConfig as TComm
from repro_torch.comm.config import PlaneConfig as TPlane
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TO
from repro_torch.serving import DeltaHopCodec as THop
from repro_torch.serving import KVCodec as TKV
from repro_torch.training import simulated as TS
from repro_torch.weights import (from_jax_params, jax_leaf_names,
                                 jax_leaves, load_jax_params, to_jax_params)
from test_torch_slice import MAX_FLIP_FRACTION
from test_torch_ssm import DECODE_ATOL, PREFILL_ATOL, arch_params
from test_torch_train_attention import (GRAD_ATOL, GRAD_RTOL, LATER_STEP_RTOL,
                                        LOSS_RTOL, _comm)

ARCH = "whisper-small"
B, S = 2, 32                       # tests/test_smoke_archs.py's shapes
OUT_TOL = 1e-5
ATTN_GRAD_RTOL, ATTN_GRAD_ATOL = 1e-4, 1e-5
BIG = TL.BIG_WINDOW


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def media_inputs(cfg, b, seed):
    """An audio model's frames (b, encoder_seq, d) or a vlm model's
    patches (b, num_patches, d), float32 from a numpy seed."""
    rng = np.random.default_rng(seed)
    name, n = ("frames", cfg.encoder_seq) if cfg.family == "audio" \
        else ("patches", cfg.num_patches)
    return {name: (rng.standard_normal((b, n, cfg.d_model)) * 0.5).astype(
        np.float32)}


def text_len(cfg):
    """The text rows of tests/test_smoke_archs.py's S: the rest after a
    vlm model's patches."""
    return S - cfg.num_patches


def _t(x):
    return torch.tensor(np.asarray(x))


def _tbatch(batch):
    return {k: _t(v).long() if np.asarray(v).dtype.kind == "i" else _t(v)
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def media():
    return arch_params(ARCH, {})


# ---------------------------------------------------------------------------
# B10 in the encoder's and the cross attention's calls
# ---------------------------------------------------------------------------

# (B, Sq, Sk, H, hd, block_k, q scale): Sk == Sq the encoder's
# self-attention, Sk != Sq cross attention
NONCAUSAL_CASES = [
    (2, 37, 37, 4, 16, 16, 1.0),     # encoder, ragged S, padded key block
    (2, 40, 32, 4, 64, 16, 4.0),     # cross, Sq > Sk (whisper SMOKE)
    (1, 20, 45, 2, 64, 16, 1.0),     # cross, Sq < Sk, Sk ragged
    (1, 9, 150, 2, 32, 64, 8.0),     # cross, Sk past 2 blocks of 64
]


@pytest.mark.parametrize("case", NONCAUSAL_CASES,
                         ids=lambda c: "-".join(map(str, c[:3])))
def test_noncausal_attention_matches_jax(case):
    """The training attention (the plain version on the CPU) at
    ``causal=False``, window `BIG_WINDOW`, keys at positions 0 as JAX's
    cross attention sets them: o, the lse and the gradients."""
    b, sq, sk, h, hd, bk, qs = case
    rng = np.random.default_rng(sum(case[:6]))
    q = (rng.standard_normal((b, sq, h, hd)) * qs).astype(np.float32)
    k, v = (rng.standard_normal((b, sk, h, hd)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    qpos = jnp.broadcast_to(jnp.arange(sq, dtype=jnp.int32), (b, sq))
    kpos = jnp.zeros((b, sk), jnp.int32) if sq != sk else qpos
    flash = JL._make_flash(False, 0.0, bk)

    def jfn(q, k, v):
        return JL.flash_attention(q, k, v, q_pos=qpos, k_pos=kpos,
                                  window=BIG, causal=False, block_k=bk)

    @jax.jit
    def jax_side(q, k, v, g):
        o, vjp = jax.vjp(jfn, q, k, v)
        _, res = flash.fwd(q, k, v, qpos, kpos, jnp.asarray(BIG, jnp.int32))
        return o, res[-1], vjp(g)

    jo, jlse, jgrads = jax_side(q, k, v, g)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    to = TL.flash_attention(tq, tk, tv, window=BIG, block_k=bk,
                            causal=False)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), _t(g))
    _, tlse = tops.flash_attention(
        *(t.detach().transpose(1, 2) for t in (tq, tk, tv)), causal=False,
        window=BIG, return_lse=True)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse),
                               rtol=OUT_TOL, atol=OUT_TOL)
    for name, tg, jg in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg),
                                   rtol=ATTN_GRAD_RTOL, atol=ATTN_GRAD_ATOL,
                                   err_msg=f"d{name}")


def test_wrapper_takes_rows_past_the_keys_only_where_all_keys_show():
    """q_offset + Sq > Sk is taken where every row sees every key (no
    causal mask, a window past the last row's position) and raised
    wherever a row could see none, by the wrapper and the plain
    version alike."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 2, 12, 16)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 5, 16)).astype(
        np.float32)) for _ in range(2))
    for fn in (TFA.flash_attention_fwd, TFA.ref.flash_attention_ref):
        out = fn(q, k, v, causal=False, window=BIG)
        assert out.shape == q.shape and torch.isfinite(out).all()
        out2 = fn(q, k, v, causal=False, window=BIG, q_offset=7)
        assert torch.equal(out, out2)
        for kw in (dict(causal=True), dict(causal=False, window=11),
                   dict(causal=False, window=0)):
            with pytest.raises(ValueError):
                fn(q, k, v, **kw)
    # rows within the keys keep the old rule: a small window is taken
    fn = TFA.flash_attention_fwd
    assert fn(q[:, :, :5], k, v, causal=False, window=2).shape == \
        (1, 2, 5, 16)


# ---------------------------------------------------------------------------
# arch-bound tests (tests/test_torch_vlm.py runs them on pixtral-12b)
# ---------------------------------------------------------------------------

def _jax_grad(name, grads):
    """The JAX gradient leaf of a port parameter name (``layers.<i>`` and
    ``enc_layers.<i>`` index their stacked leaves)."""
    parts = name.split(".")
    if parts[0] in ("layers", "enc_layers"):
        node = grads[parts[0]]
        for p in parts[2:]:
            node = node[p]
        return np.asarray(node)[int(parts[1])]
    node = grads
    for p in parts:
        node = node[p]
    return np.asarray(node)


def test_weights_round_trip_and_leaf_order(media):
    jcfg, tcfg, params, np_params = media
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
    audio = tcfg.family == "audio"
    for key in ("enc_layers.attn.wq", "enc_norm.scale", "layers.xattn.wk",
                "layers.norm_x.scale"):
        assert (key in keys) == audio, key
    assert ("head" in keys) == (not tcfg.tie_embeddings)


def test_training_logits_and_loss_match_jax(media):
    """The training forward's logits (B, S_text, V) and ``loss_fn``."""
    jcfg, tcfg, params, np_params = media
    rng = np.random.default_rng(5)
    n = text_len(jcfg)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, n)).astype(
        np.int32), **media_inputs(jcfg, B, 6)}
    h = Mo.embed_tokens(params, jcfg, batch["tokens"], batch.get("patches"))
    pos = jnp.broadcast_to(jnp.arange(h.shape[1], dtype=jnp.int32),
                           h.shape[:2])
    pr = dict(params)
    if jcfg.family == "audio":
        pr["_enc_out"] = Mo._cross_kv_all(
            pr, jcfg, Mo.encode_audio(pr, jcfg, batch["frames"]))
    jh, _, _ = Mo.trunk_forward(pr, jcfg, h, pos)
    want = Mo.lm_logits(params, jcfg, jh[:, h.shape[1] - n:])
    model = from_jax_params(np_params, tcfg)
    tb = _tbatch(batch)
    th = model.embed_tokens(tb["tokens"], tb.get("patches"))
    tpos = torch.arange(th.shape[1], dtype=torch.int32).expand(
        th.shape[:2])
    enc = model.encode_audio(tb["frames"]) if "frames" in tb else None
    with torch.no_grad():
        got = model.lm_logits(model.trunk_forward(th, tpos, enc=enc)[0][
            :, th.shape[1] - n:])
    assert got.shape == (B, n, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=PREFILL_ATOL)


@pytest.mark.parametrize("num_stages,remat", [(1, False), (2, True)])
def test_loss_and_grads_match_jax(media, num_stages, remat):
    jcfg, tcfg, params, np_params = media
    rng = np.random.default_rng(7)
    n = text_len(jcfg)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, n)),
             "targets": rng.integers(0, jcfg.vocab_size, (B, n)),
             "mask": (rng.random((B, n)) < 0.9).astype(np.float32),
             **media_inputs(jcfg, B, 8)}
    batch["tokens"], batch["targets"] = (batch[k].astype(np.int32)
                                         for k in ("tokens", "targets"))
    (want, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: Mo.loss_fn(p, jcfg, batch, num_stages=num_stages,
                             remat=remat, block_k=16), has_aux=True))(params)
    model = from_jax_params(np_params, tcfg)
    got, met = TM.loss_fn(model, _tbatch(batch), num_stages=num_stages,
                          remat=remat, block_k=16)
    assert abs(got.item() - float(want)) <= LOSS_RTOL * abs(float(want))
    assert met["aux"] == 0.0
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(got, [model.get_parameter(n)
                                      for n in names])
    for name, g in zip(names, grads):
        ref = _jax_grad(name, jgrads)
        scale = float(np.abs(ref).max()) or 1.0
        np.testing.assert_allclose(g.numpy(), ref, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=name)


def test_encoder_matches_jax(media):
    """whisper's `encode_audio` (the vlm model has no encoder: none is
    built)."""
    jcfg, tcfg, params, np_params = media
    model = from_jax_params(np_params, tcfg)
    if jcfg.family != "audio":
        assert len(model.enc_layers) == 0 and model.enc_norm is None
        return
    frames = media_inputs(jcfg, B, 9)["frames"]
    want = Mo.encode_audio(params, jcfg, frames, block_k=16)
    with torch.no_grad():
        got = model.encode_audio(_t(frames), block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OUT_TOL,
                               atol=OUT_TOL)


PROMPT, STEPS = 12, 6


def _serving_pair(media, kv_bits, hop_mode):
    """Both packages' caches and step functions for a prompt of PROMPT
    tokens and STEPS decode steps at 2 stage groups."""
    jcfg, tcfg, params, np_params = media
    model = from_jax_params(np_params, tcfg)
    n = PROMPT + STEPS + jcfg.num_patches
    jkv, tkv = JKV(bits=kv_bits), TKV(bits=kv_bits)
    jhop = JHop(mode=hop_mode, bits=4)
    thop = THop(mode=hop_mode, bits=4)
    jc = jquantize(jcfg, Mo.init_caches(jcfg, B, n, jnp.float32), jkv)
    jc["hop_m"] = jhop.init_state(1, B, jcfg.d_model)["m"]
    tc = model.init_caches(B, n, torch.float32, kv_codec=tkv)
    tc["hop_m"] = thop.init_state(1, B, tcfg.d_model)["m"]
    kv = jkv if kv_bits else None
    jsteps = {pre: jax.jit(lambda c, t, x, pre=pre: Mo.forward_with_caches(
        params, jcfg, t, c, num_stages=2, kv_codec=kv, logits_last_only=True,
        boundary_fn=jhop.boundary_fn(prefill=pre), **x))
        for pre in (True, False)}

    def tstep(c, t, x, pre):
        return model.forward_with_caches(
            t, c, num_stages=2, kv_codec=tkv if kv_bits else None,
            logits_last_only=True,
            boundary_fn=thop.boundary_fn(prefill=pre),
            **{k: _t(v) for k, v in x.items()})
    return model, jc, tc, jsteps, tstep


def test_greedy_stream_raw_caches_matches_jax(media):
    """Raw f32 caches and the fp32 hop: the same greedy tokens as JAX's
    at every step, the prefill's logits within its tolerance, and an
    audio model's cross caches (raw, written at the prefill) JAX's."""
    jcfg = media[0]
    model, jc, tc, jsteps, tstep = _serving_pair(media, 0, "fp32")
    extra = media_inputs(jcfg, B, 10)
    jt = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    tt = _t(jt).long()
    jtoks, ttoks = [], []
    for i in range(STEPS):
        x = extra if i == 0 else {}
        jl, jc = jsteps[i == 0](jc, jt, x)
        tl, tc = tstep(tc, tt, x, i == 0)
        assert tl.shape == (B, 1, jcfg.vocab_size)
        if i == 0:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                       atol=PREFILL_ATOL)
        jt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        tt = torch.argmax(tl[:, -1], -1)[:, None]
        jtoks.append(jt[:, 0].tolist())
        ttoks.append(tt[:, 0].tolist())
    assert ttoks == jtoks
    assert tc["pos"] == int(jc["pos"]) == PROMPT + STEPS - 1 \
        + jcfg.num_patches
    if jcfg.family == "audio":
        for name in ("xk", "xv"):
            assert tc[name].dtype == torch.float32
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), rtol=0,
                                       atol=PREFILL_ATOL)
    else:
        assert "xk" not in tc


def test_teacher_forced_kv8_hop_matches_jax(media):
    """8-bit KV on the decoder's self-attention and the 4-bit aqsgd hop,
    teacher-forced: prefill logits within 2e-5, decode logits within
    5e-3, every differing KV code one step away and at most 0.5% of
    them (tests/test_torch_slice.py's contract)."""
    jcfg = media[0]
    model, jc, tc, jsteps, tstep = _serving_pair(media, 8, "aqsgd")
    assert "k_codes" in tc and "k" not in tc
    assert ("xk" in tc) == (jcfg.family == "audio")
    toks = np.random.default_rng(12).integers(
        0, jcfg.vocab_size, (B, PROMPT + STEPS)).astype(np.int32)
    extra = media_inputs(jcfg, B, 13)
    jl, jc = jsteps[True](jc, toks[:, :PROMPT], extra)
    tl, tc = tstep(tc, _t(toks[:, :PROMPT]).long(), extra, True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=PREFILL_ATOL)
    for i in range(PROMPT, PROMPT + STEPS - 1):
        t = toks[:, i:i + 1]
        jl, jc = jsteps[False](jc, t, {})
        tl, tc = tstep(tc, _t(t).long(), {}, False)
        assert torch.isfinite(tl).all()
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=DECODE_ATOL)
    flips = total = 0
    for name in ("k_codes", "v_codes"):
        diff = np.abs(np.asarray(jc[name]).astype(np.int32)
                      - tc[name].numpy().astype(np.int32))
        assert diff.max() <= 1, name
        flips += int((diff > 0).sum())
        total += diff.size
    assert flips <= MAX_FLIP_FRACTION * total, (flips, total)


def test_simulated_trainer_stream_matches_jax(media):
    """3 steps of the simulated trainer at 2 stage groups, aqsgd fw 4 /
    bw 8 and the 4-bit ring over 2 workers, deterministic, on batches
    that carry frames or patches (the buffers span the trunk), against
    JAX's ``train_step`` fed the same numpy batches."""
    jcfg, tcfg, params, np_params = media
    steps, samples, n = 3, 8, text_len(jcfg)
    trunk = n + jcfg.num_patches
    jt = JS.SimTrainConfig(num_stages=2, comm=_comm(JComm, JPlane, "aqsgd"),
                           dp_workers=2,
                           optimizer=JO.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                    total_steps=steps))
    tt = TS.SimTrainConfig(num_stages=2, comm=_comm(TComm, TPlane, "aqsgd"),
                           dp_workers=2,
                           optimizer=TO.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                    total_steps=steps))
    rng = np.random.default_rng(14)
    batches = []
    for i in range(steps):
        ids = np.array([0, 1, 2, 3]) if i != 1 else np.array([4, 5, 0, 1])
        batches.append({
            "tokens": rng.integers(0, jcfg.vocab_size, (4, n)).astype(
                np.int32),
            "targets": rng.integers(0, jcfg.vocab_size, (4, n)).astype(
                np.int32),
            "mask": np.ones((4, n), np.float32),
            "sample_ids": ids.astype(np.int32), **media_inputs(jcfg, 4, i)})
    jstate = JS.init_train_state(jcfg, jt, samples, trunk,
                                 jax.random.PRNGKey(0))
    jstate["params"] = params
    tstate = TS.init_train_state(tcfg, tt, samples, trunk, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
    load_jax_params(tstate["model"], np_params)
    gen = torch.Generator().manual_seed(1)
    jl, tl = [], []
    for i, b in enumerate(batches):
        jstate, jm = JS.train_step(jstate, {k: jnp.asarray(v) for k, v in
                                            b.items()},
                                   jax.random.PRNGKey(i), mcfg=jcfg,
                                   tcfg=jt)
        tstate, tm = TS.train_step(tstate, TS.device_batch(b, "cpu"), gen,
                                   mcfg=tcfg, tcfg=tt)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl[0], jl[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tl[1:], jl[1:], rtol=LATER_STEP_RTOL)
    assert tstate["buffers"]["m"].shape == (1, samples, trunk,
                                            tcfg.d_model)


def test_serve_entry_point_on_cpu(media, capsys):
    """The launcher at SMOKE size on the CPU: 8-bit KV, the 4-bit hop;
    the bytes it prints and the stores it fills are the JAX models'; a
    vlm cache holds the patches' rows too, an audio model's cross
    caches their own count; ``--continuous`` serves either family."""
    jcfg = media[0]
    out = tserve.main(["--arch", jcfg.name, "--smoke", "--stages", "2",
                       "--mode", "aqsgd", "--fw-bits", "4", "--kv-bits", "8",
                       "--batch", "2", "--prompt-len", "6", "--gen", "3",
                       "--device", "cpu"])
    assert out["tokens"].shape == (2, 3)
    assert torch.isfinite(out["logits"]).all()
    text = capsys.readouterr().out
    kv = JKV(bits=8).stored_bytes((1, 1, jcfg.num_kv_heads, jcfg.head_dim)) \
        * 2 * jcfg.num_layers
    assert f"kv cache: {kv} B/token stored" in text
    assert out["cache_len"] == 6 + 3 + jcfg.num_patches
    assert out["kv_store_bytes"] == kv * out["cache_len"] * 2
    cross = 2 * jcfg.num_layers * 2 * jcfg.encoder_seq \
        * jcfg.num_kv_heads * jcfg.head_dim * 4
    assert out["cross_bytes"] == cross
    assert ("cross caches:" in text) == bool(cross)
    # the batcher, as JAX's, passes no frames or patches: its bf16 pool
    # keeps zero cross caches, and a vlm pool the patches' rows
    out = tserve.main(["--arch", jcfg.name, "--smoke", "--continuous",
                       "--device", "cpu", "--batch", "2", "--prompt-len", "6",
                       "--gen", "3"])
    assert [len(r.tokens) for r in out["requests"]] == [3] * 4
    assert out["cache_len"] == 6 + 3 + jcfg.num_patches
    assert out["cross_bytes"] == cross // 2


def test_train_launcher_refusals(media, capsys):
    """``--distributed`` refuses both families (JAX's launcher makes no
    frames or patches for its batch specs); the simulated path trains
    pixtral text-only, as JAX's does, and refuses whisper, whose loss
    needs the frames JAX's launcher lacks (there a KeyError)."""
    jcfg = media[0]
    args = ["--arch", jcfg.name, "--smoke", "--device", "cpu", "--steps",
            "2", "--stages", "2", "--seq", "16", "--samples", "8",
            "--batch", "4"]
    with pytest.raises(SystemExit):
        ttrain.main(args + ["--distributed", "--data-par", "2"])
    assert "frames or patches" in capsys.readouterr().err
    if jcfg.family == "audio":
        with pytest.raises(SystemExit):
            ttrain.main(args)
        assert "KeyError: 'frames'" in capsys.readouterr().err
        with pytest.raises(KeyError, match="frames"):
            TM.loss_fn(TM.Transformer(media[1]), {
                "tokens": torch.zeros((1, 4), dtype=torch.long)})
    else:
        _, losses = ttrain.main(args)
        assert len(losses) == 2 and np.isfinite(losses).all()
