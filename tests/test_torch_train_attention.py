"""The memory-lean training attention, ``remat`` and the chunked loss
against the JAX package, and gemma2-9b through the trainer.

* `repro_torch.models.layers.flash_attention` (the forward of the
  attention kernel's plain version with the rows' log-sum-exp, JAX's
  ``_bwd`` as its backward) against JAX ``repro.models.layers.
  flash_attention``: o and ``_fwd``'s lse, and dq, dk, dv through
  ``jax.vjp``, differentiated with respect to the UNREPEATED kv (JAX
  repeats kv heads before its call; the port reads them in place and
  sums the group in its backward).  Ragged S (not a multiple of
  ``block_k``), a sliding window, softcaps 50 and 30, GQA 4:2, 6:2 and
  MQA, ``block_k`` 8, 16 and 64.  Tolerances: rtol = atol = 1e-5 for o
  and lse, and atol 1e-5 + rtol 1e-4 for the gradients: both are f32
  evaluations of one formula, summed in other orders (dense softmax
  against a blockwise scan, dk and dv summed over a group in one
  product against autograd's sum over the repeats); measured <= 1.2e-6.
* gemma2-9b SMOKE (sliding window 16, softcaps, GQA 4:2) at S = 40:
  `loss_fn` and every parameter's gradient against ``jax.value_and_grad``
  of JAX ``loss_fn`` at 1 and 2 stage groups, ``block_k`` 16, remat
  off and on (loss rtol 1e-5, gradients atol 1e-5 of the leaf's
  largest + rtol 1e-4); the simulated trainer's loss stream against
  JAX ``train`` for fp32 and for aqsgd fw 4 / bw 8 with 4-bit DP over 2
  workers (deterministic), both with ``remat`` on both sides, at
  tests/test_torch_train.py's tolerances.
* ``remat`` on and off give bit-equal losses and gradients on the CPU:
  `loss_fn` on both archs, the simulated trainer over 3 stochastic
  steps (losses, parameters, buffers and carries: the stage boundaries
  draw their noise outside the checkpoints, so a recompute draws
  nothing), and a pipeline `Stage` with ``remat`` off, ``"layer"`` and
  ``"nested"`` (the distributed trainer's loss streams are compared in
  tests/test_torch_pipeline.py's spawn).
* The pipeline's chunked loss (`Stage.nll_sum`) against JAX's
  ``chunk_loss`` (`repro.training.pipeline`, written there inside
  ``make_train_step``, so run here as it is written), with its value
  and its gradients with respect to h and the embedding, at
  ``loss_chunks`` 1, 5, 7 and 64 over S = 40 (rtol 1e-6; the chunk
  count is the largest divisor of S at most ``loss_chunks``, as there).
* The trainers' config fields have the JAX package's names and
  defaults.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.config import CommConfig as JComm
from repro.comm.config import PlaneConfig as JPlane
from repro.configs.base import get_config as jget
from repro.data import pipeline as JD
from repro.models import layers as JL
from repro.models import model as Mo
from repro.optim import adamw as JO
from repro.training import pipeline as JPL
from repro.training import simulated as JS
from repro_torch.comm.config import CommConfig as TComm
from repro_torch.comm.config import PlaneConfig as TPlane
from repro_torch.configs.base import get_config as tget
from repro_torch.data import pipeline as TD
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TO
from repro_torch.training import pipeline as PL
from repro_torch.training import simulated as TS
from repro_torch.weights import from_jax_params


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BIG = 10 ** 9
OUT_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
LOSS_RTOL, LATER_STEP_RTOL = 1e-5, 1e-3
SEQ = 40                          # past gemma2 SMOKE's window of 16


def _t(x):
    return torch.tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# the attention Function against JAX's custom_vjp
# ---------------------------------------------------------------------------

# (B, S, H, Hk, hd, window, softcap, block_k, q scale)
ATTN_CASES = [
    (2, 37, 4, 4, 16, BIG, 0.0, 16, 1.0),      # ragged S, causal only
    (2, 37, 4, 2, 16, 9, 50.0, 16, 8.0),       # GQA 4:2, window, softcap
    (1, 40, 4, 2, 32, 16, 50.0, 16, 8.0),      # gemma2 SMOKE's shape
    (2, 33, 6, 2, 16, 40, 30.0, 8, 4.0),       # GQA 6:2, window past S
    (1, 24, 2, 1, 16, BIG, 0.0, 64, 1.0),      # MQA, one padded block
    (1, 21, 4, 2, 160, BIG, 0.0, 8, 1.0),      # stablelm-12b's head_dim
    (1, 21, 4, 4, 80, BIG, 0.0, 8, 1.0),       # zamba2-2.7b's head_dim
]


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=lambda c: "-".join(map(str, c[1:8])))
def test_flash_attention_matches_jax(case):
    b, s, h, hk, hd, window, cap, bk, qs = case
    grp = h // hk
    rng = np.random.default_rng(sum(case[:5]))
    q = (rng.standard_normal((b, s, h, hd)) * qs).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hk, hd)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))

    def jfn(q, k, v):
        return JL.flash_attention(q, JL._repeat_kv(k, grp),
                                  JL._repeat_kv(v, grp), q_pos=pos,
                                  k_pos=pos, window=window, causal=True,
                                  attn_softcap=cap, block_k=bk)

    flash = JL._make_flash(True, float(cap), bk)

    @jax.jit
    def jax_side(q, k, v, g):
        o, vjp = jax.vjp(jfn, q, k, v)
        _, res = flash.fwd(q, JL._repeat_kv(k, grp), JL._repeat_kv(v, grp),
                           pos, pos, jnp.asarray(window, jnp.int32))
        return o, res[-1], vjp(g)                 # res[-1]: lse (B, H, S)

    jo, jlse, jgrads = jax_side(q, k, v, g)

    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    to = TL.flash_attention(tq, tk, tv, window=window, attn_softcap=cap,
                            block_k=bk)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), _t(g))
    _, tlse = tops.flash_attention(tq.detach().transpose(1, 2),
                                   tk.detach().transpose(1, 2),
                                   tv.detach().transpose(1, 2), window=window,
                                   softcap=cap, return_lse=True)
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse),
                               rtol=OUT_TOL, atol=OUT_TOL)
    for name, tg, jg in zip("qkv", tgrads, jgrads):
        assert tg.shape == jg.shape, name
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"d{name}")


def test_training_attention_saves_no_score_tensor():
    """The Function keeps q, k, v, o and the (B, H, S) lse for its
    backward, nothing of (B, H, S, S)."""
    b, s, h, hk, hd = 2, 48, 4, 2, 16
    q = torch.randn(b, s, h, hd, requires_grad=True)
    k, v = (torch.randn(b, s, hk, hd, requires_grad=True) for _ in "kv")
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        TL.flash_attention(q, k, v, window=BIG, block_k=16)
    assert sorted(saved) == sorted([(b, s, h, hd), (b, s, hk, hd),
                                    (b, s, hk, hd), (b, s, h, hd),
                                    (b, h, s)])


# ---------------------------------------------------------------------------
# gemma2-9b SMOKE through loss_fn and the simulated trainer
# ---------------------------------------------------------------------------

def _np_params(arch):
    """SMOKE weights at the JAX package's init scales, drawn with numpy
    (as tests/test_torch_train.py draws them)."""
    cfg = jget(arch, smoke=True)
    shapes = jax.eval_shape(lambda: Mo.init_params(cfg,
                                                   jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return np.zeros(s.shape, np.float32)
        std = 0.02 if "embed" in name else s.shape[-2] ** -0.5
        return (rng.standard_normal(s.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def gemma():
    np_params = _np_params("gemma2-9b")
    return (jget("gemma2-9b", smoke=True), tget("gemma2-9b", smoke=True),
            jax.tree.map(jnp.asarray, np_params), np_params)


def _batch(vocab, seed, b=2, s=SEQ):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    toks = toks.astype(np.int32)
    mask = (np.random.default_rng(seed + 1).random((b, s)) < 0.9)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "mask": mask.astype(np.float32)}


def _tbatch(batch):
    return {"tokens": _t(batch["tokens"]).long(),
            "targets": _t(batch["targets"]).long(),
            "mask": _t(batch["mask"])}


def _port_grad(name, grads):
    """The JAX gradient leaf of one port parameter name."""
    parts = name.split(".")
    if parts[0] == "layers":
        node = grads["layers"]
        for p in parts[2:]:
            node = node[p]
        return np.asarray(node)[int(parts[1])]
    node = grads
    for p in parts:
        node = node[p]
    return np.asarray(node)


@pytest.mark.parametrize("num_stages,remat", [(1, False), (2, True)])
def test_gemma2_loss_and_grads_match_jax(gemma, num_stages, remat):
    jcfg, tcfg, params, np_params = gemma
    batch = _batch(jcfg.vocab_size, 4)
    want, jgrads = jax.jit(jax.value_and_grad(lambda p: Mo.loss_fn(
        p, jcfg, batch, num_stages=num_stages, remat=remat,
        block_k=16)[0]))(params)
    model = from_jax_params(np_params, tcfg)
    got, _ = TM.loss_fn(model, _tbatch(batch), num_stages=num_stages,
                        remat=remat, block_k=16)
    assert abs(got.item() - float(want)) <= LOSS_RTOL * abs(float(want))
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(got, [model.get_parameter(n)
                                      for n in names])
    for name, g in zip(names, grads):
        ref = _port_grad(name, jgrads)
        scale = float(np.abs(ref).max()) or 1.0
        np.testing.assert_allclose(g.numpy(), ref, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=name)


def _comm(C, P, mode, stochastic=False):
    kw = dict(stochastic=stochastic)
    if mode == "fp32":
        return C(mode="fp32", fw=P(bits=0, **kw), bw=P(bits=0, **kw))
    return C(mode="aqsgd", fw=P(bits=4, **kw), bw=P(bits=8, **kw),
             dp=P(bits=4, **kw))


def _port_train(tcfg, mode, workers, steps, *, remat, np_params,
                stochastic=False):
    dc = dict(num_samples=8, seq_len=32, vocab_size=tcfg.vocab_size)
    tt = TS.SimTrainConfig(num_stages=2, dp_workers=workers, remat=remat,
                           comm=_comm(TComm, TPlane, mode, stochastic),
                           optimizer=TO.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                    total_steps=steps))
    return TS.train(tcfg, tt, TD.Dataset(TD.DatasetConfig(**dc)),
                    num_steps=steps, batch_size=4, initial_params=np_params,
                    device="cpu")


@pytest.mark.parametrize("mode,workers", [("fp32", 1), ("aqsgd", 2)])
def test_gemma2_trainer_loss_stream_matches_jax(gemma, mode, workers):
    """3 steps over 8 samples of 32 tokens at batch 4, 2 stage groups,
    remat on in both packages; aqsgd's second epoch (step 3) runs the
    delta path."""
    jcfg, tcfg, params, np_params = gemma
    steps = 3
    dc = dict(num_samples=8, seq_len=32, vocab_size=jcfg.vocab_size)
    jt = JS.SimTrainConfig(num_stages=2, comm=_comm(JComm, JPlane, mode),
                           dp_workers=workers, remat=True,
                           optimizer=JO.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                    total_steps=steps))
    _, jl = JS.train(jcfg, jt, JD.Dataset(JD.DatasetConfig(**dc)),
                     num_steps=steps, batch_size=4, initial_params=params)
    _, tl = _port_train(tcfg, mode, workers, steps, remat=True,
                        np_params=np_params)
    np.testing.assert_allclose(tl[0], jl[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tl[1:], jl[1:], rtol=LOSS_RTOL
                               if mode == "fp32" else LATER_STEP_RTOL)


# ---------------------------------------------------------------------------
# remat on and off: bit-equal on the CPU
# ---------------------------------------------------------------------------

def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32)) \
        if a.dtype == torch.float32 else torch.equal(a, b)


@pytest.mark.parametrize("arch", ["gpt2-xl-paper", "gemma2-9b"])
def test_remat_loss_fn_is_bit_equal(arch):
    cfg = tget(arch, smoke=True)
    model = TM.Transformer(cfg, generator=torch.Generator().manual_seed(0))
    batch = _tbatch(_batch(cfg.vocab_size, 9))
    params = list(model.parameters())
    out = []
    for remat in (False, True):
        loss, _ = TM.loss_fn(model, batch, num_stages=2, remat=remat,
                             block_k=16)
        out.append((loss.detach(), torch.autograd.grad(loss, params)))
    assert _bits_equal(out[0][0], out[1][0])
    assert all(_bits_equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_remat_simulated_trainer_is_bit_equal(gemma):
    """aqsgd with stochastic rounding on every plane and 4-bit DP over 2
    workers, 3 steps: losses, parameters, message buffers and carries
    bit-equal with remat on and off (the boundaries' noise draws happen
    once, outside the checkpoints)."""
    _, tcfg, _, np_params = gemma
    runs = [_port_train(tcfg, "aqsgd", 2, 3, remat=r, np_params=np_params,
                        stochastic=True) for r in (False, True)]
    (s0, l0), (s1, l1) = runs
    assert l0 == l1
    for (n, a), (_, b) in zip(s0["model"].named_parameters(),
                              s1["model"].named_parameters()):
        assert _bits_equal(a.detach(), b.detach()), n
    for key in s0["buffers"]:
        for a, b in zip(s0["buffers"][key], s1["buffers"][key]):
            assert torch.equal(a, b), key
    assert _bits_equal(s0["dp_error"], s1["dp_error"])


def _stage(arch, layers=4):
    cfg = tget(arch, smoke=True).with_(num_layers=layers)
    model = TM.Transformer(cfg, generator=torch.Generator().manual_seed(0))
    return PL.Stage(cfg, PL.stage_layout(cfg, 1), 0).load_from_model(model)


@pytest.mark.parametrize("arch", ["gpt2-xl-paper", "gemma2-9b"])
def test_remat_pipeline_stage_is_bit_equal(arch):
    """A whole-model stage (embedding, 4 layers, head) over one
    microbatch: the loss and every gradient bit-equal with remat off,
    ``"layer"`` and ``"nested"``."""
    st = _stage(arch)
    batch = _tbatch(_batch(st.cfg.vocab_size, 11))
    params = list(st.parameters())
    out = []
    for kw in (dict(remat=False), dict(remat_mode="layer"),
               dict(remat_mode="nested")):
        pcfg = PL.PipelineConfig(microbatches=1, block_k=16, **kw)
        h = st.trunk(st.embed_tokens(batch["tokens"]), pcfg)
        loss = st.nll_sum(h, batch["targets"], batch["mask"],
                          pcfg.loss_chunks)
        out.append((loss.detach(), torch.autograd.grad(loss, params)))
    for loss, grads in out[1:]:
        assert _bits_equal(loss, out[0][0])
        assert all(_bits_equal(a, b) for a, b in zip(grads, out[0][1]))


# ---------------------------------------------------------------------------
# the pipeline's chunked loss against JAX's chunk_loss
# ---------------------------------------------------------------------------

def _jax_chunked_nll(params, cfg, h, targets, mask, loss_chunks):
    """``loss_from_hidden``'s sum of JAX's pipeline (`repro.training.
    pipeline`, inside ``make_train_step``) for one microbatch, as it is
    written there: the largest divisor of S at most ``loss_chunks``,
    and ``jax.lax.map(jax.checkpoint(chunk_loss))`` over the pieces."""
    def chunk_loss(args):
        hh, tt, mm = args
        logits = Mo.lm_logits(params, cfg, hh)
        lse = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, tt[..., None], axis=-1)[..., 0]
        return jnp.sum((lse - gold) * mm), jnp.sum(mm)

    h, targets, mask = h[None], targets[None], mask[None]   # (M=1, mb, S)
    seq = h.shape[2]
    n_chunk = 1
    for c in range(min(loss_chunks, seq), 0, -1):
        if seq % c == 0:
            n_chunk = c
            break

    def split(x):
        x = x.reshape(*x.shape[:2], n_chunk, seq // n_chunk, *x.shape[3:])
        return jnp.moveaxis(x, 2, 0)

    nll, _ = jax.lax.map(jax.checkpoint(chunk_loss),
                         (split(h), split(targets), split(mask)))
    return jnp.sum(nll), n_chunk


@pytest.mark.parametrize("loss_chunks", [1, 5, 7, 64])
def test_chunked_loss_matches_jax(gemma, loss_chunks, monkeypatch):
    jcfg, tcfg, params, np_params = gemma
    batch = _batch(jcfg.vocab_size, 13)
    h = np.random.default_rng(3).standard_normal(
        (2, SEQ, jcfg.d_model)).astype(np.float32)
    def fn(hh, p):
        return _jax_chunked_nll(p, jcfg, hh, batch["targets"],
                                batch["mask"], loss_chunks)

    (want, n_chunk), (jdh, jdp) = jax.jit(jax.value_and_grad(
        fn, argnums=(0, 1), has_aux=True))(jnp.asarray(h), params)
    n_chunk = int(n_chunk)
    st = PL.Stage(tcfg, PL.stage_layout(tcfg, 1), 0).load_from_model(
        from_jax_params(np_params, tcfg))
    pieces = []
    real = PL.checkpoint

    def spy(fn, *a, **kw):
        pieces.append(a[0].shape[1])
        return real(fn, *a, **kw)

    monkeypatch.setattr(PL, "checkpoint", spy)
    th = _t(h).requires_grad_()
    got = st.nll_sum(th, _t(batch["targets"]).long(), _t(batch["mask"]),
                     loss_chunks)
    assert pieces == [SEQ // n_chunk] * n_chunk
    dh, de = torch.autograd.grad(got, (th, st.embed))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), rtol=1e-5,
                               atol=1e-7)
    scale = float(np.abs(np.asarray(jdp["embed"])).max())
    np.testing.assert_allclose(de.numpy(), np.asarray(jdp["embed"]),
                               rtol=1e-5, atol=1e-6 * scale)


# ---------------------------------------------------------------------------
# the config fields
# ---------------------------------------------------------------------------

def test_config_fields_match_jax():
    jp, tp = JPL.PipelineConfig(), PL.PipelineConfig()
    for name in ("remat", "remat_mode", "loss_chunks", "block_k",
                 "microbatches", "buffer_dtype", "warmup"):
        assert getattr(tp, name) == getattr(jp, name), name
    assert TS.SimTrainConfig().remat == JS.SimTrainConfig().remat is False
    with pytest.raises(ValueError, match="remat_mode"):
        PL.PipelineConfig(remat_mode="stage")
    for name in ("loss_chunks", "block_k"):
        with pytest.raises(ValueError, match=name):
            dataclasses.replace(tp, **{name: 0})
