"""The untied output head (``stablelm-12b``) against the JAX package.

stablelm-12b reads its logits through a ``head`` of its own, (d_model,
vocab), where the other dense archs read the embedding's transpose.
On its SMOKE config (2 layers, d 256, GQA 4:2, gated SiLU, no window or
softcap), weights drawn with numpy at the JAX package's init scales:

* `loss_fn` and every parameter's gradient, ``head`` included, against
  ``jax.value_and_grad`` of JAX ``loss_fn``, with remat off and on, at 1
  and 2 stage groups (loss rtol 1e-5, gradients atol 1e-5 of the leaf's
  largest + rtol 1e-4, tests/test_torch_train_attention.py's
  tolerances); remat on and off bit-equal;
* the pipeline's chunked loss (`Stage.nll_sum`) and its gradients with
  respect to h and ``head`` against JAX's ``chunk_loss`` at
  ``loss_chunks`` 1 and 7 (rtol 1e-6 for the value, as there);
* `jax_leaves` puts ``head`` where ``jax.tree.leaves`` does (keys
  sorted: embed, final_norm, head, layers), and the distributed
  trainer's DP bucket lays the pipeline tree out as JAX's
  ``flatten_bucket`` does, the head on the last stage alone;
* the simulated trainer's loss stream against JAX ``train`` for aqsgd
  fw 4 / bw 8 with 4-bit DP over 2 workers, deterministic
  (tests/test_torch_train.py's tolerances);
* greedy serving: prefill and decode with raw f32 caches, the tokens
  equal to JAX's and the logits within the slice's prefill tolerance
  (2e-5).
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
from repro.optim import adamw as JO
from repro.training import pipeline as JPL
from repro.training import simulated as JS
from repro_torch.comm.config import CommConfig as TComm
from repro_torch.comm.config import PlaneConfig as TPlane
from repro_torch.configs.base import get_config as tget
from repro_torch.data import pipeline as TD
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TO
from repro_torch.training import pipeline as PL
from repro_torch.training import simulated as TS
from repro_torch.weights import (from_jax_params, jax_leaf_names,
                                 jax_leaves, stage_state_dict,
                                 to_pipeline_params)
from test_torch_train_attention import (GRAD_ATOL, GRAD_RTOL,
                                        LATER_STEP_RTOL, LOSS_RTOL, SEQ,
                                        _batch, _bits_equal,
                                        _jax_chunked_nll, _np_params,
                                        _port_grad, _t, _tbatch)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCH = "stablelm-12b"
SERVE_ATOL = 2e-5


@pytest.fixture(scope="module")
def untied():
    """(JAX config, port config, JAX params, numpy params): SMOKE
    weights at the JAX package's init scales (N(0, 0.02) embedding,
    N(0, 1/fan_in) for the head and projections, zero norms)."""
    jcfg = jget(ARCH, smoke=True)
    np_params = _np_params(ARCH)
    assert "head" in np_params and not jcfg.tie_embeddings
    return jcfg, tget(ARCH, smoke=True), \
        jax.tree.map(jnp.asarray, np_params), np_params


def test_model_owns_an_untied_head(untied):
    _, tcfg, _, np_params = untied
    model = from_jax_params(np_params, tcfg)
    assert model.head.shape == (tcfg.d_model, tcfg.vocab_size)
    np.testing.assert_array_equal(model.head.detach().numpy(),
                                  np_params["head"])
    drawn = TM.Transformer(tcfg, generator=torch.Generator().manual_seed(0))
    std = drawn.head.detach().std().item()
    assert abs(std * tcfg.d_model ** 0.5 - 1.0) < 0.01, std
    tied = TM.Transformer(tget("gemma2-27b", smoke=True))
    assert tied.head is None
    assert "head" not in dict(tied.named_parameters())
    with pytest.raises(ValueError, match="unknown family"):
        TM.Transformer(tcfg.with_(family="no-such-family"))


@pytest.mark.parametrize("num_stages,remat", [(1, False), (1, True),
                                              (2, True)])
def test_untied_loss_and_grads_match_jax(untied, num_stages, remat):
    jcfg, tcfg, params, np_params = untied
    batch = _batch(jcfg.vocab_size, 4)
    want, jgrads = jax.jit(jax.value_and_grad(lambda p: Mo.loss_fn(
        p, jcfg, batch, num_stages=num_stages, remat=remat,
        block_k=16)[0]))(params)
    model = from_jax_params(np_params, tcfg)
    got, _ = TM.loss_fn(model, _tbatch(batch), num_stages=num_stages,
                        remat=remat, block_k=16)
    assert abs(got.item() - float(want)) <= LOSS_RTOL * abs(float(want))
    names = [n for n, _ in model.named_parameters()]
    assert "head" in names
    grads = torch.autograd.grad(got, [model.get_parameter(n)
                                      for n in names])
    for name, g in zip(names, grads):
        ref = _port_grad(name, jgrads)
        scale = float(np.abs(ref).max()) or 1.0
        np.testing.assert_allclose(g.numpy(), ref, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=name)


def test_untied_remat_is_bit_equal(untied):
    _, tcfg, _, np_params = untied
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


@pytest.mark.parametrize("loss_chunks", [1, 7])
def test_untied_chunked_loss_matches_jax(untied, loss_chunks):
    """The pieces read the head's columns; with 7 the loss runs over 5
    pieces of 8 (the largest divisor of 40 at most 7)."""
    jcfg, tcfg, params, np_params = untied
    batch = _batch(jcfg.vocab_size, 13)
    h = np.random.default_rng(3).standard_normal(
        (2, SEQ, jcfg.d_model)).astype(np.float32)
    (want, _), (jdh, jdp) = jax.jit(jax.value_and_grad(
        lambda hh, p: _jax_chunked_nll(p, jcfg, hh, batch["targets"],
                                       batch["mask"], loss_chunks),
        argnums=(0, 1), has_aux=True))(jnp.asarray(h), params)
    st = PL.Stage(tcfg, PL.stage_layout(tcfg, 1), 0).load_from_model(
        from_jax_params(np_params, tcfg))
    th = _t(h).requires_grad_()
    got = st.nll_sum(th, _t(batch["targets"]).long(), _t(batch["mask"]),
                     loss_chunks)
    dh, dhead, demb = torch.autograd.grad(got, (th, st.head, st.embed),
                                          allow_unused=True)
    assert demb is None                 # the embedding is not the head
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(dh.numpy(), np.asarray(jdh), rtol=1e-5,
                               atol=1e-7)
    scale = float(np.abs(np.asarray(jdp["head"])).max())
    np.testing.assert_allclose(dhead.numpy(), np.asarray(jdp["head"]),
                               rtol=1e-5, atol=1e-6 * scale)


def test_jax_leaves_order(untied):
    _, tcfg, params, np_params = untied
    model = from_jax_params(np_params, tcfg)
    named = dict(model.named_parameters())
    keys = [k for k, _ in jax_leaf_names(named)]
    assert keys[:3] == ["embed", "final_norm.scale", "head"]
    assert all(k.startswith("layers.") for k in keys[3:])
    jleaves = jax.tree.leaves(params)
    leaves = jax_leaves(named)
    assert len(leaves) == len(jleaves)
    for mine, want in zip(leaves, jleaves):
        mine = torch.stack(mine) if isinstance(mine, list) else mine
        np.testing.assert_array_equal(mine.detach().numpy(),
                                      np.asarray(want))


def test_untied_pipeline_stages_and_bucket_match_jax(untied):
    """3 stages over 4 layers (2 dead padded layers): the last stage
    holds ``head`` and no embedding, and every stage parameter sits
    where JAX's ``flatten_bucket`` puts it."""
    jcfg, tcfg, params, np_params = untied
    jcfg, tcfg = jcfg.with_(num_layers=4), tcfg.with_(num_layers=4)
    np_params = dict(np_params, layers=jax.tree.map(
        lambda a: np.concatenate([a, a[::-1]]), np_params["layers"]))
    kk = 3
    jpipe = jax.tree.map(np.asarray, JPL.to_pipeline_params(
        jcfg, jax.tree.map(jnp.asarray, np_params), kk))
    pipe = to_pipeline_params(np_params, tcfg, kk)
    lay = PL.stage_layout(tcfg, kk)
    bucket = PL.PipelineBucket(tcfg, lay, 512)
    jlay = JG.bucket_layout(jpipe, 512)
    assert bucket.shape == (jlay.rows, jlay.group_d)
    jflat = np.asarray(JG.flatten_bucket(jpipe, jlay)).reshape(-1)
    for k in range(kk):
        stage = PL.Stage(tcfg, lay, k).load_pipeline_params(pipe, lay)
        names = {n for n, _ in stage.named_parameters()}
        assert ("embed" in names) == (k == 0)
        assert ("head" in names) == (k == kk - 1)
        state = stage_state_dict(pipe, tcfg, kk, k, embed=k == 0,
                                 final_norm=k == kk - 1, head=k == kk - 1)
        assert set(state) == names
        for name, p in stage.named_parameters():
            off, n = bucket.slot(stage, name)
            np.testing.assert_array_equal(
                jflat[off:off + n], p.detach().numpy().reshape(-1))


def _comm(C, P, stochastic=False):
    kw = dict(stochastic=stochastic)
    return C(mode="aqsgd", fw=P(bits=4, **kw), bw=P(bits=8, **kw),
             dp=P(bits=4, **kw))


def test_untied_trainer_loss_stream_matches_jax(untied):
    """aqsgd fw 4 / bw 8, 4-bit DP over 2 workers, deterministic, 2
    stage groups: 3 steps over 8 samples of 32 tokens at batch 4 (the
    second epoch, step 3, runs the delta path)."""
    jcfg, tcfg, params, np_params = untied
    steps = 3
    dc = dict(num_samples=8, seq_len=32, vocab_size=jcfg.vocab_size)
    jt = JS.SimTrainConfig(num_stages=2, comm=_comm(JComm, JPlane),
                           dp_workers=2,
                           optimizer=JO.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                    total_steps=steps))
    _, jl = JS.train(jcfg, jt, JD.Dataset(JD.DatasetConfig(**dc)),
                     num_steps=steps, batch_size=4, initial_params=params)
    tt = TS.SimTrainConfig(num_stages=2, dp_workers=2,
                           comm=_comm(TComm, TPlane),
                           optimizer=TO.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                    total_steps=steps))
    state, tl = TS.train(tcfg, tt, TD.Dataset(TD.DatasetConfig(**dc)),
                         num_steps=steps, batch_size=4,
                         initial_params=np_params, device="cpu")
    np.testing.assert_allclose(tl[0], jl[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(tl[1:], jl[1:], rtol=LATER_STEP_RTOL)
    # the head moved: AdamW and the DP bucket cover it
    assert not np.array_equal(state["model"].head.detach().numpy(),
                              np_params["head"])


def test_untied_greedy_serving_matches_jax(untied):
    jcfg, tcfg, params, np_params = untied
    b, prompt, steps = 2, 12, 6
    cache = prompt + steps
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (b, prompt)).astype(np.int32)
    step = jax.jit(lambda p, c, t: Mo.forward_with_caches(
        p, jcfg, t, c, logits_last_only=True))
    jc = Mo.init_caches(jcfg, b, cache, jnp.float32)
    model = from_jax_params(np_params, tcfg)
    tc = model.init_caches(b, cache, torch.float32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
    jtoks, ttoks = [], []
    for _ in range(steps + 1):
        jl, jc = step(params, jc, jt)
        tl, tc = model.forward_with_caches(tt, tc, logits_last_only=True)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=SERVE_ATOL)
        jt = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
        tt = torch.argmax(tl[:, -1], dim=-1)[:, None]
        jtoks.append(np.asarray(jt))
        ttoks.append(tt.numpy())
    np.testing.assert_array_equal(np.concatenate(ttoks, 1),
                                  np.concatenate(jtoks, 1))
