"""The port's flash attention (the Pallas ``flash_attention_fwd``, B10)
on the CPU, against the JAX package.

On CPU tensors `repro_torch.kernels.ops.flash_attention` runs the plain
version `repro_torch.kernels.ref.flash_attention_ref`; the CUDA kernel
itself is held against that plain version on the card
(`tests/test_torch_cuda.py`, ``chip_smoke.py``).  Here both are held,
on the same numpy inputs, against

* the JAX oracle `repro.kernels.ref.flash_attention_ref` (kv heads
  repeated, as `tests/test_flash_kernel.py` feeds it),
* the Pallas kernel through `repro.kernels.ops.flash_attention` in
  interpret mode, at the block sizes of that test, and
* the JAX model's blockwise attention `repro.models.layers.flash_attention`
  at ragged Sq/Sk with query positions ``q_offset + i``, head_dim 256,
  window 16 and softcap 50 (gemma2's serving prefill, cut down).

Tolerances are those of `tests/test_flash_kernel.py`: rtol = atol = 2e-5
in f32 (the same softmax summed in another order) and 2e-2 in bf16
(outputs rounded to bf16 by each side).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import flash_attention_ref as jax_oracle
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_pack as TP
from repro_torch.kernels import ref as TR
from repro_torch.models import layers as TL

F32_TOL, BF16_TOL = 2e-5, 2e-2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(b, h, hk, sq, sk, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, hd)).astype(np.float32),
            rng.standard_normal((b, hk, sk, hd)).astype(np.float32),
            rng.standard_normal((b, hk, sk, hd)).astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _port(fn, arrays, dtype, **kw):
    ts = [torch.from_numpy(a).to(dtype) for a in arrays]
    return fn(*ts, **kw).float().numpy()


@pytest.mark.parametrize("b,h,hk,s,hd,bq,bk", [
    (1, 2, 2, 64, 32, 16, 16),
    (2, 4, 2, 128, 64, 32, 64),     # GQA groups=2
    (1, 8, 1, 64, 128, 64, 16),     # MQA
    (1, 2, 2, 96, 32, 32, 32),
    (1, 4, 2, 64, 160, 32, 16),     # stablelm-12b's head_dim, GQA 2
    (1, 4, 4, 64, 80, 32, 16),      # zamba2-2.7b's head_dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_oracle_and_pallas(b, h, hk, s, hd, bq, bk, dtype):
    q, k, v = _qkv(b, h, hk, s, s, hd, seed=hd + h)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(x).astype(jd) for x in (q, k, v))
    g = h // hk
    oracle = jax_oracle(jq, jnp.repeat(jk, g, 1), jnp.repeat(jv, g, 1))
    pallas = jops.flash_attention(jq, jk, jv, block_q=bq, block_k=bk)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for fn in (TR.flash_attention_ref, tops.flash_attention):
        got = _port(fn, (q, k, v), td)
        _close(got, oracle, tol)
        _close(got, pallas, tol)


@pytest.mark.parametrize("window,cap,causal", [
    (9, 0.0, True), (10 ** 9, 30.0, True), (17, 4.0, True),
    (10 ** 9, 0.0, False),
])
def test_plain_masks_match_jax(window, cap, causal):
    q, k, v = _qkv(1, 2, 2, 64, 64, 32, seed=5)
    kw = dict(window=window, softcap=cap, causal=causal)
    oracle = jax_oracle(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    pallas = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), block_q=16, block_k=16,
                                  **kw)
    for fn in (TR.flash_attention_ref, tops.flash_attention):
        got = _port(fn, (q, k, v), torch.float32, **kw)
        _close(got, oracle, F32_TOL)
        _close(got, pallas, F32_TOL)


@pytest.mark.parametrize("h,hk,sq,sk,q_offset,causal", [
    (4, 2, 37, 53, 9, True),        # ragged, rows at 9..45 of 53 keys
    (4, 1, 40, 40, 0, True),        # MQA, the Pallas case q_offset 0
    (2, 2, 24, 70, 46, True),       # the query tile at the cache's end
    (4, 2, 21, 50, 13, False),
])
def test_plain_matches_jax_model_attention(h, hk, sq, sk, q_offset, causal):
    """Head dim 256, window 16, softcap 50 (gemma2's attention, cut
    down), query positions q_offset + i against keys 0 .. Sk-1."""
    b, hd, window, cap = 2, 256, 16, 50.0
    q, k, v = _qkv(b, h, hk, sq, sk, hd, seed=sq + sk)
    g = h // hk
    q_pos = jnp.broadcast_to(q_offset + jnp.arange(sq, dtype=jnp.int32),
                             (b, sq))
    k_pos = jnp.broadcast_to(jnp.arange(sk, dtype=jnp.int32), (b, sk))
    model = JL.flash_attention(
        jnp.asarray(q).transpose(0, 2, 1, 3),
        jnp.repeat(jnp.asarray(k), g, 1).transpose(0, 2, 1, 3),
        jnp.repeat(jnp.asarray(v), g, 1).transpose(0, 2, 1, 3),
        q_pos=q_pos, k_pos=k_pos, window=window, causal=causal,
        attn_softcap=cap, block_k=16)
    want = np.asarray(model).transpose(0, 2, 1, 3)
    kw = dict(window=window, softcap=cap, causal=causal, q_offset=q_offset)
    for fn in (TR.flash_attention_ref, tops.flash_attention):
        _close(_port(fn, (q, k, v), torch.float32, **kw), want, F32_TOL)


def test_cpu_tensors_do_not_count_launches():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 10, 12, 64, 3))
    TP.reset_launches()
    out = tops.flash_attention(q, k, v, window=4, softcap=30.0, q_offset=2)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert TP.LAUNCHES["flash_attention_fwd"] == 0
    assert not any(TP.LAUNCHES.values())


def test_wrapper_rejects_what_neither_version_takes():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 10, 12, 64, 4))
    with pytest.raises(ValueError, match="run past"):
        TFA.flash_attention_fwd(q, k, v, q_offset=3)
    with pytest.raises(ValueError, match="window"):
        TFA.flash_attention_fwd(q, k, v, window=0)
    with pytest.raises(ValueError, match="evenly"):
        TFA.flash_attention_fwd(q[:, :3], k, v)
    with pytest.raises(ValueError, match="batch or head_dim"):
        TFA.flash_attention_fwd(q, k[..., :32], v[..., :32])


def test_prefill_over_a_cache_goes_through_the_kernel_wrapper(monkeypatch):
    """With caches and S > 1 the attention sublayer calls
    `ops.flash_attention` with the kv heads unrepeated, the cache index
    as q_offset and the layer's window; the training attention
    (`layers.flash_attention`) runs only without caches, and goes
    through the same wrapper, kv heads unrepeated, asking for the rows'
    log-sum-exp; decode stays one-shot."""
    torch.manual_seed(0)
    att = TL.Attention(64, 4, 2, 16, 10_000.0, attn_softcap=50.0)
    att.reset_parameters(torch.Generator().manual_seed(0))
    calls, plain = [], []
    real = tops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(TL.ops, "flash_attention", spy)
    real_plain = TL.flash_attention

    def plain_spy(*a, **kw):
        plain.append(1)
        return real_plain(*a, **kw)

    monkeypatch.setattr(TL, "flash_attention", plain_spy)
    x = torch.randn(2, 5, 64)
    kc, vc = torch.zeros(2, 12, 2, 16), torch.zeros(2, 12, 2, 16)
    pos = 3 + torch.arange(5, dtype=torch.int32).expand(2, 5)
    att(x, pos, 4, kc, vc, 3)                           # prefill
    att(x[:, :1], pos[:, :1] + 5, 4, kc, vc, 8)         # decode
    assert calls == [((2, 4, 5, 16), (2, 2, 12, 16),
                      dict(causal=True, window=4, softcap=50.0,
                           q_offset=3))]
    assert not plain
    att(x, pos - 3, 4)                                  # training forward
    assert plain == [1] and len(calls) == 2
    assert calls[1] == ((2, 4, 5, 16), (2, 2, 5, 16),
                        dict(causal=True, window=4, softcap=50.0,
                             return_lse=True))
