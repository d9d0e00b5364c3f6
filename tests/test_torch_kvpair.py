"""The KV plane's pair calls in the port against the JAX package.

The served model reads k's and v's layer stores in one launch
(`KVCodec.decode_pair`, kernel B4 `unpack_dequant` over both) and
appends k's and v's fresh rows in one launch that writes the codes and
scales in place at the write head (`KVCodec.append_pair`, kernel B3
`quantize_pack` over both).  The JAX package has no pair: its
`KVCodec.append` of k, then of v, and its `KVCodec.decode` of each are
the reference.  The same numpy inputs go through jitted JAX and through
the port's two backends on CPU tensors: ``"auto"`` (the plain chain
over `core.quantization`) and ``"cuda"`` (the kernel wrappers, which on
the CPU run their plain versions, `kernels.ref` `quantize_pack_into_ref`
and `unpack_dequant_pair_ref`).  Codes, scales and decoded values must
agree bit for bit, and rows of a store outside ``[pos, pos + s)`` keep
their sentinel bytes.  A stochastic pair must equal two per-tensor
appends from the same generator.  The kernels themselves are held to
the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py ``[kv-pair-bit-exact]``).

Run: ``PYTHONPATH=src python -m pytest -q tests/test_torch_kvpair.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.serving import KVCodec as JKV
from repro_torch.kernels import quant_pack as TP
from repro_torch.kernels import ref as TR
from repro_torch.serving import KVCodec as TKV


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BITS = [2, 4, 8]
PORT_BACKENDS = ["auto", "cuda"]


def _np(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _sentinel_store(codec, shape, seed):
    """A store of ``shape``'s layout filled with random bytes and
    scales (numpy), so an untouched row is told from a written one."""
    empty = codec.empty(shape, device="cpu")
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, empty["codes"].shape, dtype=np.uint8)
    scale = (rng.random(empty["scale"].shape) + 0.5).astype(np.float32)
    return codes, scale


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


def _jax_append_decode(jc, stores, fresh, pos):
    """JAX: append k then v at ``pos``, decode both stores."""
    def step(kc, ks, vc, vs, fk, fv):
        k = jc.append({"codes": kc, "scale": ks}, fk, pos)
        v = jc.append({"codes": vc, "scale": vs}, fv, pos)
        return (k, v, jc.decode(k["codes"], k["scale"], jnp.float32),
                jc.decode(v["codes"], v["scale"], jnp.float32))
    return jax.jit(step)(*stores[0], *stores[1], *fresh)


def _port_append_decode(tc, stores, fresh, pos):
    """The port: one pair append, one pair read."""
    codes = tuple(torch.from_numpy(c.copy()) for c, _ in stores)
    scales = tuple(torch.from_numpy(s.copy()) for _, s in stores)
    tc.append_pair(codes, scales, tuple(map(torch.from_numpy, fresh)), pos)
    return codes, scales, tc.decode_pair(codes, scales, torch.float32)


def _check_pair_against_jax(bits, group_d, backend, shape, s, pos, seed,
                            jax_backend="reference"):
    b, cache, hk, hd = shape
    jc = JKV(bits=bits, group_d=group_d, backend=jax_backend)
    tc = TKV(bits=bits, group_d=group_d, backend=backend)
    stores = [_sentinel_store(tc, shape, seed + i) for i in range(2)]
    fresh = [_np((b, s, hk, hd), seed + 2 + i, 3.0) for i in range(2)]
    fresh[0][0, 0, 0] = 0.0                       # an all-zero group
    jk, jv, jdk, jdv = _jax_append_decode(jc, stores, fresh, pos)
    codes, scales, (dk, dv) = _port_append_decode(tc, stores, fresh, pos)
    for j, c, sc in ((jk, codes[0], scales[0]), (jv, codes[1], scales[1])):
        _eq(j["codes"], c)
        _eq(j["scale"], sc)
    _eq(jdk, dk)
    _eq(jdv, dv)
    assert dk.shape == dv.shape == shape
    # rows outside [pos, pos + s) keep their sentinel bytes and scales
    for (c0, s0), c, sc in zip(stores, codes, scales):
        keep = np.ones(cache, dtype=bool)
        keep[pos:pos + s] = False
        np.testing.assert_array_equal(c.numpy()[:, keep], c0[:, keep])
        np.testing.assert_array_equal(sc.numpy()[:, keep], s0[:, keep])
        assert not np.array_equal(c.numpy()[:, ~keep], c0[:, ~keep])


# (s, pos): a decode step's one row past the prompt, and a prefill-like
# run of 3 rows at pos > 0
STEPS = [(1, 5), (3, 2)]


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("s,pos", STEPS)
@pytest.mark.parametrize("group_d", [0, 32])
@pytest.mark.parametrize("bits", BITS)
def test_pair_matches_jax(bits, group_d, s, pos, backend):
    _check_pair_against_jax(bits, group_d, backend, (2, 8, 4, 64), s, pos,
                            seed=10 * bits + group_d + s)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("s,pos", [(1, 11), (3, 4)])
@pytest.mark.parametrize("bits", BITS)
def test_pair_matches_jax_at_gemma2_rows(bits, s, pos, backend):
    """gemma2-9b's KV rows (Hk 8, head_dim 256), the last row of the
    store for s = 1."""
    _check_pair_against_jax(bits, 0, backend, (2, 12, 8, 256), s, pos,
                            seed=bits + s)


@pytest.mark.parametrize("bits", BITS)
def test_pair_matches_jax_pallas(bits):
    """JAX's KVCodec on its Pallas backend (interpret mode) as the
    reference, the port on its kernel wrappers' plain versions."""
    _check_pair_against_jax(bits, 0, "cuda", (2, 8, 4, 64), 3, 2,
                            seed=bits, jax_backend="pallas")


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("bits", BITS)
def test_stochastic_pair_equals_two_appends(bits, backend):
    """A stochastic codec: the pair draws k's noise, then v's, from the
    generator, so its bits equal `append` of k then v from a generator
    in the same state, and it leaves the generator where they do."""
    tc = TKV(bits=bits, group_d=32, stochastic=True, backend=backend)
    shape = (2, 9, 3, 64)
    stores = [_sentinel_store(tc, shape, 40 + i) for i in range(2)] * 2
    fresh = [torch.from_numpy(_np((2, 4, 3, 64), 50 + i)) for i in range(2)]
    t = [tuple(torch.from_numpy(a.copy()) for a in st) for st in stores]
    g_pair = torch.Generator().manual_seed(bits)
    g_two = torch.Generator().manual_seed(bits)
    tc.append_pair((t[0][0], t[1][0]), (t[0][1], t[1][1]), fresh, 3,
                   generator=g_pair)
    tc.append(*t[2], fresh[0], 3, generator=g_two)
    tc.append(*t[3], fresh[1], 3, generator=g_two)
    for a, c in ((0, 2), (1, 3)):
        assert torch.equal(t[a][0], t[c][0]) and torch.equal(t[a][1], t[c][1])
    assert torch.equal(torch.rand(4, generator=g_pair),
                       torch.rand(4, generator=g_two))
    # the noise moved some codes off round-to-nearest
    det = [tuple(torch.from_numpy(a.copy()) for a in st) for st in stores[:2]]
    TKV(bits=bits, group_d=32, backend=backend).append_pair(
        (det[0][0], det[1][0]), (det[0][1], det[1][1]), fresh, 3)
    assert not torch.equal(det[0][0], t[0][0])


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_pair_writes_one_layer_of_the_caches(backend):
    """Through the model's cache layout (L, B, S, Hk, G, pw): the pair
    writes rows [pos, pos + s) of layer 1's k and v stores, through the
    layer view's batch stride, and nothing of layers 0 and 2."""
    tc = TKV(bits=4, group_d=16, backend=backend)
    full = (3, 2, 6, 5, 32)
    stores = [_sentinel_store(tc, full, 60 + i) for i in range(2)]
    t = [tuple(torch.from_numpy(a.copy()) for a in st) for st in stores]
    fresh = [torch.from_numpy(_np((2, 2, 5, 32), 70 + i)) for i in range(2)]
    tc.append_pair((t[0][0][1], t[1][0][1]), (t[0][1][1], t[1][1][1]),
                   fresh, 4)
    for (c0, s0), (c, sc), f in zip(stores, t, fresh):
        want_c, want_s = tc.encode(f)
        exp_c, exp_s = torch.from_numpy(c0.copy()), torch.from_numpy(s0.copy())
        exp_c[1, :, 4:6] = want_c
        exp_s[1, :, 4:6] = want_s
        assert torch.equal(c, exp_c) and torch.equal(sc, exp_s)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", BITS)
def test_kernel_pair_plain_versions_match_jax_oracle(bits, out_dtype):
    """The wrappers on CPU tensors (their plain versions) against JAX's
    kernel oracles: the pair read equals `unpack_dequant_ref` of each
    tensor (cast to the output dtype), the pair append writes
    `quantize_pack_ref`'s codes and scales at pos, with noise."""
    b, s, n, g, cache, pos = 2, 3, 5, 32, 7, 3
    x = [_np((b, s, n, g), 80 + i) for i in range(2)]
    u = [np.random.default_rng(90 + i).random((b, s, n, g), dtype=np.float32)
         for i in range(2)]
    packed = tuple(torch.zeros((b, cache, n, g * bits // 8),
                               dtype=torch.uint8) for _ in range(2))
    scale = tuple(torch.zeros((b, cache, n)) for _ in range(2))
    TP.quantize_pack_into(tuple(map(torch.from_numpy, x)), packed, scale,
                          pos, tuple(map(torch.from_numpy, u)), bits=bits)
    for i in range(2):
        jp, js = jax.jit(JR.quantize_pack_ref, static_argnums=1)(
            x[i].reshape(-1, g), bits, u[i].reshape(-1, g))
        _eq(np.asarray(jp).reshape(b, s, n, -1), packed[i][:, pos:pos + s])
        _eq(np.asarray(js).reshape(b, s, n), scale[i][:, pos:pos + s])
    rows = tuple(p.reshape(-1, p.shape[-1]) for p in packed)
    srows = tuple(sc.reshape(-1, 1) for sc in scale)
    got = TP.unpack_dequant_pair(rows, srows, bits=bits, out_dtype=out_dtype)
    for i in range(2):
        want = jax.jit(JR.unpack_dequant_ref, static_argnums=2)(
            rows[i].numpy(), srows[i].numpy(), bits)
        want = torch.from_numpy(np.array(want)).to(out_dtype)
        assert got[i].dtype == out_dtype and torch.equal(got[i], want)


@pytest.mark.parametrize("bits", BITS)
def test_seeded_pair_equals_two_seeded_calls(bits):
    """With a seed a tensor, the pair append's plain version draws each
    tensor's noise over its own (B*s*N, g) row view, as a per-tensor
    `quantize_pack` with that seed does."""
    b, s, n, g, cache, pos = 2, 2, 3, 64, 5, 1
    x = tuple(torch.from_numpy(_np((b, s, n, g), 100 + i)) for i in range(2))
    seed = (torch.tensor([3, -4], dtype=torch.int32),
            torch.tensor([2 ** 31 - 1, 7], dtype=torch.int32))
    packed = tuple(torch.zeros((b, cache, n, g * bits // 8),
                               dtype=torch.uint8) for _ in range(2))
    scale = tuple(torch.zeros((b, cache, n)) for _ in range(2))
    TP.quantize_pack_into(x, packed, scale, pos, seed=seed, bits=bits)
    for i in range(2):
        p, sc = TP.quantize_pack(x[i].reshape(-1, g), bits=bits,
                                 seed=seed[i])
        assert torch.equal(packed[i][:, pos:pos + s],
                           p.reshape(b, s, n, -1))
        assert torch.equal(scale[i][:, pos:pos + s], sc.reshape(b, s, n))
    # the two seeds drew different noise
    assert not torch.equal(TR.oncore_uniform_ref(seed[0], 4, g),
                           TR.oncore_uniform_ref(seed[1], 4, g))


def _append_args(**bad):
    """Valid pair-append arguments (B 2, s 2, N 3, g 16 at 8 bits into
    a store of 6), with one argument replaced."""
    x = tuple(torch.randn(2, 2, 3, 16) for _ in range(2))
    packed = tuple(torch.zeros(2, 6, 3, 16, dtype=torch.uint8)
                   for _ in range(2))
    scale = tuple(torch.zeros(2, 6, 3) for _ in range(2))
    args = dict(x=x, packed=packed, scale=scale, pos=4)
    args.update(bad)
    return args


BAD_APPENDS = {
    "past_the_store": dict(pos=5),
    "negative_pos": dict(pos=-1),
    "scale_dtype": dict(scale=(torch.zeros(2, 6, 3,
                                           dtype=torch.float64),) * 2),
    "codes_dtype": dict(packed=(torch.zeros(2, 6, 3, 16),) * 2),
    "packed_width": dict(packed=(torch.zeros(2, 6, 3, 8, dtype=torch.uint8),)
                         * 2),
    "strides_differ": dict(packed=(
        torch.zeros(2, 6, 3, 16, dtype=torch.uint8),
        torch.zeros(2, 7, 3, 16, dtype=torch.uint8)[:, :6])),
    "entry_not_contiguous": dict(packed=(
        torch.zeros(2, 3, 6, 16, dtype=torch.uint8).transpose(1, 2),) * 2),
    "overlapping_entries": dict(packed=(
        torch.zeros(6, 3, 16, dtype=torch.uint8).expand(2, 6, 3, 16),) * 2),
    "not_a_pair": dict(x=torch.randn(2, 2, 3, 16)),
}


@pytest.mark.parametrize("case", sorted(BAD_APPENDS))
def test_pair_append_checks(case):
    """The append wrapper checks the stores' dtype, shape and strides,
    the pairing and ``pos + s <= S`` before it writes anything, on any
    device."""
    args = _append_args(**BAD_APPENDS[case])
    with pytest.raises((ValueError, TypeError)):
        TP.quantize_pack_into(args["x"], args["packed"], args["scale"],
                              args["pos"], bits=8)


def test_pair_append_accepts_a_layer_view():
    """The valid arguments, and a layer view of (L, B, S, N, pw) stores
    (batch stride past one entry), pass the checks."""
    args = _append_args()
    TP.quantize_pack_into(args["x"], args["packed"], args["scale"], 4,
                          bits=8)
    big = torch.zeros(3, 2, 6, 3, 16, dtype=torch.uint8)
    sbig = torch.zeros(3, 2, 6, 3)
    TP.quantize_pack_into(args["x"], (big[1], big[2]), (sbig[1], sbig[2]), 0,
                          bits=8)
    assert not big[0].any() and big[1, :, :2].any() and not big[1, :, 2:].any()


# divisors of the store read's rows: powers of two (head_dim 64, 256), a
# group_d, the training hop's 1600, gemma2's 3584, odd ones, the largest
DIVISORS = [2, 3, 4, 7, 32, 64, 256, 1600, 3584, 2 ** 20 + 1, 2 ** 30 - 1,
            2 ** 31 - 1]


@pytest.mark.parametrize("d", DIVISORS)
def test_div_magic_is_exact_below_2_31(d):
    """The store read's 32-bit row quotient ``(n * mul >> 32) >> shift``
    equals ``n // d`` over [0, 2**31): the edges, the multiples of d and
    their neighbours, and random n."""
    mul, shift = TP._div_magic(d)
    assert 0 < mul < 2 ** 32
    rng = np.random.default_rng(d % 1000)
    ns = [0, 1, 2 ** 31 - 1, 2 ** 31 - 2] + \
        [int(v) for v in rng.integers(0, 2 ** 31, 2000)]
    for q in [1, 2, 3] + [int(v) for v in rng.integers(1, 2 ** 31 // d + 1,
                                                       200)]:
        ns += [q * d - 1, q * d, q * d + 1]
    for n in ns:
        if 0 <= n < 2 ** 31:
            assert ((n * mul) >> 32) >> shift == n // d, (d, n)
    with pytest.raises(ValueError):
        TP._div_magic(1)
