"""The port's codec against the JAX package, bit for bit.

For each of the four kernel functions (`repro_torch.kernels.quant_pack`,
which on CPU tensors runs the plain versions in `repro_torch.kernels.ref`)
and each boundary op (`repro_torch.core.boundary`), the same numpy
inputs go through the port, the JITTED `repro.kernels.ref` oracle /
`repro.core.boundary` reference chain, and the Pallas kernel in
interpret mode.  Codes, packed bytes, scales, ``m_new`` and dequantized
values must be equal, not close: under jit XLA turns the dequantizer's
``/ lv`` into ``* f32(1/lv)`` and fuses ``m + ...`` into one FMA, and
the port computes exactly that.

Cases cover bits 2/4/8, ragged row counts, an all-zero row (scale
clamps to 1e-12) and stochastic rounding with one shared noise tensor.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boundary as JB
from repro.core import quantization as JQ
from repro.kernels import quant_pack as JP
from repro.kernels import ref as JR
from repro_torch.core import boundary as TB
from repro_torch.core import quantization as TQ
from repro_torch.kernels import ops as TO
from repro_torch.kernels import quant_pack as TP


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BITS = [2, 4, 8]
SHAPES = [(5, 64), (37, 1600)]       # ragged rows; head_dim and d_model


def _rows(shape, seed, *, zero_row=True):
    """Normal rows at mixed magnitudes; row 0 all zero."""
    rng = np.random.default_rng(seed)
    r, d = shape
    x = rng.standard_normal((r, d)).astype(np.float32)
    x *= np.logspace(-3, 2, r, dtype=np.float32)[:, None]
    if zero_row:
        x[0] = 0.0
    return x


def _noise(shape, seed):
    return np.random.default_rng(seed + 1).random(shape, dtype=np.float32)


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


def _t(x):
    return torch.tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# the four kernel functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", BITS)
def test_delta_quantize_pack_bit_parity(bits, shape, stochastic):
    m = _rows(shape, 1, zero_row=False)
    a = m + _rows(shape, 2)               # row 0: a == m, a zero delta
    u = _noise(shape, 3) if stochastic else None
    ju = None if u is None else jnp.asarray(u)
    want = jax.jit(lambda a, m, u: JR.delta_quantize_pack_ref(
        a, m, bits, u))(a, m, ju)
    pallas = JP.delta_quantize_pack(a, m, ju, bits=bits, interpret=True)
    got = TP.delta_quantize_pack(_t(a), _t(m), None if u is None else _t(u),
                                 bits=bits)
    for w, p, g in zip(want, pallas, got):
        _eq(w, g)
        _eq(p, g)
    assert got[1][0, 0].item() == np.float32(1e-12)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", BITS)
def test_dequant_unpack_accumulate_bit_parity(bits, shape):
    r, d = shape
    rng = np.random.default_rng(4)
    packed = rng.integers(0, 256, (r, d * bits // 8), dtype=np.uint8)
    scale = np.abs(_rows((r, 1), 5, zero_row=False)) + np.float32(1e-12)
    m = _rows(shape, 6)
    want = jax.jit(lambda p, s, m: JR.dequant_unpack_accumulate_ref(
        p, s, m, bits))(packed, scale, m)
    pallas = JP.dequant_unpack_accumulate(packed, scale, m, bits=bits,
                                          interpret=True)
    got = TP.dequant_unpack_accumulate(_t(packed), _t(scale), _t(m),
                                       bits=bits)
    _eq(want, got)
    _eq(pallas, got)


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", BITS)
def test_quantize_pack_bit_parity(bits, shape, stochastic):
    x = _rows(shape, 7)
    u = _noise(shape, 8) if stochastic else None
    ju = None if u is None else jnp.asarray(u)
    want = jax.jit(lambda x, u: JR.quantize_pack_ref(x, bits, u))(x, ju)
    pallas = JP.quantize_pack(x, ju, bits=bits, interpret=True)
    got = TP.quantize_pack(_t(x), None if u is None else _t(u), bits=bits)
    for w, p, g in zip(want, pallas, got):
        _eq(w, g)
        _eq(p, g)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", BITS)
def test_unpack_dequant_bit_parity(bits, shape, out_dtype):
    r, d = shape
    rng = np.random.default_rng(9)
    packed = rng.integers(0, 256, (r, d * bits // 8), dtype=np.uint8)
    scale = np.abs(_rows((r, 1), 10, zero_row=False)) + np.float32(1e-12)
    jdt, tdt = jnp.dtype(out_dtype), getattr(torch, out_dtype)
    want = jax.jit(lambda p, s: JR.unpack_dequant_ref(p, s, bits).astype(
        jdt))(packed, scale)
    pallas = JP.unpack_dequant(packed, scale, bits=bits, out_dtype=jdt,
                               interpret=True)
    got = TP.unpack_dequant(_t(packed), _t(scale), bits=bits,
                            out_dtype=tdt)
    assert got.dtype == tdt and got.shape == (r, d)
    _eq(np.asarray(want, np.float32), got.float())
    _eq(np.asarray(pallas, np.float32), got.float())


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    """A CPU tensor goes to the plain version; only a kernel launch
    counts."""
    TP.reset_launches()
    x = _t(_rows((4, 64), 11))
    packed, scale = TP.quantize_pack(x, bits=8)
    TP.unpack_dequant(packed, scale, bits=8)
    p, s, mn = TP.delta_quantize_pack(x, torch.zeros_like(x), bits=4)
    TP.dequant_unpack_accumulate(p, s, torch.zeros_like(x), bits=4)
    assert set(TP.LAUNCHES.values()) == {0}


def test_ops_flatten_any_batch_shape():
    """`ops` flattens (..., d) to rows and restores the shape."""
    x = _t(_rows((6, 64), 12)).reshape(2, 3, 64)
    packed, scale = TO.quantize_pack(x, bits=4)
    assert packed.shape == (2, 3, 32) and scale.shape == (2, 3, 1)
    flat_p, flat_s = TP.quantize_pack(x.reshape(6, 64), bits=4)
    assert torch.equal(packed.reshape(6, 32), flat_p)
    back = TO.unpack_dequant(packed, scale, bits=4)
    assert torch.equal(back.reshape(6, 64),
                       TP.unpack_dequant(flat_p, flat_s, bits=4))
    pk, sc, mn = TO.boundary_compress(x, torch.zeros_like(x), bits=2)
    assert pk.shape == (2, 3, 16) and mn.shape == x.shape
    assert torch.equal(TO.boundary_decompress(pk, sc, torch.zeros_like(x),
                                              bits=2), mn)


# ---------------------------------------------------------------------------
# boundary ops (reference chain; auto resolves to it for CPU tensors)
# ---------------------------------------------------------------------------

BOUNDARY_BITS = [2, 4, 8, 3]         # 3: the reference-only ablation width


def _jax_noise(shape, stochastic):
    """The noise JAX's boundary draws from its key, shared with the
    port as ``u``."""
    key = jax.random.PRNGKey(0)
    u = np.asarray(jax.random.uniform(key, shape, jnp.float32)) \
        if stochastic else None
    return key, u


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", BOUNDARY_BITS)
def test_boundary_encode_delta_decode_accumulate(bits, stochastic):
    shape = (3, 7, 64)                        # (B, S, d): 21 ragged rows
    m = _rows((21, 64), 13, zero_row=False).reshape(shape)
    a = m + _rows((21, 64), 14).reshape(shape)
    key, u = _jax_noise(shape, stochastic)
    for be in ("reference", "pallas"):
        if be == "pallas" and bits not in JB.KERNEL_BITS:
            continue
        enc = jax.jit(lambda a, m: JB.encode_delta(
            a, m, bits=bits, stochastic=stochastic, key=key, backend=be))
        want = enc(a, m)
        got = TB.encode_delta(_t(a), _t(m), bits=bits, stochastic=stochastic,
                              u=None if u is None else _t(u))
        for w, g in zip(want, got):
            _eq(w, g)
        dec = jax.jit(lambda p, s, m: JB.decode_accumulate(
            p, s, m, bits=bits, backend=be))
        _eq(dec(want[0], want[1], m),
            TB.decode_accumulate(got[0], got[1], _t(m), bits=bits))
    # the receiver rebuilds the sender's buffer bit for bit
    assert torch.equal(TB.decode_accumulate(got[0], got[1], _t(m),
                                            bits=bits), got[2])


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", BOUNDARY_BITS)
def test_boundary_encode_decode_roundtrip(bits, stochastic):
    shape = (2, 5, 4, 64)                     # KV-append-like rows
    x = _rows((40, 64), 15).reshape(shape)
    key, u = _jax_noise(shape, stochastic)
    tu = None if u is None else _t(u)
    for be in ("reference", "pallas"):
        if be == "pallas" and bits not in JB.KERNEL_BITS:
            continue
        want = jax.jit(lambda x: JB.encode(x, bits=bits, stochastic=stochastic,
                                           key=key, backend=be))(x)
        got = TB.encode(_t(x), bits=bits, stochastic=stochastic, u=tu)
        for w, g in zip(want, got):
            _eq(w, g)
        dec = jax.jit(lambda p, s: JB.decode(p, s, bits=bits, d=64,
                                             backend=be))
        _eq(dec(*want), TB.decode(*got, bits=bits, d=64))
        rt = jax.jit(lambda x: JB.roundtrip(x, bits=bits, stochastic=stochastic,
                                            key=key, backend=be))
        _eq(rt(x), TB.roundtrip(_t(x), bits=bits, stochastic=stochastic,
                                u=tu))


def test_boundary_backend_resolution():
    x = torch.zeros(2, 8)
    assert TB.resolve_backend("auto", x, 4) == "reference"
    assert TB.resolve_backend("cuda", x, 3) == "reference"
    assert TB.resolve_backend("cuda", x, 4) == "cuda"
    with pytest.raises(ValueError):
        TB.resolve_backend("pallas", x, 4)
    with pytest.raises(ValueError, match="noise"):
        TB.encode(x, bits=4, stochastic=True)
    g = torch.Generator().manual_seed(0)
    p1 = TB.encode(x + 1, bits=4, stochastic=True, generator=g)
    assert p1[0].shape == (2, 4)


# ---------------------------------------------------------------------------
# quantization building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_pack_unpack_and_wire_bytes(bits):
    rng = np.random.default_rng(16)
    n = 37                                    # not a multiple of 8/bits
    codes = rng.integers(0, 1 << bits, (3, n), dtype=np.uint8)
    want = jax.jit(lambda c: JQ.pack_codes(c, bits))(codes)
    got = TQ.pack_codes(_t(codes), bits)
    _eq(want, got)
    _eq(JQ.unpack_codes(want, bits, n), TQ.unpack_codes(got, bits, n))
    assert TQ.packed_width(n, bits) == JQ.packed_width(n, bits)
    for shape in [(8, 1, 1600), (5, 64), (2, 3, 4, 37)]:
        assert TQ.wire_bytes(shape, bits) == JQ.wire_bytes(shape, bits)
    assert TQ.codes_per_byte(bits) == JQ.codes_per_byte(bits)


def test_fma_f32_rounds_once():
    """fma_f32 is the once-rounded p*r + m where a float64 sum rounded
    again to f32 is not: with p = 1 + 2**-20, r = 1 - 2**-20 and
    m = 2**24 + 2 the exact sum 2**24 + 3 - 2**-40 lies just below the
    f32 midpoint 2**24 + 3, but its float64 rounding IS that midpoint,
    which then ties to the even 2**24 + 4."""
    p = torch.tensor([1.0 + 2.0 ** -20], dtype=torch.float32)
    r = 1.0 - 2.0 ** -20
    m = torch.tensor([2.0 ** 24 + 2], dtype=torch.float32)
    assert TQ.fma_f32(p, r, m).item() == 2.0 ** 24 + 2
    assert (p.double() * r + m.double()).float().item() == 2.0 ** 24 + 4
    # and on ordinary values it is the plain float64 sum rounded once
    rng = np.random.default_rng(17)
    a, b = (_t(rng.standard_normal(1000).astype(np.float32))
            for _ in range(2))
    want = (a.double() * float(np.float32(1 / 3)) + b.double()).float()
    assert torch.equal(TQ.fma_f32(a, float(np.float32(1 / 3)), b), want)
