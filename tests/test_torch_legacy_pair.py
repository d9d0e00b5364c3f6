"""The gradient wire's legacy pair in the port against the JAX package.

`encode_with_scale` (packed codes against a given, shared row scale;
kernel B9a `quantize_pack_scaled`) and `decode_codes` (packed codes
back to int32; kernel B9b `unpack_codes`) are on no trainer's path in
either package: the JAX package reaches them only from
tests/test_grad_compress.py, its 10k-trial unbiasedness test and the
``_codec`` chain (sender -> int32 codes -> sum -> mean).  The same numpy
inputs, noise included, go through the port (CPU tensors, so the
kernels' plain versions) and through jitted JAX: its oracles, its
Pallas kernels in interpret mode, and both of its boundary backends.
Everything is bit for bit except the unbiasedness, which is the 5 sigma
harness of tests/test_grad_compress.py.  The kernels themselves are
held to the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Run: ``PYTHONPATH=src python -m pytest -q tests/test_torch_legacy_pair.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import boundary as JB
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro_torch.core import boundary as TB
from repro_torch.kernels import ops as TO
from repro_torch.kernels import quant_pack as TP
from repro_torch.kernels import ref as TR


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BITS = [2, 4, 8]
PORT_BACKENDS = ["reference", "cuda"]
# more rows than one Pallas block (128), and a ragged count below it
SHAPES = [(300, 512), (37, 256)]
KNOB = "ACSGD_ONCORE_PRNG"
N_TRIALS = 10_000


def _t(x):
    return None if x is None else torch.tensor(np.asarray(x))


def _bits_equal(jax_out, torch_out, msg=""):
    """Equal values, shapes and dtypes (f32 compared as bit patterns)."""
    a, b = np.asarray(jax_out), torch_out.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, \
        (msg, a.shape, b.shape, a.dtype, b.dtype)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _inputs(rows, d, seed, stochastic):
    """Gradient-like rows of mixed magnitude with an all-zero row, a
    shared scale 1.3x the row absmax with one zero row (clamped to
    1e-12 by every path), and uniform noise when stochastic."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    x *= np.logspace(-4, 1, rows, dtype=np.float32)[:, None]
    x[3] = 0.0
    s = (1.3 * np.abs(x).max(-1, keepdims=True)).astype(np.float32)
    s[7] = 0.0
    u = rng.random((rows, d), dtype=np.float32) if stochastic else None
    return x, s, u


# ---------------------------------------------------------------------------
# the two kernels' plain versions and wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", BITS)
def test_quantize_pack_scaled_matches_jax(bits, stochastic, shape):
    """B9a's plain version, its wrapper and the row-flattening op
    against JAX's oracle and interpret-mode Pallas (which pads the rows
    to its block and clamps the zero scale inside the kernel)."""
    rows, d = shape
    x, s, u = _inputs(rows, d, bits + rows, stochastic)
    got = TR.quantize_pack_scaled_ref(_t(x), _t(s), bits, _t(u))
    assert got.shape == (rows, d * bits // 8)
    _bits_equal(jax.jit(lambda x, s, u: JR.quantize_pack_scaled_ref(
        x, s, bits, u))(x, s, u), got, "oracle")
    _bits_equal(JO.quantize_pack_scaled(x, s, u, bits=bits), got, "pallas")
    assert torch.equal(TP.quantize_pack_scaled(_t(x), _t(s), _t(u),
                                               bits=bits), got)
    via_ops = TO.quantize_pack_scaled(
        _t(x).reshape(1, rows, d), _t(s).reshape(1, rows, 1),
        None if u is None else _t(u).reshape(1, rows, d), bits=bits)
    assert torch.equal(via_ops.reshape(got.shape), got)
    # the zero scale row quantizes against 1e-12, not to NaN codes
    u7 = None if u is None else _t(u[7:8])
    assert torch.equal(got[7], TR.quantize_pack_scaled_ref(
        _t(x[7:8]), torch.full((1, 1), 1e-12), bits, u7)[0])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", BITS)
def test_unpack_codes_matches_jax(bits, shape):
    """B9b's plain version, its wrapper and the op against JAX's oracle
    and interpret-mode Pallas, over every byte value."""
    rows, d = shape
    packed = np.random.default_rng(bits + rows).integers(
        0, 256, (rows, d * bits // 8)).astype(np.uint8)
    packed[0] = 0
    packed[1] = 255
    got = TR.unpack_codes_ref(_t(packed), bits)
    assert got.dtype == torch.int32 and got.shape == (rows, d)
    _bits_equal(jax.jit(lambda p: JR.unpack_codes_ref(p, bits))(packed), got,
                "oracle")
    _bits_equal(JO.unpack_codes(packed, bits=bits), got, "pallas")
    assert torch.equal(TP.unpack_codes(_t(packed), bits=bits), got)
    via_ops = TO.unpack_codes(_t(packed)[None], bits=bits)
    assert torch.equal(via_ops[0], got)
    assert int(got.max()) == (1 << bits) - 1 and int(got.min()) == 0


# ---------------------------------------------------------------------------
# the boundary ops and the test chain of the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", range(1, 9))
def test_legacy_pair_matches_jax(bits, stochastic):
    """`encode_with_scale` and `decode_codes` on both of the port's
    backends against JAX's on both of its, bits 1-8: raw codes where
    the width does not pack to whole bytes, `pack_codes` at bit 1, the
    kernels at 2/4/8 (the other widths take the reference chain)."""
    rows, d = 37, 256
    x, s, u = _inputs(rows, d, 40 + bits, stochastic)
    want = {}
    for be in ("reference", "pallas"):
        want[be] = jax.jit(lambda x, s, u: (lambda p: (p, JB.decode_codes(
            p, bits=bits, d=d, backend=be)))(JB.encode_with_scale(
                x, s, bits=bits, stochastic=stochastic, noise=u,
                backend=be)))(x, s, u)
    for be in PORT_BACKENDS:
        packed = TB.encode_with_scale(_t(x), _t(s), bits=bits,
                                      stochastic=stochastic, u=_t(u),
                                      backend=be)
        codes = TB.decode_codes(packed, bits=bits, d=d, backend=be)
        for jbe, (jp, jc) in want.items():
            _bits_equal(jp, packed, f"packed {be} vs {jbe}")
            _bits_equal(jc, codes, f"codes {be} vs {jbe}")
    width = d * bits // 8 if bits in (1, 2, 4, 8) else d
    assert packed.shape == (rows, width) and packed.dtype == torch.uint8


def _jax_codec(bits, stochastic, backend):
    """tests/test_grad_compress.py's ``_codec`` with the noise as an
    input: sender -> int32 codes -> the mean of three equal workers."""
    @jax.jit
    def run(v, s, u):
        packed = JB.encode_with_scale(v, s, bits=bits, stochastic=stochastic,
                                      noise=u, backend=backend)
        codes = JB.decode_codes(packed, bits=bits, d=v.shape[-1],
                                backend=backend)
        mean = JB.decode_sum_mean(codes * 3, s, bits=bits, n=3,
                                  backend=backend)
        return packed, codes, mean
    return run


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", BITS)
def test_codec_chain_matches_jax(bits, stochastic):
    """The whole ``_codec`` chain, bit for bit: packed bytes, codes and
    means, an all-zero row whose raw zero scale both ends clamp."""
    rng = np.random.default_rng(7)
    v = rng.standard_normal((37, 256)).astype(np.float32)
    v[5] = 0.0
    s = (np.float32(1.17) * np.abs(v).max(-1, keepdims=True)).astype(
        np.float32)
    u = rng.random(v.shape, dtype=np.float32) if stochastic else None
    for be in PORT_BACKENDS:
        packed = TB.encode_with_scale(_t(v), _t(s), bits=bits,
                                      stochastic=stochastic, u=_t(u),
                                      backend=be)
        codes = TB.decode_codes(packed, bits=bits, d=256, backend=be)
        mean = TB.decode_sum_mean(codes * 3, _t(s), bits=bits, n=3,
                                  backend=be)
        for jbe in ("reference", "pallas"):
            want = _jax_codec(bits, stochastic, jbe)(v, s, u)
            for name, w, g in zip(("packed", "codes", "mean"), want,
                                  (packed, codes, mean)):
                _bits_equal(w, g, f"{name} {be} vs {jbe}")


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", BITS)
def test_legacy_pair_equals_fused_sender(bits, stochastic):
    """The pair's packed bytes and codes equal the fused sender's
    (`encode_codes_with_scale(pack=True)`, B5) on the same noise: the
    round trip costs bytes, not bits."""
    x, s, u = _inputs(300, 512, 60 + bits, stochastic)
    for be in PORT_BACKENDS:
        kw = dict(bits=bits, stochastic=stochastic, u=_t(u), backend=be)
        packed = TB.encode_with_scale(_t(x), _t(s), **kw)
        codes = TB.decode_codes(packed, bits=bits, d=512, backend=be)
        fused_packed, fused_codes = TB.encode_codes_with_scale(
            _t(x), _t(s), pack=True, **kw)
        assert torch.equal(packed, fused_packed)
        assert torch.equal(codes, fused_codes)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("bits", [2, 4])
def test_stochastic_legacy_sender_unbiased_10k_trials(bits, backend):
    """tests/test_grad_compress.py's harness through the port: E[Q(x)]
    = x over 10k independent draws (one call over x tiled 10k times, its
    noise drawn from the generator), within 5 sigma of the grid."""
    x = np.random.default_rng(5).standard_normal((4, 64)).astype(np.float32)
    scale = np.maximum(np.abs(x).max(-1, keepdims=True), np.float32(1e-12))
    xt = _t(x).repeat(N_TRIALS, 1)
    st = _t(scale).repeat(N_TRIALS, 1)
    packed = TB.encode_with_scale(xt, st, bits=bits, stochastic=True,
                                  generator=torch.Generator().manual_seed(6),
                                  backend=backend)
    q = TB.decode(packed, st, bits=bits, d=64, backend=backend)
    est = q.reshape(N_TRIALS, 4, 64).double().mean(0).numpy()
    cell = 2.0 * scale / ((1 << bits) - 1)
    bound = 5.0 * cell / (2.0 * np.sqrt(N_TRIALS))
    err = np.abs(est - x)
    assert np.max(err / bound) < 1.0, float(np.max(err / bound))


@pytest.mark.parametrize("bits", BITS)
def test_knob_does_not_seed_the_legacy_sender(bits, monkeypatch):
    """B9a has no seeded variant (nor has the Pallas kernel): with the
    on-core noise knob on and the cuda backend forced (its plain
    versions, on CPU tensors), `encode_with_scale` still draws u from
    the generator, so its bytes equal the reference backend's from an
    equally seeded generator, and nothing counts as a seeded launch."""
    x, s, _ = _inputs(37, 256, 80 + bits, False)

    def run(backend):
        return TB.encode_with_scale(
            _t(x), _t(s), bits=bits, stochastic=True, backend=backend,
            generator=torch.Generator().manual_seed(9))

    drawn_u = torch.rand(x.shape, generator=torch.Generator().manual_seed(9))
    want = TB.encode_with_scale(_t(x), _t(s), bits=bits, stochastic=True,
                                u=drawn_u, backend="reference")
    monkeypatch.setenv(KNOB, "1")
    TP.reset_launches()
    assert torch.equal(run("cuda"), want)
    assert torch.equal(run("reference"), want)
    assert TP.LAUNCHES["oncore_uniform"] == 0
    monkeypatch.setenv(KNOB, "0")
    assert torch.equal(run("cuda"), want)


def test_legacy_wrappers_on_cpu_count_nothing_and_check():
    """CPU tensors go to the plain versions and count no launch; both
    counters exist; the boundary ops need noise when stochastic."""
    TP.reset_launches()
    x = torch.ones(4, 512)
    s = torch.ones(4, 1)
    packed = TP.quantize_pack_scaled(x, s, bits=4)
    TP.unpack_codes(packed, bits=4)
    TO.unpack_codes(TO.quantize_pack_scaled(x[None], s[None], bits=2),
                    bits=2)
    TB.decode_codes(TB.encode_with_scale(x, s, bits=8, backend="cuda"),
                    bits=8, d=512, backend="cuda")
    assert TP.LAUNCHES["quantize_pack_scaled"] == 0
    assert TP.LAUNCHES["unpack_codes"] == 0
    assert set(TP.LAUNCHES.values()) == {0}
    assert torch.equal(TP.unpack_codes(packed, bits=4),
                       torch.full((4, 512), 15, dtype=torch.int32))
    with pytest.raises(ValueError, match="Generator"):
        TB.encode_with_scale(x, s, bits=4, stochastic=True)
