"""The encoders at rows wider than 256 values (B1, B3 and their seeded
path): the tiling the wrapper picks, and the port's functions bit for
bit against the JAX package at that tiling's edges.

`quant_pack._encode_tiling(d, delta)` is what the wrappers pass the
kernel launcher (``csrc/quant_pack.cu`` ``launch_encode_bits``): a lane
group a row for rows of up to 256 values (the KV plane), a block of
whole warps for wider rows (4 float4s a thread for B3, 2 for B1, which
holds m too), read once up to 8192 values and walked twice past that.
On the CPU the wrappers run their plain versions (the card holds the
kernels to those: ``tests/test_torch_cuda.py``), so the parity cases
hold the functions' bits at those widths against jitted JAX and
interpret-mode Pallas: 260 (the first width past 256), 3584 (gemma2's
hop) and 8196 (the first past the register cap), a few rows each, bits
2/4/8, deterministic, with noise u, and seeded (JAX fed the port's
Philox draw as its u).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant_pack as JP
from repro.kernels import ref as JR
from repro_torch.kernels import quant_pack as TP
from repro_torch.kernels import ref as TR


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BITS = [2, 4, 8]
LANE_GROUPS = {(8, 1), (16, 1), (32, 2)}     # the launcher's lane groups
CAP = TP.ROW_VALUES                          # widest row read once: 8192
PARITY_WIDTHS = [260, 3584, CAP + 4]


def _check_tiling(d, delta):
    tpr, nv = TP._encode_tiling(d, delta)
    n4 = -(-d // 4)
    if d <= 256:
        assert (tpr, nv) in LANE_GROUPS, (d, tpr, nv)
        assert tpr * nv >= n4, (d, tpr, nv)
        return
    assert nv == TP.ROW_NV[delta] <= 4, (d, nv)
    assert tpr % 32 == 0 and 32 <= tpr <= 1024, (d, tpr)
    assert 4 * tpr * nv <= CAP, (d, tpr, nv)       # the launch bound
    if d <= CAP:                       # one pass: the row in registers
        assert 4 * tpr * nv >= d, (d, tpr, nv)
        assert 4 * (tpr - 32) * nv < d, (d, tpr)      # the fewest warps
    else:                              # two passes, the widest block
        assert 4 * tpr * nv == CAP, (d, tpr)


@pytest.mark.parametrize("delta", [False, True])
def test_tiling_covers_every_width_of_a_sweep(delta):
    """Every d from 1 to 20000 (past twice the cap): a lane group up to
    256 values, then a block of the fewest whole warps whose threads and
    float4s cover the row up to the cap, the widest block past it."""
    for d in range(1, 20001):
        _check_tiling(d, delta)


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("d", [4, 32, 64, 128, 256])
def test_kv_rows_keep_their_lane_group(d, delta):
    """The KV plane's rows (group_d 32, head_dim 64, 128, 256) keep
    their lane group: as many lanes as float4s, up to a warp."""
    assert TP._encode_tiling(d, delta) == {
        4: (8, 1), 32: (8, 1), 64: (16, 1), 128: (32, 2), 256: (32, 2)}[d]


def test_paths_widths_tile_without_idle_warps():
    """The hops' and the training boundary's widths: B3 at 1600 -> 128
    x 4 (400 float4s in 512 slots), 3584 -> 224 x 4 (exact), gemma2-27b's
    4608 -> 288 x 4 and stablelm-12b's 5120 -> 320 x 4 (exact); B1 twice
    the threads with 2 float4s each."""
    widths = (1600, 3584, 4608, 5120)
    assert [TP._encode_tiling(d) for d in widths] == \
        [(128, 4), (224, 4), (288, 4), (320, 4)]
    assert [TP._encode_tiling(d, delta=True) for d in widths] == \
        [(224, 2), (448, 2), (576, 2), (640, 2)]


def _rows(r, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((r, d)).astype(np.float32)
    x *= np.logspace(-3, 2, r, dtype=np.float32)[:, None]
    return x


def _noise(r, d, kind, seed=(3, -4)):
    """(noise for JAX as u, the port's keywords): none, a numpy u, or a
    seed whose Philox draw JAX gets as u."""
    if kind == "none":
        return None, {}
    if kind == "u":
        u = np.random.default_rng(d).random((r, d), dtype=np.float32)
        return u, {"u": torch.from_numpy(u)}
    sd = torch.tensor(seed, dtype=torch.int32)
    return TR.oncore_uniform_ref(sd, r, d).numpy(), {"seed": sd}


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


@pytest.mark.parametrize("noise", ["none", "u", "seed"])
@pytest.mark.parametrize("d", PARITY_WIDTHS)
@pytest.mark.parametrize("bits", BITS)
def test_wide_row_delta_quantize_pack_bit_parity(bits, d, noise):
    r = 3
    m = _rows(r, d, 1)
    a = m + _rows(r, d, 2)
    a[0] = m[0]                           # a zero delta: scale 1e-12
    u, kw = _noise(r, d, noise)
    ju = None if u is None else jnp.asarray(u)
    want = jax.jit(lambda a, m, u: JR.delta_quantize_pack_ref(
        a, m, bits, u))(a, m, ju)
    pallas = JP.delta_quantize_pack(a, m, ju, bits=bits, interpret=True)
    got = TP.delta_quantize_pack(torch.from_numpy(a), torch.from_numpy(m),
                                 bits=bits, **kw)
    for w, p, g in zip(want, pallas, got):
        _eq(w, g)
        _eq(p, g)


@pytest.mark.parametrize("noise", ["none", "u", "seed"])
@pytest.mark.parametrize("d", PARITY_WIDTHS)
@pytest.mark.parametrize("bits", BITS)
def test_wide_row_quantize_pack_bit_parity(bits, d, noise):
    r = 5
    x = _rows(r, d, 7)
    x[1] = 0.0
    u, kw = _noise(r, d, noise)
    ju = None if u is None else jnp.asarray(u)
    want = jax.jit(lambda x, u: JR.quantize_pack_ref(x, bits, u))(x, ju)
    pallas = JP.quantize_pack(x, ju, bits=bits, interpret=True)
    got = TP.quantize_pack(torch.from_numpy(x), bits=bits, **kw)
    for w, p, g in zip(want, pallas, got):
        _eq(w, g)
        _eq(p, g)
