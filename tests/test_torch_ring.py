"""The port's compressed ring DP wire against the JAX package and against
its own simulator, over gloo processes.

* The ring's integer steps (B7 `unpack_accumulate`, B8a `pack_sums`,
  B8b `unpack_sums`): the port's plain versions equal the JAX package's
  oracles (`repro.kernels.ref`), its reference chain and its Pallas
  kernels in interpret mode, bit for bit, over bits 2/4/8, every sum
  width (2, 4, 8, 16 and 32 bits) and row counts that are not a
  multiple of the Pallas block.
* `ring_chunk_bounds` and `ring_wire_bytes` equal the JAX package's.
* Over 2, 3 and 5 gloo processes, each holding a DISTINCT bucket whose
  rows do not divide by the ring size: the ``ring`` wire (1, 2 and 3
  chunks) and the ``psum`` wire equal the port's single-process
  `grad_compress.compress_allreduce` bit for bit (mean and carry, two
  steps so the carry telescopes), deterministic and with noise drawn
  once here and handed to both; each rank's bytes equal
  `ring_wire_bytes`, and its calls the registry's manifest (the gate of
  tests/workers/dp_grad_worker.py).
* In the same processes, the seeded path (the on-core noise knob): the
  wires handed a generator and no noise on the cuda backend (its plain
  versions, on these CPU tensors) with the knob on equal, for the
  monolithic ``psum``, ``ring`` and ``ring-sharded``, the reference wire
  fed `oncore_uniform_ref` under the seed that generator gives, bit for
  bit (mean and carry, two steps); the chunked ring and ZeRO wire do
  not change with the knob (they keep one full-bucket noise tensor, as
  JAX's chunk encoder does); and without the knob every wire equals the
  reference wire fed the generator's own draw.
"""
import collections

import jax
import numpy as np
import pytest
import torch

from repro.core import boundary as JB
from repro.core import collectives as JC
from repro.core import quantization as JQ
from repro.kernels import ref as JR
from repro_torch.comm import wires as TW
from repro_torch.core import boundary as TB
from repro_torch.core import collectives as TC
from repro_torch.core import grad_compress as TG
from repro_torch.core import quantization as TQ
from repro_torch.kernels import quant_pack as TP
from repro_torch.launch.mesh import spawn

from test_torch_mesh import CASES, SEEDED, wire_worker


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BITS = [2, 4, 8]
# (bits, n) giving each sum width: 2, 4, 8, 16 and 32 bits
SUM_WIDTH_CASES = [(2, 1), (2, 3), (4, 1), (4, 2), (8, 2), (8, 300)]
GROUP = 128
SPAWN_TIMEOUT = 120


def _t(x):
    return torch.tensor(np.asarray(x))


def _equal(jax_out, torch_out):
    a, b = np.asarray(jax_out), torch_out.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, \
        (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the three kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [37, 130])
@pytest.mark.parametrize("bits", BITS)
def test_unpack_accumulate_matches_jax(bits, rows):
    rng = np.random.default_rng(bits + rows)
    d = 512
    packed = rng.integers(0, 256, (rows, d * bits // 8), dtype=np.uint8)
    acc = rng.integers(0, 1 << 20, (rows, d), dtype=np.int32)
    got = TP.unpack_accumulate(_t(packed), _t(acc), bits=bits)
    _equal(JR.unpack_accumulate_ref(packed, acc, bits), got)
    for be in ("reference", "pallas"):
        _equal(jax.jit(lambda p, a: JB.accumulate_codes(
            p, a, bits=bits, backend=be))(packed, acc), got)
    _equal(jax.jit(lambda p, a: JB.accumulate_codes(
        p, a, bits=bits, backend="reference"))(packed, acc),
        TB.accumulate_codes(_t(packed), _t(acc), bits=bits,
                            backend="reference"))


@pytest.mark.parametrize("rows", [37, 130])
@pytest.mark.parametrize("bits,n", SUM_WIDTH_CASES)
def test_sum_packers_match_jax(bits, n, rows):
    rng = np.random.default_rng(bits * n + rows)
    d = 512
    sw = TQ.sum_wire_bits(bits, n)
    assert sw == JQ.sum_wire_bits(bits, n)
    hi = min(n * ((1 << bits) - 1), 2 ** 31 - 1)
    total = rng.integers(0, hi + 1, (rows, d), dtype=np.int64).astype(
        np.int32)
    total[0, :4] = [0, hi, hi - 1, 1]
    packed = TP.pack_sums(_t(total), bits=bits, n=n)
    assert packed.shape == (rows, TQ.sum_packed_width(d, bits, n))
    _equal(JR.pack_sums_ref(total, bits, n), packed)
    _equal(JQ.pack_sums(total, bits, n), TQ.pack_sums(_t(total), bits, n))
    back = TP.unpack_sums(packed, bits=bits, n=n)
    np.testing.assert_array_equal(back.numpy(), total)
    _equal(JR.unpack_sums_ref(np.asarray(packed), bits, n), back)
    for be in ("reference", "pallas"):
        _equal(jax.jit(lambda t: JB.pack_sums(t, bits=bits, n=n,
                                              backend=be))(total), packed)
        _equal(jax.jit(lambda p: JB.unpack_sums(
            p, bits=bits, n=n, d=d, backend=be))(np.asarray(packed)),
            TB.unpack_sums(packed, bits=bits, n=n, d=d))


def test_sum_packer_checks():
    with pytest.raises(ValueError):      # 4 sums a byte at 2 bits
        TP._check_sum_width(2, 1, 6)
    with pytest.raises(ValueError):
        TP._check_sum_width(3, 2, 8)
    assert TP._check_sum_width(8, 2, 6) == 16


# ---------------------------------------------------------------------------
# geometry and bytes
# ---------------------------------------------------------------------------

def test_ring_chunk_bounds_match_jax():
    for seg in (1, 2, 5, 7, 64, 100):
        for chunks in range(1, seg + 1):
            assert TC.ring_chunk_bounds(seg, chunks) \
                == JC.ring_chunk_bounds(seg, chunks), (seg, chunks)
    assert len(TC.ring_chunk_bounds(7, 4)) == 4
    assert len(TC.ring_chunk_bounds(10, 4)) == 4
    assert len(TC.ring_chunk_bounds(9, 4)) == 3     # fewer than asked
    for bad in (0, -1, 1.5, True, None):
        with pytest.raises(ValueError, match="positive int"):
            TC.ring_chunk_bounds(5, bad)
    with pytest.raises(ValueError, match="exceeds"):
        TC.ring_chunk_bounds(5, 6)


def test_ring_wire_bytes_match_jax():
    for shape in ((1, 512), (7, 512), (637107, 512), (100, 64)):
        for bits in BITS:
            for n in (1, 2, 3, 5, 8):
                seg = TC.ring_segment_rows(shape[0], n)
                for chunks in sorted({1, 2, 3} & set(range(1, seg + 1))):
                    assert TC.ring_wire_bytes(shape, bits, n, chunks=chunks) \
                        == JC.ring_wire_bytes(shape, bits, n, chunks=chunks)
                ring = TW.get_wire("ring")
                assert ring.wire_bytes(shape, bits, n) \
                    == JC.ring_wire_bytes(shape, bits, n)
                if n > 1:
                    man = ring.expected_collectives(shape, bits, n)
                    assert sum(b * c for _, _, b, c in man) \
                        == ring.wire_bytes(shape, bits, n)
                    man = TW.get_wire("psum").expected_collectives(
                        shape, bits, n)
                    assert sum(b * c for _, _, b, c in man) \
                        == TW.get_wire("psum").wire_bytes(shape, bits, n)
    with pytest.raises(ValueError):
        TC.ring_wire_bytes((4, 512), 4, 2, chunks=3)


# ---------------------------------------------------------------------------
# the wires over gloo processes against the simulator
# ---------------------------------------------------------------------------

def _trees(step, n):
    """n distinct gradient trees of 10092 elements: with GROUP=128 a
    bucket of 79 rows, a multiple of none of the ring sizes."""
    rng = np.random.default_rng(100 + step)
    out = []
    for _ in range(n):
        out.append([torch.tensor(rng.standard_normal(shape) * sd,
                                 dtype=torch.float32)
                    for shape, sd in (((57, 33), 1.0), ((19,), 1.0),
                                      ((4096, 2), 0.3))])
    return out


def _merged(rows):
    c = collections.Counter()
    for kind, dt, b, count in rows:
        c[(kind, dt, b)] += count
    return c


@pytest.fixture(scope="module", params=[2, 3, 5])
def wire_runs(request, tmp_path_factory):
    """One spawn of `wire_worker` over n ranks: (n, bits, layout,
    every rank's results)."""
    n = request.param
    bits = 4 if n != 3 else 8          # n=3 at 8 bits: 16-bit sums
    lay = TG.bucket_layout(_trees(0, 1)[0], GROUP)
    assert lay.rows % n, lay.rows
    inputs = {"shape": (lay.rows, lay.group_d), "bits": bits,
              "v": [], "noise": []}
    for step in range(2):
        inputs["v"].append([TG.flatten_bucket(t, lay).numpy()
                            for t in _trees(step, n)])
        g = torch.Generator().manual_seed(7 + step)
        inputs["noise"].append([torch.rand(lay.rows, lay.group_d,
                                           generator=g).numpy()
                                for _ in range(n)])
    results = spawn(wire_worker, n, (inputs,), timeout=SPAWN_TIMEOUT,
                    store_dir=tmp_path_factory.mktemp("ring"))
    return n, bits, lay, results


def test_wires_match_simulator_over_gloo(wire_runs):
    n, bits, lay, results = wire_runs
    inputs = {"shape": (lay.rows, lay.group_d)}
    for stochastic in (False, True):
        err_s = torch.zeros(n, lay.rows, lay.group_d)
        for step in range(2):
            trees = _trees(step, n)
            mean_s, err_s = TG.compress_allreduce(
                trees, err_s, bits, stochastic=stochastic,
                generator=torch.Generator().manual_seed(7 + step),
                backend="reference", layout=lay)
            live_s = TG.flatten_bucket(mean_s, lay).reshape(-1)[:lay.total]
            ref_mean = results[0][(stochastic, "psum", 1)][step][0]
            bits_of = lambda a: torch.from_numpy(a).view(torch.int32)
            for r in range(n):
                for case in CASES:
                    mean, err, nbytes, manifest = \
                        results[r][(stochastic, *case)][step]
                    # every wire and every rank: the psum mean, bit for bit
                    assert torch.equal(bits_of(mean), bits_of(ref_mean)), \
                        (r, case)
                    assert torch.equal(bits_of(mean).reshape(-1)[:lay.total],
                                       live_s.view(torch.int32)), \
                        (r, case, step)
                    assert torch.equal(bits_of(err),
                                       err_s[r].view(torch.int32)), \
                        (r, case, step)
                    spec = TW.get_wire(case[0])
                    assert nbytes == spec.wire_bytes(
                        inputs["shape"], bits, n), (r, case)
                    if case[1] == 1:       # chunks cut the hops smaller
                        assert _merged(manifest) == _merged(
                            spec.expected_collectives(inputs["shape"], bits,
                                                      n)), (r, case)


def test_seeded_wires_over_gloo(wire_runs):
    n, _, _, results = wire_runs

    def same(a, b):
        return all(np.array_equal(x.view(np.int32), y.view(np.int32))
                   for p, q in zip(a, b) for x, y in zip(p, q))

    for r in range(n):
        for wire, chunks in SEEDED:
            on, off, oncore, drawn = (results[r][(v, wire, chunks)] for v in
                                      ("1", "0", "oncore-u", "drawn-u"))
            assert same(off, drawn), (r, wire, chunks)
            if chunks == 1:
                assert same(on, oncore), (r, wire)
                assert not same(on, off), (r, wire)
            else:
                assert same(on, off), (r, wire, chunks)


def test_single_rank_ring_is_the_n1_codec():
    """A ring of one rank (D = 1) decodes its own codes, no calls."""
    import torch.distributed as dist

    class _One:
        size, index = 1, 0

        def all_reduce(self, x, op=dist.ReduceOp.SUM):
            return x

    v = torch.randn(9, 64)
    mean, err = TC.ring_ef_reduce_mean_bucket(v, torch.zeros_like(v), _One(),
                                              4, stochastic=False)
    s = torch.clamp(TG.local_scale(v), min=TQ._EPS)
    _, codes, want_err = TG.ef_encode(v, s, 4, stochastic=False)
    assert torch.equal(err, want_err)
    assert torch.equal(mean, TB.decode_sum_mean(codes, s, bits=4, n=1))
