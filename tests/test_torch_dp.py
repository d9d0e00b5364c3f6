"""The port's data-parallel gradient wire against the JAX package.

The same numpy inputs go through the port (CPU tensors, so the plain
versions of the kernels) and through JITTED JAX on both of its
backends: the reference chain and the Pallas kernels in interpret mode.

* The sender (`quantize_codes_scaled`, codes against a given row scale)
  and the receiver (`dequant_sum_mean`, the mean from an int32 code sum)
  are bit-equal on both backends.  Under jit XLA folds the receiver's
  ``((ic * s) / lv) / n`` into ``(ic * s) * C`` with
  ``C = f32(f32(1/lv) * f32(1/n))``, and the port multiplies by that C.
* The error-feedback carry ``v - q`` is bit-equal to the Pallas
  backend, where ``q`` leaves the kernel rounded.  On the reference
  backend XLA fuses ``v - p * C`` into one FMA, so the carry there
  differs by at most one ulp of the larger of the dequantized value
  ``q`` and the carry (with deterministic rounding the carry is at most
  half a grid step, never above |q|, so that is one ulp of ``q``; the
  carry alone can be near zero, so an ulp of it says nothing); codes
  and means are identical.  The
  buckets here have more rows than the Pallas block (128): with a grid
  of one block, interpret mode inlines the kernel and XLA fuses the
  carry on that backend too, which a compiled kernel never allows.
* Bucket layouts follow ``jax.tree.leaves`` order, and the wire byte
  models equal the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import faults as JF
from repro.comm import wires as JW
from repro.configs.base import get_config as jget
from repro.core import boundary as JB
from repro.core import grad_compress as JG
from repro.core import quantization as JQ
from repro.models import model as Mo
from repro_torch.comm import faults as TF
from repro_torch.comm import wires as TW
from repro_torch.comm.config import CommConfig, PlaneConfig
from repro_torch.configs.base import get_config as tget
from repro_torch.core import boundary as TB
from repro_torch.core import grad_compress as TG
from repro_torch.core import quantization as TQ
from repro_torch.kernels import ops as TO
from repro_torch.kernels import quant_pack as TP
from repro_torch.weights import from_jax_params, jax_leaves


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BITS = [2, 4, 8]
BACKENDS = ["reference", "pallas"]


def _t(x):
    return torch.tensor(np.asarray(x))


def _bits_equal(jax_out, torch_out):
    """Equal bit patterns (so -0 != +0 and NaN payloads count)."""
    a, b = np.asarray(jax_out), torch_out.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, \
        (a.shape, b.shape, a.dtype, b.dtype)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


def _bucket(rows, d, seed):
    """A compensated-gradient-like bucket: mixed row magnitudes, one
    all-zero row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    x *= np.logspace(-6, 1, rows, dtype=np.float32)[:, None]
    x[1] = 0.0
    return x


def _scale(x, seed):
    """A shared scale at or above each row's absmax, one zero row (the
    sender clamps it at 1e-12)."""
    rng = np.random.default_rng(seed)
    s = np.abs(x).max(-1, keepdims=True) \
        * (1.0 + rng.random((x.shape[0], 1))).astype(np.float32)
    s[1] = 0.0
    return s.astype(np.float32)


def _carry_ulps(err, jax_err, q):
    """|err - jax_err| in units of the last place of max(|q|, |err|),
    q the dequantized value (f32)."""
    err = np.asarray(err, np.float32)
    diff = np.abs(err.astype(np.float64)
                  - np.asarray(jax_err, np.float64))
    big = np.maximum(np.abs(np.asarray(q, np.float32)), np.abs(err))
    return diff / np.spacing(big)


# ---------------------------------------------------------------------------
# the two kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", BITS)
def test_quantize_codes_scaled_matches_jax(bits, stochastic, pack):
    rows, d = 37, 512                            # ragged against block 128
    x = _bucket(rows, d, bits)
    s = _scale(x, bits + 1)
    u = np.random.default_rng(bits + 2).random((rows, d), dtype=np.float32) \
        if stochastic else None
    got = TP.quantize_codes_scaled(_t(x), _t(s), None if u is None else _t(u),
                                   bits=bits, pack=pack)
    got = got if pack else (got,)
    for be in BACKENDS:
        want = jax.jit(lambda x, s, u: JB.encode_codes_with_scale(
            x, s, bits=bits, stochastic=stochastic, noise=u, pack=pack,
            backend=be))(x, s, u)
        want = want if pack else (want,)
        for w, g in zip(want, got):
            _bits_equal(w, g)
    # and through the boundary op and the row-flattening wrapper
    tu = None if u is None else _t(u)
    via_b = TB.encode_codes_with_scale(_t(x), _t(s), bits=bits,
                                       stochastic=stochastic, u=tu,
                                       pack=pack)
    via_o = TO.quantize_codes_scaled(_t(x).reshape(1, rows, d),
                                     _t(s).reshape(1, rows, 1),
                                     None if tu is None
                                     else tu.reshape(1, rows, d),
                                     bits=bits, pack=pack)
    for a, b, c in zip(got, via_b if pack else (via_b,),
                       via_o if pack else (via_o,)):
        assert torch.equal(a, b) and torch.equal(a, c.reshape(a.shape))


@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("bits", BITS)
def test_dequant_sum_mean_matches_jax(bits, n):
    rows, d = 37, 512
    rng = np.random.default_rng(10 * bits + n)
    total = rng.integers(0, n * ((1 << bits) - 1) + 1, (rows, d)
                         ).astype(np.int32)
    s = (rng.random((rows, 1)) * 4).astype(np.float32)
    s[2] = 0.0
    got = TP.dequant_sum_mean(_t(total), _t(s), bits=bits, n=n)
    for be in BACKENDS:
        want = jax.jit(lambda t, s: JB.decode_sum_mean(
            t, s, bits=bits, n=n, backend=be))(total, s)
        _bits_equal(want, got)
    assert torch.equal(got, TB.decode_sum_mean(_t(total), _t(s), bits=bits,
                                               n=n))
    assert torch.equal(got, TO.dequant_sum_mean(
        _t(total).reshape(1, rows, d), _t(s).reshape(1, rows, 1), bits=bits,
        n=n).reshape(rows, d))


def test_sum_mean_factor_is_the_folded_constant():
    """For bits 4, n 3 the jitted HLO multiplies by 0.0222222246, which
    is not f32(1/45)."""
    assert np.float32(TQ.sum_mean_factor(4, 3)) == np.float32(0.0222222246)
    assert np.float32(TQ.sum_mean_factor(4, 3)) != np.float32(1 / 45)
    assert TQ.sum_mean_factor(8, 1) == TQ.rcp_levels(8)


def test_dp_wrappers_on_cpu_count_nothing_and_check_n():
    TP.reset_launches()
    x = torch.ones(4, 512)
    codes = TP.quantize_codes_scaled(x, torch.ones(4, 1), bits=4)
    TP.dequant_sum_mean(codes, torch.ones(4, 1), bits=4, n=1)
    assert set(TP.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):
        TB.decode_sum_mean(codes, torch.ones(4, 1), bits=4, n=0)


# ---------------------------------------------------------------------------
# error feedback and the simulated allreduce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", BITS)
def test_ef_encode_matches_jax(bits, stochastic):
    v = _bucket(300, 64, 20 + bits)            # > one Pallas block
    s = np.maximum(np.abs(v).max(-1, keepdims=True), np.float32(1e-12))
    key = jax.random.PRNGKey(bits)
    u = np.asarray(jax.random.uniform(key, v.shape, jnp.float32)) \
        if stochastic else None
    _, codes, err = TG.ef_encode(_t(v), _t(s), bits, stochastic=stochastic,
                                 u=None if u is None else _t(u))
    for be in BACKENDS:
        _, jc, je = jax.jit(lambda v, s: JG.ef_encode(
            v, s, bits, key, stochastic=stochastic, backend=be))(v, s)
        _bits_equal(jc, codes)
        if be == "pallas":
            _bits_equal(je, err)
        else:
            q = TB.decode_sum_mean(codes, _t(s), bits=bits, n=1)
            assert _carry_ulps(err, je, q).max() <= 1.0


def _tree(seed):
    """A multi-leaf gradient tree whose bucket (group 64) has 177 rows,
    the last one ragged; returned in jax.tree.leaves order for the
    port."""
    rng = np.random.default_rng(seed)
    t = {"b": rng.standard_normal((300, 37)).astype(np.float32),
         "a": {"w": rng.standard_normal((5, 7, 3)).astype(np.float32)
               * np.float32(1e-3),
               "s": rng.standard_normal((64,)).astype(np.float32)}}
    return t, [_t(x) for x in jax.tree.leaves(t)]


def test_compress_allreduce_matches_jax():
    """3 workers, deterministic rounding, a carried error in."""
    n, bits = 3, 4
    trees = [_tree(30 + i) for i in range(n)]
    jlay = JG.bucket_layout(trees[0][0], 64)
    tlay = TG.bucket_layout(trees[0][1], 64)
    assert (tlay.sizes, tlay.shapes, tlay.rows, tlay.pad) == \
        (jlay.sizes, jlay.shapes, jlay.rows, jlay.pad) and jlay.pad
    err = np.stack([_bucket(jlay.rows, 64, 40 + i) * np.float32(1e-3)
                    for i in range(n)])
    mean, new_err = TG.compress_allreduce(
        [t for _, t in trees], _t(err), bits, stochastic=False, layout=tlay)
    key = jax.random.PRNGKey(0)
    v = torch.stack([TG.flatten_bucket(t, tlay) for _, t in trees]) \
        + _t(err)
    q = v - new_err               # the port's dequantized values
    for be in BACKENDS:
        jm, je = jax.jit(lambda gl, e: JG.compress_allreduce(
            gl, e, bits, key, stochastic=False, backend=be,
            layout=jlay))([t for t, _ in trees], err)
        for w, g in zip(jax.tree.leaves(jm), mean):
            _bits_equal(w, g)
        if be == "pallas":
            _bits_equal(je, new_err)
        else:
            assert _carry_ulps(new_err, je, q).max() <= 1.0


def test_compress_gradients_matches_jax():
    """The one-worker form: grads ``v - carry`` and the carry, bit-equal
    to the Pallas backend."""
    jtree, tree = _tree(50)
    jlay = JG.bucket_layout(jtree, 64)
    tlay = TG.bucket_layout(tree, 64)
    err = _bucket(jlay.rows, 64, 51) * np.float32(1e-3)
    got, new_err = TG.compress_gradients(tree, _t(err), 8, stochastic=False,
                                         layout=tlay)
    want, want_err = jax.jit(lambda g, e: JG.compress_gradients(
        g, e, 8, jax.random.PRNGKey(0), stochastic=False, backend="pallas",
        layout=jlay))(jtree, err)
    _bits_equal(want_err, new_err)
    for w, g in zip(jax.tree.leaves(want), got):
        _bits_equal(w, g)
    _, e1 = TG.compress_allreduce([tree], _t(err)[None], 8,
                                  stochastic=False, layout=tlay)
    assert torch.equal(e1[0], new_err)


def test_bucket_layout_and_flatten_follow_jax_leaf_order():
    """gpt2-xl-paper SMOKE: the port's per-layer parameters in JAX leaf
    order give JAX's layout, leaf for leaf, and the same bucket."""
    cfg = jget("gpt2-xl-paper", smoke=True)
    shapes = jax.eval_shape(lambda: Mo.init_params(cfg,
                                                   jax.random.PRNGKey(0)))
    rng = np.random.default_rng(70)
    params = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        np.float32), shapes)
    model = from_jax_params(params, tget("gpt2-xl-paper", smoke=True))
    tree = jax_leaves(dict(model.named_parameters()))
    jlay = JG.bucket_layout(params)
    tlay = TG.bucket_layout(tree)
    assert tlay == TG.BucketLayout(jlay.sizes, jlay.shapes, jlay.rows,
                                   jlay.group_d, jlay.pad)
    flat = TG.flatten_bucket(tree, tlay)
    _bits_equal(JG.flatten_bucket(params, jlay), flat)
    back = TG.unflatten_bucket(flat, tlay, tree)
    for a, b in zip(back, tree):
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            assert torch.equal(x, y.detach())
    assert TG.grad_wire_bytes(tree, 4) == JG.grad_wire_bytes(params, 4)
    err = TG.init_error_state(tree)
    assert err.shape == JG.init_error_state(params).shape


# ---------------------------------------------------------------------------
# wire registry and byte models
# ---------------------------------------------------------------------------

def test_wire_byte_models_match_jax():
    for name in TW.wire_names("dp-grad"):
        jspec, tspec = JW.get_wire(name, "dp-grad"), TW.get_wire(name)
        for shape in [(877132, 512), (37, 64), (5, 13)]:
            for bits in (2, 4, 8):
                for n in (1, 2, 3, 5, 8):
                    assert tspec.wire_bytes(shape, bits, n) == \
                        jspec.wire_bytes(shape, bits, n), \
                        (name, shape, bits, n)
    assert TW.wire_names("dp-grad") == JW.wire_names("dp-grad") == \
        ["ring", "psum", "ring-sharded", "fp16"]
    with pytest.raises(ValueError, match="did you mean 'ring'"):
        TW.get_wire("rng")
    for bits in (1, 2, 4, 8):
        for n in (1, 2, 3, 5, 17, 300):
            assert TQ.sum_wire_bits(bits, n) == JQ.sum_wire_bits(bits, n)
            assert TQ.sum_packed_width(61, bits, n) == \
                JQ.sum_packed_width(61, bits, n)


def test_unported_dp_wires_raise_at_config():
    """Once refused at config time, the ZeRO and fp16 wires now build
    and name their registry specs."""
    from repro_torch.training.simulated import SimTrainConfig
    for wire, sharded in (("ring-sharded", True), ("fp16", False)):
        comm = CommConfig(dp=PlaneConfig(bits=4, wire=wire))
        tcfg = SimTrainConfig(num_stages=2, comm=comm, dp_workers=2)
        spec = tcfg.comm.dp_wire_spec
        assert spec is TW.get_wire(wire) and spec.name == wire
        assert spec.sharded is sharded
    assert CommConfig(dp=PlaneConfig(bits=4)).dp_wire_spec.sim_allreduce \
        is TG.compress_allreduce
    assert CommConfig(dp=PlaneConfig(
        bits=4, wire="ring-sharded")).dp_wire_spec.sim_allreduce \
        is TG.compress_reduce_scatter
    assert CommConfig(dp=PlaneConfig(bits=4, wire="fp16")).dp_wire_spec \
        .sim_allreduce is TW.fp16_sim_allreduce


# ---------------------------------------------------------------------------
# the payload guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["clean", "nan", "inf", "huge", "zero"])
def test_guard_dp_pair_matches_jax(case):
    rng = np.random.default_rng(60)
    g = {"a": rng.standard_normal((4, 5)).astype(np.float32),
         "b": rng.standard_normal((7,)).astype(np.float32)}
    if case == "zero":
        g = {k: np.zeros_like(v) for k, v in g.items()}
    elif case != "clean":
        g["b"][3] = {"nan": np.nan, "inf": -np.inf, "huge": 3e30}[case]
    e = rng.standard_normal((2, 8)).astype(np.float32)
    jg, je = jax.jit(JF.guard_dp_pair)(g, e)
    tg, te = TF.guard_dp_pair([_t(x) for x in jax.tree.leaves(g)], _t(e))
    for w, x in zip(jax.tree.leaves(jg), tg):
        _bits_equal(w, x)
    _bits_equal(je, te)
    assert torch.isnan(te).all().item() == (case != "clean")
