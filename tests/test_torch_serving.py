"""The port's serving modules against `repro.serving`, bit for bit.

`KVCodec` (quantize-on-append, whole-store dequantize) and
`DeltaHopCodec` (the delta-coded decode hop) must produce the JAX
package's codes, scales, references and hidden states on shared
inputs, with JAX jitted (its serving loop jits the decode step), and
their byte models must agree exactly.  `CommConfig` must read and write
the JAX package's JSON.
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import config as JC
from repro.serving import DeltaHopCodec as JHop
from repro.serving import KVCodec as JKV
from repro_torch.comm import config as TC
from repro_torch.serving import DeltaHopCodec as THop
from repro_torch.serving import KVCodec as TKV
from repro_torch.serving import delta as tdelta


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BITS = [2, 4, 8]


def _np(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _eq(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


# ---------------------------------------------------------------------------
# KV cache codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("group_d", [0, 16])
@pytest.mark.parametrize("bits", BITS)
def test_kvcodec_matches_jax(bits, group_d):
    jc, tc = JKV(bits=bits, group_d=group_d), TKV(bits=bits, group_d=group_d)
    b, s, hk, hd, sc = 2, 3, 4, 64, 8
    fresh = _np((b, s, hk, hd), 0)
    fresh[0, 0, 0] = 0.0                        # an all-zero group
    store_shape = (b, sc, hk, hd)

    # append at pos 2 of an empty store, then decode the whole store
    def jax_step(f):
        st = jc.empty(store_shape, jnp.float32)
        st = jc.append(st, f, 2)
        return st, jc.decode(st["codes"], st["scale"], jnp.float32)

    jst, jvals = jax.jit(jax_step)(fresh)
    tst = tc.empty(store_shape, torch.float32)
    tc.append(tst["codes"], tst["scale"], torch.from_numpy(fresh), 2)
    _eq(jst["codes"], tst["codes"])
    _eq(jst["scale"], tst["scale"])
    tvals = tc.decode(tst["codes"], tst["scale"], torch.float32)
    _eq(jvals, tvals)
    assert tvals.shape == store_shape
    assert not tvals[:, :2].any() and not tvals[:, 5:].any()
    enc = jax.jit(jc.encode)(fresh)
    for w, g in zip(enc, tc.encode(torch.from_numpy(fresh))):
        _eq(w, g)
    for shape in [(1, 1, 25, 64), store_shape, (8, 160, 25, 64)]:
        assert tc.stored_bytes(shape) == jc.stored_bytes(shape)
        assert tc.grouped_shape(shape) == jc.grouped_shape(shape)


@pytest.mark.parametrize("bits", BITS)
def test_kvcodec_matches_jax_at_gemma2_rows(bits):
    """gemma2-9b's KV rows (Hk 8, head_dim 256): append, whole-store
    decode and the byte model, against JAX; stored bytes at the served
    shape (batch 2, cache 8192) too."""
    jc, tc = JKV(bits=bits), TKV(bits=bits)
    fresh = _np((2, 3, 8, 256), bits, 3.0)
    store_shape = (2, 8, 8, 256)

    def jax_step(f):
        st = jc.append(jc.empty(store_shape, jnp.float32), f, 4)
        return st, jc.decode(st["codes"], st["scale"], jnp.float32)

    jst, jvals = jax.jit(jax_step)(fresh)
    tst = tc.empty(store_shape, torch.float32)
    tc.append(tst["codes"], tst["scale"], torch.from_numpy(fresh), 4)
    _eq(jst["codes"], tst["codes"])
    _eq(jst["scale"], tst["scale"])
    _eq(jvals, tc.decode(tst["codes"], tst["scale"], torch.float32))
    for shape in [(1, 1, 8, 256), (2, 8192, 8, 256), (2, 8160, 8, 256)]:
        assert tc.stored_bytes(shape) == jc.stored_bytes(shape)
    # per token and layer, k or v: 8 rows of 256 codes plus 8 f32 scales
    assert tc.stored_bytes((1, 1, 8, 256)) == 8 * (256 * bits // 8 + 4)


def test_kvcodec_raw_and_layout():
    assert TKV(bits=0).stored_bytes((2, 3, 4, 64)) == \
        JKV(bits=0).stored_bytes((2, 3, 4, 64))
    raw = TKV(bits=0).empty((2, 3, 4, 64), torch.float32)
    assert raw.shape == (2, 3, 4, 64) and not raw.any()
    st = TKV(bits=4, group_d=32).empty((2, 3, 4, 64))
    assert st["codes"].shape == (2, 3, 4, 2, 16)
    assert st["scale"].shape == (2, 3, 4, 2)
    with pytest.raises(ValueError):
        TKV(bits=4, group_d=24).group(64)


# ---------------------------------------------------------------------------
# decode hop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,bits", [("aqsgd", 2), ("aqsgd", 4),
                                       ("aqsgd", 8), ("directq", 4),
                                       ("fp32", 4)])
def test_delta_hop_matches_jax(mode, bits):
    jh, th = JHop(mode=mode, bits=bits), THop(mode=mode, bits=bits)
    b, d, nb = 3, 96, 2
    h_prompt = _np((b, 5, d), 1, 4.0)
    jst = jh.init_state(nb, b, d)
    tst = th.init_state(nb, b, d)
    jst, jh_out = jh.prefill_boundary(jst, h_prompt, 1)
    tst, th_out = th.prefill_boundary(tst, torch.from_numpy(h_prompt), 1)
    _eq(jst["m"], tst["m"])
    _eq(jh_out, th_out)
    step = jax.jit(lambda st, h: jh.decode_boundary(st, h, 1))
    for t in range(4):                           # a drifting hidden state
        h = h_prompt[:, -1:] + _np((b, 1, d), 10 + t, 0.1 * (t + 1))
        jst, jout = step(jst, h)
        tst, tout = th.decode_boundary(tst, torch.from_numpy(h), 1)
        _eq(jst["m"], tst["m"])
        _eq(jout, tout)
    assert not tst["m"][0].any()                 # boundary 0 untouched


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_hop_bytes_match_jax(bits):
    for b, d in [(8, 1600), (2, 256), (1, 7)]:
        for mode in ("aqsgd", "directq", "fp32"):
            assert THop(mode=mode, bits=bits).hop_bytes(b, d) == \
                JHop(mode=mode, bits=bits).hop_bytes(b, d)
    # the decode hops the chip run drives: gpt2-xl at batch 8, gemma2-9b
    # at batch 2
    assert THop(bits=4).hop_bytes(8, 1600) == 8 * 800 + 8 * 4
    assert THop(bits=4).hop_bytes(2, 3584) == \
        JHop(bits=4).hop_bytes(2, 3584) == 2 * 1792 + 2 * 4


@pytest.mark.parametrize("mode,bits", [("aqsgd", 4), ("aqsgd", 8),
                                       ("directq", 4), ("fp32", 4)])
def test_decode_hops_count_the_bytes_they_send(mode, bits):
    """`delta.SENT` adds up the payload each decode hop produced: the byte
    model per hop (gemma2-9b's hop at batch 2 among the shapes); the
    prefill crossing counts nothing."""
    th = THop(mode=mode, bits=bits)
    for b, d in [(3, 96), (2, 3584)]:
        st = th.init_state(1, b, d)
        tdelta.reset_sent()
        st, _ = th.prefill_boundary(st, torch.from_numpy(_np((b, 5, d), 1)),
                                    0)
        assert tdelta.SENT == {"hops": 0, "bytes": 0}
        for t in range(3):
            h = torch.from_numpy(_np((b, 1, d), 10 + t))
            st, _ = th.decode_boundary(st, h, 0)
        assert tdelta.SENT == {"hops": 3, "bytes": 3 * th.hop_bytes(b, d)}


# ---------------------------------------------------------------------------
# comm config
# ---------------------------------------------------------------------------

FLAG_SETS = [
    [],
    ["--mode", "aqsgd", "--fw-bits", "4", "--kv-bits", "8"],
    ["--mode", "directq", "--fw-bits", "2", "--bw-bits", "0",
     "--dp-grad-bits", "4", "--dp-wire", "psum", "--no-stochastic",
     "--no-error-feedback"],
    ["--mode", "fp32", "--fw-bits", "0", "--dp-wire", "ring-sharded",
     "--dp-chunks", "4", "--buffer-bits", "8"],
]


def _parse(mod, flags):
    ap = argparse.ArgumentParser()
    mod.add_cli_args(ap)
    return ap.parse_args(flags)


@pytest.mark.parametrize("flags", FLAG_SETS)
def test_comm_config_matches_jax_json(flags):
    """The same flags give the same JSON in both packages, and each
    package reads the other's JSON back to the same config."""
    jcfg = JC.from_args(_parse(JC, flags))
    tcfg = TC.from_args(_parse(TC, flags))
    assert tcfg.to_dict() == jcfg.to_dict()
    assert TC.CommConfig.from_json(jcfg.to_json()) == tcfg
    assert JC.CommConfig.from_json(tcfg.to_json()) == jcfg
    via = TC.from_args(_parse(TC, ["--comm-config", tcfg.to_json()]))
    assert via == tcfg


def test_comm_config_rejects_what_jax_rejects():
    for bad in [dict(mode="sgd"), dict(mode="aqsgd", fw={"bits": 0}),
                dict(dp={"wire": "rnig"}),
                dict(dp={"wire": "psum", "chunks": 2}),
                dict(kv={"bits": 8, "colour": 1}), dict(extra=1)]:
        with pytest.raises(ValueError):
            JC.CommConfig.from_dict(json.loads(json.dumps(bad)))
        with pytest.raises(ValueError):
            TC.CommConfig.from_dict(bad)
    with pytest.raises(ValueError):
        TC.CommConfig.from_dict({"fw": {"backend": "pallas"}})
    kv = TC.CommConfig.from_dict({"kv": {"bits": 8}})
    assert TKV.from_comm(kv) == TKV(bits=8)
    assert THop.from_comm(kv) == THop(mode="aqsgd", bits=4)
