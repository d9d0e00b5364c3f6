"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test asks the `card` fixture for the device and
skips when there is none (decided inside the fixture, never at import,
so every test worker collects the same tests).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernels must equal the plain versions bit for bit (which the CPU
tests hold against the JAX package), on the vectorised path (d % 4 == 0)
and the scalar path, ragged rows, stochastic rounding with shared noise,
both output types of the store read, and, for the gradient wire, both
``pack`` variants, zero scale rows and several worker counts; the
ring's accumulate and sum packers at every sum width (2/4/8/16/32
bits), on the int4 path and the element path.  The flash-attention
kernel (B10) is held to its plain version within a tolerance (rtol =
atol = 2e-5 in f32, 2e-2 in bf16, as `tests/test_flash_kernel.py`):
head dims 32-256, GQA and MQA, windows, softcaps, non-causal, ragged
Sq and Sk with a query offset.  The seeded encoders (the kernels'
own Philox noise) equal the plain versions fed
`ref.oncore_uniform_ref` bit for bit, on both paths and a misaligned
view, and the on-core noise knob routes the boundary ops through them.
The gradient wire's legacy pair (`quantize_pack_scaled`,
`unpack_codes`) equals its plain versions on both paths, with zero
scale rows and a misaligned view.  The sums' unpacker (B8b, and B9b
on its kernel) is also held bit-exact where n leaves a tail past its
last 16-byte group, at every sum width.  B10 is also checked at each
head dim with Sq and Sk off its tiles, q scaled by 16 under a softcap
of 50 (f32 against the plain formula in float64: the plain version's
own f32 rounding is past 2e-5 there), and on f32 k and v rows that are
not 16-byte aligned.  The KV plane's pair calls (k and v in one
launch; the append written in place into the stores) equal their plain
versions and two per-tensor calls at both archs' KV shapes, and the
append at per-row write heads (the continuous batcher's pool, heads
past the store clamped) equals its plain version; one pooled decode
step makes no synchronizing call.  The
encoders' rows wider than 256 values (a block a row, read once up to
8192 values, walked twice past that) are held at the tiling's edges:
260, 1600, 3584, 5120 and 8196 values, 1 and 5 rows.  The training
attention (`repro_torch.models.layers.flash_attention`: B10 with the
rows' log-sum-exp, JAX's backward in PyTorch) is held to the formula
in float64 at gpt2-xl's training shape (4, 25, 1024, 64), causal, and
at gemma2-9b's heads (16 on 8 kv heads of 256, 1024 tokens) with
windows 4096 and 512 and a softcap of 50: o within 2e-5, the lse
within 2e-5 (rtol = atol), dq, dk and dv within 1e-4 of each one's
largest value (bounds set before the first run on the card); B10's o
is bit-identical with and without the lse; and ``remat`` on and off
give bit-equal losses and gradients, with B10 launched once a layer
and once more a layer in the recompute.  The rest of the DP wires and
the optimizer: the ZeRO wire's simulator on the card (B5, B6) equals
the CPU's plain run bit for bit, its live segment rows equal the
ring's mean and its pad rows are signed zeros; the bucket-space AdamW
gives the bits of the per-leaf one elementwise on the card; the
simulated trainer's ``ring-sharded`` stream equals its ``ring`` stream
bit for bit on the card, and ``fp16``'s f16 sum equals the CPU's;
8-bit AdamW moments on the card (the same PyTorch ops, no kernel) hold
the CPU's parameters within 1e-6 relative, scales within 1e-6, and
codes equal except within 1e-3 code units of a half-code tie (or where
they already differed): PyTorch on CUDA divides by a scalar as a
multiply by its reciprocal.  B10 at head_dim 80 (zamba2-2.7b's shared
block) runs the hd-96 instance on the wrapper's zero-padded copies: its
80 columns, with and without the lse, against the plain version at 80
(f32 against the float64 formula), one launch a call, the tile edges
and the training attention at zamba2's (4, 32, 1024, 80); a head_dim of
neither an instance nor a padded width (48, 72) still raises.  The moe
family: B10 at deepseek-moe-16b's heads (16 of 128) and mixtral-8x22b's
(48 on 8 kv heads of 128, a window) against the plain version, short
and at their full prefill shapes (the plain version a batch row and kv
head at a time); the MoE
FFN (plain PyTorch, no kernel) on the card against the CPU at SMOKE
width and capacity_factor 1.25: routing and keep masks equal, values
and gradients within 1e-4, two card runs bit-equal.  A prefill over
raw bf16 stores (the batcher's default dtype; a MoE model's dense
prefix) reads them in the queries' f32, one B10 launch within 1e-4 of
the plain version.  The continuous batcher's pool on the other
families: mamba2's pooled step over f32 ssm states and bf16 conv
windows, written in place, and whisper's over bf16 cross caches (8-bit
KV), against the CPU within 5e-3; zamba2's admission prefill at
head_dim 80 over the fresh bf16 row, B10 once a block through the hd-96
copies, its shared attention within 1e-4 of the plain version.
"""
import math

import pytest
import torch

from repro_torch.core import boundary as TB
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import quant_pack as TP
from repro_torch.kernels import ref as TR

pytestmark = pytest.mark.cuda

BITS = [2, 4, 8]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU "
                    "mode; their plain versions are tested on the CPU)")
    return torch.device("cuda")


def _x(rows, d, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, d, generator=g, device=dev) \
        * torch.logspace(-3, 2, rows, device=dev)[:, None]
    x[0] = 0.0
    return x


# the encoders' tiling edges past 256 values (quant_pack._encode_tiling):
# the first width a block takes, the hops' and stablelm-12b's d_model,
# and the first width past the register cap (8192), walked twice
WIDE = [260, 1600, 3584, 5120, 8196]


def _dims(bits):
    """(rows, d): the hop and KV shapes, ragged rows, the encoders'
    tiling edges, and a d that is not a multiple of 4 where the width
    allows it (the scalar path)."""
    odd = [] if bits == 2 else [(7, 66), (3, 1602)]
    return [(8, 1600), (200, 64), (37, 64), (1, 1600), (5, 260),
            (1, 3584), (5, 5120), (3, 8196)] + odd


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w), (g != w).sum().item()


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", BITS)
def test_encoders_match_plain(card, bits, stochastic):
    for rows, d in _dims(bits):
        m = _x(rows, d, 1, card)
        a = m + _x(rows, d, 2, card)
        u = torch.rand(rows, d, device=card) if stochastic else None
        _equal(TP.delta_quantize_pack(a, m, u, bits=bits),
               TR.delta_quantize_pack_ref(a, m, bits, u))
        _equal(TP.quantize_pack(a, u, bits=bits),
               TR.quantize_pack_ref(a, bits, u))


@pytest.mark.parametrize("bits", BITS)
def test_decoders_match_plain(card, bits):
    for rows, d in _dims(bits):
        packed = torch.randint(0, 256, (rows, d * bits // 8), device=card,
                               dtype=torch.uint8)
        scale = torch.rand(rows, 1, device=card) + 1e-3
        m = _x(rows, d, 3, card)
        _equal([TP.dequant_unpack_accumulate(packed, scale, m, bits=bits)],
               [TR.dequant_unpack_accumulate_ref(packed, scale, m, bits)])
        for dt in (torch.float32, torch.bfloat16):
            _equal([TP.unpack_dequant(packed, scale, bits=bits,
                                      out_dtype=dt)],
                   [TR.unpack_dequant_ref(packed, scale, bits, dt)])


@pytest.mark.parametrize("bits", BITS)
def test_gradient_wire_kernels_match_plain(card, bits):
    """quantize_codes_scaled (pack on and off, deterministic and
    stochastic, a zero scale row) and dequant_sum_mean (n 1/2/3/5)."""
    for rows, d in _dims(bits) + [(300, 512)]:
        x = _x(rows, d, 5, card)
        s = x.abs().amax(-1, keepdim=True) * 1.5
        s[min(1, rows - 1)] = 0.0                 # clamps to 1e-12
        for u in (None, torch.rand(rows, d, device=card)):
            for pack in (False, True):
                got = TP.quantize_codes_scaled(x, s, u, bits=bits, pack=pack)
                want = TR.quantize_codes_scaled_ref(x, s, bits, u, pack)
                _equal(got if pack else [got], want if pack else [want])
        for n in (1, 2, 3, 5):
            total = torch.randint(0, n * ((1 << bits) - 1) + 1, (rows, d),
                                  device=card, dtype=torch.int32)
            _equal([TP.dequant_sum_mean(total, s, bits=bits, n=n)],
                   [TR.dequant_sum_mean_ref(total, s, bits, n)])


def _offset(x):
    """A copy of x one f32 past a 16-byte boundary: contiguous but
    misaligned, so the kernels take the scalar path even at d % 4 == 0."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("bits", BITS)
def test_seeded_encoders_match_plain(card, bits):
    """B1, B3 and B5 with a seed against their plain versions fed the
    seeded stream, over three seeds, the dims above, a d % 4 != 0 and a
    misaligned view with d % 4 == 0 (the scalar path)."""
    dims = _dims(bits) + [(4096, 1600), (300, 512), (5, 12)]
    for sd in ((0, 0), (1, -2), (2 ** 31 - 1, -2 ** 31)):
        seed = torch.tensor(sd, dtype=torch.int32, device=card)
        for rows, d in dims:
            u = TR.oncore_uniform_ref(seed, rows, d)
            m = _x(rows, d, 1, card)
            a = m + _x(rows, d, 2, card)
            s = a.abs().amax(-1, keepdim=True) * 1.5
            for aa, mm in ((a, m), (_offset(a), _offset(m))):
                _equal(TP.delta_quantize_pack(aa, mm, bits=bits, seed=seed),
                       TR.delta_quantize_pack_ref(a, m, bits, u))
                _equal(TP.quantize_pack(aa, bits=bits, seed=seed),
                       TR.quantize_pack_ref(a, bits, u))
                for pack in (False, True):
                    got = TP.quantize_codes_scaled(aa, s, bits=bits,
                                                   pack=pack, seed=seed)
                    want = TR.quantize_codes_scaled_ref(a, s, bits, u, pack)
                    _equal(got if pack else [got], want if pack else [want])


@pytest.mark.parametrize("bits", BITS)
def test_legacy_pair_kernels_match_plain(card, bits):
    """B9a (deterministic and stochastic, a zero scale row and a zero x
    row) and B9b, on the vector path, the scalar path (d % 4 != 0) and
    a misaligned view."""
    for rows, d in _dims(bits) + [(300, 512)]:
        x = _x(rows, d, 6, card)
        s = x.abs().amax(-1, keepdim=True) * 1.3
        s[min(1, rows - 1)] = 0.0                 # clamps to 1e-12
        for u in (None, torch.rand(rows, d, device=card)):
            want = TR.quantize_pack_scaled_ref(x, s, bits, u)
            _equal([TP.quantize_pack_scaled(x, s, u, bits=bits)], [want])
            _equal([TP.quantize_pack_scaled(
                _offset(x), s, None if u is None else _offset(u),
                bits=bits)], [want])
        packed = torch.randint(0, 256, (rows, d * bits // 8), device=card,
                               dtype=torch.uint8)
        want = TR.unpack_codes_ref(packed, bits)
        _equal([TP.unpack_codes(packed, bits=bits)], [want])
        _equal([TP.unpack_codes(_offset(packed), bits=bits)], [want])


def test_oncore_knob_launches_seeded_kernels(card, monkeypatch):
    monkeypatch.setenv("ACSGD_ONCORE_PRNG", "1")
    TP.reset_launches()
    x = _x(8, 64, 4, card)
    g = torch.Generator(device=card).manual_seed(0)
    TB.encode_delta(x, x * 0.5, bits=4, stochastic=True, generator=g)
    TB.roundtrip(x, bits=8, stochastic=True, generator=g)
    TB.encode_codes_with_scale(x, x.abs().amax(-1, keepdim=True), bits=4,
                               stochastic=True, generator=g)
    TB.encode(x, bits=8, stochastic=True, u=torch.rand_like(x))  # u wins
    assert TP.LAUNCHES["oncore_uniform"] == 3
    assert TP.LAUNCHES["quantize_pack"] == 2
    with pytest.raises(ValueError, match="not both"):
        TP.quantize_pack(x, torch.rand_like(x), bits=8,
                         seed=torch.zeros(2, dtype=torch.int32, device=card))


# (bits, n) giving each sum width: 2, 4, 8, 16 and 32 bits
SUM_WIDTH_CASES = [(2, 1), (2, 3), (4, 2), (8, 2), (8, 300)]


@pytest.mark.parametrize("bits", BITS)
def test_ring_accumulate_matches_plain(card, bits):
    for rows, d in _dims(bits) + [(300, 512), (5, 4)]:
        pw = d * bits // 8
        packed = torch.randint(0, 256, (rows, pw), device=card,
                               dtype=torch.uint8)
        acc = torch.randint(0, 1000, (rows, d), device=card,
                            dtype=torch.int32)
        _equal([TP.unpack_accumulate(packed, acc, bits=bits)],
               [TR.unpack_accumulate_ref(packed, acc, bits)])
        # a misaligned view takes the element path
        flat = torch.randint(0, 256, (rows * pw + 1,), device=card,
                             dtype=torch.uint8)
        p1 = flat[1:].view(rows, pw)
        _equal([TP.unpack_accumulate(p1, acc, bits=bits)],
               [TR.unpack_accumulate_ref(p1, acc, bits)])


@pytest.mark.parametrize("bits,n", SUM_WIDTH_CASES)
def test_sum_packers_match_plain(card, bits, n):
    from repro_torch.core import quantization as TQ
    sw = TQ.sum_wire_bits(bits, n)
    hi = min(n * ((1 << bits) - 1), 2 ** 31 - 1)
    for rows, d in [(8, 1600), (37, 512), (3, 24), (1, 8)]:
        total = torch.randint(0, hi + 1, (rows, d), device=card,
                              dtype=torch.int32)
        packed = TP.pack_sums(total, bits=bits, n=n)
        _equal([packed], [TR.pack_sums_ref(total, bits, n)])
        _equal([TP.unpack_sums(packed, bits=bits, n=n)], [total])
        _equal([TP.unpack_sums(packed, bits=bits, n=n)],
               [TR.unpack_sums_ref(packed, bits, n)])
        # rows * d not a multiple of 4: the element path
        k = 8 // sw if sw <= 8 else 1
        t1 = total[:1, :k]
        _equal([TP.pack_sums(t1.contiguous(), bits=bits, n=n)],
               [TR.pack_sums_ref(t1, bits, n)])


# (rows, d) whose rows * d is not a multiple of the unpacker's 16-byte
# group (128/SW values) at SW 2, 4, 8 and 16, each a multiple of 4 (the
# vector path plus its value-by-value tail); at SW 32 the group is 4
# values, so only the element path has a tail
UNPACK_TAIL_DIMS = [(5, 20), (3, 1604), (37, 516), (1, 4)]


def _misaligned_u8(packed):
    """packed's bytes one past a 16-byte boundary: the element path."""
    flat = torch.empty(packed.numel() + 1, dtype=torch.uint8,
                       device=packed.device)
    view = flat[1:].view(packed.shape)
    view.copy_(packed)
    return view


@pytest.mark.parametrize("bits,n", SUM_WIDTH_CASES)
def test_sum_unpacker_tails_match_plain(card, bits, n):
    """B8b at every sum width: a tail past the last whole 16-byte group
    in the same launch, and a misaligned view, bit-exact."""
    from repro_torch.core import quantization as TQ
    for rows, d in UNPACK_TAIL_DIMS:
        pw = TQ.sum_packed_width(d, bits, n)
        packed = torch.randint(0, 256, (rows, pw), device=card,
                               dtype=torch.uint8)
        want = TR.unpack_sums_ref(packed, bits, n)
        TP.reset_launches()
        _equal([TP.unpack_sums(packed, bits=bits, n=n)], [want])
        _equal([TP.unpack_sums(_misaligned_u8(packed), bits=bits, n=n)],
               [want])
        assert TP.LAUNCHES["unpack_sums"] == 2     # one launch a call


@pytest.mark.parametrize("bits", BITS)
def test_code_unpacker_tails_match_plain(card, bits):
    """B9b (B8b's kernel at SW = bits) with tails and a misaligned view."""
    for rows, d in UNPACK_TAIL_DIMS:
        packed = torch.randint(0, 256, (rows, d * bits // 8), device=card,
                               dtype=torch.uint8)
        want = TR.unpack_codes_ref(packed, bits)
        TP.reset_launches()
        _equal([TP.unpack_codes(packed, bits=bits)], [want])
        _equal([TP.unpack_codes(_misaligned_u8(packed), bits=bits)], [want])
        assert TP.LAUNCHES["unpack_codes"] == 2


# the KV plane's pair calls, (B, S, N, g, s, pos): gpt2-xl's layer store
# (batch 8, cache 160, 25 heads of 64) with a decode append and the
# prefill's, gemma2-9b's (batch 2, cache 8192, 8 heads of 256) with a
# decode append at its last row and a prefill run, a group_d of 32 over
# a ragged row count, and rows too wide for registers (the two-pass path)
KV_PAIR_SHAPES = [(8, 160, 25, 64, 1, 150), (8, 160, 25, 64, 128, 0),
                  (2, 8192, 8, 256, 1, 8191), (2, 8192, 8, 256, 8, 8160),
                  (3, 7, 10, 32, 2, 5), (1, 5, 3, 1600, 2, 1),
                  # stablelm-12b's rows of 160 (batch 2, cache 4096, 8
                  # kv heads) and gemma2-27b's of 128 (cache 8192, 16)
                  (2, 4096, 8, 160, 1, 4095), (2, 4096, 8, 160, 8, 4064),
                  (2, 8192, 16, 128, 1, 8191), (2, 8192, 16, 128, 8, 8160)]


def _kv_pair_inputs(dev, b, cache, n, g, s, bits, seed):
    """Fresh k and v rows (B, s, N, g), and two stores full of random
    bytes and scales."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = tuple(torch.randn(b, s, n, g, generator=gen, device=dev) * 3
              for _ in range(2))
    x[0][0, 0, 0] = 0.0                               # an all-zero row
    packed = tuple(torch.randint(0, 256, (b, cache, n, g * bits // 8),
                                 generator=gen, device=dev,
                                 dtype=torch.uint8) for _ in range(2))
    scale = tuple(torch.rand(b, cache, n, generator=gen, device=dev) + 0.5
                  for _ in range(2))
    return x, packed, scale


@pytest.mark.parametrize("bits", BITS)
def test_kv_pair_kernels_match_plain(card, bits):
    """The pair append, in place, and the pair read, one launch each,
    bit-equal to their plain versions and to two per-tensor kernel calls
    (plus the slice writes): deterministic, with noise and with seeds,
    on the vector path, with g % 4 != 0 and on misaligned x and stores
    (the scalar paths); rows outside [pos, pos + s) keep their bytes."""
    odd = [] if bits == 2 else [(2, 6, 5, 66, 3, 2)]
    for case in KV_PAIR_SHAPES + odd:
        b, cache, n, g, s, pos = case
        x, packed, scale = _kv_pair_inputs(card, b, cache, n, g, s, bits,
                                           sum(case) + bits)
        seeds = tuple(torch.tensor(sd, dtype=torch.int32, device=card)
                      for sd in ((1, -2), (2 ** 31 - 1, 5)))
        for noise in ("none", "u", "seed"):
            u = tuple(torch.rand_like(t) for t in x) if noise == "u" \
                else (None, None)
            seed = seeds if noise == "seed" else (None, None)
            plain_u = tuple(
                TR.oncore_uniform_ref(sd, b * s * n, g).reshape(x[0].shape)
                for sd in seeds) if noise == "seed" else u
            want_p = tuple(p.clone() for p in packed)
            want_s = tuple(t.clone() for t in scale)
            TR.quantize_pack_into_ref(x, want_p, want_s, pos, bits, plain_u)
            for misaligned in (False, True):
                got_p = tuple(_offset(p) if misaligned
                              else p.clone() for p in packed)
                got_s = tuple(_offset(t) if misaligned
                              else t.clone() for t in scale)
                xx = tuple(_offset(t) for t in x) if misaligned else x
                TP.reset_launches()
                TP.quantize_pack_into(xx, got_p, got_s, pos, u, seed,
                                      bits=bits)
                assert TP.LAUNCHES["quantize_pack"] == 1
                assert TP.LAUNCHES["oncore_uniform"] == (noise == "seed")
                _equal(got_p + got_s, want_p + want_s)
            for i in range(2):
                p1, s1 = TP.quantize_pack(
                    x[i].reshape(-1, g),
                    None if u[i] is None else u[i].reshape(-1, g),
                    bits=bits, seed=seed[i])
                _equal([want_p[i][:, pos:pos + s], want_s[i][:, pos:pos + s]],
                       [p1.reshape(b, s, n, -1), s1.reshape(b, s, n)])
        rows = tuple(p.reshape(-1, p.shape[-1]) for p in want_p)
        srows = tuple(t.reshape(-1, 1) for t in want_s)
        for dt in (torch.float32, torch.bfloat16):
            for misaligned in (False, True):
                rr = tuple(_offset(r) for r in rows) if misaligned else rows
                TP.reset_launches()
                got = TP.unpack_dequant_pair(rr, srows, bits=bits,
                                             out_dtype=dt)
                assert TP.LAUNCHES["unpack_dequant"] == 1
                _equal(got, TR.unpack_dequant_pair_ref(rows, srows, bits, dt))
                _equal(got, [TP.unpack_dequant(r, t, bits=bits, out_dtype=dt)
                             for r, t in zip(rows, srows)])


# the KV append at per-row write heads (the continuous batcher's pool):
# (b, cache, n, g, s, heads) for gpt2-xl's pool of 8 slots (cache 160,
# 25 heads of 64) with heads at 0, inside, at the last row and past the
# store (clamped), gemma2's 2 slots (cache 8192, 8 heads of 256), and a
# run of 2 rows a slot (a head at cache - 1 clamps to cache - 2)
ROW_HEAD_CASES = [(8, 160, 25, 64, 1, (0, 5, 77, 128, 159, 160, 200, 3)),
                  (2, 8192, 8, 256, 1, (8191, 9000)),
                  (4, 12, 10, 32, 2, (0, 11, 5, 40))]


@pytest.mark.parametrize("bits", BITS)
def test_kv_pair_append_at_row_heads_matches_plain(card, bits):
    """The pair append with a (B,) int32 head tensor on the card, one
    launch, bit-equal to its plain version (`quantize_pack_into_ref`,
    the clamp included), deterministic and seeded, into stores of
    random bytes whose other rows keep theirs; and equal to the
    scalar-head launch of each batch entry at its clamped head."""
    seeds = tuple(torch.tensor(sd, dtype=torch.int32, device=card)
                  for sd in ((3, -4), (5, 6)))
    for b, cache, n, g, s, heads in ROW_HEAD_CASES:
        x, packed, scale = _kv_pair_inputs(card, b, cache, n, g, s, bits,
                                           cache + n + bits)
        pos = torch.tensor(heads, dtype=torch.int32, device=card)
        for seed in ((None, None), seeds):
            plain_u = (None, None) if seed[0] is None else tuple(
                TR.oncore_uniform_ref(sd, b * s * n, g).reshape(x[0].shape)
                for sd in seed)
            want_p = tuple(p.clone() for p in packed)
            want_s = tuple(t.clone() for t in scale)
            TR.quantize_pack_into_ref(x, want_p, want_s, pos, bits, plain_u)
            got_p = tuple(p.clone() for p in packed)
            got_s = tuple(t.clone() for t in scale)
            TP.reset_launches()
            TP.quantize_pack_into(x, got_p, got_s, pos, seed=seed, bits=bits)
            assert TP.LAUNCHES["quantize_pack"] == 1
            _equal(got_p + got_s, want_p + want_s)
            if seed[0] is not None:
                continue
            for i, h in enumerate(heads):
                start = min(max(h, 0), cache - s)
                one_p = tuple(p[i:i + 1].clone() for p in packed)
                one_s = tuple(t[i:i + 1].clone() for t in scale)
                TP.quantize_pack_into(tuple(t[i:i + 1] for t in x), one_p,
                                      one_s, start, bits=bits)
                _equal(one_p + one_s, [t[i:i + 1] for t in got_p + got_s])


def test_pooled_decode_step_makes_no_sync(card):
    """One pooled `forward_with_caches` step (per-row heads, 8-bit KV,
    the 4-bit aqsgd hop over 2 stages, gpt2-xl SMOKE) under
    ``torch.cuda.set_sync_debug_mode("warn")``: no synchronizing call,
    so the step can be captured whole.  A host read under the same mode
    is the control: it must warn, or the mode sees nothing."""
    import warnings

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Transformer
    from repro_torch.serving import DeltaHopCodec, KVCodec

    cfg = get_config("gpt2-xl-paper", smoke=True)
    model = Transformer(cfg, device=card,
                        generator=torch.Generator().manual_seed(0))
    kv, hop = KVCodec(bits=8), DeltaHopCodec(mode="aqsgd", bits=4)
    pool = model.init_caches(3, 16, kv_codec=kv)
    pool["hop_m"] = hop.init_state(1, 3, cfg.d_model, device=card)["m"]
    pool["pos"] = torch.tensor([2, 9, 19], dtype=torch.int32, device=card)
    tok = torch.tensor([[1], [2], [3]], device=card)

    def step():
        return model.forward_with_caches(
            tok, pool, logits_last_only=True, num_stages=2,
            boundary_fn=hop.boundary_fn(prefill=False), kv_codec=kv)

    step()                       # builds and loads the kernels
    torch.cuda.synchronize()

    def syncs_in(fn):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return out, [str(w.message) for w in seen
                     if "called a synchronizing" in str(w.message)]

    (logits, out), syncs = syncs_in(step)
    assert syncs == [], syncs
    assert syncs_in(lambda: logits.sum().item())[1], "the control saw none"
    assert out["pos"].tolist() == [4, 11, 21]
    assert torch.isfinite(logits).all().item()


@pytest.mark.parametrize("bits", BITS)
def test_codecs_at_path_shapes(card, bits):
    """B1, B3 and B4 per call at the paths' shapes: the hops (8, 1600)
    and (2, 3584), the KV rows of gpt2-xl (200, 64) and gemma2 (16, 256),
    the stores (32000, 64) and (131072, 256), the training boundary
    (4096, 1600); B1 and B3 also at the tiling's edges past 256 values
    (`WIDE`) with 1 and 5 rows; stochastic, deterministic and seeded."""
    seed = torch.tensor((7, -9), dtype=torch.int32, device=card)
    for rows, d in [(8, 1600), (2, 3584), (200, 64), (16, 256),
                    (4096, 1600), (25600, 64)] + \
            [(r, d) for d in WIDE for r in (1, 5)]:
        m = _x(rows, d, 1, card)
        a = m + _x(rows, d, 2, card)
        u = torch.rand(rows, d, device=card)
        su = TR.oncore_uniform_ref(seed, rows, d)
        for uu in (None, u):
            _equal(TP.delta_quantize_pack(a, m, uu, bits=bits),
                   TR.delta_quantize_pack_ref(a, m, bits, uu))
            _equal(TP.quantize_pack(a, uu, bits=bits),
                   TR.quantize_pack_ref(a, bits, uu))
        _equal(TP.delta_quantize_pack(a, m, bits=bits, seed=seed),
               TR.delta_quantize_pack_ref(a, m, bits, su))
        _equal(TP.quantize_pack(a, bits=bits, seed=seed),
               TR.quantize_pack_ref(a, bits, su))
    for rows, d in [(32000, 64), (131072, 256), (4096, 1600), (37, 64)]:
        packed = torch.randint(0, 256, (rows, d * bits // 8), device=card,
                               dtype=torch.uint8)
        scale = torch.rand(rows, 1, device=card) + 1e-3
        for dt in (torch.float32, torch.bfloat16):
            _equal([TP.unpack_dequant(packed, scale, bits=bits,
                                      out_dtype=dt)],
                   [TR.unpack_dequant_ref(packed, scale, bits, dt)])


def test_counters_and_checks(card):
    TP.reset_launches()
    x = _x(8, 64, 4, card)
    p, s = TB.encode(x, bits=8)
    TB.decode(p, s, bits=8, d=64)
    TB.decode_accumulate(*TB.encode_delta(x, x * 0.5, bits=4)[:2], x,
                         bits=4)
    packed, codes = TB.encode_codes_with_scale(x, s, bits=8, pack=True)
    TB.decode_sum_mean(codes, s, bits=8, n=1)
    acc = TB.accumulate_codes(packed, codes, bits=8)
    TB.unpack_sums(TB.pack_sums(acc, bits=8, n=2), bits=8, n=2, d=64)
    TB.decode_codes(TB.encode_with_scale(x, s, bits=4), bits=4, d=64)
    assert TP.LAUNCHES == {"delta_quantize_pack": 1,
                           "dequant_unpack_accumulate": 1,
                           "quantize_pack": 1, "unpack_dequant": 1,
                           "quantize_pack_scaled": 1, "unpack_codes": 1,
                           "quantize_codes_scaled": 1,
                           "dequant_sum_mean": 1, "unpack_accumulate": 1,
                           "pack_sums": 1, "unpack_sums": 1,
                           "flash_attention_fwd": 0, "oncore_uniform": 0}
    with pytest.raises(TypeError):
        TP.quantize_pack(x.double(), bits=8)
    with pytest.raises(ValueError):
        TP.quantize_pack(x.t(), bits=8)          # not contiguous
    with pytest.raises(ValueError):
        TP.quantize_pack(x, bits=3)
    with pytest.raises(ValueError):
        TP.quantize_pack(x, x.cpu(), bits=8)      # mixed devices
    assert TP.LAUNCHES["quantize_pack"] == 1


# (b, h, hk, sq, sk, hd, q_offset, causal, window, softcap)
FLASH_CASES = [
    # stablelm-12b's heads (32 on 8 kv heads of 160), ragged, an offset
    (2, 32, 8, 100, 130, 160, 30, True, 10 ** 9, 0.0),
    (1, 4, 2, 65, 97, 160, 0, False, 40, 30.0),
    # zamba2-2.7b's shared block (32 heads of 80, zero-padded to the
    # kernel's 96 by the wrapper), ragged, an offset; and GQA at 80
    (2, 32, 32, 100, 130, 80, 30, True, 10 ** 9, 0.0),
    (1, 4, 2, 65, 97, 80, 0, False, 40, 30.0),
    # the moe family's heads: deepseek-moe-16b's (16 of 128, causal) and
    # mixtral-8x22b's (48 on 8 kv heads of 128, GQA 6:1, a window under
    # the keys), ragged, an offset
    (2, 16, 16, 100, 130, 128, 30, True, 10 ** 9, 0.0),
    (1, 48, 8, 300, 400, 128, 100, True, 128, 0.0),
    (1, 2, 2, 64, 64, 32, 0, True, 10 ** 9, 0.0),
    (2, 4, 2, 128, 128, 64, 0, True, 10 ** 9, 0.0),      # GQA
    (1, 8, 1, 64, 64, 128, 0, True, 10 ** 9, 0.0),       # MQA
    (1, 2, 2, 64, 64, 32, 0, True, 9, 0.0),
    (1, 2, 2, 64, 64, 32, 0, True, 17, 4.0),
    (1, 2, 2, 64, 64, 32, 0, True, 10 ** 9, 30.0),
    (1, 2, 2, 64, 64, 32, 0, False, 10 ** 9, 0.0),
    (2, 4, 2, 37, 53, 256, 9, True, 16, 50.0),           # ragged, offset
    (2, 25, 25, 128, 160, 64, 0, True, 10 ** 9, 0.0),    # gpt2-xl prefill
    (1, 16, 8, 300, 400, 256, 70, True, 128, 50.0),      # gemma2 local
    # the continuous batcher's B = 1 prefills into a row cache of 160
    (1, 25, 25, 4, 160, 64, 0, True, 10 ** 9, 0.0),
    (1, 25, 25, 77, 160, 64, 0, True, 10 ** 9, 0.0),
    (1, 25, 25, 128, 160, 64, 0, True, 10 ** 9, 0.0),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_plain(card, case, dtype):
    b, h, hk, sq, sk, hd, off, causal, window, cap = case
    g = torch.Generator(device=card).manual_seed(sq + sk + hd)
    q = torch.randn(b, h, sq, hd, generator=g, device=card).to(dtype)
    k = torch.randn(b, hk, sk, hd, generator=g, device=card).to(dtype)
    v = torch.randn(b, hk, sk, hd, generator=g, device=card).to(dtype)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=off)
    TP.reset_launches()
    got = TFA.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert TP.LAUNCHES["flash_attention_fwd"] == 1
    want = TR.flash_attention_ref(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# Sq and Sk off the kernel's tiles (64 query rows; kv tiles of 64 keys
# at hd <= 64, 32 at hd 128 and 256), a query offset, a window, and q
# scaled by 16 under gemma2's softcap of 50 (scores reach the cap):
# (sq, sk, q_offset, window, softcap, q scale)
FLASH_EDGES = [(65, 97, 32, 10 ** 9, 50.0, 16.0),
               (33, 47, 14, 20, 50.0, 16.0),
               (130, 161, 31, 10 ** 9, 0.0, 1.0),
               (1, 33, 32, 10 ** 9, 30.0, 1.0)]


def _flash_ref64(q, k, v, *, causal, window, softcap, q_offset):
    """`TR.flash_attention_ref`'s formula in float64, as f32.  With q
    scaled by 16 at hd 256 the plain version's own f32 rounding of q k^T
    (one FMA chain along hd) is up to 2.5e-5 of (1 + |o|) from this, past
    2e-5, so f32 results there are held to the float64 value."""
    b, h, sq, hd = q.shape
    hk, sk = k.shape[1], k.shape[2]
    qg = q.double().reshape(b, hk, h // hk, sq, hd)
    s = torch.matmul(qg, k.double()[:, :, None].transpose(-1, -2)) \
        / math.sqrt(hd)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    pos = q_offset + torch.arange(sq, device=q.device)[:, None]
    key = torch.arange(sk, device=q.device)[None, :]
    vis = (key > pos - window) & ((key <= pos) | (not causal))
    p = torch.softmax(torch.where(vis, s, TR.NEG_INF), dim=-1)
    return torch.matmul(p, v.double()[:, :, None]).reshape(b, h, sq, hd) \
        .float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [32, 64, 80, 128, 160, 256])
def test_flash_attention_tile_edges(card, hd, dtype):
    """f32 against the float64 formula, bf16 against the plain version."""
    for sq, sk, off, window, cap, qs in FLASH_EDGES:
        g = torch.Generator(device=card).manual_seed(sq + sk + hd)
        q = (torch.randn(2, 4, sq, hd, generator=g, device=card) * qs) \
            .to(dtype)
        k = torch.randn(2, 2, sk, hd, generator=g, device=card).to(dtype)
        v = torch.randn(2, 2, sk, hd, generator=g, device=card).to(dtype)
        kw = dict(causal=True, window=window, softcap=cap, q_offset=off)
        got = TFA.flash_attention_fwd(q, k, v, **kw)
        if dtype == torch.float32:
            want, tol = _flash_ref64(q, k, v, **kw), 2e-5
        else:
            want, tol = TR.flash_attention_ref(q, k, v, **kw), 2e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("hd", [64, 256])
def test_flash_attention_unaligned_rows(card, hd):
    """f32 k and v rows that are not 16-byte aligned (a row stride of hd
    + 1): the register copy in place of cp.async."""
    b, h, hk, sq, sk = 1, 4, 2, 70, 100
    g = torch.Generator(device=card).manual_seed(hd)
    q = torch.randn(b, h, sq, hd, generator=g, device=card)
    k = torch.randn(b, hk, sk, hd + 1, generator=g, device=card)[..., :hd]
    v = torch.randn(b, hk, sk, hd + 1, generator=g, device=card)[..., 1:]
    kw = dict(causal=True, window=10 ** 9, softcap=50.0, q_offset=30)
    got = TFA.flash_attention_fwd(q, k, v, **kw)
    want = TR.flash_attention_ref(q, k.contiguous(), v.contiguous(), **kw)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_attention_reads_views_in_place(card):
    """The serving prefill's layout: transposed (B, S, H, hd) queries and
    (B, Sc, Hk, hd) cache rows, read without copies; the output has the
    queries' (B, Sq, H, hd) memory layout."""
    b, h, hk, sq, sk, hd = 2, 16, 8, 100, 230, 256
    g = torch.Generator(device=card).manual_seed(7)
    q = torch.randn(b, sq, h, hd, generator=g, device=card).transpose(1, 2)
    k = torch.randn(b, sk, hk, hd, generator=g, device=card).transpose(1, 2)
    v = torch.randn(b, sk, hk, hd, generator=g, device=card).transpose(1, 2)
    kw = dict(causal=True, window=64, softcap=50.0, q_offset=130)
    got = TFA.flash_attention_fwd(q, k, v, **kw)
    assert got.transpose(1, 2).is_contiguous()
    want = TR.flash_attention_ref(q.contiguous(), k.contiguous(),
                                  v.contiguous(), **kw)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_hd160_every_column(card, dtype):
    """hd 160 (stablelm-12b): the p v tiling is 2 x 5 m16n8 tiles a warp,
    two rows of four warps.  The output is filled with NaN before the
    launch (through the wrapper's allocation), so an unwritten column
    shows; o with and without the lse, and the lse, against the plain
    version (f32 o against the float64 formula)."""
    b, h, hk, sq, sk, hd = 2, 8, 2, 130, 200, 160
    g = torch.Generator(device=card).manual_seed(160)
    q = torch.randn(b, h, sq, hd, generator=g, device=card).to(dtype)
    k = torch.randn(b, hk, sk, hd, generator=g, device=card).to(dtype)
    v = torch.randn(b, hk, sk, hd, generator=g, device=card).to(dtype)
    kw = dict(causal=True, window=10 ** 9, softcap=0.0, q_offset=70)
    real = torch.empty_like

    def nan_like(t, **kwargs):
        return real(t, **kwargs).fill_(float("nan"))

    torch.empty_like = nan_like
    try:
        TP.reset_launches()
        o, lse = TFA.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        plain = TFA.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
    finally:
        torch.empty_like = real
    assert TP.LAUNCHES["flash_attention_fwd"] == 2
    assert torch.isfinite(o).all() and torch.isfinite(plain).all()
    assert torch.equal(o, plain)
    want, want_lse = TR.flash_attention_ref(q, k, v, return_lse=True, **kw)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    if dtype == torch.float32:
        want = _flash_ref64(q, k, v, **kw)
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_hd80_is_the_padded_kernel(card, dtype):
    """hd 80 (zamba2-2.7b): the wrapper zero-pads q, k and v to 96
    columns and launches the hd-96 instance once, with the scale of 80.
    Its allocations are filled with NaN first, so a column the kernel
    left unwritten shows; o (80 columns) with and without the lse, and
    the lse, against the plain version at 80 (f32 o against the float64
    formula)."""
    b, h, hk, sq, sk, hd = 2, 8, 8, 130, 200, 80
    g = torch.Generator(device=card).manual_seed(80)
    q = torch.randn(b, h, sq, hd, generator=g, device=card).to(dtype)
    k = torch.randn(b, hk, sk, hd, generator=g, device=card).to(dtype)
    v = torch.randn(b, hk, sk, hd, generator=g, device=card).to(dtype)
    kw = dict(causal=True, window=10 ** 9, softcap=0.0, q_offset=70)
    real = torch.empty_like

    def nan_like(t, **kwargs):
        return real(t, **kwargs).fill_(float("nan"))

    torch.empty_like = nan_like
    try:
        TP.reset_launches()
        o, lse = TFA.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        plain = TFA.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
    finally:
        torch.empty_like = real
    assert TP.LAUNCHES["flash_attention_fwd"] == 2
    assert o.shape == q.shape and o.dtype == dtype
    assert torch.isfinite(o).all() and torch.equal(o, plain)
    want, want_lse = TR.flash_attention_ref(q, k, v, return_lse=True, **kw)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    if dtype == torch.float32:
        want = _flash_ref64(q, k, v, **kw)
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)


@pytest.mark.parametrize("bits", BITS)
def test_hops_at_new_widths(card, bits):
    """B1 and B2 at gemma2-27b's and stablelm-12b's decode hops (2, 4608)
    and (2, 5120), a block a row: deterministic, with noise, seeded, and
    the receiver, bit for bit."""
    seed = torch.tensor((3, -4), dtype=torch.int32, device=card)
    for d in (4608, 5120):
        m = _x(2, d, 5, card)
        a = m + _x(2, d, 6, card)
        u = torch.rand(2, d, device=card)
        for uu in (None, u):
            got = TP.delta_quantize_pack(a, m, uu, bits=bits)
            _equal(got, TR.delta_quantize_pack_ref(a, m, bits, uu))
            _equal([TP.dequant_unpack_accumulate(got[0], got[1], m,
                                                 bits=bits)],
                   [TR.dequant_unpack_accumulate_ref(got[0], got[1], m,
                                                     bits)])
            _equal([got[2]], [TP.dequant_unpack_accumulate(
                got[0], got[1], m, bits=bits)])
        _equal(TP.delta_quantize_pack(a, m, bits=bits, seed=seed),
               TR.delta_quantize_pack_ref(
                   a, m, bits, TR.oncore_uniform_ref(seed, 2, d)))


def test_flash_attention_checks(card):
    q = torch.randn(1, 2, 8, 64, device=card)
    wide = torch.randn(1, 2, 8, 72, device=card)
    for hd in (48, 72):          # no instance and no padded width
        t = wide[..., :hd].contiguous()
        with pytest.raises(ValueError, match="head_dim"):
            TFA.flash_attention_fwd(t, t, t)
    with pytest.raises(TypeError):
        TFA.flash_attention_fwd(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        TFA.flash_attention_fwd(q.transpose(2, 3).contiguous()
                                .transpose(2, 3), q, q)
    with pytest.raises(ValueError):
        TFA.flash_attention_fwd(q, q.cpu(), q)             # mixed devices


# the training attention at the trainers' shapes: (b, h, hk, s, hd,
# window, softcap, q scale); gemma2's q scaled so scores reach the cap
TRAIN_ATTN = [(4, 25, 25, 1024, 64, 1024, 0.0, 1.0),
              (4, 32, 32, 1024, 80, 1024, 0.0, 1.0),      # zamba2
              (1, 16, 8, 1024, 256, 4096, 50.0, 16.0),
              (1, 16, 8, 1024, 256, 512, 50.0, 16.0),
              (2, 32, 8, 512, 160, 10 ** 9, 0.0, 1.0)]     # stablelm-12b
TRAIN_GRAD_TOL = 1e-4


def _train_attn64(q, k, v, window, cap):
    """The training attention's formula in float64, differentiable:
    (o (B, S, H, hd), lse (B, H, S)); q (B, S, H, hd), k, v (B, S, Hk,
    hd), query i and key j at positions i and j."""
    b, s, h, hd = q.shape
    grp = h // k.shape[2]
    kk = k.repeat_interleave(grp, dim=2)
    vv = v.repeat_interleave(grp, dim=2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(hd)
    if cap > 0:
        sc = cap * torch.tanh(sc / cap)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    sc = torch.where((j <= i) & (j > i - window), sc, TR.NEG_INF)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), vv)
    return o, torch.logsumexp(sc, -1)


@pytest.mark.parametrize("case", TRAIN_ATTN)
def test_training_attention_matches_float64(card, case):
    from repro_torch.models import layers as TL
    b, h, hk, s, hd, window, cap, qs = case
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=card).manual_seed(s + hd)
    q = torch.randn(b, s, h, hd, generator=gen, device=card) * qs
    k, v = (torch.randn(b, s, hk, hd, generator=gen, device=card)
            for _ in "kv")
    g = torch.randn(b, s, h, hd, generator=gen, device=card)
    heads = [t.transpose(1, 2) for t in (q, k, v)]
    kw = dict(causal=True, window=window, softcap=cap)
    TP.reset_launches()
    o, lse = TFA.flash_attention_fwd(*heads, return_lse=True, **kw)
    plain = TFA.flash_attention_fwd(*heads, **kw)
    assert TP.LAUNCHES["flash_attention_fwd"] == 2
    assert torch.equal(o, plain)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = TL.flash_attention(*leaves, window=window, attn_softcap=cap)
    grads = torch.autograd.grad(out, leaves, g)
    assert torch.equal(out.detach(), o.transpose(1, 2))
    ref = [t.double().requires_grad_() for t in (q, k, v)]
    o64, lse64 = _train_attn64(*ref, window, cap)
    grads64 = torch.autograd.grad(o64, ref, g.double())
    torch.testing.assert_close(o.transpose(1, 2), o64.float(), rtol=2e-5,
                               atol=2e-5)
    torch.testing.assert_close(lse, lse64.float(), rtol=2e-5, atol=2e-5)
    for name, got, want in zip("qkv", grads, grads64):
        err = (got.double() - want).abs().max().item()
        assert err <= TRAIN_GRAD_TOL * want.abs().max().item(), (name, err)


# non-causal calls, every key visible to every row (the whisper
# encoder's self-attention, cross attention over its frames): (b, h, hk,
# sq, sk, hd, q_offset); Sk of 1500 off the 32-key tile, Sq past Sk (the
# decoder rows outnumbering the frames, at a query offset too), GQA,
# several query tiles walked latest first
NONCAUSAL_ATTN = [(2, 12, 12, 1500, 1500, 64, 0),
                  (2, 12, 12, 128, 1500, 64, 0),
                  (1, 4, 4, 200, 75, 64, 0),
                  (1, 4, 2, 130, 37, 128, 50),
                  (1, 2, 2, 65, 33, 256, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", NONCAUSAL_ATTN)
def test_flash_attention_noncausal_matches_float64(card, case, dtype):
    """f32 against the float64 formula (2e-5), bf16 against the plain
    version (2e-2); one launch a call."""
    b, h, hk, sq, sk, hd, off = case
    g = torch.Generator(device=card).manual_seed(sq + sk + hd)
    q = torch.randn(b, h, sq, hd, generator=g, device=card).to(dtype)
    k, v = (torch.randn(b, hk, sk, hd, generator=g, device=card).to(dtype)
            for _ in "kv")
    kw = dict(causal=False, window=10 ** 9, softcap=0.0, q_offset=off)
    TP.reset_launches()
    got = TFA.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert TP.LAUNCHES["flash_attention_fwd"] == 1
    if dtype == torch.float32:
        want, tol = _flash_ref64(q, k, v, **kw), 2e-5
    else:
        want, tol = TR.flash_attention_ref(q, k, v, **kw), 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("sq,sk", [(300, 300), (448, 1500), (200, 75)])
def test_noncausal_training_attention_matches_float64(card, sq, sk):
    """The training attention at ``causal=False`` (the encoder's, Sq =
    Sk, and cross attention's, keys of another length): o and lse within
    2e-5 of the float64 formula, dq, dk, dv within 1e-4 of each one's
    largest."""
    from repro_torch.models import layers as TL
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, hd = 2, 12, 64
    gen = torch.Generator(device=card).manual_seed(sq + sk)
    q = torch.randn(b, sq, h, hd, generator=gen, device=card)
    k, v = (torch.randn(b, sk, h, hd, generator=gen, device=card)
            for _ in "kv")
    g = torch.randn(b, sq, h, hd, generator=gen, device=card)
    o, lse = TFA.flash_attention_fwd(*(t.transpose(1, 2) for t in (q, k, v)),
                                     causal=False, return_lse=True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = TL.flash_attention(*leaves, window=TL.BIG_WINDOW, causal=False)
    grads = torch.autograd.grad(out, leaves, g)
    assert torch.equal(out.detach(), o.transpose(1, 2))
    ref = [t.double().requires_grad_() for t in (q, k, v)]
    sc = torch.einsum("bqhd,bkhd->bhqk", ref[0], ref[1]) / math.sqrt(hd)
    o64 = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), ref[2])
    grads64 = torch.autograd.grad(o64, ref, g.double())
    torch.testing.assert_close(o.transpose(1, 2), o64.float(), rtol=2e-5,
                               atol=2e-5)
    torch.testing.assert_close(lse, torch.logsumexp(sc, -1).float(),
                               rtol=2e-5, atol=2e-5)
    for name, got, want in zip("qkv", grads, grads64):
        err = (got.double() - want).abs().max().item()
        assert err <= TRAIN_GRAD_TOL * want.abs().max().item(), (name, err)


@pytest.mark.parametrize("arch", ["gpt2-xl-paper", "gemma2-9b"])
def test_remat_gradients_are_bit_equal(card, arch):
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as TM
    cfg = get_config(arch, smoke=True)
    model = TM.Transformer(cfg, device=card,
                           generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 41), generator=gen)
    batch = {"tokens": toks[:, :-1].to(card),
             "targets": toks[:, 1:].to(card),
             "mask": torch.ones(2, 40, device=card)}
    params = list(model.parameters())
    out = []
    for remat in (False, True):
        TP.reset_launches()
        loss, _ = TM.loss_fn(model, batch, num_stages=2, remat=remat)
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        assert TP.LAUNCHES["flash_attention_fwd"] == \
            cfg.num_layers * (2 if remat else 1)
        out.append((loss, grads))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the rest of the DP wires and the optimizer
# ---------------------------------------------------------------------------

def _grad_trees(n, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [[(torch.randn(57, 33, generator=g) * 0.1).to(dev),
             torch.randn(19, generator=g).to(dev),
             torch.randn(4064, 2, generator=g).to(dev)] for _ in range(n)]


@pytest.mark.parametrize("n", [2, 3])
def test_reduce_scatter_sim_matches_cpu(card, n):
    from repro_torch.core import grad_compress as TG
    lay = TG.bucket_layout(_grad_trees(1, "cpu")[0], 512)
    err = torch.randn(n, lay.rows, 512,
                      generator=torch.Generator().manual_seed(5)) * 1e-3
    out = {}
    for dev in ("cpu", card):
        TP.reset_launches()
        segs, new_err = TG.compress_reduce_scatter(
            _grad_trees(n, dev), err.to(dev), 4, stochastic=False,
            layout=lay)
        mean, full_err = TG.compress_allreduce(
            _grad_trees(n, dev), err.to(dev), 4, stochastic=False,
            layout=lay)
        if dev != "cpu":
            assert TP.LAUNCHES["quantize_codes_scaled"] == 2 * n
        flat = TG.flatten_bucket(mean, lay).reshape(-1)[:lay.total]
        assert torch.equal(segs.reshape(-1)[:lay.total], flat)
        assert torch.equal(new_err, full_err)
        assert (segs.reshape(-1)[lay.rows * 512:] == 0).all()
        out[str(dev)] = (segs.cpu(), new_err.cpu())
    a, b = out.values()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_bucket_adamw_equals_leaf_adamw_on_card(card):
    from repro_torch.optim import adamw as TO
    cfg = TO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    g = torch.Generator().manual_seed(3)
    p = torch.randn(300, 512, generator=g).to(card)
    leaf = {"w": p.clone()}
    bucket = p.clone()[None]
    ls, bs = TO.init_opt_state(leaf), TO.init_bucket_opt_state(
        1, 300, 512, device=card)
    for _ in range(4):
        grad = torch.randn(300, 512, generator=g).to(card)
        ls = TO.apply_updates(cfg, leaf, {"w": grad}, ls)
        bs = TO.apply_bucket_updates(cfg, bucket, grad[None], bs)
        assert torch.equal(leaf["w"], bucket[0])
        assert torch.equal(ls["nu"]["w"], bs["nu"][0])


def test_sim_ring_sharded_stream_equals_ring_on_card(card):
    from repro_torch.comm.config import CommConfig, PlaneConfig
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import Dataset, DatasetConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training import simulated as TS
    cfg = get_config("gpt2-xl-paper", smoke=True).with_(num_layers=2)
    losses = {}
    for wire in ("ring", "ring-sharded", "fp16"):
        tcfg = TS.SimTrainConfig(
            num_stages=2, dp_workers=2,
            comm=CommConfig(dp=PlaneConfig(bits=4, wire=wire)),
            optimizer=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4))
        ds = Dataset(DatasetConfig(num_samples=8, seq_len=16,
                                   vocab_size=cfg.vocab_size))
        _, losses[wire] = TS.train(cfg, tcfg, ds, num_steps=4, batch_size=4,
                                   device=card)
    assert losses["ring-sharded"] == losses["ring"]
    assert all(math.isfinite(x) for x in losses["fp16"])


def test_fp16_sum_and_8bit_moments_match_cpu(card):
    from repro_torch.comm import wires as TW
    from repro_torch.core import grad_compress as TG
    from repro_torch.optim import adamw as TO
    lay = TG.bucket_layout(_grad_trees(1, "cpu")[0], 512)
    err = torch.zeros(3, lay.rows, 512)
    got = [TW.fp16_sim_allreduce(_grad_trees(3, dev), err.to(dev), 4,
                                 layout=lay) for dev in ("cpu", card)]
    for a, b in zip(got[0][0], got[1][0]):
        assert torch.equal(a, b.cpu())
    cfg = TO.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                         state_bits=8)
    g = torch.Generator().manual_seed(4)
    p = torch.randn(64, 33, generator=g)
    params = {dev: {"w": p.clone().to(dev)} for dev in ("cpu", card)}
    states = {dev: TO.init_opt_state(params[dev], 8) for dev in params}
    differed = {m: torch.zeros(64, 33, dtype=torch.bool) for m in states[card]
                if m != "step"}
    for _ in range(4):
        grad = torch.randn(64, 33, generator=g)
        cpu = states["cpu"]
        # the moments before rounding, from the CPU's incoming state
        mu = TO._q_dec(cpu["mu"]["w"], 8).double()
        nu = TO._q_dec(cpu["nu"]["w"], 8).double() ** 2
        pre = {"mu": 0.9 * mu + 0.1 * grad.double(),
               "nu": (0.999 * nu + 0.001 * grad.double() ** 2).sqrt()}
        for dev in params:
            states[dev] = TO.apply_updates(cfg, params[dev],
                                           {"w": grad.to(dev)}, states[dev])
        torch.testing.assert_close(params[card]["w"].cpu(),
                                   params["cpu"]["w"], rtol=1e-6, atol=1e-7)
        for m in differed:
            a, b = states["cpu"][m]["w"], states[card][m]["w"]
            torch.testing.assert_close(b["scale"].cpu(), a["scale"],
                                       rtol=1e-6, atol=0)
            diff = a["codes"] != b["codes"].cpu()
            y = (pre[m] / a["scale"].double() + 1) * 127.5
            near = (y - y.floor() - 0.5).abs() <= 1e-3
            assert bool((~diff | near | differed[m]).all()), m
            differed[m] |= diff


@pytest.mark.parametrize("case", [
    (2, 16, 16, 4064, 4096, 10 ** 9),      # deepseek-moe-16b's prefill
    (2, 48, 8, 8160, 8192, 4096),          # mixtral-8x22b's, GQA 6:1
])
def test_flash_attention_moe_prefills(card, case):
    """B10 at the moe family's full prefill shapes (hd 128, causal, as
    the model passes them: transposed (B, S, H, hd) views) against the
    plain version, a batch row and kv head at a time (mixtral's whole
    score tensor is 25.7 GB), within 1e-4 (chip_smoke's path
    tolerance); one launch."""
    b, h, hk, sq, sk, window = case
    g = torch.Generator(device=card).manual_seed(sq)
    q = torch.randn(b, sq, h, 128, generator=g, device=card).transpose(1, 2)
    k, v = (torch.randn(b, sk, hk, 128, generator=g,
                        device=card).transpose(1, 2) for _ in range(2))
    kw = dict(causal=True, window=window, softcap=0.0, q_offset=0)
    TP.reset_launches()
    got = TFA.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert TP.LAUNCHES["flash_attention_fwd"] == 1
    r = h // hk
    for i in range(b):
        for j in range(hk):
            heads = slice(j * r, (j + 1) * r)
            want = TR.flash_attention_ref(q[i:i + 1, heads],
                                          k[i:i + 1, j:j + 1],
                                          v[i:i + 1, j:j + 1], **kw)
            torch.testing.assert_close(got[i:i + 1, heads], want,
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mixtral-8x22b"])
def test_moe_ffn_on_card_matches_cpu(card, arch):
    """The MoE FFN (plain PyTorch: router, stable sort, dispatch, expert
    matmuls, the fixed-order combine) at SMOKE width and capacity_factor
    1.25 on the card against the CPU on the same weights and x: the
    routing equal where the k-th and (k+1)-th probabilities lie 1e-5
    apart, the keep masks equal, out, aux and every gradient within
    1e-4; two card runs bit-equal (no atomics in the combine)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe as TMoE

    cfg = get_config(arch, smoke=True).with_(capacity_factor=1.25)
    m = {"cpu": TMoE.MoE(cfg)}
    m["cpu"].reset_parameters(torch.Generator().manual_seed(0))
    m[card] = TMoE.MoE(cfg, device=card)
    m[card].load_state_dict(m["cpu"].state_dict())
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 40, cfg.d_model, generator=g) \
        + torch.randn(cfg.d_model, generator=g)
    w = torch.randn(3, 40, cfg.d_model, generator=g)
    runs = {}
    for dev in ("cpu", card, card):
        xd = x.to(dev).requires_grad_()
        out, aux = TMoE.moe_ffn(m[dev], xd, top_k=cfg.top_k,
                                capacity_factor=1.25)
        grads = torch.autograd.grad((out * w.to(dev)).sum() + aux,
                                    [xd, *m[dev].parameters()])
        with torch.no_grad():
            r = TMoE.route(m[dev], xd.reshape(1, -1, cfg.d_model),
                           cfg.top_k, TMoE.capacity(120, cfg.top_k,
                                                    cfg.n_experts, 1.25))
        runs.setdefault(str(dev), []).append(
            [t.detach().cpu() for t in (out, aux, *grads)]
            + [r[k].cpu() for k in ("probs", "top_i", "keep")])
    (cpu,), (one, two) = runs["cpu"], runs[str(card)]
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    top = cpu[-3].sort(-1, descending=True).values
    clear = top[..., cfg.top_k - 1] - top[..., cfg.top_k] > 1e-5
    assert bool(clear.all())
    assert torch.equal(cpu[-2].sort(-1).values, one[-2].sort(-1).values)
    assert torch.equal(cpu[-1], one[-1]) and not bool(cpu[-1].all())
    for a, b in zip(cpu[:-3], one[:-3]):
        scale = max(1.0, a.abs().max().item())
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4 * scale)



def test_prefill_over_a_bf16_raw_cache(card):
    """A prefill over raw bf16 k and v stores (the continuous batcher's
    default dtype, which a MoE model's dense prefix keeps raw) with f32
    queries: the layer reads the stores in q's dtype, as JAX's attention
    promotes them; one B10 launch, within 1e-4 of the plain version over
    the same q and the stores as written."""
    from repro_torch.models import layers as L

    att = L.Attention(256, 4, 4, 64, 10000.0, device=card)
    att.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(1, 12, 256, generator=torch.Generator().manual_seed(1))
    x = x.to(card)
    kc, vc = (torch.zeros(1, 24, 4, 64, dtype=torch.bfloat16, device=card)
              for _ in range(2))
    pos = torch.arange(12, dtype=torch.int32, device=card)[None]
    TP.reset_launches()
    with torch.no_grad():
        out, _, _ = att(x, pos, TFA.BIG_WINDOW, kc, vc, 0)
        torch.cuda.synchronize()
        assert TP.LAUNCHES["flash_attention_fwd"] == 1
        q = L.rope((x @ att.wq).reshape(1, 12, 4, 64), pos, 10000.0)
        want = TR.flash_attention_ref(
            q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
            causal=True, window=TFA.BIG_WINDOW, softcap=0.0, q_offset=0)
        want = want.transpose(1, 2).reshape(1, 12, 256) @ att.wo
    assert kc.dtype == torch.bfloat16 and bool(kc[0, :12].abs().gt(0).any())
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)


# the continuous batcher's pool on the ssm, hybrid and audio families:
# one pooled step (or admission) on the card against the same weights and
# pool on the CPU, logits within the serving checks' decode tolerance
POOL_DECODE_ATOL = 5e-3


def _family_pool(arch, card, *, kv_bits=0, **cfg_kw):
    """``arch``'s SMOKE model (fields ``cfg_kw`` replaced) on the CPU and
    on the card from one CPU seed, and a 3-slot bf16 pool the CPU batcher
    filled by admitting prompts of 4, 9 and 6 tokens (heads 4, 9, 6),
    copied to the card: (models, batchers, pools by device)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Transformer
    from repro_torch.serving import ContinuousBatcher, KVCodec

    cfg = get_config(arch, smoke=True).with_(**cfg_kw)
    models, bats = {}, {}
    for dev in ("cpu", card):
        models[dev] = Transformer(cfg, device=dev,
                                  generator=torch.Generator().manual_seed(0))
        bats[dev] = ContinuousBatcher(models[dev], num_slots=3, cache_len=16,
                                      kv_codec=KVCodec(bits=kv_bits))
    gen = torch.Generator().manual_seed(5)
    for n in (4, 9, 6):
        bats["cpu"].submit(torch.randint(0, cfg.vocab_size, (n,),
                                         generator=gen).tolist(),
                           max_new_tokens=8)
    bats["cpu"]._admit()
    return models, bats


def _pooled_step(bat, pool, tokens):
    """One pooled decode step of ``bat`` over ``pool`` (written in
    place) from ``tokens``: (its logits on the CPU, the pool)."""
    bat.caches = pool
    bat._next_tok = tokens
    bat._decode()
    return bat.last_logits.cpu(), bat.caches


def test_pooled_ssm_step_on_card_matches_cpu(card):
    """mamba2's pooled decode step over a bf16 pool (f32 ssm states,
    bf16 conv windows) on the card against the CPU: logits within
    POOL_DECODE_ATOL, the new states within 1e-4 of their largest value
    (the conv windows also within one bf16 step), written in place into
    the pool's own storage; no kernel launches (no KV, one stage)."""
    models, bats = _family_pool("mamba2-1.3b", card)
    pool = {k: v.clone() for k, v in bats["cpu"].caches.items()}
    gpool = {k: v.to(card, copy=True) for k, v in pool.items()}
    tokens = bats["cpu"]._next_tok.clone()
    want, new_cpu = _pooled_step(bats["cpu"], pool, tokens)
    ptrs = {k: gpool[k].data_ptr() for k in ("ssm", "conv")}
    TP.reset_launches()
    got, new_card = _pooled_step(bats[card], gpool, tokens.to(card))
    torch.cuda.synchronize()
    assert all(n == 0 for n in TP.LAUNCHES.values()), TP.LAUNCHES
    assert {k: new_card[k].data_ptr() for k in ptrs} == ptrs
    assert new_card["conv"].dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=POOL_DECODE_ATOL)
    for name in ("ssm", "conv"):
        c, g = new_cpu[name].float(), new_card[name].cpu().float()
        tol = 1e-4 * c.abs().max().item()
        if name == "conv":
            tol = torch.maximum(torch.full_like(c, tol),
                                c.abs() * 2.0 ** -7)
        assert bool(((c - g).abs() <= tol).all()), name
    assert torch.equal(new_card["pos"].cpu(), new_cpu["pos"])


def test_hybrid_admission_over_bf16_pool_at_hd80(card):
    """zamba2's admission prefill into a fresh bf16 row (the launcher's
    pool dtype) at head_dim 80: the shared block's B10 call reads the
    raw bf16 k and v in the queries' f32 through the hd-96 copies, one
    launch a block, the layer's output within 1e-4 of the plain version
    over the same stores; the row's logits within POOL_DECODE_ATOL of
    the CPU's."""
    from repro_torch.models import layers as L

    models, bats = _family_pool("zamba2-2.7b", card, head_dim=80)
    prompt = list(range(3, 15))
    want, _ = bats["cpu"]._prefill(prompt)
    TP.reset_launches()
    got, row = bats[card]._prefill(prompt)
    torch.cuda.synchronize()
    cfg = models[card].cfg
    assert TP.LAUNCHES["flash_attention_fwd"] == cfg.n_blocks
    assert row["k"].dtype == torch.bfloat16 and row["k"].shape[-1] == 80
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=POOL_DECODE_ATOL)
    att = models[card].shared_block.attn
    x = torch.randn(1, 12, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(card)
    kc, vc = (torch.zeros(1, 16, cfg.num_kv_heads, 80, dtype=torch.bfloat16,
                          device=card) for _ in range(2))
    pos = torch.arange(12, dtype=torch.int32, device=card)[None]
    TP.reset_launches()
    with torch.no_grad():
        out, _, _ = att(x, pos, TFA.BIG_WINDOW, kc, vc, 0)
        torch.cuda.synchronize()
        assert TP.LAUNCHES["flash_attention_fwd"] == 1
        q = L.rope((x @ att.wq).reshape(1, 12, cfg.num_heads, 80), pos,
                   cfg.rope_theta)
        ref = TR.flash_attention_ref(
            q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
            causal=True, window=TFA.BIG_WINDOW, softcap=0.0, q_offset=0)
        ref = ref.transpose(1, 2).reshape(1, 12, -1) @ att.wo
    assert bool(kc[0, :12].abs().gt(0).any())
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_whisper_decode_over_bf16_cross_caches(card):
    """whisper's pooled decode step with 8-bit KV over the pool's bf16
    cross caches, filled here with random values (the batcher leaves
    them zero): on the card against the CPU, logits within
    POOL_DECODE_ATOL, the KV pair once a layer; the cross attention
    reads bf16 ``xk``/``xv`` to the bits it reads their f32 widening."""
    models, bats = _family_pool("whisper-small", card, kv_bits=8)
    pool = {k: v.clone() for k, v in bats["cpu"].caches.items()}
    gen = torch.Generator().manual_seed(9)
    for name in ("xk", "xv"):
        assert pool[name].dtype == torch.bfloat16
        pool[name].copy_(torch.randn(pool[name].shape, generator=gen))
    tokens = bats["cpu"]._next_tok.clone()
    gpool = {k: v.to(card, copy=True) for k, v in pool.items()}
    want, _ = _pooled_step(bats["cpu"], pool, tokens)
    TP.reset_launches()
    got, _ = _pooled_step(bats[card], gpool, tokens.to(card))
    torch.cuda.synchronize()
    layers = models[card].cfg.num_layers
    assert TP.LAUNCHES["quantize_pack"] == layers
    assert TP.LAUNCHES["unpack_dequant"] == layers
    torch.testing.assert_close(got, want, rtol=0, atol=POOL_DECODE_ATOL)
    xattn = models[card].layers[0].xattn
    x = torch.randn(3, 1, models[card].cfg.d_model, device=card)
    qpos = gpool["pos"][:, None]
    xk, xv = gpool["xk"][0], gpool["xv"][0]
    with torch.no_grad():
        assert torch.equal(xattn.cross(x, qpos, xk, xv),
                           xattn.cross(x, qpos, xk.float(), xv.float()))
