"""Seeded stochastic rounding in the port (the `seed=` path of the
encode kernels), and the launchers' device-independent weights.

The JAX package's Pallas encoders can draw their noise on the TPU core
(``REPRO_ONCORE_PRNG=1``); their bits depend on the grid blocks, so no
port reproduces them and the reference gates that path statistically
(tests/test_grad_compress.py).  The port's kernels draw Philox4x32-10
over each element's index (`repro_torch.kernels.ref.philox4x32_10`,
`oncore_uniform_ref`), so the plain version draws the same bits: here
on the CPU the plain Philox meets Random123's known answers, the stream
is a seeded, sliceable U[0, 1) on the 2**-24 grid, and the seeded
encoders round without bias over 10k trials (the 5 sigma harness of
tests/test_grad_compress.py), as JAX's reference encoder does on the
same numpy inputs.  The kernels themselves are held to the plain
version bit for bit on the card (tests/test_torch_cuda.py,
chip_smoke.py).  The knob (``ACSGD_ONCORE_PRNG``) changes nothing on
the CPU, in the distributed trainer too (whose seeded DP wires are
tests/test_torch_ring.py's).

Run: ``PYTHONPATH=src python -m pytest -q tests/test_torch_oncore.py``.
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import boundary as JB
from repro_torch.comm.config import CommConfig, PlaneConfig
from repro_torch.configs.base import get_config
from repro_torch.core import boundary as TB
from repro_torch.core import quantization as Q
from repro_torch.data.pipeline import Dataset, DatasetConfig
from repro_torch.kernels import quant_pack as TP
from repro_torch.kernels import ref as TR
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models.model import Transformer
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training import simulated as TS


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = pathlib.Path(__file__).resolve().parents[1]
KNOB = "ACSGD_ONCORE_PRNG"
N_TRIALS = 10_000
M32 = 0xFFFFFFFF


def _seed(a, b):
    return torch.tensor([a, b], dtype=torch.int32)


# ---------------------------------------------------------------------------
# the plain Philox and its uniform stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), "6627e8d5 e169c58d bc57ac4c 9b00dbd8"),
    ((M32,) * 4, (M32, M32), "408f276d 41c83b0e a20bc7c6 6d5451fd"),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0), "d16cfe09 94fdcceb 5001e420 24126ea1"),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's kat_vectors for philox4x32_10."""
    out = TR.philox4x32_10(torch.tensor(ctr, dtype=torch.int64),
                           torch.tensor(key, dtype=torch.int64))
    assert " ".join(f"{int(w):08x}" for w in out) == want


def test_oncore_uniform_is_on_the_24_bit_grid():
    u = TR.oncore_uniform_ref(_seed(-7, 2 ** 31 - 1), 37, 515)
    assert u.shape == (37, 515) and u.dtype == torch.float32
    k = u.double() * 2 ** 24
    assert torch.equal(k, k.round())
    assert 0.0 <= u.min().item() and u.max().item() <= 1.0 - 2.0 ** -24


def test_oncore_uniform_is_seeded():
    a = TR.oncore_uniform_ref(_seed(1, 2), 16, 64)
    assert torch.equal(a, TR.oncore_uniform_ref(_seed(1, 2), 16, 64))
    for other in (_seed(1, 3), _seed(2, 2), _seed(-1, 2)):
        b = TR.oncore_uniform_ref(other, 16, 64)
        assert (a != b).float().mean().item() > 0.99


@pytest.mark.parametrize("rows,d,lo,hi", [(10, 64, 3, 7), (9, 6, 1, 8),
                                          (7, 5, 2, 3), (5, 1, 0, 5)])
def test_oncore_uniform_slices_like_the_full_draw(rows, d, lo, hi):
    """Rows [lo, hi) drawn alone equal that slice of the full draw, at
    any alignment of the 4-element counter groups: the stream depends
    on the element's index and the seed, not on how a call is cut."""
    seed = _seed(123, -456)
    full = TR.oncore_uniform_ref(seed, rows, d)
    part = TR.oncore_uniform_ref(seed, hi - lo, d, row0=lo)
    assert torch.equal(part, full[lo:hi])


def test_oncore_uniform_moments():
    """Mean 0.5 and lag-1 correlation 0 along rows (neighbours in one
    Philox call) and columns (d apart), each within 5 sigma."""
    u = TR.oncore_uniform_ref(_seed(11, 12), 999, 1001).double()
    n = u.numel()
    assert abs(u.mean().item() - 0.5) < 5 * (1 / 12 / n) ** 0.5

    def corr(x, y):
        x, y = x - x.mean(), y - y.mean()
        return ((x * y).mean() / (x.std() * y.std())).item(), x.numel()

    for r, m in (corr(u[:, :-1], u[:, 1:]), corr(u[:-1], u[1:])):
        assert abs(r) < 5 / m ** 0.5, r


# ---------------------------------------------------------------------------
# unbiased rounding through the seeded encoders (plain versions)
# ---------------------------------------------------------------------------

def _x(seed=5):
    return np.random.default_rng(seed).standard_normal((4, 64)) \
        .astype(np.float32)


def _bound(x, bits):
    """5 sigma of a 10k-trial mean on the b-bit grid of each row (the
    harness of tests/test_grad_compress.py)."""
    scale = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-12)
    cell = 2.0 * scale / ((1 << bits) - 1)
    return 5.0 * cell / (2.0 * np.sqrt(N_TRIALS))


def _tiled_mean(q):
    return q.reshape(N_TRIALS, 4, 64).mean(0).double().numpy()


def _seeded_mean(op, x, bits):
    """Mean over 10k trials of one seeded encode -> decode, as one call
    over the tiled batch (each row draws its own noise)."""
    xt = torch.from_numpy(x).repeat(N_TRIALS, 1)
    seed = _seed(6, 7)
    if op == "quantize_codes_scaled":
        s = torch.clamp(xt.abs().amax(-1, keepdim=True), min=Q._EPS)
        codes = TP.quantize_codes_scaled(xt, s, bits=bits, seed=seed)
        return _tiled_mean(Q.dequant_sum_mean(codes, s, bits, 1))
    if op == "delta_quantize_pack":
        m = torch.from_numpy(_x(9)).repeat(N_TRIALS, 1)
        _, _, m_new = TP.delta_quantize_pack(m + xt, m, bits=bits, seed=seed)
        return _tiled_mean(m_new - m)
    packed, s = TP.quantize_pack(xt, bits=bits, seed=seed)
    return _tiled_mean(TR.unpack_dequant_ref(packed, s, bits))


@pytest.mark.parametrize("op,bits", [("quantize_codes_scaled", 2),
                                     ("quantize_codes_scaled", 4),
                                     ("delta_quantize_pack", 4),
                                     ("quantize_pack", 8)])
def test_seeded_encoders_unbiased_10k_trials(op, bits):
    """E[Q(x)] = x for B5 (the DP wire, 2 and 4 bits), B1 (the 4-bit
    forward hop: m_new - m estimates a - m) and B3 (the 8-bit backward
    gradient), with kernel-drawn noise."""
    x = _x()
    err = np.abs(_seeded_mean(op, x, bits) - x)
    assert np.max(err / _bound(x, bits)) < 1.0


@pytest.mark.parametrize("bits", [2, 4])
def test_seeded_mean_agrees_with_jax(bits):
    """On one numpy input, the port's seeded B5 mean and JAX's reference
    encoder's mean over 10k keys both lie within 5 sigma of x."""
    x = _x()
    xj = jnp.asarray(x)
    scale = jnp.maximum(jnp.max(jnp.abs(xj), axis=-1, keepdims=True), 1e-12)

    @jax.jit
    @jax.vmap
    def one(key):
        codes = JB.encode_codes_with_scale(xj, scale, bits=bits,
                                           stochastic=True, key=key,
                                           backend="reference")
        return JB.decode_sum_mean(codes, scale, bits=bits, n=1,
                                  backend="reference")

    jmean = np.asarray(one(jax.random.split(jax.random.PRNGKey(6),
                                            N_TRIALS))).mean(0)
    tmean = _seeded_mean("quantize_codes_scaled", x, bits)
    bound = _bound(x, bits)
    assert np.max(np.abs(jmean - x) / bound) < 1.0
    assert np.max(np.abs(tmean - x) / bound) < 1.0


# ---------------------------------------------------------------------------
# the wrappers and the boundary ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["delta_quantize_pack", "quantize_pack",
                                "quantize_codes_scaled"])
def test_wrappers_refuse_noise_and_seed(op):
    x = torch.randn(4, 8)
    u, seed = torch.rand(4, 8), _seed(1, 2)
    args = {"delta_quantize_pack": (x, x * 0.5),
            "quantize_pack": (x,),
            "quantize_codes_scaled": (x, x.abs().amax(-1, keepdim=True))}[op]
    with pytest.raises(ValueError, match="not both"):
        getattr(TP, op)(*args, u, bits=4, seed=seed)


@pytest.mark.parametrize("op", ["encode_delta", "encode",
                                "encode_codes_with_scale", "roundtrip"])
def test_boundary_seed_path(op, monkeypatch):
    """With the knob on, a stochastic encode on the cuda backend (here
    its plain versions, on CPU tensors) draws a (2,) int32 seed from the
    generator and rounds with the seeded stream; an explicit u wins;
    the reference backend ignores the knob."""
    x = torch.randn(3, 2, 16)
    m = torch.randn(3, 2, 16)
    s = torch.clamp(x.abs().amax(-1, keepdim=True), min=Q._EPS)
    call = {"encode_delta": lambda **kw: TB.encode_delta(x, m, **kw),
            "encode": lambda **kw: TB.encode(x, **kw),
            "encode_codes_with_scale":
                lambda **kw: TB.encode_codes_with_scale(x, s, pack=True,
                                                        **kw),
            "roundtrip": lambda **kw: TB.roundtrip(x, **kw)}[op]

    def run(backend, **kw):
        out = call(bits=4, stochastic=True, backend=backend,
                   generator=torch.Generator().manual_seed(3), **kw)
        return out if isinstance(out, tuple) else (out,)

    seed = torch.randint(-2 ** 31, 2 ** 31, (2,), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(3))
    seeded_u = TR.oncore_uniform_ref(seed, 6, 16).reshape(x.shape)
    drawn_u = torch.rand(x.shape, generator=torch.Generator().manual_seed(3))
    given_u = torch.rand(x.shape, generator=torch.Generator().manual_seed(4))

    def same(a, b):
        return all(torch.equal(p, q) for p, q in zip(a, b))

    monkeypatch.setenv(KNOB, "1")
    TP.reset_launches()
    assert same(run("cuda"), run("reference", u=seeded_u))
    assert same(run("cuda", u=given_u), run("reference", u=given_u))
    assert same(run("reference"), run("reference", u=drawn_u))
    assert TP.LAUNCHES["oncore_uniform"] == 0       # CPU tensors: plain
    monkeypatch.setenv(KNOB, "0")
    assert same(run("cuda"), run("reference", u=drawn_u))


def test_knob_leaves_cpu_training_unchanged(monkeypatch):
    """The simulated trainer on the CPU (stochastic aqsgd 4/8 and 4-bit
    DP over 2 workers): the knob changes no loss, carry or buffer bit,
    since the reference backend ignores it, as in the JAX package."""
    cfg = get_config("gpt2-xl-paper", smoke=True)
    plane = dict(stochastic=True)
    tcfg = TS.SimTrainConfig(
        num_stages=2, dp_workers=2,
        comm=CommConfig(mode="aqsgd", fw=PlaneConfig(bits=4, **plane),
                        bw=PlaneConfig(bits=8, **plane),
                        dp=PlaneConfig(bits=4, **plane)),
        optimizer=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3))

    def run():
        ds = Dataset(DatasetConfig(num_samples=4, seq_len=16,
                                   vocab_size=cfg.vocab_size))
        return TS.train(cfg, tcfg, ds, num_steps=3, batch_size=4, seed=2,
                        device="cpu")

    monkeypatch.delenv(KNOB, raising=False)
    s0, l0 = run()
    monkeypatch.setenv(KNOB, "1")
    s1, l1 = run()
    assert l0 == l1 and all(np.isfinite(l0))
    assert torch.equal(s0["dp_error"], s1["dp_error"])
    assert torch.equal(s0["buffers"]["m"], s1["buffers"]["m"])


DIST_ARGV = ["--device", "cpu", "--smoke", "--distributed", "--data-par",
             "2", "--stages", "2", "--dp-grad-bits", "4", "--steps", "2",
             "--seq", "16", "--samples", "8", "--batch", "4"]


def test_distributed_launcher_takes_the_knob(monkeypatch, capsys):
    """``--distributed`` runs with the knob on: the launcher hands its
    spec to the spawn and prints the run's final loss."""
    monkeypatch.setenv(KNOB, "1")
    seen = []

    def run(specs, timeout):
        seen.extend(specs)
        return [[{"losses": [1.5, 1.25], "start": 0, "orphans_removed": 0}]
                * 4]
    monkeypatch.setattr(tlaunch, "run_distributed", run)
    _, losses = tlaunch.main(DIST_ARGV)
    assert losses == [1.5, 1.25]
    assert "final loss 1.2500" in capsys.readouterr().out
    assert seen == [tlaunch.distributed_spec(
        tlaunch.build_parser().parse_args(DIST_ARGV), torch.device("cpu"))]


def test_distributed_knob_is_a_noop_on_the_cpu(tmp_path):
    """The launcher's SMOKE run (stochastic aqsgd and the 4-bit ring
    over a 2 x 2 gloo mesh) with the knob on and off, in one spawn:
    the reference backend ignores it, so every rank's losses are
    bit-equal."""
    from repro_torch.launch.mesh import spawn
    from test_torch_mesh import knob_worker
    spec = tlaunch.distributed_spec(
        tlaunch.build_parser().parse_args(DIST_ARGV), torch.device("cpu"))
    assert json.loads(spec["comm"])["dp"]["stochastic"]
    out = spawn(knob_worker, 4, (spec,), timeout=120, store_dir=tmp_path)
    for on, off in out:
        assert len(on) == 2 and np.isfinite(on).all()
        assert on == off == out[0][0]


def test_knob_is_read_only_in_env():
    """env.py is the one module of the port that reads the environment
    and the one that names the knob."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    named = {f.name for f in files if KNOB in f.read_text()}
    reads = {f.name for f in files
             if "os.environ" in f.read_text() or "getenv" in f.read_text()}
    assert named == reads == {"env.py"}


# ---------------------------------------------------------------------------
# the launchers' repaired faults
# ---------------------------------------------------------------------------

def _same_weights(a: Transformer, b: Transformer):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_serve_launcher_weights_are_the_cpu_draw(monkeypatch):
    built = []

    class Capture(Transformer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(tserve, "Transformer", Capture)
    out = tserve.main(["--arch", "gpt2-xl-paper", "--smoke", "--batch", "1",
                       "--prompt-len", "4", "--gen", "1", "--seed", "5",
                       "--device", "cpu"])
    assert out["build_s"] >= 0
    cfg = get_config("gpt2-xl-paper", smoke=True)
    _same_weights(built[0], Transformer(
        cfg, generator=torch.Generator().manual_seed(5)))


def test_train_weights_are_the_cpu_draw():
    cfg = get_config("gpt2-xl-paper", smoke=True)
    ds = Dataset(DatasetConfig(num_samples=4, seq_len=8,
                               vocab_size=cfg.vocab_size))
    state, losses = TS.train(cfg, TS.SimTrainConfig(num_stages=2), ds,
                             num_steps=0, batch_size=4, seed=3, device="cpu")
    assert losses == []
    _same_weights(state["model"], Transformer(
        cfg, generator=torch.Generator().manual_seed(3)))


def test_serve_parser_defaults_to_gemma2():
    """As the JAX launcher (`repro.launch.serve`, ``--arch`` default)."""
    assert tserve.build_parser().parse_args([]).arch == "gemma2-9b"
