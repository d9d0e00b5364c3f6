"""The port's checkpoint subsystem (`repro_torch.checkpoint`) against the
JAX package's (`repro.checkpoint`).

tests/test_checkpoint.py's cases on a tree of tensors, numpy arrays and
an int: bit-exact round trips (bf16, f32, bool, int32, uint32, a Python
int step as JAX's 0-d int32), fail-closed refusals of a flipped byte in
either file and of a per-array CRC swap behind a rewritten SHA-256,
keep-last-k rotation, the re-commit of an existing step, orphan
cleanup, the structure and comm diffs.

Across packages, the on-disk format is one: a checkpoint written by
either package is verified and restored by the other bit for bit, with
equal fingerprints — small trees, the simulated trainer's whole state
(`training.simulated.to_jax_state` against JAX's `init_train_state`
structure, on the ``ring`` and ``ring-sharded`` DP wires, both
directions), and the launchers' ``--checkpoint`` params export.  After a
JAX-written state is restored into the port, one more step in each
package gives losses within tests/test_torch_train.py's later-step
tolerance (the packages' f32 kernels differ by ulps, and a 4-bit code
can flip on an ulp).  The port's trainer runs on one torch thread
here, as in tests/test_torch_runner.py: the tests share the host with
other test workers.
"""
import hashlib
import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro.comm import CommConfig as JComm
from repro.configs.base import get_config as jget
from repro.data import pipeline as JD
from repro.models import model as Mo
from repro.optim.adamw import AdamWConfig as JAdam
from repro.training import simulated as JS
from repro_torch import checkpoint as ck
from repro_torch.comm.config import CommConfig as TComm
from repro_torch.configs.base import get_config as tget
from repro_torch.data import pipeline as TD
from repro_torch.launch import train as tlaunch
from repro_torch.optim.adamw import AdamWConfig as TAdam
from repro_torch.training import simulated as TS
from repro_torch.weights import (from_jax_params, load_jax_params,
                                 to_jax_params)

ARCH = "gpt2-xl-paper"
LATER_STEP_RTOL = 1e-3          # tests/test_torch_train.py's


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_tree():
    """Every dtype class a training state stores: bf16 (stored as f32),
    f32, bool, int32, uint32 (numpy), and a Python int step."""
    rng = np.random.default_rng(0)
    return {
        "params": {"w": torch.tensor(rng.standard_normal((3, 4)),
                                     dtype=torch.bfloat16),
                   "b": torch.tensor(rng.standard_normal(4),
                                     dtype=torch.float32)},
        "opt": {"mu": torch.tensor(rng.standard_normal((3, 4)),
                                   dtype=torch.float32),
                "step": 7},
        "seen": torch.tensor([True, False, True]),
        "k_run": np.asarray([123, 456], np.uint32),
        "count": torch.tensor(5, dtype=torch.int32),
    }


def make_jax_tree():
    """`make_tree`'s structure and values in the JAX package."""
    t = make_tree()
    return {
        "params": {"w": jnp.asarray(t["params"]["w"].float().numpy(),
                                    jnp.bfloat16),
                   "b": jnp.asarray(t["params"]["b"].numpy())},
        "opt": {"mu": jnp.asarray(t["opt"]["mu"].numpy()),
                "step": jnp.asarray(7, jnp.int32)},
        "seen": jnp.asarray(t["seen"].numpy()),
        "k_run": jnp.asarray(t["k_run"]),
        "count": jnp.asarray(5, jnp.int32),
    }


def _np(leaf):
    if isinstance(leaf, torch.Tensor):
        return (leaf.float() if leaf.dtype == torch.bfloat16 else leaf) \
            .detach().cpu().numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    a = np.asarray(leaf)
    return a.astype(np.float32) if a.dtype.kind not in "biufc" else a


def _flat(tree, prefix=""):
    if isinstance(tree, (dict, list)):
        out = {}
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def assert_trees_bit_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        na, nb = _np(fa[k]), _np(fb[k])
        assert na.dtype == nb.dtype and na.shape == nb.shape, k
        assert na.tobytes() == nb.tobytes(), k


def assert_same_kind(a, b):
    """Leaves of the same kind: tensor of the same dtype and device,
    numpy array of the same dtype, or int."""
    fa, fb = _flat(a), _flat(b)
    for k in fa:
        x, y = fa[k], fb[k]
        assert type(x) is type(y), k
        if isinstance(x, torch.Tensor):
            assert (x.dtype, x.device) == (y.dtype, y.device), k


COMM = {"mode": "aqsgd", "fw": {"bits": 4}, "dp": {"bits": 4,
                                                   "wire": "ring"}}


# ---------------------------------------------------------------------------
# legacy single-file API
# ---------------------------------------------------------------------------

def test_legacy_roundtrip(tmp_path):
    tree = make_tree()
    path = str(tmp_path / "params.npz")
    ck.save(path, tree)
    out = ck.restore(path, tree)
    assert_trees_bit_equal(tree, out)
    assert_same_kind(tree, out)
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]


def test_legacy_restore_loud_diff(tmp_path):
    tree = make_tree()
    path = str(tmp_path / "params.npz")
    ck.save(path, tree)
    like = make_tree()
    del like["opt"]["mu"]                        # -> unexpected
    like["extra"] = torch.zeros(2)               # -> missing
    like["params"]["b"] = torch.zeros(5)
    with pytest.raises(ck.CheckpointError) as e:
        ck.restore(path, like)
    msg = str(e.value)
    assert "missing from checkpoint: extra" in msg
    assert "unexpected in checkpoint: opt/mu" in msg
    assert "shape mismatch: params/b" in msg


# ---------------------------------------------------------------------------
# manifest protocol
# ---------------------------------------------------------------------------

def test_save_state_roundtrip_bit_exact(tmp_path):
    tree = make_tree()
    comm = TComm.from_dict(COMM)
    path = ck.save_state(str(tmp_path), tree, step=3, comm=comm,
                         extra={"data_position": 3})
    assert os.path.basename(path) == "step_00000003"
    out, body = ck.restore_state(str(tmp_path), make_tree(), comm=comm)
    assert_trees_bit_equal(tree, out)
    assert_same_kind(tree, out)
    assert out["opt"]["step"] == 7
    assert body["step"] == 3
    assert body["extra"]["data_position"] == 3
    assert body["comm"] == comm.to_dict()
    assert body["fingerprint"] == ck.tree_fingerprint(tree)
    assert ck.checkpoint_nbytes(str(tmp_path)) == sum(
        os.path.getsize(os.path.join(path, n))
        for n in (ck.ARRAYS_NAME, ck.MANIFEST_NAME))


def test_restore_goes_to_the_like_trees_device_and_dtype(tmp_path):
    """A restored leaf takes its ``like`` leaf's dtype (a bf16 tensor
    stored as f32 comes back bf16) and the manifest keeps the logical
    dtype beside the stored one."""
    tree = make_tree()
    path = ck.save_state(str(tmp_path), tree, step=1)
    body = json.load(open(os.path.join(path, ck.MANIFEST_NAME)))["body"]
    assert body["arrays"]["params/w"]["dtype"] == "bfloat16"
    assert body["arrays"]["params/w"]["stored_dtype"] == "float32"
    assert body["arrays"]["opt/step"]["dtype"] == "int32"
    out, _ = ck.restore_state(str(tmp_path), tree)
    assert out["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["w"], tree["params"]["w"])


def test_rotation_and_latest(tmp_path):
    tree = make_tree()
    for s in (2, 4, 6, 8):
        ck.save_state(str(tmp_path), tree, step=s, keep=2)
    assert ck.checkpoint_steps(str(tmp_path)) == [6, 8]
    assert ck.latest_step(str(tmp_path)) == 8
    out, body = ck.restore_state(str(tmp_path), tree, step=6)
    assert body["step"] == 6
    with pytest.raises(ck.CheckpointError, match="available"):
        ck.resolve_checkpoint(str(tmp_path), step=2)


def test_recommit_same_step(tmp_path):
    """Replay after recovery re-commits an existing step: the new
    content wins and no tmp residue survives."""
    tree = make_tree()
    ck.save_state(str(tmp_path), tree, step=5)
    tree2 = make_tree()
    tree2["opt"]["step"] = 99
    ck.save_state(str(tmp_path), tree2, step=5)
    out, _ = ck.restore_state(str(tmp_path), tree)
    assert out["opt"]["step"] == 99
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]


def test_orphan_cleanup(tmp_path):
    tree = make_tree()
    ck.save_state(str(tmp_path), tree, step=1)
    orphan = tmp_path / ".tmp-999-deadbeef"
    orphan.mkdir()
    (orphan / "arrays.npz").write_bytes(b"partial")
    (tmp_path / "old.tmp123.npz").write_bytes(b"legacy partial")
    removed = ck.clean_orphans(str(tmp_path))
    assert sorted(removed) == [".tmp-999-deadbeef", "old.tmp123.npz"]
    assert ck.checkpoint_steps(str(tmp_path)) == [1]
    assert ck.clean_orphans(str(tmp_path)) == []


def test_empty_dir_fails_loudly(tmp_path):
    with pytest.raises(ck.CheckpointError, match="no committed"):
        ck.resolve_checkpoint(str(tmp_path))


# ---------------------------------------------------------------------------
# fail-closed corruption detection
# ---------------------------------------------------------------------------

def _flip_byte(path, offset=None):
    data = bytearray(open(path, "rb").read())
    offset = len(data) // 2 if offset is None else offset
    data[offset] ^= 0xFF
    open(path, "wb").write(bytes(data))


def test_array_byteflip_fails_closed(tmp_path):
    tree = make_tree()
    path = ck.save_state(str(tmp_path), tree, step=1)
    _flip_byte(os.path.join(path, ck.ARRAYS_NAME))
    with pytest.raises(ck.CheckpointError, match="SHA-256 mismatch"):
        ck.restore_state(str(tmp_path), tree)


def test_array_crc_catches_sha_preserving_swap(tmp_path):
    """Per-array CRCs are verified even when someone rewrites the npz
    (and the manifest's npz_sha256) around a corrupted array."""
    tree = make_tree()
    path = ck.save_state(str(tmp_path), tree, step=1)
    npz_path = os.path.join(path, ck.ARRAYS_NAME)
    with np.load(npz_path) as data:
        flat = dict(data)
    flat["opt/mu"] = flat["opt/mu"] + 1.0
    with open(npz_path, "wb") as f:
        np.savez(f, **flat)
    mpath = os.path.join(path, ck.MANIFEST_NAME)
    manifest = json.load(open(mpath))
    manifest["body"]["npz_sha256"] = hashlib.sha256(
        open(npz_path, "rb").read()).hexdigest()
    manifest["crc32"] = zlib.crc32(
        ck.checkpoint._canonical(manifest["body"]))
    json.dump(manifest, open(mpath, "w"), sort_keys=True,
              separators=(",", ":"))
    with pytest.raises(ck.CheckpointError,
                       match="CRC32 mismatch on array 'opt/mu'"):
        ck.restore_state(str(tmp_path), tree)


def test_manifest_byteflip_fails_closed(tmp_path):
    tree = make_tree()
    path = ck.save_state(str(tmp_path), tree, step=1)
    mpath = os.path.join(path, ck.MANIFEST_NAME)
    raw = open(mpath).read()
    fp = json.loads(raw)["body"]["fingerprint"]
    open(mpath, "w").write(raw.replace(fp, "f" * len(fp), 1))
    with pytest.raises(ck.CheckpointError, match="manifest CRC"):
        ck.restore_state(str(tmp_path), tree)
    open(mpath, "w").write(raw[: len(raw) // 2])   # truncated JSON
    with pytest.raises(ck.CheckpointError, match="corrupt"):
        ck.restore_state(str(tmp_path), tree)


# ---------------------------------------------------------------------------
# loud mismatch diffs
# ---------------------------------------------------------------------------

def test_structure_mismatch_diff_and_fingerprint(tmp_path):
    tree = make_tree()
    ck.save_state(str(tmp_path), tree, step=1)
    like = make_tree()
    del like["seen"]
    like["dp_error"] = torch.zeros(2, 8)
    with pytest.raises(ck.CheckpointError) as e:
        ck.restore_state(str(tmp_path), like)
    msg = str(e.value)
    assert "missing from checkpoint: dp_error" in msg
    assert "unexpected in checkpoint: seen" in msg
    assert "fingerprint" in msg
    assert "different model/comm/optimizer configuration" in msg


def test_comm_mismatch_diff(tmp_path):
    tree = make_tree()
    saved = TComm.from_dict(COMM)
    live = TComm.from_dict({"mode": "aqsgd", "fw": {"bits": 4},
                            "dp": {"bits": 8, "wire": "psum"}})
    ck.save_state(str(tmp_path), tree, step=1, comm=saved)
    with pytest.raises(ck.CheckpointError) as e:
        ck.restore_state(str(tmp_path), tree, comm=live)
    msg = str(e.value)
    assert "dp.bits: checkpoint=4 run=8" in msg
    assert "dp.wire: checkpoint='ring' run='psum'" in msg
    out, _ = ck.restore_state(str(tmp_path), tree, comm=saved)
    assert_trees_bit_equal(tree, out)


# ---------------------------------------------------------------------------
# one format across the packages
# ---------------------------------------------------------------------------

def test_fingerprint_and_keys_match_jax():
    assert ck.tree_fingerprint(make_tree()) == \
        jck.tree_fingerprint(make_jax_tree())
    assert list(ck.flatten_tree(make_tree())) == \
        list(jck.flatten_tree(make_jax_tree()))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_small_tree_across_packages(writer, tmp_path):
    """A tree saved by one package restores in the other with every
    check passing, bit for bit; the manifests' bodies agree except for
    the npz's SHA-256 (its zip entries carry the write time)."""
    jcomm, tcomm = JComm.from_dict(COMM), TComm.from_dict(COMM)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save_state(jd, make_jax_tree(), step=4, comm=jcomm,
                   extra={"data_position": 4})
    ck.save_state(td, make_tree(), step=4, comm=tcomm,
                  extra={"data_position": 4})
    if writer == "port":
        out, body = jck.restore_state(
            td, jax.eval_shape(make_jax_tree), comm=jcomm)
        assert out["params"]["w"].dtype == jnp.bfloat16
    else:
        out, body = ck.restore_state(jd, make_tree(), comm=tcomm)
        assert_same_kind(make_tree(), out)
    assert_trees_bit_equal(make_tree(), out)
    assert body["fingerprint"] == ck.tree_fingerprint(make_tree())
    bodies = [json.load(open(os.path.join(d, "step_00000004",
                                          ck.MANIFEST_NAME)))["body"]
              for d in (jd, td)]
    for b in bodies:
        del b["npz_sha256"]
    assert bodies[0] == bodies[1]


def _comm(wire, stochastic=True):
    d = dict(COMM, bw={"bits": 8}, dp={"bits": 4, "wire": wire})
    if not stochastic:
        for plane in ("fw", "bw", "dp"):
            d[plane] = dict(d[plane], stochastic=False)
    return d


def _configs(wire, stochastic=True):
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    jt = JS.SimTrainConfig(num_stages=2,
                           comm=JComm.from_dict(_comm(wire, stochastic)),
                           dp_workers=2, optimizer=JAdam(**opt))
    tt = TS.SimTrainConfig(num_stages=2,
                           comm=TComm.from_dict(_comm(wire, stochastic)),
                           dp_workers=2, optimizer=TAdam(**opt))
    return jt, tt


DC = dict(num_samples=8, seq_len=16, seed=0)


def _port_state(tt, steps):
    """The port's simulated state after ``steps`` steps on the CPU."""
    cfg = tget(ARCH, smoke=True)
    ds = TD.Dataset(TD.DatasetConfig(vocab_size=cfg.vocab_size, **DC))
    state = TS.init_train_state(cfg, tt, DC["num_samples"], DC["seq_len"],
                                generator=torch.Generator().manual_seed(0),
                                device="cpu")
    gen = torch.Generator().manual_seed(1)
    batches = list(ds.batches(4, 3))
    for b in batches[:steps]:
        TS.train_step(state, TS.device_batch(b, "cpu"), gen, mcfg=cfg,
                      tcfg=tt)
    return cfg, state, batches


@pytest.mark.parametrize("wire", ["ring", "ring-sharded"])
def test_port_sim_state_restores_in_jax(wire, tmp_path):
    """The port's whole simulated state after 2 steps (moments, step,
    seen and written buffers, carries; on ring-sharded the bucket
    moments), saved by the port, passes every check of JAX's
    `restore_state` against its `init_train_state` structure, bit for
    bit, with JAX's fingerprint."""
    jt, tt = _configs(wire)
    _, state, _ = _port_state(tt, 2)
    tree = TS.to_jax_state(state)
    assert tree["opt"]["step"] == 2 and bool(tree["buffers"]["seen"].any())
    ck.save_state(str(tmp_path), tree, step=2, comm=tt.comm)
    jcfg = jget(ARCH, smoke=True)
    like = jax.eval_shape(lambda: JS.init_train_state(
        jcfg, jt, DC["num_samples"], DC["seq_len"], jax.random.PRNGKey(0)))
    out, body = jck.restore_state(str(tmp_path), like, comm=jt.comm)
    assert body["fingerprint"] == jck.tree_fingerprint(like) \
        == ck.tree_fingerprint(tree)
    assert int(out["opt"]["step"]) == 2
    assert_trees_bit_equal(tree, jax.tree.map(np.asarray, out))


@pytest.mark.parametrize("wire", ["ring", "ring-sharded"])
def test_jax_sim_state_restores_in_port(wire, tmp_path):
    """JAX's simulated state after 2 deterministic steps, saved by JAX,
    passes every check of the port's `restore_state` against
    `to_jax_state`'s structure, and `load_jax_state` puts it in the
    port's trainer bit for bit; a third step in each package then gives
    losses within the later-step tolerance."""
    jt, tt = _configs(wire, stochastic=False)
    jcfg = jget(ARCH, smoke=True)
    jstate = JS.init_train_state(jcfg, jt, DC["num_samples"], DC["seq_len"],
                                 jax.random.PRNGKey(0))
    jds = JD.Dataset(JD.DatasetConfig(vocab_size=jcfg.vocab_size, **DC))
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in jds.batches(4, 3)]
    key = jax.random.PRNGKey(1)
    for b in batches[:2]:
        jstate, _ = JS.train_step(jstate, b, key, mcfg=jcfg, tcfg=jt)
    jck.save_state(str(tmp_path), jstate, step=2, comm=jt.comm)
    _, jmet = JS.train_step(jstate, batches[2], key, mcfg=jcfg, tcfg=jt)

    cfg, state, tb = _port_state(tt, 0)
    like = TS.to_jax_state(state)
    tree, body = ck.restore_state(str(tmp_path), like, comm=tt.comm)
    assert body["fingerprint"] == ck.tree_fingerprint(like)
    assert_same_kind(like, tree)
    TS.load_jax_state(state, tree)
    assert_trees_bit_equal(TS.to_jax_state(state),
                           jax.tree.map(np.asarray, jstate))
    _, met = TS.train_step(state, TS.device_batch(tb[2], "cpu"),
                           torch.Generator().manual_seed(1), mcfg=cfg,
                           tcfg=tt)
    want = float(jmet["loss"])
    assert abs(float(met["loss"]) - want) <= LATER_STEP_RTOL * abs(want)


def test_checkpoint_export_loads_across_packages(tmp_path):
    """``--checkpoint`` writes the final params in JAX's layout: JAX's
    `restore` loads the port's export against `init_params`'s structure,
    and the port loads JAX's export (`repro.checkpoint.save` of its
    params, what JAX's ``--checkpoint`` writes) into a model."""
    path = str(tmp_path / "port.npz")
    state, _ = tlaunch.main(["--device", "cpu", "--smoke", "--stages", "2",
                             "--steps", "2", "--seq", "16", "--samples",
                             "8", "--batch", "4", "--checkpoint", path])
    jcfg = jget(ARCH, smoke=True)
    like = jax.eval_shape(lambda: Mo.init_params(jcfg,
                                                 jax.random.PRNGKey(0)))
    got = jck.restore(path, like)
    assert_trees_bit_equal(to_jax_params(state["model"]),
                           jax.tree.map(np.asarray, got))

    params = Mo.init_params(jcfg, jax.random.PRNGKey(3))
    jpath = str(tmp_path / "jax.npz")
    jck.save(jpath, params)
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            tget(ARCH, smoke=True))
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    load_jax_params(model, ck.restore(jpath, to_jax_params(model)))
    assert_trees_bit_equal(to_jax_params(model),
                           jax.tree.map(np.asarray, params))


def test_sim_train_state_roundtrip(tmp_path):
    """The port's whole state survives its own round trip bit for bit,
    through `load_jax_state` into a fresh state."""
    _, tt = _configs("ring")
    cfg, state, _ = _port_state(tt, 1)
    ck.save_state(str(tmp_path), TS.to_jax_state(state), step=11,
                  comm=tt.comm)
    _, fresh, _ = _port_state(tt, 0)
    tree, body = ck.restore_state(str(tmp_path), TS.to_jax_state(fresh),
                                  comm=tt.comm)
    assert body["step"] == 11
    TS.load_jax_state(fresh, tree)
    assert_trees_bit_equal(TS.to_jax_state(state), TS.to_jax_state(fresh))
