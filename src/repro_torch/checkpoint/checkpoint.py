"""Versioned, manifest-based full-state checkpointing (port of
`repro.checkpoint.checkpoint`, in the JAX package's on-disk format).

A checkpoint is a directory ``<dir>/step_00000123/`` holding exactly
two files:

* ``arrays.npz``    — every leaf of the state tree under its
  ``/``-joined path (``params/layers/attn/wq`` …); bf16 leaves are
  stored as f32 and re-cast on restore (exact: f32 is a superset of
  bf16);
* ``manifest.json`` — a CRC-protected JSON record of the format
  version, the step, the run's ``CommConfig.to_dict()``, a fingerprint
  of the state STRUCTURE (sorted (path, shape, dtype) triples, numpy
  dtype names), per-array CRC32 checksums, the whole-file SHA-256 of
  ``arrays.npz``, and free-form ``extra`` metadata.

A state tree is a nested dict (or list) whose leaves are tensors, numpy
arrays or Python ints; dict keys are walked sorted, as ``jax.tree``
walks them, so the paths, the fingerprint and the npz's order are the
JAX package's.  A Python int leaf stands for a 0-d ``int32`` (JAX's
``opt/step``) and restores as an int.  Tensors come to the host once,
in `flatten_tree`; a restored leaf goes to the device (and dtype) of
its counterpart in ``like``, and to the host where that is a meta
tensor: a tree of meta tensors is a structure, as JAX's
``jax.eval_shape`` gives one.  Either package restores the other's
checkpoint of the same structure.

Write protocol (crash-safe): stage into a UNIQUE
``.tmp-<pid>-<uuid>/`` directory inside ``<dir>``, fsync both files,
then ``os.rename`` the staged directory into place and fsync the
parent.  A kill at any point leaves either the previous checkpoint set
intact or an orphaned ``.tmp-*`` directory that `clean_orphans`
removes on startup.  Rotation (``keep`` last k) renames the victim to
a tmp name before deleting, so a crash mid-rotation also degrades to
an orphan.

Read protocol (fail closed): the manifest's own CRC, the npz SHA-256,
every per-array CRC32, then the structure diff, then the comm diff —
all BEFORE any value is returned; a single flipped byte in either file
raises :class:`CheckpointError` naming the corrupt artifact.

The legacy single-file API (`save`/`restore` on one ``.npz``) is kept
for params-only export (``launch.train --checkpoint``) with the same
tmp protocol and loud restore errors.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import uuid
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

FORMAT_VERSION = 1
ARRAYS_NAME = "arrays.npz"
MANIFEST_NAME = "manifest.json"
STEP_PREFIX = "step_"
TMP_PREFIX = ".tmp-"

# torch dtypes numpy cannot hold: stored as f32, named as JAX names them
_WIDE_DTYPES = {torch.bfloat16: "bfloat16"}


class CheckpointError(RuntimeError):
    """A checkpoint could not be written, found, verified, or mapped
    onto the requested state structure.  The message names the
    offending file or paths."""


# ---------------------------------------------------------------------------
# state tree <-> flat dict of numpy arrays
# ---------------------------------------------------------------------------

def _leaves(tree: Any, path: tuple = ()):
    """(path, leaf) pairs in ``jax.tree`` order: dict keys sorted, list
    items in turn, None an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _map_tree(fn, tree: Any, path: tuple = ()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(path, tree)


def _leaf_key(path) -> str:
    return "/".join(str(p) for p in path)


def _is_int(leaf) -> bool:
    return isinstance(leaf, int) and not isinstance(leaf, bool)


def _shape(leaf) -> tuple:
    return () if _is_int(leaf) else tuple(int(s) for s in leaf.shape)


def _dtype_name(leaf) -> str:
    """The numpy name of a leaf's logical dtype (JAX's manifest names)."""
    if _is_int(leaf):
        return "int32"
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype in _WIDE_DTYPES:
            return _WIDE_DTYPES[leaf.dtype]
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.dtype(leaf.dtype))


def _to_numpy(leaf) -> np.ndarray:
    if _is_int(leaf):
        return np.asarray(leaf, np.int32)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype in _WIDE_DTYPES else t).numpy()
    return np.asarray(leaf)


def flatten_tree(tree: Any) -> dict:
    """Flatten a state tree into ``{path-key: np.ndarray}`` (the npz
    payload); bf16 leaves are stored as f32."""
    flat = {}
    for path, leaf in _leaves(tree):
        arr = _to_numpy(leaf)
        if arr.dtype.kind not in "biufc":
            arr = arr.astype(np.float32)
        flat[_leaf_key(path)] = arr
    return flat


def _struct_items(tree: Any) -> list:
    """Sorted (key, shape, logical-dtype) triples of a state tree."""
    return sorted((_leaf_key(p), _shape(leaf), _dtype_name(leaf))
                  for p, leaf in _leaves(tree))


def tree_fingerprint(tree: Any) -> str:
    """SHA-256 over the sorted (path, shape, dtype) triples of a state
    tree: the structure identity the manifest records, equal to the
    JAX package's for a tree of the same structure."""
    blob = json.dumps(_struct_items(tree)).encode()
    return hashlib.sha256(blob).hexdigest()


def _like_leaf(arr: np.ndarray, leaf):
    """A stored array as a leaf like ``leaf``: a tensor on its device
    (on the host for a meta tensor, a structure's leaf) and of its
    dtype, a numpy array of its dtype, or an int."""
    if _is_int(leaf):
        return int(arr)
    if isinstance(leaf, torch.Tensor):
        dev = "cpu" if leaf.is_meta else leaf.device
        return torch.from_numpy(arr.copy(order="C")).to(
            device=dev, dtype=leaf.dtype)
    return arr.astype(np.dtype(leaf.dtype))


def _restore_flat(flat: dict, like: Any, *, where: str,
                  stored_fp: Optional[str] = None) -> Any:
    """Map a flat ``{key: array}`` dict onto the structure of `like`.
    Any missing / unexpected / shape-mismatched path fails loudly with
    the full diff and (when known) both structure fingerprints."""
    want = {_leaf_key(p): leaf for p, leaf in _leaves(like)}
    missing = sorted(set(want) - set(flat))
    unexpected = sorted(set(flat) - set(want))
    mismatched = sorted(
        (k, flat[k].shape, _shape(want[k])) for k in set(want) & set(flat)
        if tuple(flat[k].shape) != _shape(want[k]))
    if missing or unexpected or mismatched:
        lines = [f"checkpoint {where} does not match the requested "
                 f"state structure:"]
        lines += [f"  missing from checkpoint: {k} "
                  f"(want {_shape(want[k])} {_dtype_name(want[k])})"
                  for k in missing]
        lines += [f"  unexpected in checkpoint: {k} {flat[k].shape}"
                  for k in unexpected]
        lines += [f"  shape mismatch: {k} stored {s} != wanted {w}"
                  for k, s, w in mismatched]
        if stored_fp is not None:
            lines.append(f"  manifest fingerprint {stored_fp} != "
                         f"state-struct fingerprint "
                         f"{tree_fingerprint(like)} — the checkpoint "
                         f"was written by a different model/comm/"
                         f"optimizer configuration")
        raise CheckpointError("\n".join(lines))
    return _map_tree(lambda p, leaf: _like_leaf(flat[_leaf_key(p)], leaf),
                     like)


# ---------------------------------------------------------------------------
# durable file primitives
# ---------------------------------------------------------------------------

def _sha256(path: str) -> str:
    """The SHA-256 of a file, read in pieces."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for piece in iter(lambda: f.read(1 << 26), b""):
            h.update(piece)
    return h.hexdigest()


def _crc32(arr: np.ndarray) -> int:
    """CRC32 of an array's bytes in C order (no copy when contiguous)."""
    return zlib.crc32(arr if arr.flags.c_contiguous else arr.copy())


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _tmp_name() -> str:
    return f"{TMP_PREFIX}{os.getpid()}-{uuid.uuid4().hex[:12]}"


def clean_orphans(directory: str) -> list:
    """Remove crash residue: ``.tmp-*`` staging entries (and legacy
    ``*.tmp*.npz`` single-file temps) left in ``directory`` by a killed
    writer.  Returns the removed names.  Committed checkpoints are
    never touched."""
    removed = []
    if not os.path.isdir(directory):
        return removed
    for name in sorted(os.listdir(directory)):
        p = os.path.join(directory, name)
        if name.startswith(TMP_PREFIX) or (".tmp" in name
                                           and name.endswith(".npz")):
            shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
            removed.append(name)
    return removed


# ---------------------------------------------------------------------------
# legacy single-file API (params-only export)
# ---------------------------------------------------------------------------

def save(path: str, tree: Any) -> None:
    """Write one state tree to a single ``.npz``, atomically: a unique
    tmp name in the target directory, fsync, then rename."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, _tmp_name() + ".npz")
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **flatten_tree(tree))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    _fsync_path(d)


def restore(path: str, like: Any) -> Any:
    """Restore a `save` file into the structure of `like`.  Missing /
    unexpected / mis-shaped keys raise a :class:`CheckpointError`
    listing every offending path."""
    with np.load(path) as data:
        flat = dict(data)
    return _restore_flat(flat, like, where=path)


# ---------------------------------------------------------------------------
# manifest-based versioned checkpoints
# ---------------------------------------------------------------------------

def _ckpt_name(step: int) -> str:
    return f"{STEP_PREFIX}{step:08d}"


def checkpoint_steps(directory: str) -> list:
    """Steps of every COMMITTED checkpoint in ``directory`` (a
    ``step_*`` dir whose manifest file exists), ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if not name.startswith(STEP_PREFIX):
            continue
        if os.path.exists(os.path.join(directory, name, MANIFEST_NAME)):
            try:
                steps.append(int(name[len(STEP_PREFIX):]))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    """The newest committed checkpoint step, or None."""
    steps = checkpoint_steps(directory)
    return steps[-1] if steps else None


def _canonical(body: dict) -> bytes:
    return json.dumps(body, sort_keys=True,
                      separators=(",", ":")).encode()


def _comm_dict(comm) -> Optional[dict]:
    if comm is None:
        return None
    return comm.to_dict() if hasattr(comm, "to_dict") else dict(comm)


def save_state(directory: str, state: Any, *, step: int, comm=None,
               extra: Optional[dict] = None, keep: int = 0) -> str:
    """Commit the FULL train state as checkpoint ``step`` under
    ``directory``; returns the committed path.

    ``comm`` (a `CommConfig`, or its dict) is recorded so
    `restore_state` can refuse a config-mismatched resume with a field
    diff.  ``extra`` is free-form JSON metadata.  ``keep > 0`` rotates:
    after the commit only the newest ``keep`` checkpoints survive.  A
    step that already exists is re-committed (the replay after a
    recovery): the staged replacement is durable before the old one
    moves aside."""
    os.makedirs(directory, exist_ok=True)
    flat = flatten_tree(state)
    tmp = os.path.join(directory, _tmp_name())
    os.makedirs(tmp)
    try:
        npz_path = os.path.join(tmp, ARRAYS_NAME)
        with open(npz_path, "wb") as f:
            np.savez(f, **flat)
            f.flush()
            os.fsync(f.fileno())
        with ThreadPoolExecutor(1) as pool:     # hashes release the GIL
            sha = pool.submit(_sha256, npz_path)
            arrays = {}
            for key, shape, dtype in _struct_items(state):
                arr = flat[key]
                arrays[key] = {"shape": list(shape), "dtype": dtype,
                               "stored_dtype": str(arr.dtype),
                               "crc32": _crc32(arr)}
            npz_sha = sha.result()
        body = {"format_version": FORMAT_VERSION, "step": int(step),
                "comm": _comm_dict(comm),
                "fingerprint": tree_fingerprint(state),
                "arrays": arrays, "npz_sha256": npz_sha,
                "extra": extra or {}}
        manifest = {"crc32": zlib.crc32(_canonical(body)), "body": body}
        mpath = os.path.join(tmp, MANIFEST_NAME)
        with open(mpath, "w") as f:
            json.dump(manifest, f, sort_keys=True,
                      separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        _fsync_path(tmp)
        final = os.path.join(directory, _ckpt_name(step))
        if os.path.exists(final):
            old = os.path.join(directory, _tmp_name())
            os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old)
        else:
            os.rename(tmp, final)
    except BaseException:
        if os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    _fsync_path(directory)
    if keep > 0:
        for s in checkpoint_steps(directory)[:-keep]:
            victim = os.path.join(directory, _ckpt_name(s))
            doomed = os.path.join(directory, _tmp_name())
            os.rename(victim, doomed)     # a crash here leaves an orphan
            shutil.rmtree(doomed)
    return os.path.join(directory, _ckpt_name(step))


def _load_manifest(ckpt_path: str) -> dict:
    mpath = os.path.join(ckpt_path, MANIFEST_NAME)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except FileNotFoundError:
        raise CheckpointError(f"{ckpt_path}: no {MANIFEST_NAME} — not "
                              f"a committed checkpoint")
    except json.JSONDecodeError as e:
        raise CheckpointError(f"{mpath}: manifest is corrupt (JSON "
                              f"parse failed: {e}); refusing to load")
    body, crc = manifest.get("body"), manifest.get("crc32")
    if body is None or crc != zlib.crc32(_canonical(body)):
        raise CheckpointError(f"{mpath}: manifest CRC mismatch — the "
                              f"file was corrupted after commit; "
                              f"refusing to load")
    if body.get("format_version") != FORMAT_VERSION:
        raise CheckpointError(
            f"{mpath}: format_version {body.get('format_version')!r} "
            f"!= supported {FORMAT_VERSION}")
    return body


def resolve_checkpoint(directory: str,
                       step: Optional[int] = None) -> str:
    """Path of the checkpoint to restore: ``directory`` itself if it IS
    a committed checkpoint, else its newest (or ``step``-selected)
    ``step_*`` child.  No committed checkpoint raises."""
    if os.path.exists(os.path.join(directory, MANIFEST_NAME)):
        return directory
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise CheckpointError(
                f"{directory}: no committed checkpoint found "
                f"(nothing matching {STEP_PREFIX}*/{MANIFEST_NAME})")
    path = os.path.join(directory, _ckpt_name(step))
    if not os.path.exists(os.path.join(path, MANIFEST_NAME)):
        raise CheckpointError(f"{path}: no committed checkpoint at "
                              f"step {step}; available: "
                              f"{checkpoint_steps(directory)}")
    return path


def read_manifest(directory: str, step: Optional[int] = None) -> dict:
    """The manifest body of a committed checkpoint, found as
    `resolve_checkpoint` finds it, its CRC and format checked; the
    arrays are not read."""
    return _load_manifest(resolve_checkpoint(directory, step))


def checkpoint_nbytes(directory: str, step: Optional[int] = None) -> int:
    """Bytes on disk of a committed checkpoint (both files), found as
    `resolve_checkpoint` finds it."""
    path = resolve_checkpoint(directory, step)
    return sum(os.path.getsize(os.path.join(path, n))
               for n in (ARRAYS_NAME, MANIFEST_NAME))


def _diff_comm(stored: dict, live: dict) -> list:
    diffs = []

    def walk(a, b, prefix):
        for k in sorted(set(a) | set(b)):
            va, vb = a.get(k), b.get(k)
            if isinstance(va, dict) and isinstance(vb, dict):
                walk(va, vb, f"{prefix}{k}.")
            elif va != vb:
                diffs.append(f"  {prefix}{k}: checkpoint={va!r} "
                             f"run={vb!r}")
    walk(stored, live, "")
    return diffs


def restore_state(directory: str, like: Any, *,
                  step: Optional[int] = None, comm=None):
    """Load and VERIFY a committed checkpoint into the structure of
    ``like``; returns ``(state, manifest_body)``.

    Verification is fail-closed, in order: manifest CRC, whole-file npz
    SHA-256, per-array CRC32, the structure (a mismatch raises the
    missing/unexpected/mismatched diff), and — when ``comm`` is given —
    the stored comm config (a mismatch raises a field-by-field diff)."""
    path = resolve_checkpoint(directory, step)
    body = _load_manifest(path)
    npz_path = os.path.join(path, ARRAYS_NAME)
    # the file's SHA-256 runs beside the load and the arrays' CRC32s
    # (both release the GIL); its verdict is still reported first
    with ThreadPoolExecutor(1) as pool:
        sha = pool.submit(_sha256, npz_path)
        try:
            with np.load(npz_path) as data:
                flat = dict(data)
            bad = [k for k, meta in body["arrays"].items()
                   if k in flat and _crc32(flat[k]) != meta["crc32"]]
            load_error = None
        except Exception as e:      # raised below unless the SHA says why
            flat, bad, load_error = None, [], e
        try:
            digest = sha.result()
        except FileNotFoundError:
            raise CheckpointError(f"{path}: {ARRAYS_NAME} is missing")
    if digest != body["npz_sha256"]:
        raise CheckpointError(
            f"{npz_path}: SHA-256 mismatch vs manifest — the array "
            f"payload was corrupted after commit; refusing to load")
    if load_error is not None:
        raise load_error
    if bad:                         # keys absent: the structure diff says
        raise CheckpointError(
            f"{npz_path}: CRC32 mismatch on array {bad[0]!r} — "
            f"corrupt payload; refusing to load")
    if comm is not None and body.get("comm") is not None:
        live = _comm_dict(comm)
        if live != body["comm"]:
            raise CheckpointError(
                "checkpoint comm config != this run's comm config:\n"
                + "\n".join(_diff_comm(body["comm"], live))
                + "\n  pass the checkpoint's config (or a fresh "
                  "--ckpt-dir) to proceed")
    state = _restore_flat(flat, like, where=path,
                          stored_fp=body["fingerprint"])
    return state, body
