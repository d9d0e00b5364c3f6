"""The distributed trainer's checkpoint in the JAX launcher's global
layout: one state for the whole mesh, committed by one writer, which
either package resumes.

The JAX package has no such module.  Its ``--distributed`` launcher
(`repro.launch.train`, lines 163-193) builds one global state and
commits it with ``ckpt.save_state(args.ckpt_dir, state, step=done,
comm=comm, extra={"data_position": done}, keep=args.keep)`` (lines
227-231); ``--resume`` cleans the orphans and ``restore_state``s it
against ``jax.eval_shape`` of that state (lines 195-204).
`global_structs` gives that tree's keys, shapes and dtypes (as meta
tensors: this package's ``eval_shape``):

* ``params``: the pipeline layout of ``to_pipeline_params``, f32:
  ``stages.*`` (K, lps, ...), dead padded layers included, beside
  ``embed``, ``final_norm``, the untied ``head``, a MoE model's
  ``prefix`` list, the hybrid's ``shared_block`` and an audio model's
  ``enc_layers`` (stacked) and ``enc_norm``, each once;
* ``opt``: per-leaf f32 ``mu``/``nu`` and an int32 ``step``; under the
  ZeRO wire ``init_sharded_opt``'s (D, seg, group_d) moment buckets
  (`repro.training.pipeline`, line 572); with 8-bit moments
  ``make_state_structs``' ``{"codes": uint8, "scale": (..., 1) f32}``
  a leaf (lines 1112-1140; no JAX launcher flag sets them);
* ``dp_error`` (D, rows, group_d), as ``init_dp_error`` builds it
  (line 546), where the DP wire is on;
* ``m_out``/``m_in`` (K, D * (samples // D), seq, d), raw in the
  buffer dtype or ``{"codes", "scale"}`` under z-bit buffers
  (``buffer_structs``, line 617), in aqsgd.  Every stage has an entry:
  the last stage's ``m_out`` and the first stage's ``m_in`` stay zero,
  as JAX's step never writes them.

Where each rank's state goes (`places`): a stage parameter and its
moments into its leaf, a layer at ``[k, l]``, an encoder layer at
``[i]``, an FSDP shard (`pipeline.stage_shards`) narrowed along its
dim; a leaf D does not split lies whole on every data rank, and data
rank 0's copy is written.  With 8-bit moments a leaf split along its
last dim keeps the whole rows' scales on every data rank
(`adamw.code_moments`), so data rank 0's scales are written; a leaf
split along another dim splits its scales alike.  Expert parallelism
stores its expert stacks by the same shard rule (its weight all-to-all
runs at step time), so they are assembled as every sharded leaf is.
The copies: every stage holds the hybrid's shared block and an audio
model's encoder, and the first and last stages a tied embedding;
stage 0's is written.  The DP carry and the ZeRO moment segments are
not stage slots: every model rank of data rank d holds the same copy
of its data rank's carry, and of its ring segment's moments, because
the gradient all-reduce leaves every rank the same full-model bucket
and each model column's DP wire draws its noise from (seed, step, data
rank) alone (`pipeline.PipelineRank._update`).  So model rank 0's copy
goes into slot ``[d]``, what JAX's data rank d keeps.  Every copy is
held to the one written, bit for bit, at every save: each rank sends
the writer a SHA-256 of each copy.

The message buffers hold fewer rows in JAX (trap 7): its data rank
keeps ``samples // D`` rows and its step indexes them by sample id
(reads clamp, writes past them drop), while each port rank keeps a row
for every sample.  Data rank d's row i < samples // D goes to global
row ``d * (samples // D) + i``, where JAX's data rank d keeps sample i.
The rest go to a second manifest checkpoint, ``<ckpt-dir>/torch_rows/
step_<N>`` (`rows_structs`: (K, D, samples - samples // D, ...)),
committed before the main step and rotated with it; JAX's
``checkpoint_steps`` and ``clean_orphans`` never look there.  The two
carry one random stamp in their ``extra`` (key ``torch_rows``), and a
resume takes the sidecar only beside the main step of its own commit.
So a port-written checkpoint resumes in the port bit for bit; a
JAX-written one has no stamp (and a sidecar left by a save cut before
its main step has no match), and those rows start at zero, the port's
initial value.

`save`: the ranks send their parts and the copies' digests to rank
(data 0, model 0) on the transport's ``ckpt`` plane; it assembles the
global tree on the host, commits the sidecar and then the main step,
and a barrier holds every rank until the commit.  `restore` runs the
same way back: rank (0, 0) restores the newest committed step, with
every check of `repro_torch.checkpoint.restore_state` (the manifest's
CRC, SHA-256 and CRC32s, the structure, the comm config), and sends
each rank its slices on the ``ckpt`` plane, with the ZeRO wire's
full-model parameter bucket, which JAX's state lacks, rebuilt from
``params``.  So one process holds the whole state on the host at a
save or a restore, not one a rank.
"""
from __future__ import annotations

import hashlib
import os
import time
import uuid
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch.core import grad_compress as GC
from repro_torch.core import quantization as Q
from repro_torch.training.pipeline import (PipelineBucket, Stage,
                                           pipeline_leaves, pipeline_shapes,
                                           spec_configs, stage_layout,
                                           stage_shards)

ROWS_DIR = "torch_rows"          # the sidecar of the rows JAX has no place for
STAMP = ROWS_DIR                 # ``extra`` key of a main step and its sidecar
DIGEST = 32                      # bytes of a copy's SHA-256


@dataclass(frozen=True)
class Layout:
    """What fixes the global state's structure and each rank's place
    in it: the model, the pipeline and optimizer configs, the (data,
    model) mesh, the dataset's samples and text length, and whether
    the stages are FSDP-sharded."""
    cfg: object
    pcfg: object
    opt_cfg: object
    data: int
    stages: int
    num_samples: int
    seq_len: int
    fsdp: bool = True

    @property
    def lay(self):
        return stage_layout(self.cfg, self.stages)

    @property
    def n_loc(self) -> int:
        """Message rows a JAX data rank keeps."""
        return self.num_samples // self.data

    @property
    def trunk(self) -> int:
        return self.seq_len + self.cfg.num_patches

    @property
    def buffers(self) -> bool:
        return self.pcfg.comm.mode == "aqsgd"

    @property
    def zero(self) -> bool:
        comm = self.pcfg.comm
        return bool(comm.dp.bits) and comm.dp_wire_spec.sharded

    @property
    def bucket(self) -> PipelineBucket:
        return PipelineBucket(self.cfg, self.lay, self.pcfg.comm.dp_group_d)

    @property
    def extra_rows(self) -> int:
        """A rank's rows past the JAX layout's (the sidecar's); none
        where no stage hop keeps buffers."""
        return self.num_samples - self.n_loc \
            if self.buffers and self.stages > 1 else 0


def layout_of(trainer) -> Layout:
    """The `Layout` of a `pipeline.PipelineRank`."""
    mesh = trainer.mesh
    return Layout(trainer.cfg, trainer.pcfg, trainer.opt_cfg,
                  mesh.shape.data, mesh.shape.model, trainer.num_samples,
                  trainer.seq, trainer.stage.fsdp is not None)


def spec_layout(spec: dict) -> Layout:
    """The `Layout` of a distributed run's ``spec``
    (`repro_torch.launch.train.distributed_spec`)."""
    cfg, pcfg, opt_cfg = spec_configs(spec)
    return Layout(cfg, pcfg, opt_cfg, spec["data_par"], spec["stages"],
                  spec["dataset"]["num_samples"], spec["dataset"]["seq_len"],
                  not spec.get("_whole_stage", False))


# ---------------------------------------------------------------------------
# the structures
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _nest(flat: dict) -> dict:
    """{dotted name: leaf} as a nested tree: a level whose keys are all
    digits (a MoE model's ``prefix``) a list, as JAX keeps it."""
    out: dict = {}
    for name, value in flat.items():
        node = out
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(out)


def _buffer(lo: Layout, lead: tuple) -> object:
    """A message buffer of ``lead + (trunk, d)`` rows: raw, or z-bit
    codes and scales."""
    d, zbits = lo.cfg.d_model, lo.pcfg.comm.zbuf.bits
    if zbits:
        return {"codes": _meta((*lead, lo.trunk, Q.packed_width(d, zbits)),
                               torch.uint8),
                "scale": _meta((*lead, lo.trunk, 1), torch.float32)}
    return _meta((*lead, lo.trunk, d), getattr(torch, lo.pcfg.buffer_dtype))


def global_structs(lo: Layout) -> dict:
    """The JAX launcher's global state, as meta tensors (the module
    docstring); its ``tree_fingerprint`` is JAX's."""
    shapes = pipeline_shapes(lo.cfg, lo.lay)
    params = {n: _meta(s, torch.float32) for n, s in shapes.items()}
    bits = lo.opt_cfg.state_bits
    if lo.zero:
        seg = GC.ring_segment_rows(lo.bucket.rows, lo.data)
        moment = _meta((lo.data, seg, lo.bucket.group_d), torch.float32)
        opt = {"mu": moment, "nu": moment}
    else:
        def moment(s):
            if bits:
                return {"codes": _meta(s, torch.uint8),
                        "scale": _meta((*s[:-1], 1), torch.float32)}
            return _meta(s, torch.float32)
        moments = _nest({n: moment(s) for n, s in shapes.items()})
        opt = {"mu": moments, "nu": moments}
    opt["step"] = 0
    state = {"params": _nest(params), "opt": opt}
    if lo.pcfg.comm.dp.bits:
        state["dp_error"] = _meta((lo.data, *lo.bucket.shape), torch.float32)
    if lo.buffers:
        state["m_out"] = state["m_in"] = _buffer(
            lo, (lo.stages, lo.data * lo.n_loc))
    return state


def rows_structs(lo: Layout) -> Optional[dict]:
    """The sidecar's tree, (K, D, rows past the JAX layout's, ...) a
    buffer, or None where there are no such rows."""
    if not lo.extra_rows:
        return None
    buf = _buffer(lo, (lo.stages, lo.data, lo.extra_rows))
    return {"m_out": buf, "m_in": buf}


def _zeros(tree):
    """A host tree of zeros of a structure's shapes and dtypes."""
    if isinstance(tree, list):
        return [_zeros(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype)
    return tree


def _coded_zeros(tree, bits: int):
    """Each ``{"codes", "scale"}`` moment of a zero tree as the codes
    of zero, as JAX's ``init_opt_state`` makes them."""
    if isinstance(tree, list):
        return [_coded_zeros(v, bits) for v in tree]
    if "codes" in tree:
        codes, scale = Q.quantize(tree["codes"].float(), bits)
        return {"codes": codes, "scale": scale}
    return {k: _coded_zeros(v, bits) for k, v in tree.items()}


def initial_state(lo: Layout) -> dict:
    """The global state's initial values on the host: zeros, and 8-bit
    moments the codes of zero."""
    tree = _zeros(global_structs(lo))
    bits = lo.opt_cfg.state_bits
    if bits and not lo.zero:
        for m in ("mu", "nu"):
            tree["opt"][m] = _coded_zeros(tree["opt"][m], bits)
    return tree


def leaf(tree, path: tuple):
    """The subtree at ``path`` (dict keys, list indices as digits or
    ints)."""
    for p in path:
        tree = tree[int(p)] if isinstance(tree, list) else tree[p]
    return tree


def bucket_of(lo: Layout, params: dict, rows: int) -> torch.Tensor:
    """A global ``params`` tree (or any tree of its shapes: the
    per-leaf moments) flattened in the DP bucket's order
    (`pipeline.PipelineBucket`), ``rows`` rows of ``group_d``, zero past
    the model: the ZeRO wire's parameter bucket, and its moments'
    order."""
    gd = lo.pcfg.comm.dp_group_d
    out = torch.zeros(rows * gd, dtype=torch.float32)
    off = 0
    for name, *_ in pipeline_leaves(lo.cfg, lo.lay):
        t = leaf(params, name.split(".")).reshape(-1)
        out[off:off + t.numel()] = t
        off += t.numel()
    return out.view(rows, gd)


# ---------------------------------------------------------------------------
# where a rank's state goes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Place:
    """One tensor of a rank's state and its slot in a global tree:
    ``local`` its path in `rank_tree` (``rows``: the slice of its first
    dim, for a message buffer), ``tree`` "main" or "rows" (the
    sidecar), ``dst`` the leaf's path there and ``index`` the slot in
    it.  ``owner``: this rank's copy is the one written; ``copy``: other
    model ranks of its data rank hold the same slot (held bit-equal)."""
    local: tuple
    rows: Optional[slice]
    tree: str
    dst: tuple
    index: tuple
    owner: bool
    copy: bool


def _stage_leaf(name: str, k: int) -> tuple:
    """(pipeline leaf name, leading index) of a stage parameter."""
    top, _, rest = name.partition(".")
    if top == "layers":
        i, rest = rest.split(".", 1)
        return "stages." + rest, (k, int(i))
    if top == "enc_layers":
        i, rest = rest.split(".", 1)
        return "enc_layers." + rest, (int(i),)
    return name, ()


def _copied(cfg, name: str, stages: int) -> bool:
    """Whether more than one stage holds parameter ``name``: a tied
    embedding (the first and last stages), the shared block and the
    encoder (every stage)."""
    if stages == 1:
        return False
    top = name.split(".")[0]
    return (top == "embed" and cfg.tie_embeddings) \
        or top in ("shared_block", "enc_layers", "enc_norm")


def places(lo: Layout, d: int, k: int) -> list:
    """Every tensor of rank (data ``d``, model ``k``)'s state with its
    slot in the global trees (the module docstring); AdamW's ``step``,
    the same on every rank, is not among them."""
    cfg, lay = lo.cfg, lo.lay
    st = Stage(cfg, lay, k, device="meta")
    shards = stage_shards(st, lay, lo.data) \
        if lo.fsdp and lo.data > 1 else {}
    bits = lo.opt_cfg.state_bits
    out = []
    for name, p in st.named_parameters():
        spec = shards.get(name)
        if spec is not None and not spec.held(d):
            continue
        gname, lead = _stage_leaf(name, k)
        dst = tuple(gname.split("."))
        sl = [slice(None)] * p.dim()
        if spec is not None and spec.dim is not None:
            n = spec.shape[spec.dim] // spec.parts
            sl[spec.dim] = slice(d * n, (d + 1) * n)
        copied = _copied(cfg, name, lo.stages)
        own = not (copied and k > 0) and (spec is not None or d == 0)
        idx = lead + tuple(sl)
        out.append(Place(("params", name), None, "main", ("params", *dst),
                         idx, own, copied))
        if lo.zero:
            continue
        for m in ("mu", "nu"):
            if not bits:
                out.append(Place(("opt", m, name), None, "main",
                                 ("opt", m, *dst), idx, own, copied))
                continue
            split_last = spec is not None and spec.dim == p.dim() - 1
            out.append(Place(("opt", m, name, "codes"), None, "main",
                             ("opt", m, *dst, "codes"), idx, own, copied))
            out.append(Place(("opt", m, name, "scale"), None, "main",
                             ("opt", m, *dst, "scale"),
                             lead + tuple(sl[:-1]) + (slice(None),),
                             own and not (split_last and d > 0), copied))
    twin = lo.stages > 1
    if lo.zero:
        for m in ("mu", "nu"):
            out.append(Place(("opt", m), None, "main", ("opt", m),
                             (slice(d, d + 1),), k == 0, twin))
    if lo.pcfg.comm.dp.bits:
        out.append(Place(("dp_error",), None, "main", ("dp_error",), (d,),
                         k == 0, twin))
    if lo.buffers:
        keys = ("codes", "scale") if lo.pcfg.comm.zbuf.bits else ("m",)
        n = lo.n_loc
        for buf, held in (("m_out", k < lo.stages - 1), ("m_in", k > 0)):
            if not held:
                continue
            for key in keys:
                dst = (buf,) if key == "m" else (buf, key)
                out.append(Place((buf, key), slice(0, n), "main", dst,
                                 (k, slice(d * n, (d + 1) * n)), True, False))
                if lo.extra_rows:
                    out.append(Place((buf, key), slice(n, None), "rows", dst,
                                     (k, d), True, False))
    return out


def rank_tree(trainer) -> dict:
    """The rank's state by the paths `places` names: ``params`` (its
    shards), ``opt`` (their moments or its ZeRO segment's, and
    ``step``), and where it has them ``dp_error``, ``m_out``,
    ``m_in``: the trainer's own tensors."""
    tree = {"params": trainer.params, "opt": trainer.opt}
    for name in ("dp_error", "m_out", "m_in"):
        if getattr(trainer, name, None) is not None:
            tree[name] = getattr(trainer, name)
    return tree


def _local(tree: dict, pl: Place):
    t = leaf(tree, pl.local)
    return t if pl.rows is None else t[pl.rows]


def _digest(t: torch.Tensor) -> bytes:
    """SHA-256 of a tensor's bytes."""
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
    return hashlib.sha256(raw.numpy()).digest()


# ---------------------------------------------------------------------------
# save and restore
# ---------------------------------------------------------------------------

def rows_dir(directory: str) -> str:
    return os.path.join(directory, ROWS_DIR)


def clean_orphans(directory: str) -> int:
    """Remove the staged ``.tmp-*`` entries of a killed writer from the
    checkpoint directory and its sidecar; returns how many."""
    return len(ckpt.clean_orphans(directory)) \
        + len(ckpt.clean_orphans(rows_dir(directory)))


@torch.no_grad()
def save(trainer, directory: str, step: int, keep: int = 3) -> dict:
    """Commit the mesh's state after ``step`` steps as
    ``<directory>/step_<step>`` (and its sidecar), on rank (0, 0); every
    rank calls it, and returns once the commit is done.  Returns
    {"step", "seconds", "bytes" (on disk, written by this rank),
    "ckpt_plane_bytes" (what this rank sent)}."""
    mesh = trainer.mesh
    tr = mesh.transport
    t0 = time.perf_counter()
    sent0 = tr.bytes_sent("ckpt")
    lo = layout_of(trainer)
    tree = rank_tree(trainer)
    mine = places(lo, mesh.data_rank, mesh.model_rank)
    digests = b"".join(_digest(_local(tree, pl)) for pl in mine if pl.copy)
    nbytes = 0
    if mesh.rank != 0:
        if digests:
            tr.send(torch.frombuffer(bytearray(digests), dtype=torch.uint8),
                    0, "ckpt")
        for pl in mine:
            if pl.owner:
                tr.send(_local(tree, pl).contiguous(), 0, "ckpt")
    else:
        trees = {"main": initial_state(lo), "rows": _zeros(rows_structs(lo))}
        trees["main"]["opt"]["step"] = trainer.opt["step"]
        held = {}
        for r in range(mesh.shape.world):
            d, k = mesh.shape.coords(r)
            pls = mine if r == 0 else places(lo, d, k)
            n_copy = sum(pl.copy for pl in pls)
            got = digests if r == 0 else bytes(tr.recv(
                (n_copy * DIGEST,), torch.uint8, r, "ckpt", host=True)
                .numpy()) if n_copy else b""
            for i, pl in enumerate(p for p in pls if p.copy):
                key = (d, pl.dst, repr(pl.index))
                dig = got[i * DIGEST:(i + 1) * DIGEST]
                if held.setdefault(key, dig) != dig:
                    raise ckpt.CheckpointError(
                        f"save of step {step}: rank ({d}, {k})'s copy of "
                        f"{'/'.join(map(str, pl.dst))} differs from model "
                        f"rank 0's")
            for pl in pls:
                if not pl.owner:
                    continue
                slot = leaf(trees[pl.tree], pl.dst)[pl.index]
                slot.copy_(_local(tree, pl) if r == 0 else tr.recv(
                    slot.shape, slot.dtype, r, "ckpt", host=True))
        comm = trainer.pcfg.comm
        extra = {"data_position": step}
        if trees["rows"] is not None:
            extra[STAMP] = uuid.uuid4().hex
            side = rows_dir(directory)
            ckpt.save_state(side, trees["rows"], step=step, comm=comm,
                            extra=dict(extra, first_row=lo.n_loc), keep=keep)
            nbytes += ckpt.checkpoint_nbytes(side, step)
        ckpt.save_state(directory, trees["main"], step=step, comm=comm,
                        extra=extra, keep=keep)
        nbytes += ckpt.checkpoint_nbytes(directory, step)
        del trees
    dist.barrier()
    return {"step": step, "seconds": time.perf_counter() - t0,
            "bytes": nbytes, "ckpt_plane_bytes": tr.bytes_sent("ckpt") - sent0}


def _read(lo: Layout, directory: str, comm) -> tuple:
    """Rank (0, 0)'s half of `restore`: the newest committed step of
    ``directory`` and its sidecar, where the sidecar's stamp is the main
    step's, verified.  Returns (step, {"main", "rows" (None where not
    taken)}, bytes read)."""
    step = ckpt.latest_step(directory)
    if step is None:
        raise ckpt.CheckpointError(
            f"{directory}: no committed checkpoint to resume from")
    main, body = ckpt.restore_state(directory, global_structs(lo),
                                    step=step, comm=comm)
    trees = {"main": main, "rows": None}
    nbytes = ckpt.checkpoint_nbytes(directory, step)
    want_rows, side = rows_structs(lo), rows_dir(directory)
    stamp = body["extra"].get(STAMP)
    if want_rows is not None and stamp is not None \
            and step in ckpt.checkpoint_steps(side) \
            and ckpt.read_manifest(side, step)["extra"].get(STAMP) == stamp:
        trees["rows"] = ckpt.restore_state(side, want_rows, step=step,
                                           comm=comm)[0]
        nbytes += ckpt.checkpoint_nbytes(side, step)
    return step, trees, nbytes


@torch.no_grad()
def restore(trainer, directory: str) -> dict:
    """Restore the newest committed step of ``directory`` into the
    mesh, as JAX's ``--resume`` takes ``latest_step``: rank (0, 0) reads
    and verifies it and sends every other rank its slices on the
    ``ckpt`` plane (`places`, as `save` gathers them); every rank calls
    it.  A failed read raises on every rank.  Returns {"step",
    "seconds", "bytes" (read from disk, by this rank), "ckpt_plane_bytes"
    (what this rank sent), "rows" (False where no sidecar of the main
    step's commit was found: a JAX-written checkpoint, whose rows past
    the JAX layout's start at zero)}."""
    t0 = time.perf_counter()
    mesh, comm = trainer.mesh, trainer.pcfg.comm
    tr = mesh.transport
    sent0 = tr.bytes_sent("ckpt")
    lo = layout_of(trainer)
    tree = rank_tree(trainer)
    nbytes = 0
    if mesh.rank == 0:
        try:
            step, trees, nbytes = _read(lo, directory, comm)
        except BaseException:
            for r in range(1, mesh.shape.world):
                tr.send(torch.tensor([-1, 0, 0], dtype=torch.int64), r,
                        "ckpt")
            raise
        found = trees["rows"] is not None
        opt_step = int(trees["main"]["opt"]["step"])
        pbucket = bucket_of(lo, trees["main"]["params"],
                            trainer.pbucket.shape[0]) if lo.zero else None
        for r in range(mesh.shape.world):
            pls = places(lo, *mesh.shape.coords(r))
            if r:
                tr.send(torch.tensor([step, int(found), opt_step],
                                     dtype=torch.int64), r, "ckpt")
            for pl in pls:
                if pl.tree == "rows" and not found:
                    if not r:
                        _local(tree, pl).zero_()
                    continue
                part = leaf(trees[pl.tree], pl.dst)[pl.index]
                if r:
                    tr.send(part.contiguous(), r, "ckpt")
                else:
                    _local(tree, pl).copy_(part)
            if pbucket is not None:
                if r:
                    tr.send(pbucket, r, "ckpt")
                else:
                    trainer.pbucket.copy_(pbucket)
        del trees, pbucket
    else:
        step, found, opt_step = (int(v) for v in tr.recv(
            (3,), torch.int64, 0, "ckpt", host=True))
        if step < 0:
            raise ckpt.CheckpointError(
                f"{directory}: rank (0, 0) could not restore it (its "
                f"error says why)")
        for pl in places(lo, mesh.data_rank, mesh.model_rank):
            dst = _local(tree, pl)
            if pl.tree == "rows" and not found:
                dst.zero_()
            else:
                dst.copy_(tr.recv(dst.shape, dst.dtype, 0, "ckpt",
                                  host=True))
        if lo.zero:
            trainer.pbucket.copy_(tr.recv(trainer.pbucket.shape,
                                          trainer.pbucket.dtype, 0, "ckpt",
                                          host=True))
    trainer.opt["step"] = opt_step
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return {"step": step, "seconds": time.perf_counter() - t0,
            "bytes": nbytes, "ckpt_plane_bytes": tr.bytes_sent("ckpt") - sent0,
            "rows": bool(found) or lo.extra_rows == 0}
