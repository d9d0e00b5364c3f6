"""Single-process simulation of AQ-SGD pipeline training (port of
`repro.training.simulated`).

The model trunk is cut into K stage groups; at each of the K-1
boundaries the activation is replaced by the message m(ξ) (full
precision on a sample's first visit, ``+= Q(Δ)`` after) and the
backward activation gradient is quantized, exactly what the wire would
carry (`repro_torch.core.aqsgd.apply_boundary`).

DP gradient compression (Fig. 5, ``comm.dp.bits > 0``): the batch is
split over ``dp_workers`` simulated workers, each worker's gradient
tree goes into one ``(rows, group_d)`` bucket, and the configured DP
wire's simulator (`WireSpec.sim_allreduce`, the error-feedback codec of
`repro_torch.core.grad_compress`) returns the mean and the new
carried errors, which `comm.faults.guard_dp_pair` checks before AdamW.
A sharded wire (``ring-sharded``, the ZeRO wire) stops at the
reduce-scatter midpoint (`grad_compress.compress_reduce_scatter`:
worker i keeps the mean of its own segment of the bucket), AdamW runs
in bucket space on each owner's segment (`optim.adamw.
apply_bucket_updates`, moments one segment a worker) over the
zero-padded f32 parameter bucket, and the parameters are written back
from its live rows.  Its losses equal the ``ring`` wire's bit for bit:
the segment means are rows of the full mean, and the bucket AdamW runs
the per-leaf update's ops.

Random numbers: `train` draws the initial weights from a CPU
``torch.Generator().manual_seed(seed)``, leaf by leaf, each leaf moved
to the device once drawn, so a seed gives the same weights on the card
and on the CPU.  Every stochastic-rounding draw comes from a second
generator, on the device, seeded from ``(seed, "noise")`` through a
stable hash (`repro_torch.rng.seeded_generator`), in a fixed order (per
step: worker 0's forward boundaries, its backward boundaries in
reverse, worker 1's, ..., then the DP wire's workers in order).  Each
draw is a noise tensor, or with the on-core noise knob on
(`repro_torch.env.oncore_prng`) and the data on the card a
(2,) int32 seed from which the encode kernel draws its own noise
(`repro_torch.core.boundary`).  JAX's threefry stream is not
reproduced, so stochastic runs match the JAX package statistically;
deterministic runs match its loss stream within a tolerance
(tests/test_torch_train.py).

A MoE model's loss holds its router's load-balance term (`models.model.
loss_fn`), each worker's its own; as in JAX, the metrics' ``aux`` is
that term's aux with one worker and 0.0 in the DP-workers branch.

A batch may carry a vlm model's ``patches`` (B, P, d) or an audio
model's ``frames`` (B, Se, d) (`train_step`; the worker split slices
them with the rest, as JAX's).  The patches' rows cross the stage
boundaries with the text, so the message buffers then span P + S rows
(``seq_len`` of `init_train_state` is the trunk's length).  `train`
feeds the `Dataset`'s batches, which hold neither: a vlm model trains
text-only there, as in the JAX package, and an audio model, whose loss
cannot run without frames (JAX's fails there), gets stub ones
(`data.pipeline.with_stub_media`, seeded by the run's seed).

`train_step` marks its phases for `torch.profiler` (``train.*``
ranges: each worker's forward, the DP wire, AdamW, the buffer writes;
the backward runs on autograd's own thread, outside them); outside a
profiler they cost a few microseconds.

The training state is a dict: ``model`` (a `Transformer`), ``opt``
(AdamW moments), ``buffers`` (AQ-SGD messages) and, with DP
compression, ``dp_error`` ((workers, rows, group_d) f32).  Parameters,
moments, buffers and carries are updated in place.  `to_jax_state` and
`load_jax_state` carry it to and from the JAX package's state tree
(``params``, ``opt/{mu,nu,step}``, ``buffers``, ``dp_error``), the tree
a checkpoint holds (`repro_torch.checkpoint`, `launch.runner`).
"""
from __future__ import annotations

import time
from dataclasses import InitVar, dataclass, field
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.comm import faults
from repro_torch.comm.config import CommConfig, reject_legacy_comm
from repro_torch.configs.base import ModelConfig
from repro_torch.core import aqsgd
from repro_torch.core import grad_compress as GC
from repro_torch.data.pipeline import with_stub_media
from repro_torch.models import model as Mo
from repro_torch.optim import adamw
from repro_torch.rng import seeded_generator
from repro_torch.weights import (from_jax_tree, jax_leaf_names, jax_leaves,
                                 jax_tree, load_jax_params, to_jax_params)


@dataclass(frozen=True)
class SimTrainConfig:
    """Simulated-trainer knobs.  All communication lives in ``comm``;
    ``dp_workers`` is the simulated DP degree when ``comm.dp.bits``;
    ``remat`` recomputes each unit's activations in the backward (a
    layer, or a hybrid's block: `repro_torch.models.model.run_remat`;
    the stage boundaries are never recomputed).  The trailing init-only
    fields are the JAX package's removed scattered comm kwargs, taken
    only to refuse them (`reject_legacy_comm`).  8-bit moments
    (``optimizer.state_bits``) run in the distributed trainer only: the
    JAX package's simulator builds f32 moments and would fail in its
    first update, so they are refused here."""
    num_stages: int = 4
    comm: Optional[CommConfig] = None
    optimizer: adamw.AdamWConfig = field(default_factory=adamw.AdamWConfig)
    dp_workers: int = 1
    remat: bool = False
    compression: InitVar[Optional[object]] = None
    dp_grad_bits: InitVar[Optional[int]] = None
    dp_grad_group: InitVar[Optional[int]] = None
    dp_sharded: InitVar[Optional[bool]] = None

    def __post_init__(self, compression, dp_grad_bits, dp_grad_group,
                      dp_sharded):
        reject_legacy_comm(
            "SimTrainConfig",
            {"compression": compression, "dp_grad_bits": dp_grad_bits,
             "dp_grad_group": dp_grad_group, "dp_sharded": dp_sharded})
        if self.comm is None:
            object.__setattr__(self, "comm", CommConfig())
        if self.dp_workers < 1:
            raise ValueError(f"dp_workers={self.dp_workers} must be >= 1")
        if self.optimizer.state_bits:
            raise ValueError(
                f"optimizer.state_bits={self.optimizer.state_bits}: 8-bit "
                f"AdamW moments run in the distributed trainer "
                f"(repro_torch.training.pipeline); the simulated trainer "
                f"keeps f32 moments")


def init_train_state(mcfg: ModelConfig, tcfg: SimTrainConfig,
                     num_samples: int, seq_len: int, *,
                     generator: torch.Generator, device) -> dict:
    """Random weights from ``generator``, zero moments, buffers and
    carries, all on ``device``."""
    model = Mo.Transformer(mcfg, device=device, generator=generator)
    params = dict(model.named_parameters())
    dpc = tcfg.comm.dp
    if dpc.bits and tcfg.comm.dp_wire_spec.sharded:
        # the ZeRO wire: bucket moments, one segment a worker
        lay = GC.bucket_layout(jax_leaves(params), dpc.group_d)
        opt = adamw.init_bucket_opt_state(
            tcfg.dp_workers, GC.ring_segment_rows(lay.rows, tcfg.dp_workers),
            lay.group_d, device=device)
    else:
        opt = adamw.init_opt_state(params)
    state = {
        "model": model,
        "opt": opt,
        "buffers": aqsgd.init_buffers(
            tcfg.comm.activation, tcfg.num_stages - 1, num_samples,
            seq_len, mcfg.d_model, device=device),
    }
    if dpc.bits:
        lay = GC.bucket_layout(jax_leaves(params), dpc.group_d)
        state["dp_error"] = torch.zeros(
            (tcfg.dp_workers, lay.rows, lay.group_d), dtype=torch.float32,
            device=device)
    return state


def to_jax_state(state: dict) -> dict:
    """The training state as the JAX package's simulated-trainer state
    tree (`repro.training.simulated.init_train_state`'s layout, shapes
    and dtypes): ``params`` (JAX names, layers stacked), ``opt`` as
    ``{mu, nu, step}`` (per-leaf moments in the params' layout, or the
    ZeRO wire's (workers, seg, group_d) bucket moments; ``step`` an int,
    JAX's 0-d int32), ``buffers`` (absent outside aqsgd) and
    ``dp_error``.  Stacked leaves are new tensors; the others share the
    state's storage."""
    opt = state["opt"]
    mu, nu = opt["mu"], opt["nu"]
    if isinstance(mu, dict):
        mu, nu = jax_tree(mu), jax_tree(nu)
    tree = {"params": to_jax_params(state["model"]),
            "opt": {"mu": mu, "nu": nu, "step": int(opt["step"])}}
    if state["buffers"] is not None:
        tree["buffers"] = dict(state["buffers"])
    if "dp_error" in state:
        tree["dp_error"] = state["dp_error"]
    return tree


@torch.no_grad()
def load_jax_state(state: dict, tree: dict) -> dict:
    """Copy a state tree in `to_jax_state`'s layout (tensors on any
    device) into the training state, in place; returns the state."""
    params = dict(state["model"].named_parameters())
    for name, t in from_jax_tree(tree["params"]).items():
        params[name].copy_(t)
    opt = state["opt"]
    for k in ("mu", "nu"):
        if isinstance(opt[k], dict):
            for name, t in from_jax_tree(tree["opt"][k]).items():
                opt[k][name].copy_(t)
        else:
            opt[k].copy_(tree["opt"][k])
    opt["step"] = int(tree["opt"]["step"])
    for k, t in tree.get("buffers", {}).items():
        state["buffers"][k].copy_(t)
    if "dp_error" in state:
        state["dp_error"].copy_(tree["dp_error"])
    return state


def _loss_and_grads(model, tcfg, batch, m_all, seen_all, generator):
    """Loss, metrics and gradients (name -> tensor) of one worker."""
    cc = tcfg.comm.activation

    def boundary_fn(bstate, h, idx):
        m = m_all[idx] if m_all is not None else None
        seen = seen_all[idx] if seen_all is not None else None
        h2, m_new = aqsgd.apply_boundary(cc, h, m, seen,
                                         generator=generator)
        return bstate + (m_new,), h2

    with record_function("train.forward"):
        loss, metrics = Mo.loss_fn(model, batch,
                                   num_stages=tcfg.num_stages,
                                   boundary_fn=boundary_fn,
                                   boundary_state=(), remat=tcfg.remat)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [model.get_parameter(n)
                                       for n in names])
    return loss.detach(), metrics, dict(zip(names, grads))


def train_step(state: dict, batch: dict, generator: torch.Generator, *,
               mcfg: ModelConfig, tcfg: SimTrainConfig):
    """One AQ-SGD training step, in place.  batch: device tensors with
    ``sample_ids``.  Returns (state, metrics) with loss, ce and aux as
    device scalars."""
    cc = tcfg.comm.activation
    dpc = tcfg.comm.dp
    model = state["model"]
    bufs = state["buffers"]
    ids = batch["sample_ids"]
    nb = tcfg.num_stages - 1
    if cc.mode == "aqsgd":
        m_all = [aqsgd.read_buffer(cc, bufs, i, ids, mcfg.d_model)
                 for i in range(nb)]
        seen_all = [bufs["seen"][i][ids] for i in range(nb)]
    else:
        m_all = seen_all = None

    w = tcfg.dp_workers if dpc.bits else 1
    bsz = batch["tokens"].shape[0]
    if bsz % w:
        raise ValueError(f"batch {bsz} does not split over {w} workers")
    b = bsz // w
    gdicts, loss, ce, parts = [], 0.0, 0.0, []
    for i in range(w):
        sl = slice(i * b, (i + 1) * b)
        sub = {k: v[sl] for k, v in batch.items()}
        sub_m = [m[sl] for m in m_all] if m_all is not None else None
        sub_s = [s[sl] for s in seen_all] if seen_all is not None else None
        lw, met, g = _loss_and_grads(model, tcfg, sub, sub_m, sub_s,
                                     generator)
        gdicts.append(g)
        loss = loss + lw / w
        ce = ce + met["ce"].detach() / w
        parts.append(met["boundary_state"])

    params = dict(model.named_parameters())
    spec = tcfg.comm.dp_wire_spec if dpc.bits else None
    # JAX's DP-workers branch reports aux 0.0 (each worker's loss holds
    # its own); one worker reports its loss_fn's
    aux = 0.0 if dpc.bits and (w > 1 or spec.sharded) else met["aux"]
    if isinstance(aux, torch.Tensor):
        aux = aux.detach()
    if dpc.bits:
        # the configured wire's simulator over the per-worker trees
        trees = [jax_leaves(g) for g in gdicts]
        del gdicts
        lay = GC.bucket_layout(trees[0], dpc.group_d)
        err_in = state["dp_error"] if dpc.error_feedback \
            else torch.zeros_like(state["dp_error"])
        with record_function("train.dp_allreduce"):
            mean, new_err = spec.sim_allreduce(
                trees, err_in, dpc.bits, stochastic=dpc.stochastic,
                generator=generator, backend=dpc.backend, layout=lay)
            del trees
            # payload guard: NaN-poison a corrupt mean and the carry
            mean, new_err = faults.guard_dp_pair(mean, new_err)
        state["dp_error"] = new_err if dpc.error_feedback \
            else torch.zeros_like(new_err)
        if not spec.sharded:
            names = [n for _, ns in jax_leaf_names(params) for n in ns]
            grads = dict(zip(names, _tensors(mean)))
    else:
        grads = gdicts[0]

    with record_function("train.adamw"):
        if spec is not None and spec.sharded:
            _sharded_update(tcfg, state, params, mean)
        else:
            state["opt"] = adamw.apply_updates(tcfg.optimizer, params,
                                               grads, state["opt"])
    if cc.mode == "aqsgd":
        with record_function("train.write_buffers"):
            for j in range(nb):
                m_new = torch.cat([parts[i][j] for i in range(w)], dim=0)
                aqsgd.write_buffer(cc, bufs, j, ids, m_new)
    return state, {"loss": loss, "ce": ce, "aux": aux}


@torch.no_grad()
def _sharded_update(tcfg: SimTrainConfig, state: dict, params: dict,
                    means: torch.Tensor) -> None:
    """The ZeRO wire's update: AdamW on every worker's segment of the
    zero-padded f32 parameter bucket (``means``: (workers, seg,
    group_d)), then the parameters written back from its live rows."""
    w, seg, gd = means.shape
    tree = jax_leaves(params)
    lay = GC.bucket_layout(tree, gd)
    pb = GC.flatten_bucket(tree, lay, rows=w * seg)
    state["opt"] = adamw.apply_bucket_updates(
        tcfg.optimizer, pb.reshape(w, seg, gd), means, state["opt"])
    for src, dst in zip(_tensors(GC.unflatten_bucket(pb, lay, tree)),
                        _tensors(tree)):
        dst.copy_(src)


def _tensors(tree: list) -> list:
    """The tensors of a tree in JAX leaf order, stacked leaves' layers
    in turn."""
    return [t for leaf in tree
            for t in (leaf if isinstance(leaf, list) else [leaf])]


def device_batch(batch: dict, device) -> dict:
    """A `Dataset` batch (numpy) as tensors on ``device``: token ids as
    int64; the mask, and frames or patches where a batch carries them,
    as f32."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.float() if k in ("mask", "frames", "patches")
                  else t.long()).to(device)
    return out


def train(mcfg: ModelConfig, tcfg: SimTrainConfig, dataset, *,
          num_steps: int, batch_size: int, seed: int = 0, device="cuda",
          log_every: int = 0, initial_params: Optional[dict] = None):
    """Run the simulated trainer.  Returns (state, per-step losses);
    ``state["step_seconds"]`` holds each step's wall time, measured to
    the end of its device work, and ``state["last_metrics"]`` the last
    step's metrics (loss, ce, aux; empty when no step ran).

    initial_params: a JAX params pytree (numpy arrays) to start from,
    the paper's fine-tuning setting, in place of the random init."""
    device = torch.device(device)
    state = init_train_state(mcfg, tcfg, dataset.num_samples,
                             dataset.dc.seq_len,
                             generator=torch.Generator().manual_seed(seed),
                             device=device)
    gen = seeded_generator(device, seed, "noise")
    if initial_params is not None:
        load_jax_params(state["model"], initial_params)
    losses, seconds, metrics = [], [], {}
    for step, batch in enumerate(dataset.batches(batch_size, num_steps)):
        if mcfg.family == "audio":
            batch = with_stub_media(mcfg, batch, seed=seed, step=step)
        t0 = time.perf_counter()
        state, metrics = train_step(state, device_batch(batch, device),
                                    gen, mcfg=mcfg, tcfg=tcfg)
        losses.append(float(metrics["loss"]))      # waits for the device
        seconds.append(time.perf_counter() - t0)
        if log_every and step % log_every == 0:
            print(f"step {step:5d} loss {losses[-1]:.4f}", flush=True)
    state["step_seconds"] = seconds
    state["last_metrics"] = metrics
    return state, losses
