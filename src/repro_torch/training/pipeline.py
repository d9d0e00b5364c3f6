"""Distributed pipeline-parallel training with AQ-SGD boundary
compression over torch.distributed (port of `repro.training.pipeline`
for every family: dense, moe, ssm, hybrid, audio, vlm).

Mesh: ``(data=D, model=K)`` processes (`repro_torch.launch.mesh`);
model rank k runs pipeline stage k (its ceil(L/K) layers; stage 0 also
the embedding, stage K-1 the final norm and the head: a copy of the
embedding when the config ties them, else the untied ``head``, which
stage K-1 alone holds), data rank d its shard of every microbatch.
As in the JAX package the layers are cut into stages one by one in
every family; a hybrid's shared block runs after each layer that
``cfg.layer_has_shared_attn`` flags, and every stage holds a copy of
it (JAX passes it into the ``shard_map`` replicated over the pipe
axis).  A MoE model's stages cut the layers past its dense ``prefix``,
which runs on the first stage after the embedding (JAX runs it with the
embedding, before the pipeline), its gradients in the bucket under the
``prefix`` leaves.  As JAX's ``_apply_layer``, the stages drop the MoE
router's auxiliary loss: the distributed loss is the cross-entropy.
``PipelineConfig.moe_mode`` is ``zero3`` (every rank computes with its
stage's experts, one expert after another, as JAX's ``expert_map``
scan: `models.moe.moe_ffn` with an ``expert_map``, each expert's step
checkpointed on its own) or
``expert_parallel`` (each data rank computes its own experts on every
data rank's tokens, which cross the data group by all-to-all,
`models.moe._expert_parallel_ffn`, on the ``ep`` plane; their weights
reach it by JAX's sharded branch, one weight all-to-all of the other
ranks' shards of them on the ``fsdp`` plane; an expert's gradient then
lives on its owner alone and the bucket's sum over the data ranks
equals ``zero3``'s).

A vlm model's batch carries ``patches`` (M, mb, P, d): the first stage
embeds them ahead of the text, the boundaries and the message buffers
span the trunk's P + S rows, and the last stage drops the patch rows
before the loss (JAX ``train_step``).  An audio model's batch carries
``frames`` (M, mb, Se, d).  JAX runs the encoder once, outside the
stage map, and feeds its output to every stage, whose layers project
their cross keys and values from it (``_apply_layer``).  Here every
stage holds the whole encoder, as the hybrid's shared block, and runs
it on each microbatch's frames; each stage's encoder gradient is the
part its layers' cross attention sends back, and the bucket's
all-reduce sums the stages' parts into the whole gradient, which every
copy then applies, so the copies stay equal.

Schedule: GPipe.  Each step runs the M microbatches forward through the
stages, then backward in reverse order.  A stage boundary is a pair of
`torch.autograd.Function`s over the transport (`Transfer`):

* forward wire  = packed delta codes + f32 row scales (AQ-SGD, B1 at
  the sender, B2 at the receiver), packed codes (DirectQ), or raw f32
  (fp32 and the warm-up epoch);
* backward wire = packed bw-bit gradient codes + scales (B3, B4), or
  raw f32 when ``bw_bits >= 32`` and in fp32 / warm-up.

Message buffers (aqsgd): a stage keeps ``m_out`` (its outgoing
boundary) and the next stage ``m_in``, a replica; both apply the same
quantized delta, so they stay bit-identical (Algorithm 2; B1's m_new
and B2's output round identically).  They hold every sample of the
dataset, indexed by its id, in ``buffer_dtype`` (bf16 by default) or
as z-bit codes.  The first epoch runs the ``warmup=True`` step: an
uncompressed transfer that fills the buffers.

Gradients.  As in the JAX package, the DP wire's input is the gradient
of the GLOBAL batch's mean loss over the whole pipeline tree: each rank
writes its stage's gradient into a zero (rows, group_d) f32 bucket in
the pipeline tree's leaf order (`PipelineBucket`), and one f32
all-reduce over every rank sums the data shards and the stages (a tied
embedding's two halves add there, as do the hybrid shared block's
copies, one a stage, so every stage gets the sum of all the stages'
contributions).  With ``comm.dp.bits`` the
configured DP wire (`comm.wires`, ``ring`` by default) then runs over
the rank's data group with per-rank error feedback, so it performs D
independent stochastic quantizations of that shared gradient (the
JAX package's placement caveat).  The wire's noise is seeded by (seed,
step, data rank) and never by the model rank, so every model column
computes the same mean and the two copies of a tied embedding stay
equal.  Then AdamW updates each stage's own parameters, with f32
moments, or with ``state_bits`` b-bit ones (8-bit Adam).

The ZeRO wire (``ring-sharded``) stops the ring after its
reduce-scatter half, so each data rank holds the mean of one segment of
the WHOLE model's bucket, as in the JAX package, whose
``replicate_leaves`` gathers every stage into it.  A segment spans
other stages' parameters, so every rank keeps a full-model f32
parameter bucket, drawn once from the init every rank runs: AdamW
(`adamw.apply_bucket_updates`, moments one segment a rank) updates its
own segment there, the updated segments are all-gathered over the data
group (the ``dp-gather`` plane), which leaves the bucket current on
every rank, and each stage copies its parameters out of their slots.
Its losses equal the ``ring`` wire's bit for bit: the segment means are
rows of the full mean, and the bucket AdamW runs the per-leaf update's
ops.

The f32 all-reduce sums in gloo's order, not XLA's, so distributed
losses match the JAX package within a tolerance, not bit for bit.

Memory, as in the JAX package's `PipelineConfig`: with ``remat`` each
layer is recomputed in the backward, and with ``remat_mode="nested"``
the whole stage run too (only the stage input is kept a microbatch);
the loss runs over ``loss_chunks`` pieces of the sequence, each
recomputed in the backward, so one piece's logits are live at a time.
The hops (`_SendHop`, `_RecvHop`) and the message buffers stay outside
every checkpoint, so a recompute never sends, draws or writes again.

Checkpoints (the JAX launcher's ``--ckpt-dir``/``--save-every``/
``--resume``/``--keep``): the JAX launcher's one global state, in its
layout, committed by rank (data 0, model 0) from the parts every rank
sends it on the transport's ``ckpt`` plane, and restored by that rank,
which sends each rank its slices on the same plane
(`repro_torch.training.pipeline_state`; the message rows JAX's layout
has no place for go to a sidecar beside it).  Either package resumes the other's checkpoint.  A resume takes
the newest committed step, as JAX's does, and replays the data stream
by skipping; the warm-up choice and the per-step seeds take the global
step index, so a stopped-and-resumed run gives the uninterrupted run's
losses.  As in the JAX package there is no fault plan or guard on this
path.

FSDP (ZeRO-3), as the JAX package's trainer always shards over its
``data`` axis (`StageFsdp`): where the data group has D > 1 ranks, each
rank keeps 1/D of every stage leaf the JAX package shards (its rule,
`shard_dims`, on the pipeline layout's shapes: `fsdp_dim` past the
stage dims, the expert dim skipped), and AdamW's moments of that shard.
A unit's leaves are all-gathered whole, in one flat buffer staged
through the host like every transport call (the ``fsdp`` plane), where
the unit runs, in the JAX package's units: a layer inside its remat
unit, so again in its recompute and in the nested stage recompute; in
``zero3`` a MoE layer's expert stacks one expert at a time, inside that
expert's own checkpoint (JAX's ``expert_map`` under
``jax.checkpoint(one_expert)``), so again in its backward; the hybrid's
shared block once a stage call, outside the nested checkpoint (JAX's
``shared_full``: its optimized HLO gathers it in no backward loop), its
uses' gradients summed by autograd; the encoder, a dense prefix layer
and the embedding, final norm and head once a microbatch pass.  The
backward sends nothing: a
gathered weight's gradient is added whole into an f32 accumulator of
the leaf, which takes ``p.grad``'s place in the DP bucket, so the
bucket, its all-reduce and the DP wire (JAX's ``replicate_leaves``
placement) are unchanged and the losses equal the whole-stage layout's
bit for bit; AdamW then updates each rank's part.  8-bit moments of a
leaf split along its last dim take their rows' scales over the data
group (`adamw.code_moments`).  `fsdp_gathers` counts the units'
gathers, from which `fsdp_gather_bytes` and `fsdp_largest_gather` model
the plane's bytes and its largest gathered buffer a step
(`Transport.largest_gather`); `rank_param_bytes` models a rank's
resident state.

Seeded noise (the on-core noise knob, `repro_torch.env.oncore_prng`,
as the JAX package's ``--distributed`` runs ``REPRO_ONCORE_PRNG=1``):
the hop's generator and the DP wire's reach the encoders unchanged, so
on the cuda backend with the knob on each stochastic encode that is
given no noise tensor draws a (2,) seed from its generator and the
kernel (B1, B3, B5) rounds with its own Philox stream: the hop's B1 and
B3, and the monolithic DP wires' one B5 (psum, ring, ring-sharded at
one chunk); the chunked ring keeps its full-bucket noise tensor, as
JAX's does (`repro_torch.core.collectives`).  The wire's generator
stays seeded by (seed, step, data rank), so every model column draws
the same seed and the copies of a tied embedding stay equal.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import time
from dataclasses import InitVar, dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.comm import faults
from repro_torch.comm.config import CommConfig, reject_legacy_comm
from repro_torch.configs.base import ModelConfig
from repro_torch.core import boundary as B
from repro_torch.core import grad_compress as GC
from repro_torch.core import quantization as Q
from repro_torch.data.pipeline import with_stub_media
from repro_torch.models import layers as L
from repro_torch.models.moe import capacity, slice_experts
from repro_torch.models.model import (FAMILIES, Block, Transformer,
                                      embed_rows, encode, head_logits,
                                      layer_fn, prefix_forward, run_remat,
                                      trunk_layer)
from repro_torch.optim import adamw
from repro_torch.rng import seeded_generator
from repro_torch.weights import stage_state_dict

MODES = ("fp32", "warmup", "directq", "aqsgd")
REMAT_MODES = ("nested", "layer")
MOE_MODES = ("zero3", "expert_parallel")


@dataclass(frozen=True)
class PipelineConfig:
    """Pipeline-trainer knobs, with the JAX package's names and
    defaults.  All communication lives in ``comm``; ``warmup`` selects
    the warm-up step variant (uncompressed transfer that fills the
    buffers); ``buffer_dtype`` is the raw buffers' storage type.
    ``remat`` recomputes each layer in the backward, and
    ``remat_mode="nested"`` also the whole stage run (``"layer"``: the
    layers only, one recompute fewer, more memory); ``loss_chunks``
    bounds the pieces of the sequence the loss runs over (the largest
    divisor of S at most this); ``block_k`` is the attention backward's
    key block; ``moe_mode`` is ``zero3`` or ``expert_parallel`` (the
    module docstring).  The trailing init-only fields are the JAX package's
    removed scattered comm kwargs, taken only to refuse them
    (`reject_legacy_comm`)."""
    microbatches: int = 16
    comm: Optional[CommConfig] = None
    warmup: bool = False
    remat: bool = True
    block_k: int = 512
    buffer_dtype: str = "bfloat16"
    loss_chunks: int = 64
    remat_mode: str = "nested"
    moe_mode: str = "zero3"
    compression: InitVar[Optional[object]] = None
    buffer_bits: InitVar[Optional[int]] = None
    dp_grad_bits: InitVar[Optional[int]] = None
    dp_grad_group: InitVar[Optional[int]] = None
    dp_wire: InitVar[Optional[str]] = None

    def __post_init__(self, compression, buffer_bits, dp_grad_bits,
                      dp_grad_group, dp_wire):
        reject_legacy_comm(
            "PipelineConfig",
            {"compression": compression, "buffer_bits": buffer_bits,
             "dp_grad_bits": dp_grad_bits, "dp_grad_group": dp_grad_group,
             "dp_wire": dp_wire})
        if self.comm is None:
            object.__setattr__(self, "comm", CommConfig())
        for name in ("microbatches", "block_k", "loss_chunks"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name}={getattr(self, name)} must be "
                                 f">= 1")
        if self.remat_mode not in REMAT_MODES:
            raise ValueError(f"remat_mode={self.remat_mode!r}; one of "
                             f"{REMAT_MODES}")
        if self.moe_mode not in MOE_MODES:
            raise ValueError(f"moe_mode={self.moe_mode!r}; one of "
                             f"{MOE_MODES}")


# ---------------------------------------------------------------------------
# stage layout
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StageLayout:
    num_stages: int
    lps: int                         # layers per stage (padded)
    n_layers: int                    # live layers (past a MoE prefix)
    n_padded: int                    # dead zero layers after them
    shared_attn: bool = False        # zamba2's shared block


def stage_layout(cfg: ModelConfig, num_stages: int) -> StageLayout:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; the "
                         f"distributed trainer runs the "
                         f"{', '.join(FAMILIES)} families")
    n = cfg.n_trunk
    lps = -(-n // num_stages)
    return StageLayout(num_stages, lps, n, num_stages * lps - n,
                       cfg.family == "hybrid")


def ep_wire_bytes(cfg: ModelConfig, pcfg: PipelineConfig, n_layers: int,
                  tokens: int, data_par: int, microbatches: int) -> int:
    """The ``ep`` plane's bytes a rank sends in a step under expert
    parallelism, its stage holding ``n_layers`` MoE layers and each
    microbatch's dispatch ``tokens`` tokens.  Each pass of a layer's
    forward sends its dispatch and its return all-to-all, and its
    backward the two inverse ones, each (D-1)/D of the (E, cap, d)
    buffer.  A layer's forward runs once, again in its checkpoint's
    recompute with ``remat``, and with nested remat again in the
    stage's recompute for every layer but the stage's last (that
    recompute stops once the last layer's input is back: torch's
    checkpoint recomputes only up to the last tensor it saved)."""
    if data_par == 1:
        return 0
    cap = capacity(tokens, cfg.top_k, cfg.n_experts, cfg.capacity_factor,
                   data_par)
    one = (data_par - 1) * (cfg.n_experts * cap // data_par) \
        * cfg.d_model * cfg.torch_dtype.itemsize
    passes = sum(2 * _passes(pcfg, l, n_layers) + 2 for l in range(n_layers))
    return microbatches * passes * one


def _passes(pcfg: PipelineConfig, l: int, n_layers: int) -> int:
    """Forward runs of a stage's layer l (of ``n_layers``) in a
    microbatch: the forward, its checkpoint's recompute with ``remat``,
    and with nested remat the stage's recompute for every layer but the
    last (`ep_wire_bytes`)."""
    nested = pcfg.remat and pcfg.remat_mode == "nested"
    return 1 + pcfg.remat + (nested and l < n_layers - 1)


def fsdp_gathers(cfg: ModelConfig, pcfg: PipelineConfig, lay: StageLayout,
                 k: int, data_par: int) -> dict:
    """The ``fsdp`` plane's calls of a rank of stage ``k`` in one
    microbatch over ``data_par`` data ranks (`StageFsdp`): {unit: (calls,
    bytes the rank sends in one, the whole gathered buffer's bytes or
    None for an all-to-all)}.  A gather sends the rank's f32 shards of
    the unit to the D-1 others.  A layer's unit is gathered at each
    forward run of the layer (`_passes`); in ``zero3`` each of a MoE
    layer's experts (``experts.<l>``, E calls a run) at each forward
    run of the layer and once more in its own backward recompute; the
    shared block, the encoder, a dense prefix layer and the ``io`` unit
    (embedding, final norm, head) once.  Under expert parallelism each
    forward run of a MoE layer exchanges its sharded expert stacks by
    one all-to-all instead, the rank's shard of each of the ne experts a
    peer computes to each of the D-1 peers."""
    st = Stage(cfg, lay, k, device="meta")
    shards = stage_shards(st, lay, data_par)
    units, experts = fsdp_units(shards)
    n = len(st.layer_ids)

    def flat(names, share=1):
        return 4 * sum(shards[x].numel_on(0) // share for x in names)

    out = {}
    for unit, names in units.items():
        kind, _, i = unit.partition(".")
        runs = _passes(pcfg, int(i), n) if kind == "layers" else 1
        out[unit] = (runs, (data_par - 1) * flat(names),
                     data_par * flat(names))
    e = cfg.n_experts
    for l, names in experts.items():
        one = flat(names, share=e)
        if pcfg.moe_mode == "expert_parallel":
            out[f"experts.{l}"] = (_passes(pcfg, l, n), (data_par - 1)
                                   * max(e // data_par, 1) * one, None)
        else:
            out[f"experts.{l}"] = (e * (_passes(pcfg, l, n) + 1),
                                   (data_par - 1) * one, data_par * one)
    return out


def fsdp_gather_bytes(cfg: ModelConfig, pcfg: PipelineConfig,
                      lay: StageLayout, k: int, data_par: int,
                      microbatches: int) -> int:
    """The ``fsdp`` plane's bytes a rank of stage ``k`` sends in a step
    (`fsdp_gathers`, ``microbatches`` times)."""
    if data_par == 1:
        return 0
    return microbatches * sum(
        calls * sent for calls, sent, _ in
        fsdp_gathers(cfg, pcfg, lay, k, data_par).values())


def fsdp_largest_gather(cfg: ModelConfig, pcfg: PipelineConfig,
                        lay: StageLayout, k: int, data_par: int) -> int:
    """The bytes of the largest buffer a rank of stage ``k`` gathers
    whole in a step (`fsdp_gathers`; 0 with one data rank)."""
    if data_par == 1:
        return 0
    return max((whole for _, _, whole in
                fsdp_gathers(cfg, pcfg, lay, k, data_par).values()
                if whole is not None), default=0)


def rank_param_bytes(cfg: ModelConfig, pcfg: PipelineConfig,
                     lay: StageLayout, k: int, data_par: int,
                     state_bits: int = 0) -> int:
    """A rank of stage ``k``'s resident parameter and AdamW moment bytes
    (the same on every data rank; `resident_param_bytes` counts them):
    its shards of the stage's parameters in f32 (1/D of each leaf the
    JAX package shards, the rest whole), and two moments of each, in
    f32 or as ``state_bits``-bit codes (a byte a value) with an f32
    scale a row; under the ZeRO wire instead the full-model f32
    parameter bucket and the f32 moments of one ring segment of it."""
    st = Stage(cfg, lay, k, device="meta")
    shards = stage_shards(st, lay, data_par) if data_par > 1 else {}
    total = moments = 0
    for name, p in st.named_parameters():
        spec = shards.get(name)
        if spec is not None and not spec.held(0):
            continue
        shape = spec.local_shape() if spec is not None else tuple(p.shape)
        size = _numel(shape)
        total += 4 * size
        moments += 2 * (size + 4 * _numel(shape[:-1]) if state_bits
                        else 4 * size)
    comm = pcfg.comm
    if comm.dp.bits and comm.dp_wire_spec.sharded:
        bucket = PipelineBucket(cfg, lay, comm.dp_group_d)
        seg = GC.ring_segment_rows(bucket.rows, data_par)
        return total + 4 * bucket.group_d * seg * (data_par + 2)
    return total + moments


def layer_flags(cfg: ModelConfig, lay: StageLayout) -> list:
    """Per stage, per padded layer: whether the shared block runs after
    it (JAX ``layer_flags``' third vector; False on dead layers)."""
    return [[k * lay.lps + i < lay.n_layers
             and cfg.layer_has_shared_attn(k * lay.lps + i)
             for i in range(lay.lps)] for k in range(lay.num_stages)]


# ---------------------------------------------------------------------------
# FSDP (ZeRO-3): the shard rule of the JAX package
# ---------------------------------------------------------------------------

def fsdp_dim(shape, dsize: int, skip: int) -> Optional[int]:
    """The dim (>= ``skip``) a leaf is sharded along over ``dsize`` data
    ranks: the first one they divide (JAX ``fsdp_dim``)."""
    for i in range(skip, len(shape)):
        if shape[i] % dsize == 0 and shape[i] >= dsize:
            return i
    return None


def _is_expert_leaf(shape, stage_leaf: bool) -> bool:
    """MoE expert stacks are the only 5-D stage leaves (K, lps, E, d,
    ff); their expert dim is never sharded (JAX ``_is_expert_leaf``)."""
    return stage_leaf and len(shape) >= 5


def _stage_fsdp_dim(shape, dsize: int) -> Optional[int]:
    return fsdp_dim(shape, dsize, 3 if _is_expert_leaf(shape, True) else 2)


def fsdp_dims_tree(shapes: dict, dsize: int, skip: int, shift: int = 0,
                   stage: bool = False) -> dict:
    """JAX ``fsdp_dims_tree`` over a flat {name: shape} dict: each leaf's
    sharded dim less ``shift``, -1 where none; with ``stage``, -1 for the
    expert stacks too (`expert_axes` gives theirs)."""
    def rule(shape):
        if _is_expert_leaf(shape, stage):
            return -1
        fd = fsdp_dim(shape, dsize, skip)
        return -1 if fd is None else fd - shift
    return {name: rule(shape) for name, shape in shapes.items()}


def expert_axes(stage_shapes: dict, dsize: int) -> dict:
    """JAX ``expert_axes``: {"w_gate" | "w_up" | "w_down": the sharded
    axis of one expert's weight, -1 where none} for the 5-D expert
    stacks among ``stage_shapes`` (the ``stages`` leaves keyed by their
    names under it: ``ffn.w_gate`` ...)."""
    axes = {}
    for name in ("w_gate", "w_up", "w_down"):
        shape = stage_shapes.get("ffn." + name)
        if shape is not None and len(shape) >= 5:
            fd = _stage_fsdp_dim(shape, dsize)
            axes[name] = -1 if fd is None else fd - 3
    return axes


def pipeline_leaves(cfg: ModelConfig, lay: StageLayout) -> list:
    """The JAX pipeline tree's leaves in ``jax.tree.leaves`` order, as
    (name, shape of one copy, copies): ``embed``, an audio model's
    ``enc_layers.<layer param>`` (sorted; a copy a layer) and
    ``enc_norm.scale``, ``final_norm.scale``, the untied ``head``, a MoE
    model's ``prefix.<i>.*`` (its items in turn, each sorted), the
    hybrid's ``shared_block.*`` (sorted), then ``stages.<block param>``
    (sorted; K lps copies, dead padded layers included)."""
    def sort(entries):
        return sorted(entries, key=lambda x: tuple(x[0].split(".")))

    def block_leaves(prefix, blk, copies):
        return sort((prefix + n, tuple(p.shape), copies)
                    for n, p in blk.named_parameters())

    out = [("embed", (cfg.vocab_size, cfg.d_model), 1)]
    if cfg.encoder_layers:
        out += block_leaves("enc_layers.", Block(cfg, device="meta"),
                            cfg.encoder_layers)
        out.append(("enc_norm.scale", (cfg.d_model,), 1))
    out.append(("final_norm.scale", (cfg.d_model,), 1))
    if not cfg.tie_embeddings:
        out.append(("head", (cfg.d_model, cfg.vocab_size), 1))
    for i in range(cfg.first_dense_layers):
        out += block_leaves(f"prefix.{i}.", Block(cfg, device="meta"), 1)
    if lay.shared_attn:
        out += block_leaves("shared_block.", Block(cfg, device="meta"), 1)
    out += block_leaves("stages.", trunk_layer(cfg, device="meta"),
                        lay.num_stages * lay.lps)
    return out


def pipeline_shapes(cfg: ModelConfig, lay: StageLayout) -> dict:
    """{name: shape} of the JAX pipeline tree's leaves (`pipeline_leaves`;
    ``stages.*`` (K, lps, ...), ``enc_layers.*`` (encoder_layers, ...))."""
    out = {}
    for name, shape, copies in pipeline_leaves(cfg, lay):
        top = name.split(".")[0]
        if top == "stages":
            shape = (lay.num_stages, lay.lps, *shape)
        elif top == "enc_layers":
            shape = (copies, *shape)
        out[name] = tuple(shape)
    return out


def shard_dims(cfg: ModelConfig, lay: StageLayout, dsize: int) -> dict:
    """{pipeline leaf name: the dim the JAX package shards it along over
    ``dsize`` data ranks, or None}: a ``stages`` leaf's
    `_stage_fsdp_dim`, every other leaf's ``fsdp_dim(shape, D, 0)``
    (`pipeline_param_specs`' data rule; its split of a last dim over
    ``model`` is XLA's layout and is not copied)."""
    return {name: _stage_fsdp_dim(shape, dsize)
            if name.startswith("stages.") else fsdp_dim(shape, dsize, 0)
            for name, shape in pipeline_shapes(cfg, lay).items()}


@dataclass(frozen=True)
class LeafShard:
    """How a stage parameter lies over the ``parts`` data ranks: split
    along ``dim`` into equal pieces, piece r on data rank r; or whole on
    data rank ``owner`` alone (an audio encoder leaf, whose stacked
    leaf the JAX package splits by layer)."""
    shape: tuple                     # the whole leaf's
    parts: int
    dim: Optional[int] = None
    owner: Optional[int] = None

    def held(self, r: int) -> bool:
        return self.owner is None or self.owner == r

    def local_shape(self) -> tuple:
        """The shape of a rank's part (an owner's: the whole leaf)."""
        if self.dim is None:
            return self.shape
        s = list(self.shape)
        s[self.dim] //= self.parts
        return tuple(s)

    def numel_on(self, r: int) -> int:
        return _numel(self.local_shape()) if self.held(r) else 0

    def local(self, whole: torch.Tensor, r: int) -> torch.Tensor:
        """Data rank r's part of the whole leaf (a view)."""
        if self.dim is None:
            return whole
        n = self.shape[self.dim] // self.parts
        return whole.narrow(self.dim, r * n, n)


def stage_shards(stage: "Stage", lay: StageLayout, dsize: int) -> dict:
    """{stage parameter name: `LeafShard`} of the leaves the JAX package
    shards over ``dsize`` data ranks (`shard_dims` on its pipeline
    layout's shapes, mapped onto the stage's names): a layer's leaf
    ``layers.<l>.<p>`` splits along dim ``fd - 2`` of the ``stages.<p>``
    leaf's dim fd (the port keeps every leaf in the JAX orientation,
    which `tests/test_torch_fsdp.py` holds), an encoder layer's along
    ``fd - 1`` of its stacked leaf, or, where fd is the stack's dim 0,
    lies whole on the data rank holding its layer; the other leaves
    keep fd.  Leaves no dim of which D divides stay whole on every
    rank and are not listed."""
    dims = shard_dims(stage.cfg, lay, dsize)
    out = {}
    for name, p in stage.named_parameters():
        top, _, rest = name.partition(".")
        shape = tuple(p.shape)
        if top == "layers":
            fd = dims["stages." + rest.split(".", 1)[1]]
            spec = None if fd is None else LeafShard(shape, dsize, fd - 2)
        elif top == "enc_layers":
            i, leaf = rest.split(".", 1)
            fd = dims["enc_layers." + leaf]
            per = stage.cfg.encoder_layers // dsize
            spec = None if fd is None else \
                LeafShard(shape, dsize, owner=int(i) // per) if fd == 0 \
                else LeafShard(shape, dsize, fd - 1)
        else:
            fd = dims[name]
            spec = None if fd is None else LeafShard(shape, dsize, fd)
        if spec is not None:
            out[name] = spec
    return out


EXPERT_STACKS = ("w_gate", "w_up", "w_down")


def fsdp_units(shards: dict) -> tuple:
    """The gather units of a stage's sharded leaves: ({unit: names}, {l:
    names}).  A unit is gathered in one flat all-gather: ``layers.<l>``
    (a layer), ``shared_block``, ``encoder`` (an audio model's encoder
    layers and ``enc_norm``), ``prefix.<i>`` (a MoE model's dense
    layer) or ``io`` (the embedding, ``final_norm`` and the head the
    stage holds).  A MoE layer's expert stacks leave its unit for the
    second dict: gathered one expert at a time in ``zero3``, exchanged
    by the weight all-to-all under expert parallelism."""
    units, experts = {}, {}
    for name in shards:
        parts = name.split(".")
        if parts[0] == "layers":
            if parts[2:4] in (["ffn", w] for w in EXPERT_STACKS) \
                    and len(shards[name].shape) == 3:
                experts.setdefault(int(parts[1]), []).append(name)
                continue
            unit = f"layers.{parts[1]}"
        elif parts[0] in ("enc_layers", "enc_norm"):
            unit = "encoder"
        elif parts[0] == "prefix":
            unit = f"prefix.{parts[1]}"
        elif parts[0] == "shared_block":
            unit = "shared_block"
        else:
            unit = "io"
        units.setdefault(unit, []).append(name)
    return units, experts


def _param_slot(root: nn.Module, name: str) -> tuple:
    """(module, attribute) holding ``root``'s parameter ``name``."""
    mod, _, attr = name.rpartition(".")
    return (root.get_submodule(mod) if mod else root), attr


class StageFsdp:
    """ZeRO-3 over one stage's data group (JAX ``gather_fsdp``, the
    ``pipeline_param_specs`` layout): the rank keeps only its shard of
    each leaf of `stage_shards` (`shard_`), and a unit's leaves
    (`fsdp_units`) are all-gathered whole in one flat buffer where the
    unit runs (`gather`, `whole`; `RingGroup.all_gather_sunk`, the
    ``fsdp`` plane), and again wherever remat recomputes it.  A MoE
    layer's sharded expert stacks are gathered one expert at a time in
    ``zero3`` (`expert`, `expert_map`); under expert parallelism each
    rank receives its own experts' shards from every rank by one weight
    all-to-all instead (`experts`, JAX ``ep_weights``).

    A gathered weight's gradient is added whole into an f32 accumulator
    of the leaf (`take_grads`; an expert's into its slot of the stack's),
    the one the whole-stage layout's ``p.grad`` would be, so the DP
    bucket, its all-reduce and the DP wire are unchanged and the losses
    stay bit for bit the whole-stage layout's.  ``gathers`` counts the
    step's calls by unit (an expert's under ``experts.<l>``), as
    `fsdp_gathers` models them; ``seconds``: the wall time spent in the
    gathers and exchanges (the device synchronized first)."""

    def __init__(self, stage: "Stage", lay: StageLayout, group,
                 expert_parallel: bool = False):
        self.group, self.r = group, group.index
        self.expert_parallel = expert_parallel
        self.shards = stage_shards(stage, lay, group.size)
        self.units, self.expert_units = fsdp_units(self.shards)
        self.split_rows = sorted(n for n, s in self.shards.items()
                                 if s.dim == len(s.shape) - 1)
        self.acc, self.seconds = {}, 0.0
        self.gathers = collections.Counter()
        self._params, self._layout = {}, {}

    @torch.no_grad()
    def shard_(self, stage: "Stage") -> None:
        """Replace each sharded parameter of ``stage`` by this rank's
        shard (a new parameter), or drop it where another rank holds it
        whole."""
        for name, spec in self.shards.items():
            mod, attr = _param_slot(stage, name)
            p = mod._parameters[attr]
            mod._parameters[attr] = nn.Parameter(
                spec.local(p.detach(), self.r).clone()) \
                if spec.held(self.r) else None
            self._params[name] = mod._parameters[attr]

    def local(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's part of leaf ``name`` given whole."""
        spec = self.shards.get(name)
        return whole if spec is None else spec.local(whole, self.r)

    def _offsets(self, key: str, specs: list) -> list:
        """Per leaf (`LeafShard` of ``specs``), per data rank: (offset,
        numel) in that rank's flat buffer of gather ``key``."""
        if key not in self._layout:
            n = self.group.size
            ends, rows = [0] * n, []
            for spec in specs:
                row = []
                for r in range(n):
                    k = spec.numel_on(r)
                    row.append((ends[r], k))
                    ends[r] += k
                rows.append(row)
            if len(set(ends)) != 1:
                raise ValueError(f"unit {key}: the data ranks hold "
                                 f"{ends} values")
            self._layout[key] = rows
        return self._layout[key]

    def _timed(self, fn):
        if self.group.transport.device.type == "cuda":
            torch.cuda.synchronize(self.group.transport.device)
        t0 = time.perf_counter()
        out = fn()
        self.seconds += time.perf_counter() - t0
        return out

    def _gather(self, key: str, names: list, specs: list, held: list,
                sink) -> dict:
        """{name: whole leaf}: ``held`` (this rank's parts of the leaves
        ``specs`` describe) all-gathered in one flat buffer, counted under
        ``key``'s unit; the backward hands the leaves' gradients to
        ``sink``."""
        rows = self._offsets(key, specs)

        def assemble(out):
            whole = []
            for spec, row in zip(specs, rows):
                if spec.dim is None:
                    o, k = row[spec.owner]
                    whole.append(out[spec.owner, o:o + k].view(
                        spec.shape).clone())
                    continue
                piece = spec.local_shape()
                whole.append(torch.cat([out[r, o:o + k].view(piece)
                                        for r, (o, k) in enumerate(row)],
                                       spec.dim))
            return whole

        self.gathers[key] += 1
        full = self._timed(lambda: self.group.all_gather_sunk(
            held, assemble, sink))
        return dict(zip(names, full))

    def gather(self, unit: str) -> dict:
        """{name: whole leaf} of ``unit`` ({} if it has no sharded leaf),
        all-gathered over the data group; their gradients go to the
        accumulators."""
        names = self.units.get(unit)
        if not names:
            return {}
        held = [self._params[n] for n in names if self.shards[n].held(self.r)]
        return self._gather(unit, names, [self.shards[n] for n in names],
                            held, self._sink(names))

    def expert(self, l: int, e: int) -> dict:
        """{name: expert ``e``'s whole weight} of layer ``l``'s sharded
        expert stacks, its three slices all-gathered in one flat buffer
        (JAX ``expert_map``); the gradients go to slot ``e`` of the
        stacks' accumulators."""
        names = self.expert_units.get(l)
        if not names:
            return {}
        specs = [LeafShard(s.shape[1:], s.parts, s.dim - 1)
                 for s in (self.shards[n] for n in names)]

        def sink(grads):
            for n, g in zip(names, grads):
                if g is None:
                    continue
                if n not in self.acc:
                    self.acc[n] = torch.zeros(self.shards[n].shape,
                                              dtype=torch.float32,
                                              device=g.device)
                self.acc[n][e] += g

        return self._gather(f"experts.{l}", names, specs,
                            [self._params[n][e] for n in names], sink)

    def expert_map(self, l: int, moe: nn.Module):
        """Layer ``l``'s `models.moe.moe_ffn` ``expert_map`` over ``moe``
        (its `MoE`): expert e's (w_gate, w_up, w_down), the sharded ones
        gathered by `expert` when the hook is called."""
        def weights(e):
            full = self.expert(l, e)
            return tuple(full[f"layers.{l}.ffn.{w}"]
                         if f"layers.{l}.ffn.{w}" in full
                         else getattr(moe, w)[e] for w in EXPERT_STACKS)
        return weights

    def experts(self, l: int) -> dict:
        """{name: this rank's own experts (ne, ...) of layer ``l``'s
        sharded expert stack}, by one weight all-to-all (JAX
        ``ep_weights``: each rank sends its shard of expert e_j to the
        rank j computing it, 1/D the bytes of a ZeRO-3 all-gather); the
        gradients go to the owner's slots of the accumulators."""
        names = self.expert_units.get(l)
        if not names:
            return {}
        dd, r = self.group.size, self.r
        e = self.shards[names[0]].shape[0]
        ne = max(e // dd, 1)
        idx = torch.tensor([(j * e) // dd + i for j in range(dd)
                            for i in range(ne)],
                           device=self.group.transport.device)
        send = torch.cat([self._params[n][idx].reshape(dd, -1)
                          for n in names], 1)
        sizes = [ne * self.shards[n].numel_on(r) // e for n in names]

        def assemble(recv):
            whole, o = [], 0
            for n, k in zip(names, sizes):
                spec = self.shards[n]
                piece = (ne, *spec.local_shape()[1:])
                whole.append(torch.cat([recv[j, o:o + k].view(piece)
                                        for j in range(dd)], spec.dim))
                o += k
            return whole

        start = r * e // dd

        def sink(grads):
            for n, g in zip(names, grads):
                if g is None:
                    continue
                if n not in self.acc:
                    self.acc[n] = torch.zeros(self.shards[n].shape,
                                              dtype=torch.float32,
                                              device=g.device)
                    self.acc[n][start:start + ne].copy_(g)
                else:
                    self.acc[n][start:start + ne] += g

        self.gathers[f"experts.{l}"] += 1
        full = self._timed(lambda: self.group.all_to_all_sunk(
            send, assemble, sink))
        return dict(zip(names, full))

    def _sink(self, names):
        def sink(grads):
            for n, g in zip(names, grads):
                if g is None:
                    continue
                if n in self.acc:
                    self.acc[n] += g
                else:
                    self.acc[n] = g.detach().clone()
        return sink

    def take_grads(self) -> dict:
        """The step's accumulated whole gradients (name -> f32 tensor),
        handed over and cleared."""
        grads, self.acc = self.acc, {}
        return grads

    @contextlib.contextmanager
    def whole(self, stage: "Stage", *units: str, layer: Optional[int] = None):
        """Within: ``units`` (and with ``layer`` its unit and, under
        expert parallelism, its own experts) gathered whole and in place
        in ``stage``."""
        full = {}
        if layer is not None:
            full.update(self.gather(f"layers.{layer}"))
            if self.expert_parallel:
                full.update(self.experts(layer))
        for unit in units:
            full.update(self.gather(unit))
        with stage.swapped(full):
            yield


class Stage(nn.Module):
    """Pipeline stage k: its live layers (trunk layers k*lps ..), the
    embedding and a MoE model's dense ``prefix`` on the first stage, the
    final norm and the head on the last (a copy of the embedding if
    tied, else the untied ``head``), and a hybrid's ``shared_block`` and
    an audio model's encoder (``enc_layers``, ``enc_norm``) on every
    stage.  Parameter names are the stage's own (``layers.<local>.*``,
    ``prefix.<i>.*``, ``shared_block.*``, ``enc_layers.<i>.*``).  With
    ``fsdp`` (a `StageFsdp`, which `PipelineRank` sets where the data
    group has more than one rank) the stage holds its shards, and each
    unit runs on its weights gathered whole: a layer inside its remat
    unit, in ``zero3`` a MoE layer's experts one at a time inside their
    own checkpoints, the shared block once a `trunk` call, the encoder
    and a dense prefix layer once a microbatch pass, and the embedding,
    final norm and head once a microbatch pass, handed in by the caller
    (``io``: a loss piece recomputes, it never gathers)."""

    def __init__(self, cfg: ModelConfig, lay: StageLayout, k: int,
                 device=None):
        super().__init__()
        self.cfg, self.k = cfg, k
        self.first, self.last = k == 0, k == lay.num_stages - 1
        self.layer_ids = [k * lay.lps + i for i in range(lay.lps)
                          if k * lay.lps + i < lay.n_layers]
        self.layers = nn.ModuleList(trunk_layer(cfg, device=device)
                                    for _ in self.layer_ids)
        self.prefix = nn.ModuleList(
            Block(cfg, device=device)
            for _ in range(cfg.first_dense_layers if self.first else 0))
        self.shared_after = layer_flags(cfg, lay)[k][:len(self.layer_ids)]
        self.shared_block = Block(cfg, device=device) \
            if lay.shared_attn else None
        self.enc_layers = nn.ModuleList(
            Block(cfg, device=device) for _ in range(cfg.encoder_layers))
        self.enc_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps,
                                  device=device) \
            if cfg.encoder_layers else None
        tied = cfg.tie_embeddings
        self.embed = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.d_model, device=device)) \
            if self.first or (self.last and tied) else None
        self.head = nn.Parameter(torch.empty(
            cfg.d_model, cfg.vocab_size, device=device)) \
            if self.last and not tied else None
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps,
                                    device=device) if self.last else None
        self.fsdp: Optional[StageFsdp] = None

    @contextlib.contextmanager
    def swapped(self, tensors: dict):
        """Within: each parameter named in ``tensors`` replaced by its
        tensor there (a unit's gathered whole weights)."""
        slots = [(_param_slot(self, n), t) for n, t in tensors.items()]
        old = [mod._parameters[a] for (mod, a), _ in slots]
        for (mod, a), t in slots:
            mod._parameters[a] = t
        try:
            yield
        finally:
            for ((mod, a), _), o in zip(slots, old):
                mod._parameters[a] = o

    def gather_io(self) -> dict:
        """The embedding, final norm and head this stage holds, gathered
        whole ({} without FSDP): once a microbatch pass, for
        `embed_tokens` and `nll_sum`."""
        return self.fsdp.gather("io") if self.fsdp is not None else {}

    @torch.no_grad()
    def load_from_model(self, model: Transformer) -> "Stage":
        """Copy this stage's weights out of a whole model."""
        own = dict(self.named_parameters())
        src = dict(model.named_parameters())
        for name, p in own.items():
            if name.startswith("layers."):
                _, i, rest = name.split(".", 2)
                name = f"layers.{self.layer_ids[int(i)]}.{rest}"
            p.copy_(src[name])
        return self

    def load_pipeline_params(self, np_pipe: dict,
                             lay: StageLayout) -> "Stage":
        """Load this stage's weights from a JAX pipeline-layout tree of
        numpy arrays (`repro_torch.weights.to_pipeline_params`)."""
        state = stage_state_dict(np_pipe, self.cfg, lay.num_stages, self.k,
                                 embed=self.embed is not None,
                                 final_norm=self.last,
                                 head=self.head is not None,
                                 shared=self.shared_block is not None,
                                 prefix=len(self.prefix) > 0,
                                 encoder=self.enc_norm is not None)
        self.load_state_dict({k: torch.tensor(np.asarray(v))
                              for k, v in state.items()})
        return self

    def embed_tokens(self, tokens: torch.Tensor, block_k: int = 512,
                     patches: Optional[torch.Tensor] = None,
                     io: Optional[dict] = None) -> torch.Tensor:
        """The first stage's input: the embedding (after a vlm model's
        ``patches``), then a MoE model's dense prefix
        (`models.model.prefix_forward`; ``block_k`` its attention
        backward's key block).  ``io``: `gather_io`'s whole weights."""
        with self.swapped(io or {}):
            h = embed_rows(self.cfg, self.embed, tokens, patches)
        b, s = h.shape[0], h.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=h.device).expand(b, s)
        fs = self.fsdp
        around = None if fs is None else \
            (lambda i: fs.whole(self, f"prefix.{i}"))
        return prefix_forward(self.cfg, self.prefix, h, positions, block_k,
                              around=around)

    def encode(self, frames: torch.Tensor,
               pcfg: PipelineConfig) -> torch.Tensor:
        """An audio model's encoder over one microbatch's frames (mb, Se,
        d), each layer a remat unit with ``pcfg.remat`` (JAX's
        ``encode_audio`` under ``vmap``).  With FSDP the encoder is
        gathered whole once, and each layer's unit (its recompute too)
        runs on its part of it."""
        if self.fsdp is None:
            return encode(self.cfg, self.enc_layers, self.enc_norm, frames,
                          remat=pcfg.remat, block_k=pcfg.block_k)
        full = self.fsdp.gather("encoder")
        per = [{n: t for n, t in full.items()
                if n.startswith(f"enc_layers.{i}.")}
               for i in range(len(self.enc_layers))]
        with self.swapped({n: t for n, t in full.items()
                           if n.startswith("enc_norm.")}):
            return encode(self.cfg, self.enc_layers, self.enc_norm, frames,
                          remat=pcfg.remat, block_k=pcfg.block_k,
                          around=lambda i: self.swapped(per[i]))

    def trunk(self, h: torch.Tensor, pcfg: PipelineConfig,
              ep=None, enc: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The stage's layers over one microbatch, checkpointed as
        ``pcfg`` says (`PipelineConfig`); a MoE layer's aux is dropped,
        as JAX's ``_apply_layer`` drops it, and in ``zero3`` (``ep``
        None) its experts run one at a time, as JAX's pipeline passes
        ``expert_map`` (`models.moe.moe_ffn`).  ``ep``: the data group of
        expert parallelism, or None; ``enc``: an audio model's encoder
        output, which each layer's cross attention reads.  With FSDP the
        shared block is gathered once here, before the nested
        checkpoint, so no recompute gathers it again."""
        b, s = h.shape[0], h.shape[1]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=h.device).expand(b, s)
        offset = self.cfg.first_dense_layers
        fs = self.fsdp
        shared = fs.gather("shared_block") \
            if fs is not None and self.shared_block is not None else {}

        def hook(l):
            if not self.cfg.has_moe or ep is not None:
                return None
            return slice_experts if fs is None \
                else functools.partial(fs.expert_map, l)

        def unit(l, fn):
            if fs is None:
                return fn

            def whole(x):
                with self.swapped(shared), fs.whole(self, layer=l):
                    return fn(x)
            return whole

        def run(x):
            for l, (i, blk, sh) in enumerate(zip(
                    self.layer_ids, self.layers, self.shared_after)):
                fn = layer_fn(self.cfg, i + offset, blk, positions, s,
                              pcfg.block_k,
                              self.shared_block if sh else None, ep=ep,
                              enc=enc, expert_hook=hook(l))
                x = run_remat(unit(l, fn), x, remat=pcfg.remat)[0]
            return x

        if pcfg.remat and pcfg.remat_mode == "nested" and self.layers:
            return checkpoint(run, h, use_reentrant=False,
                              preserve_rng_state=False)
        return run(h)

    def nll_sum(self, h: torch.Tensor, targets: torch.Tensor,
                mask: torch.Tensor, loss_chunks: int,
                io: Optional[dict] = None) -> torch.Tensor:
        """Summed masked next-token NLL of the head over h (mb, S, d),
        as JAX's ``chunk_loss``: over n pieces of the sequence, n the
        largest divisor of S at most ``loss_chunks``, each piece's
        logits recomputed in the backward; the pieces' sums added in
        order.  ``io``: `gather_io`'s whole weights."""
        seq = h.shape[1]
        n = next(c for c in range(min(loss_chunks, seq), 0, -1)
                 if seq % c == 0)

        def piece(hh, tt, mm):
            with self.swapped(io or {}):
                hh = self.final_norm(hh)
                logits = head_logits(self.cfg, hh, self.embed, self.head)
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, tt[..., None].long())[..., 0]
            return ((lse - gold) * mm).sum()

        total = None
        for hh, tt, mm in zip(h.chunk(n, 1), targets.chunk(n, 1),
                              mask.chunk(n, 1)):
            nll = checkpoint(piece, hh, tt, mm, use_reentrant=False,
                             preserve_rng_state=False)
            total = nll if total is None else total + nll
        return total


# ---------------------------------------------------------------------------
# the DP bucket of the pipeline tree
# ---------------------------------------------------------------------------

def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


class PipelineBucket:
    """The flatten-and-concat DP bucket of the pipeline tree, in the JAX
    package's ``jax.tree.leaves`` order of `to_pipeline_params`:
    ``embed``, an audio model's ``enc_layers.<layer param>`` (sorted,
    each stacked (encoder_layers, ...)) and ``enc_norm.scale``,
    ``final_norm.scale``, the untied ``head`` if any, a MoE model's
    ``prefix.<i>.*`` (its items in turn, each sorted), the hybrid's
    ``shared_block.*`` (sorted), then ``stages.<block param>`` (sorted)
    each shaped (K, lps, ...), dead padded layers included as zeros.
    The encoder and the shared block have one slot, which every stage's
    copy writes.  Knows where every parameter of a `Stage` sits in
    it."""

    def __init__(self, cfg: ModelConfig, lay: StageLayout, group_d: int):
        self.lay, self.group_d = lay, group_d
        off = 0
        self.offsets, self.sizes = {}, {}
        for name, shape, copies in pipeline_leaves(cfg, lay):
            self.offsets[name], self.sizes[name] = off, _numel(shape)
            off += copies * _numel(shape)
        self.total = off
        self.rows = max(-(-off // group_d), 1)

    @property
    def shape(self) -> tuple:
        return (self.rows, self.group_d)

    def slot(self, stage: Stage, name: str) -> tuple:
        """(offset, numel) of one stage parameter in the flat bucket."""
        top, _, rest = name.partition(".")
        if top in ("layers", "enc_layers"):
            i, rest = rest.split(".", 1)
            if top == "layers":
                key, g = "stages." + rest, stage.layer_ids[int(i)]
            else:
                key, g = "enc_layers." + rest, int(i)
            return self.offsets[key] + g * self.sizes[key], self.sizes[key]
        return self.offsets[name], self.sizes[name]

    def flatten(self, stage: Stage, tensors: dict,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A zero f32 bucket holding ``tensors`` (stage name -> tensor)
        at their slots, or ``out`` (a bucket of at least ``rows`` rows)
        with them written in."""
        if out is None:
            out = torch.zeros(self.shape, dtype=torch.float32,
                              device=next(iter(tensors.values())).device)
        flat = out.reshape(-1)
        for name, t in tensors.items():
            off, n = self.slot(stage, name)
            flat[off:off + n] = t.detach().reshape(-1)
        return out

    def views(self, stage: Stage, bucket: torch.Tensor, like: dict) -> dict:
        """The stage's slices of a bucket, shaped like ``like`` (name ->
        a tensor of the whole leaf's shape, or that shape)."""
        flat = bucket.reshape(-1)
        out = {}
        for name, t in like.items():
            off, n = self.slot(stage, name)
            out[name] = flat[off:off + n].reshape(getattr(t, "shape", t))
        return out


def init_dp_error(pbucket: PipelineBucket, device) -> torch.Tensor:
    """This rank's error-feedback carry: zeros (rows, group_d) f32,
    full-bucket under every wire."""
    return torch.zeros(pbucket.shape, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# message buffers (raw or z-bit, paper §H.5)
# ---------------------------------------------------------------------------

def buffer_structs(pcfg: PipelineConfig, n: int, seq: int, d: int) -> dict:
    """Shapes and dtypes of one buffer (m_out or m_in) of n samples."""
    zbits = pcfg.comm.zbuf.bits
    if zbits:
        return {"codes": ((n, seq, Q.packed_width(d, zbits)), torch.uint8),
                "scale": ((n, seq, 1), torch.float32)}
    return {"m": ((n, seq, d), getattr(torch, pcfg.buffer_dtype))}


def init_buffer(pcfg: PipelineConfig, n: int, seq: int, d: int,
                device) -> dict:
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in buffer_structs(pcfg, n, seq, d).items()}


def buffer_read(pcfg: PipelineConfig, buf: dict, ids: torch.Tensor,
                d: int) -> torch.Tensor:
    """The messages of samples ``ids`` as f32 (mb, S, d)."""
    zb = pcfg.comm.zbuf
    if zb.bits:
        return B.decode(buf["codes"][ids], buf["scale"][ids], bits=zb.bits,
                        d=d, backend=zb.backend)
    return buf["m"][ids].float()


@torch.no_grad()
def buffer_write(pcfg: PipelineConfig, buf: dict, ids: torch.Tensor,
                 val: torch.Tensor) -> None:
    """Store the messages of samples ``ids``, in place."""
    zb = pcfg.comm.zbuf
    if zb.bits:
        packed, scale = B.encode(val.float(), bits=zb.bits, stochastic=False,
                                 backend=zb.backend)
        buf["codes"][ids] = packed
        buf["scale"][ids] = scale
    else:
        buf["m"][ids] = val.to(buf["m"].dtype)


# ---------------------------------------------------------------------------
# the boundary transfer
# ---------------------------------------------------------------------------

class Transfer:
    """One stage boundary as this rank sees it: the sending half (to the
    next stage, rank ``dst``) and the receiving half (from the previous
    stage, rank ``src``), forward and backward.  ``mode``: fp32 |
    warmup | directq | aqsgd.  Forward payloads go on the transport's
    ``fw`` plane, backward ones on ``bw``."""

    def __init__(self, mode: str, fw_bits: int, bw_bits: int,
                 stochastic: bool, backend: str, transport, *,
                 src: Optional[int], dst: Optional[int],
                 generator: Optional[torch.Generator] = None):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
        if mode in ("directq", "aqsgd"):
            if fw_bits not in B.PACKABLE_BITS:
                raise ValueError(f"wire fw_bits must be one of "
                                 f"{B.PACKABLE_BITS}, got {fw_bits}")
            if bw_bits < 32 and bw_bits not in B.PACKABLE_BITS:
                raise ValueError(f"wire bw_bits must be one of "
                                 f"{B.PACKABLE_BITS} or >= 32, got {bw_bits}")
        self.mode, self.fw, self.bw = mode, fw_bits, bw_bits
        self.stochastic, self.backend = stochastic, backend
        self.t, self.src, self.dst, self.gen = transport, src, dst, generator

    @property
    def raw_backward(self) -> bool:
        return self.mode in ("fp32", "warmup") or self.bw >= 32

    def _send_codes(self, packed, scale, peer, plane):
        self.t.send(packed.contiguous(), peer, plane)
        self.t.send(scale.contiguous(), peer, plane)

    def _recv_codes(self, shape, bits, peer, plane):
        pw = Q.packed_width(shape[-1], bits)
        packed = self.t.recv((*shape[:-1], pw), torch.uint8, peer, plane)
        scale = self.t.recv((*shape[:-1], 1), torch.float32, peer, plane)
        return packed, scale

    # -- forward halves (no autograd here) -------------------------------

    def send_forward(self, out: torch.Tensor, m_out_s):
        """Ship ``out``; returns the new outgoing message (warmup,
        aqsgd) or None."""
        if self.mode in ("fp32", "warmup"):
            self.t.send(out.contiguous(), self.dst, "fw")
            return out if self.mode == "warmup" else None
        if self.mode == "directq":
            packed, scale = B.encode(out, bits=self.fw,
                                     stochastic=self.stochastic,
                                     generator=self.gen,
                                     backend=self.backend)
            self._send_codes(packed, scale, self.dst, "fw")
            return None
        packed, scale, nmo = B.encode_delta(out, m_out_s, bits=self.fw,
                                            stochastic=self.stochastic,
                                            generator=self.gen,
                                            backend=self.backend)
        self._send_codes(packed, scale, self.dst, "fw")
        return nmo

    def recv_forward(self, shape, dtype, m_in_s):
        """(what the stage computes on, the new incoming message or
        None)."""
        if self.mode in ("fp32", "warmup"):
            recv = self.t.recv(shape, torch.float32, self.src, "fw").to(dtype)
            return recv, (recv if self.mode == "warmup" else None)
        packed, scale = self._recv_codes(shape, self.fw, self.src, "fw")
        if self.mode == "directq":
            return B.decode(packed, scale, bits=self.fw, d=shape[-1],
                            dtype=dtype, backend=self.backend), None
        nmi = B.decode_accumulate(packed, scale, m_in_s, bits=self.fw,
                                  backend=self.backend)
        return nmi.to(dtype), nmi

    # -- backward halves ---------------------------------------------------

    def send_backward(self, g: torch.Tensor) -> None:
        g = g.contiguous()
        if self.raw_backward:
            self.t.send(g.float(), self.src, "bw")
            return
        packed, scale = B.encode(g, bits=self.bw, stochastic=self.stochastic,
                                 generator=self.gen, backend=self.backend)
        self._send_codes(packed, scale, self.src, "bw")

    def recv_backward(self, shape, dtype) -> torch.Tensor:
        if self.raw_backward:
            return self.t.recv(shape, torch.float32, self.dst, "bw").to(dtype)
        packed, scale = self._recv_codes(shape, self.bw, self.dst, "bw")
        return B.decode(packed, scale, bits=self.bw, d=shape[-1], dtype=dtype,
                        backend=self.backend)

    # -- autograd ends -------------------------------------------------------

    def send(self, out: torch.Tensor, m_out_s=None):
        """Forward-ship a stage output.  Returns (token, new m_out): a
        scalar whose backward receives the gradient of ``out`` from the
        next stage, and the new outgoing message (or None)."""
        box = {}
        token = _SendHop.apply(out, self, m_out_s, box)
        return token, box["m_out"]

    def recv(self, shape, dtype, m_in_s=None):
        """Receive a stage input.  Returns (h, new m_in): h's backward
        sends its gradient to the previous stage."""
        box = {}
        anchor = torch.zeros((), requires_grad=True)
        h = _RecvHop.apply(anchor, self, shape, dtype, m_in_s, box)
        return h, box["m_in"]


class _SendHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, hop, m_out_s, box):
        with torch.no_grad():
            box["m_out"] = hop.send_forward(out.detach().float(), m_out_s)
        ctx.hop, ctx.shape, ctx.dtype = hop, out.shape, out.dtype
        return out.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        return ctx.hop.recv_backward(ctx.shape, ctx.dtype), None, None, None


class _RecvHop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, hop, shape, dtype, m_in_s, box):
        with torch.no_grad():
            h, box["m_in"] = hop.recv_forward(shape, dtype, m_in_s)
        ctx.hop = hop
        return h

    @staticmethod
    def backward(ctx, g):
        ctx.hop.send_backward(g)
        return None, None, None, None, None, None


def make_transfer(pcfg: PipelineConfig, mesh, generator=None) -> Transfer:
    """The boundary transfer of this rank's stage for ``pcfg`` (the
    warm-up variant when ``pcfg.warmup`` and the mode is aqsgd)."""
    cc = pcfg.comm.activation
    mode = "warmup" if (pcfg.warmup and cc.mode == "aqsgd") else cc.mode
    k, kk = mesh.model_rank, mesh.shape.model
    return Transfer(mode, cc.fw_bits, cc.bw_bits, cc.stochastic, cc.backend,
                    mesh.transport,
                    src=mesh.stage_rank(k - 1) if k > 0 else None,
                    dst=mesh.stage_rank(k + 1) if k < kk - 1 else None,
                    generator=generator)


# ---------------------------------------------------------------------------
# one rank's trainer
# ---------------------------------------------------------------------------

class PipelineRank:
    """The state and step of one rank: its stage, AdamW moments, message
    buffers and DP carry, all on the mesh's device; under the ZeRO wire
    also the full-model f32 parameter bucket (``pbucket``, rows padded
    to whole segments) and the moments of this rank's segment of it.
    After a step, ``phase_seconds`` holds its phases' wall times:
    ``pipeline`` (the microbatches forward and backward, hops
    included), ``grad_allreduce``, ``dp_wire``, ``adamw`` and, under
    the ZeRO wire, ``param_gather`` (the all-gather and the copy into
    the stage); with FSDP also ``fsdp_gather``, the part of
    ``pipeline`` spent in the weight gathers (`StageFsdp.seconds`).
    ``seq_len`` is the text's length; a vlm model's message buffers span
    its ``num_patches`` rows too.

    Where the data group has more than one rank the stage's parameters
    and AdamW moments are sharded over it (`StageFsdp`, ZeRO-3, as the
    JAX package's trainer always shards over ``data``): ``params`` and
    ``opt`` hold this rank's shards, ``shapes`` every stage leaf's whole
    shape.  ``whole_stage`` keeps every leaf whole on every rank: the
    layout the sharded one is held to bit for bit in the tests (the
    spec's private ``_whole_stage``; no launcher flag sets it)."""

    def __init__(self, cfg: ModelConfig, pcfg: PipelineConfig, mesh,
                 opt_cfg: adamw.AdamWConfig, *, num_samples: int,
                 seq_len: int, seed: int = 0,
                 initial_params: Optional[dict] = None,
                 whole_stage: bool = False):
        self.cfg, self.pcfg, self.mesh, self.opt_cfg = cfg, pcfg, mesh, \
            opt_cfg
        self.seed, self.seq, self.num_samples = seed, seq_len, num_samples
        dev = mesh.device
        self.lay = stage_layout(cfg, mesh.shape.model)
        self.stage = Stage(cfg, self.lay, mesh.model_rank, device=dev)
        self.ep = mesh.data_group if cfg.has_moe \
            and pcfg.moe_mode == "expert_parallel" else None
        comm = pcfg.comm
        self.bucket = PipelineBucket(cfg, self.lay, comm.dp_group_d)
        self.sharded = bool(comm.dp.bits) and comm.dp_wire_spec.sharded
        if initial_params is not None:
            def load(st):
                return st.load_pipeline_params(initial_params, self.lay)
        else:
            # every rank draws the whole model on the CPU from the same
            # seed, so the stages (and both copies of a tied embedding)
            # agree, and a run on the card starts from the weights of the
            # same run on the CPU
            model = Transformer(cfg, device="cpu", generator=seeded_generator(
                "cpu", seed, "init"))

            def load(st):
                return st.load_from_model(model)
        load(self.stage)
        self.shapes = {n: tuple(p.shape)
                       for n, p in self.stage.named_parameters()}
        if mesh.shape.data > 1 and not whole_stage:
            self.stage.fsdp = StageFsdp(self.stage, self.lay,
                                        mesh.data_group, self.ep is not None)
            self.stage.fsdp.shard_(self.stage)
        self.params = dict(self.stage.named_parameters())
        if self.sharded:
            n = mesh.shape.data
            self.seg = GC.ring_segment_rows(self.bucket.rows, n)
            self.pbucket = self._param_bucket(load, n * self.seg).to(dev)
            self.opt = adamw.init_bucket_opt_state(
                1, self.seg, self.bucket.group_d, device=dev)
        else:
            self.opt = adamw.init_opt_state(self.params, opt_cfg.state_bits)
        self.has_bufs = comm.mode == "aqsgd"
        k, kk = mesh.model_rank, mesh.shape.model
        d = cfg.d_model
        # a vlm model's boundaries carry its patch rows ahead of the text
        trunk = seq_len + cfg.num_patches
        self.m_out = init_buffer(pcfg, num_samples, trunk, d, dev) \
            if self.has_bufs and k < kk - 1 else None
        self.m_in = init_buffer(pcfg, num_samples, trunk, d, dev) \
            if self.has_bufs and k > 0 else None
        self.dp_error = init_dp_error(self.bucket, dev) \
            if comm.dp.bits else None

    def _param_bucket(self, load, rows: int) -> torch.Tensor:
        """The whole model's f32 parameter bucket on the CPU, ``rows``
        rows (zero past the model): every stage built on the CPU with
        ``load`` and written into its slots (a tied embedding's two
        copies into the one slot they share)."""
        out = torch.zeros((rows, self.bucket.group_d), dtype=torch.float32)
        for k in range(self.lay.num_stages):
            st = load(Stage(self.cfg, self.lay, k, device="cpu"))
            self.bucket.flatten(st, dict(st.named_parameters()), out=out)
        return out

    def step(self, batch: dict, step: int, *, warmup: bool) -> float:
        """One training step on this rank's shard ``batch`` (numpy,
        microbatch-major (M, mb, ...), with the global batch's mask
        count under ``"count"``; a vlm model's with ``patches``, an
        audio model's with ``frames``).  Returns the global mean loss."""
        pcfg = dataclasses.replace(self.pcfg, warmup=warmup)
        mesh, st, dev = self.mesh, self.stage, self.mesh.device
        self.phase_seconds, self._t = {}, time.perf_counter()
        k, kk = mesh.model_rank, mesh.shape.model
        hop = make_transfer(pcfg, mesh, seeded_generator(
            dev, self.seed, step, "act", mesh.rank))
        aq = hop.mode == "aqsgd"
        t = {name: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
             for name, v in batch.items() if name != "count"}
        count = float(batch["count"])
        need = {"audio": "frames", "vlm": "patches"}.get(self.cfg.family)
        if need is not None and need not in t:
            raise KeyError(f"{self.cfg.name}: the {self.cfg.family} "
                           f"family's batch needs {need!r}")
        M, mb, seq = t["tokens"].shape
        n_patch = self.cfg.num_patches if "patches" in t else 0
        shape = (mb, n_patch + seq, self.cfg.d_model)
        for p in self.params.values():
            p.grad = None

        if st.fsdp is not None:
            st.fsdp.seconds, st.fsdp.gathers = 0.0, collections.Counter()
        terminals, loss = [], torch.zeros((), device=dev)
        for j in range(M):
            ids = t["sample_ids"][j].long()
            enc = st.encode(t["frames"][j], pcfg) if "frames" in t \
                else None
            io = st.gather_io()
            if k == 0:
                h = st.embed_tokens(t["tokens"][j], pcfg.block_k,
                                    t["patches"][j] if n_patch else None,
                                    io=io)
            else:
                m_in_s = buffer_read(pcfg, self.m_in, ids,
                                     self.cfg.d_model) if aq else None
                h, nmi = hop.recv(shape, self.cfg.torch_dtype, m_in_s)
                if nmi is not None and self.has_bufs:
                    buffer_write(pcfg, self.m_in, ids, nmi)
            out = st.trunk(h, pcfg, self.ep, enc)
            del enc
            if k < kk - 1:
                m_out_s = buffer_read(pcfg, self.m_out, ids,
                                      self.cfg.d_model) if aq else None
                token, nmo = hop.send(out, m_out_s)
                if nmo is not None and self.has_bufs:
                    buffer_write(pcfg, self.m_out, ids, nmo)
                terminals.append(token)
            else:
                nll = st.nll_sum(out[:, n_patch:], t["targets"][j],
                                 t["mask"][j].float(), pcfg.loss_chunks,
                                 io=io) / max(count, 1.0)
                terminals.append(nll)
                loss = loss + nll.detach()
            del io
        for term in reversed(terminals):
            term.backward()
        del terminals
        self._lap("pipeline")
        if st.fsdp is not None:
            self.phase_seconds["fsdp_gather"] = st.fsdp.seconds
        self._update(step)
        total = mesh.transport.all_reduce(loss, dist.ReduceOp.SUM, None,
                                          "loss")
        return float(total)

    def _update(self, step: int) -> None:
        """Full-tree f32 mean gradient, the DP wire, AdamW (on this rank's
        shards with FSDP)."""
        mesh, comm, fs = self.mesh, self.pcfg.comm, self.stage.fsdp
        grads = fs.take_grads() if fs is not None else {}
        grads.update({n: p.grad for n, p in self.params.items()
                      if p.grad is not None})
        bucket = self.bucket.flatten(self.stage, grads)
        del grads
        for p in self.params.values():
            p.grad = None
        mean = mesh.transport.all_reduce(bucket, dist.ReduceOp.SUM, None,
                                         "grad")
        del bucket
        self._lap("grad_allreduce")
        dpc = comm.dp
        if dpc.bits:
            spec = comm.dp_wire_spec
            extra = {"chunks": dpc.chunks} if spec.chunkable else {}
            err = self.dp_error if dpc.error_feedback \
                else torch.zeros_like(self.dp_error)
            mean, new_err = spec.collective(
                mean, err, mesh.data_group, dpc.bits,
                stochastic=dpc.stochastic, backend=dpc.backend,
                generator=seeded_generator(mesh.device, self.seed, step,
                                           "dp", mesh.data_rank), **extra)
            # a sharded wire returns this rank's segment, which a small
            # model can leave all padding (legitimately zero)
            mean, new_err = faults.guard_dp_pair(
                mean, new_err, expect_nonzero=not spec.sharded)
            self.dp_error = new_err if dpc.error_feedback \
                else torch.zeros_like(new_err)
            self._lap("dp_wire")
        if self.sharded:
            self._sharded_update(mean)
            return
        whole = self.bucket.views(self.stage, mean, self.shapes)
        g = {n: fs.local(n, whole[n]) if fs is not None else whole[n]
             for n in self.params}
        # 8-bit moments keep one scale a row of the whole leaf: a leaf
        # split along its last dim takes its rows' maxima over the data
        # group (one MAX all-reduce, the ``opt`` plane), so its codes are
        # the whole leaf's
        bits = self.opt_cfg.state_bits
        rows = [n for n in fs.split_rows if n in self.params] \
            if fs is not None and bits else []
        adamw.widen_moments(self.opt, rows, bits)
        self.opt = adamw.apply_updates(self.opt_cfg, self.params, g,
                                       self.opt)
        adamw.code_moments(self.opt, rows, bits, lambda m: fs.group.
                           all_reduce(m, dist.ReduceOp.MAX, plane="opt"))
        self._lap("adamw")

    @torch.no_grad()
    def _sharded_update(self, seg_mean: torch.Tensor) -> None:
        """The ZeRO wire's owner update: AdamW on this rank's segment of
        the full-model parameter bucket, the segments all-gathered over
        the data group, the stage's parameters copied out."""
        group, seg = self.mesh.data_group, self.seg
        own = self.pbucket[group.index * seg:(group.index + 1) * seg]
        self.opt = adamw.apply_bucket_updates(self.opt_cfg, own[None],
                                              seg_mean[None], self.opt)
        self._lap("adamw")
        group.all_gather(own, self.pbucket.view(group.size, seg, -1))
        fs = self.stage.fsdp
        whole = self.bucket.views(self.stage, self.pbucket, self.shapes)
        for name, p in self.params.items():
            p.copy_(fs.local(name, whole[name]) if fs is not None
                    else whole[name])
        self._lap("param_gather")

    def _lap(self, name: str) -> None:
        """Record the wall time since the last lap under ``name``, at
        the end of this rank's device work (the step's phase times)."""
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        now = time.perf_counter()
        self.phase_seconds[name] = now - self._t
        self._t = now


def spec_configs(spec: dict) -> tuple:
    """(model config, `PipelineConfig`, `adamw.AdamWConfig`) of a run's
    ``spec`` (`repro_torch.launch.train.distributed_spec`)."""
    from repro_torch.configs.base import get_config
    cfg = get_config(spec["arch"], smoke=spec["smoke"])
    if spec.get("num_layers"):
        cfg = cfg.with_(num_layers=spec["num_layers"])
    pcfg = PipelineConfig(microbatches=spec["microbatches"],
                          comm=CommConfig.from_json(spec["comm"]),
                          **spec.get("pipeline", {}))
    return cfg, pcfg, adamw.AdamWConfig(**spec["optimizer"])


def build_rank(rank: int, world: int, spec: dict) -> tuple:
    """This process's `PipelineRank` and the run's `Dataset` for
    ``spec``, the run's plain-data description (see
    `repro_torch.launch.train.distributed_spec`)."""
    from repro_torch.data.pipeline import Dataset, DatasetConfig
    from repro_torch.launch.mesh import Mesh, MeshShape

    shape = MeshShape(spec["data_par"], spec["stages"])
    if world != shape.world:
        raise ValueError(f"world {world} != mesh {shape.world}")
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh = Mesh(shape, rank, dev)
    cfg, pcfg, opt_cfg = spec_configs(spec)
    ds = Dataset(DatasetConfig(**spec["dataset"]))
    trainer = PipelineRank(cfg, pcfg, mesh, opt_cfg,
                           num_samples=ds.num_samples, seq_len=ds.dc.seq_len,
                           seed=spec["seed"],
                           initial_params=spec.get("initial_params"),
                           whole_stage=spec.get("_whole_stage", False))
    return trainer, ds


def rank_batch(trainer: PipelineRank, batch: dict) -> dict:
    """This rank's shard of a global (B, ...) batch in the layout of
    `PipelineRank.step`: microbatch-major, with the global mask count."""
    from repro_torch.data.pipeline import data_shard, microbatch_major
    mesh = trainer.mesh
    local = data_shard(microbatch_major(batch, trainer.pcfg.microbatches),
                       mesh.shape.data, mesh.data_rank)
    local["count"] = float(np.sum(batch["mask"]))
    return local


def train_rank(rank: int, world: int, spec: dict) -> dict:
    """One process of a distributed run (`repro_torch.launch.mesh.spawn`
    target).  ``spec``: the run's plain-data description (see
    `repro_torch.launch.train.distributed_spec`; ``ckpt_dir``,
    ``save_every``, ``keep`` and ``resume`` are the checkpoint flags).
    Returns the rank's losses (of the steps this call ran), the count
    of staged ``.tmp-*`` entries rank 0 removed from the checkpoint
    directory and its sidecar (``orphans_removed``; 0 on the others),
    step and phase times, peak device memory, kernel launches,
    transport bytes and manifests, the ``fsdp`` plane's largest
    gathered buffer and its calls by unit (`StageFsdp.gathers`),
    replica checks (after every step) and the checkpoints' saves and
    restores (``ckpt``: step, seconds, bytes on disk written or read,
    and a save's ``ckpt`` plane bytes, `pipeline_state.save` and
    `pipeline_state.restore`), as plain data.  An audio or vlm
    model's global batches get stub frames or patches
    (`data.pipeline.with_stub_media`, seeded by the run's seed), which
    the `Dataset` does not make and its step needs."""
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.training import pipeline_state as PS

    trainer, ds = build_rank(rank, world, spec)
    mesh, dev = trainer.mesh, trainer.mesh.device
    steps, gb = spec["steps"], spec["batch"]
    warm_steps = max(ds.num_samples // gb, 1) * spec["warmup_epochs"] \
        if trainer.has_bufs else 0
    out = {"rank": rank, "data_rank": mesh.data_rank,
           "model_rank": mesh.model_rank, "losses": [], "step_seconds": [],
           "replicas": [], "bytes": [], "launches": [], "manifests": [],
           "phase_seconds": [], "ckpt": [], "start": 0,
           "orphans_removed": 0, "largest_gather": [], "fsdp_gathers": []}
    ckpt_dir = spec.get("ckpt_dir", "")
    save_every = spec.get("save_every", 0)
    if ckpt_dir and rank == 0:
        out["orphans_removed"] = PS.clean_orphans(ckpt_dir)
    if spec.get("resume"):
        info = PS.restore(trainer, ckpt_dir)
        out["start"] = info["step"]
        out["ckpt"].append({"op": "restore", **info})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    batches = ds.batches(gb, steps)
    for _ in range(out["start"]):
        next(batches)       # the data stream is deterministic: replay by
                            # skipping to the checkpointed position
    for step_i, batch in enumerate(batches, start=out["start"]):
        batch = with_stub_media(trainer.cfg, batch, seed=spec["seed"],
                                step=step_i)
        local = rank_batch(trainer, batch)
        mesh.transport.reset()
        qp.reset_launches()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss = trainer.step(local, step_i, warmup=step_i < warm_steps)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["step_seconds"].append(time.perf_counter() - t0)
        out["phase_seconds"].append(dict(trainer.phase_seconds))
        out["losses"].append(loss)
        out["launches"].append(dict(qp.LAUNCHES))
        tr = mesh.transport
        out["bytes"].append({p: tr.bytes_sent(p)
                             for p in ("fw", "bw", "dp", "dp-gather", "ep",
                                       "grad", "fsdp", "opt")})
        out["largest_gather"].append(tr.largest_gather("fsdp"))
        fs = trainer.stage.fsdp
        out["fsdp_gathers"].append({} if fs is None else dict(fs.gathers))
        out["manifests"].append(tr.manifest("dp"))
        out["replicas"].append(check_replicas(trainer))
        done = step_i + 1
        if ckpt_dir and save_every and done % save_every == 0:
            out["ckpt"].append({"op": "save", **PS.save(
                trainer, ckpt_dir, done, keep=spec.get("keep", 3))})
    if dev.type == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    out["dp_bucket"] = list(trainer.bucket.shape)
    out["warm_steps"] = warm_steps
    out["resident_bytes"] = resident_param_bytes(trainer)
    return out


def resident_param_bytes(trainer: PipelineRank) -> int:
    """The bytes of the rank's parameters, AdamW moments (codes and
    scales with 8-bit moments) and, under the ZeRO wire, parameter
    bucket, as held (`rank_param_bytes` models them)."""
    def nbytes(t):
        if isinstance(t, dict):
            return sum(nbytes(v) for v in t.values())
        return t.numel() * t.element_size() \
            if isinstance(t, torch.Tensor) else 0
    total = nbytes(trainer.params) + nbytes(trainer.opt["mu"]) \
        + nbytes(trainer.opt["nu"])
    return total + (nbytes(trainer.pbucket) if trainer.sharded else 0)


@torch.no_grad()
def gather_whole(trainer: PipelineRank, tensors: dict) -> dict:
    """Tensors keyed as ``trainer.params`` (this rank's shards, or
    anything shaped like them), whole: each sharded leaf all-gathered
    over the data group on the ``check`` plane, outside the wire planes,
    and the encoder leaves other data ranks hold whole included; the
    rest as given.  Every rank of the data group calls it at the same
    point (the tests' view of the whole stage)."""
    fs = trainer.stage.fsdp
    if fs is None:
        return dict(tensors)
    group, out = fs.group, {}
    for name, shape in trainer.shapes.items():
        spec = fs.shards.get(name)
        if spec is None:
            out[name] = tensors[name]
            continue
        mine = tensors[name] if spec.held(fs.r) else torch.zeros(
            shape, dtype=torch.float32, device=trainer.mesh.device)
        got = group.all_gather(mine.contiguous(), mine.new_empty(
            (group.size, *mine.shape)), plane="check")
        out[name] = got[spec.owner] if spec.dim is None \
            else torch.cat(list(got), spec.dim)
    return out


def train_ranks(rank: int, world: int, specs: list) -> list:
    """`train_rank` of each spec in turn, in one process."""
    return [train_rank(rank, world, spec) for spec in specs]


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bit pattern as integers (so -0 != +0 and NaNs
    compare)."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


@torch.no_grad()
def check_replicas(trainer: PipelineRank) -> dict:
    """Ship each stage's m_out to the next stage, when the embedding is
    tied stage 0's embedding to the last stage, and a hybrid's shared
    block and an audio model's encoder from stage 0 to every other stage
    (the ``check`` plane, outside the wire planes), and compare bit for
    bit.  Returns {"m_in_equal", "embed_equal", "shared_equal",
    "encoder_equal"}, each a bool or None where this rank checks
    nothing (an untied model has one embedding and checks none)."""
    mesh, tr = trainer.mesh, trainer.mesh.transport
    k, kk = mesh.model_rank, mesh.shape.model
    res = {"m_in_equal": None, "embed_equal": None, "shared_equal": None,
           "encoder_equal": None}
    if trainer.has_bufs:
        if k < kk - 1:
            for name in sorted(trainer.m_out):
                tr.send(trainer.m_out[name], mesh.stage_rank(k + 1), "check")
        if k > 0:
            eq = True
            for name in sorted(trainer.m_in):
                mine = trainer.m_in[name]
                got = tr.recv(mine.shape, mine.dtype,
                              mesh.stage_rank(k - 1), "check")
                eq &= torch.equal(_bits(got), _bits(mine))
            res["m_in_equal"] = bool(eq)
    if kk > 1 and trainer.cfg.tie_embeddings:
        if k == 0:
            tr.send(trainer.stage.embed, mesh.stage_rank(kk - 1), "check")
        elif k == kk - 1:
            e = trainer.stage.embed
            got = tr.recv(e.shape, e.dtype, mesh.stage_rank(0), "check")
            res["embed_equal"] = bool(torch.equal(_bits(got), _bits(e)))
    st = trainer.stage
    for key, mods in (("shared_equal", [st.shared_block]),
                      ("encoder_equal", [st.enc_layers, st.enc_norm])):
        if kk == 1 or mods[-1] is None:
            continue
        params = [p for m in mods for _, p in sorted(m.named_parameters())]
        if k == 0:
            for dst in range(1, kk):
                for p in params:
                    tr.send(p, mesh.stage_rank(dst), "check")
        else:
            eq = True
            for p in params:
                got = tr.recv(p.shape, p.dtype, mesh.stage_rank(0), "check")
                eq &= torch.equal(_bits(got), _bits(p))
            res[key] = bool(eq)
    return res
