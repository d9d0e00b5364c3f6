"""The model of every family (dense, moe, ssm, hybrid, audio, vlm):
training forward and loss, and serving with KV caches, SSM states and
stage groups (port of `repro.models.model`).

One `Transformer` class serves every family the port runs, so the
launchers, trainers, `repro_torch.weights` and checkpoints have one
entry point.  Its ``layers`` are dense `Block`s (``dense``), MoE
`Block`s (``moe``: mixtral, deepseek-moe, moonshot; their FFN a
`moe.MoE`, after a ``prefix`` of ``first_dense_layers`` dense `Block`s,
JAX's ``prefix`` list outside the stacked layers) or `MambaBlock`s
(``ssm``: mamba2; ``hybrid``: zamba2, whose one ``shared_block``, a
dense `Block`, runs after every ``shared_attn_every``-th mamba layer
with the same weights each time).  The stage groups (and remat's unit)
are the JAX package's: the layers for dense, moe (its MoE layers; the
prefix runs before them) and ssm, blocks of ``shared_attn_every`` mamba
layers and the shared block for hybrid (so a hybrid's block count must
divide by the stage groups).  ``vlm`` (pixtral) is the dense decoder
with stub patch embeddings ahead of the text (`embed_rows`): they run
through the trunk and the stage groups like text rows, and their rows
are dropped before the head.  ``audio`` (whisper) adds an encoder
(``enc_layers``, dense `Block`s whose self-attention is non-causal over
the stub frame embeddings, then ``enc_norm``: `encode`), run before
the decoder and outside its stage groups, and each decoder layer a
cross attention (``norm_x``, ``xattn``) after its FFN over the
encoder's output, keys and values projected by the layer, no RoPE;
serving keeps them in raw ``xk``/``xv`` caches written at the step
that carries ``frames``.

`loss_fn` is the training forward over whole sequences, with autograd:
`Transformer.trunk_forward` cuts the layer stack into ``num_stages``
stage groups and runs ``boundary_fn(state, h, idx) -> (state, h)``
between them, where the simulated trainer plugs in the AQ-SGD
boundary (`repro_torch.core.aqsgd.apply_boundary`); with ``remat``
each unit (a layer, or a hybrid's block: `run_remat`), never a
boundary, is recomputed in the backward.

`Transformer.forward_with_caches` is the unified prefill (S > 1) /
decode (S = 1) step.  Its serving-plane hooks are the JAX package's:

* ``num_stages``/``boundary_fn`` cut the layer stack into pipeline
  stage groups and run ``boundary_fn(state, h, idx) -> (state, h)`` on
  the hidden state between them (the compressed decode hop,
  `repro_torch.serving.delta.DeltaHopCodec`); the hop's reference
  buffers ride in the cache dict under ``"hop_m"`` (f32 (nb, B, 1, d));
* a ``kv_codec`` with ``bits > 0`` switches the ``k``/``v`` stores to
  the quantized layout (``{k,v}_codes``/``{k,v}_scale``,
  `repro_torch.serving.kvcache`): each layer dequantizes its whole
  store, attends with the step's fresh raw rows scattered in, then
  encodes only those fresh rows back.  k and v go together: one store
  read for both (`KVCodec.decode_pair`) and one append for both
  (`KVCodec.append_pair`), which writes the codes and scales in place
  at the write head, so on the card a layer runs two KV kernels and
  the two scatters.

Unlike the JAX package, caches are updated IN PLACE (a decode step
writes B rows per layer instead of copying the whole store; an ssm or
hybrid layer overwrites its ``ssm`` state (L, B, h, p, n) f32 and its
``conv`` window (L, B, width-1, conv_dim) of raw pre-conv rows; the
hybrid's raw ``k``/``v`` are (n_blocks, B, Sc, Hk, hd), one a shared
block call).  An ssm or hybrid step runs a prefill (S > 1) through
`ssm.mamba2_forward` from the stored state, a decode step (S = 1)
through `ssm.mamba2_decode_step`.  The
write head ``caches["pos"]`` is a Python int for a uniform batch, or a
(B,) int32 tensor on the device, a head a row: the continuous
batcher's pool (`repro_torch.serving.batcher`), whose rows sit at
different depths.  Such a step decodes one token a row; each row's
positions start at its own head, its raw-cache row and KV append are
written at the head clamped into the store (``dynamic_update_slice``'s
rule, which the JAX batcher applies row by row under ``vmap``), and
the heads advance on the device, so the step reads no position on the
host.  Every family takes such a pool: an ssm or hybrid step reads and
writes each row's ``ssm`` state and ``conv`` window in place (an ssm
step reads no position at all), a hybrid's shared block and an audio
model's decoder self-attention write at the per-row heads, and an audio
model's cross attention reads each row's own ``xk``/``xv`` (zeros in
the batcher's pool, which passes no ``frames`` or ``patches``, as the
JAX batcher passes none).

A MoE layer dispatches as JAX's serving does: a prefill (S > 1) per
sequence, a uniform decode step over its B rows (so two rows that pick
one expert past its capacity drop the later slot), and a pooled step
per row (JAX's batcher ``vmap``s a one-row step over the slots).  The
prefix's raw ``pk``/``pv`` caches are never quantized.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cache_rows import clamp_heads
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


class Block(nn.Module):
    """One dense or MoE decoder layer: pre-norm attention + pre-norm FFN,
    a `layers.MLP` or, with ``moe``, a `moe.MoE`; with ``cross`` (the
    whisper decoder's layers, JAX ``_init_dec_layer``) a pre-norm cross
    attention after the FFN, ``norm_x`` and ``xattn``."""

    def __init__(self, cfg: ModelConfig, device=None, moe: bool = False,
                 cross: bool = False):
        super().__init__()
        self.norm1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.attn = L.Attention(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                                cfg.head_dim, cfg.rope_theta,
                                cfg.attn_softcap, device=device)
        self.norm2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.ffn = M.MoE(cfg, device=device) if moe else \
            L.MLP(cfg.d_model, cfg.d_ff, cfg.act, cfg.mlp_gated,
                  device=device)
        if cross:
            self.norm_x = L.RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
            self.xattn = L.Attention(cfg.d_model, cfg.num_heads,
                                     cfg.num_kv_heads, cfg.head_dim,
                                     cfg.rope_theta, device=device)
        else:
            self.norm_x = self.xattn = None

    @property
    def is_moe(self) -> bool:
        return isinstance(self.ffn, M.MoE)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """JAX's init scales: the attentions' and the FFN's (norms
        zero)."""
        self.attn.reset_parameters(generator)
        self.ffn.reset_parameters(generator)
        if self.xattn is not None:
            self.xattn.reset_parameters(generator)

    def forward(self, h, positions, window, k_cache=None, v_cache=None,
                cache_index=0, block_k=512, *, per_sequence: bool = False,
                ep=None, expert_map=None, causal: bool = True, xkv=None):
        """Returns (h, fresh_k, fresh_v, aux): aux the MoE router's
        load-balance loss, 0.0 for an MLP.  ``per_sequence``, ``ep`` and
        ``expert_map``: `moe.moe_ffn`'s; ``causal=False``: the whisper
        encoder's self-attention; ``xkv``: a cross layer's keys and
        values of the encoder's output (B, Se, Hk, hd) each, read after
        the FFN (JAX's audio step)."""
        a, k, v = self.attn(self.norm1(h), positions, window, k_cache,
                            v_cache, cache_index, block_k, causal)
        h = h + a
        hn = self.norm2(h)
        if self.is_moe:
            f, aux = self.ffn(hn, per_sequence=per_sequence, ep=ep,
                              expert_map=expert_map)
        else:
            f, aux = self.ffn(hn), 0.0
        h = h + f
        if xkv is not None:
            h = h + self.xattn.cross(self.norm_x(h), positions, *xkv,
                                     block_k=block_k)
        return h, k, v, aux


class MambaBlock(nn.Module):
    """One ssm/hybrid trunk layer: pre-norm Mamba2 mixer with the
    residual (JAX ``_init_mamba_layer`` / ``_mamba_layer``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.norm1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.mamba = S.Mamba2(cfg, device=device)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        out, _ = S.mamba2_forward(self.mamba, self.norm1(h), self.cfg)
        return h + out

    def step(self, h: torch.Tensor, ssm_state: torch.Tensor,
             conv_state: torch.Tensor) -> torch.Tensor:
        """One serving step from the stored states, written back in
        place: a prefill (S > 1) from ``ssm_state`` (the conv starts from
        zeros, as JAX's), or a decode step (S = 1) over the stored conv
        window.  ``ssm_state`` (B, h, p, n) f32 and ``conv_state`` (B,
        width-1, conv_dim) in the cache's dtype are views of a layer's
        rows, a uniform batch's or the continuous batcher's whole pool,
        so a pooled step touches no other copy of the pool."""
        hin = self.norm1(h)
        if h.shape[1] == 1:
            out, nst, ncv = S.mamba2_decode_step(self.mamba, hin, self.cfg,
                                                 ssm_state, conv_state)
        else:
            out, st = S.mamba2_forward(self.mamba, hin, self.cfg,
                                       initial_state=ssm_state)
            nst, ncv = st["ssm"], st["conv"]
        ssm_state.copy_(nst)
        conv_state.copy_(ncv)
        return h + out


def trunk_layer(cfg: ModelConfig, device=None) -> nn.Module:
    """One trunk layer of the family: a dense or MoE `Block` (an audio
    model's with cross attention; vlm's is dense), or a `MambaBlock`."""
    if cfg.family in ("ssm", "hybrid"):
        return MambaBlock(cfg, device=device)
    return Block(cfg, device=device, moe=cfg.family == "moe",
                 cross=cfg.family == "audio")


def layer_fn(cfg: ModelConfig, i: int, blk: nn.Module,
             positions: torch.Tensor, seq: int, block_k: int,
             shared_block: Optional[Block] = None, ep=None,
             enc: Optional[torch.Tensor] = None,
             expert_hook: Optional[Callable] = None) -> Callable:
    """Global layer ``i``'s training function h -> (h, aux) (JAX's scan
    body), aux a MoE layer's router loss (``ep``: `moe.moe_ffn`'s;
    ``expert_hook(moe)``, called at each run of the layer: its
    ``expert_map``) and 0.0 in any other layer: a dense or MoE layer at
    its window (an audio layer with its cross attention over the
    encoder's output ``enc``, its keys and values projected inside, as
    the pipeline's ``_apply_layer`` does), or a mamba layer followed,
    where
    ``shared_block`` is given, by the hybrid's shared block over the
    whole sequence (``cfg.sliding_window or seq``)."""
    if isinstance(blk, Block):
        window = cfg.layer_window(i, seq)
        if blk.xattn is not None and enc is None:
            raise ValueError(f"{cfg.name}: a cross-attention layer needs "
                             f"the encoder's output")

        def attn_layer(x):
            xkv = blk.xattn.cross_kv(enc) if blk.xattn is not None else None
            em = expert_hook(blk.ffn) \
                if expert_hook is not None and blk.is_moe else None
            out = blk(x, positions, window, block_k=block_k, ep=ep,
                      expert_map=em, xkv=xkv)
            return out[0], out[3]
        return attn_layer
    if shared_block is None:
        return lambda x: (blk(x), 0.0)

    def layer(x):
        return shared_block(blk(x), positions, cfg.sliding_window or seq,
                            block_k=block_k)[0], 0.0
    return layer


class Transformer(nn.Module):
    """The decoder (dense: ``gpt2-xl-paper``, ``gemma2-9b``,
    ``gemma2-27b``, ``stablelm-12b``, with per-layer sliding windows,
    GQA, attention and final logit softcaps, gated or plain MLP; moe:
    ``mixtral-8x22b``, ``deepseek-moe-16b``, ``moonshot-v1-16b-a3b``;
    ssm: ``mamba2-1.3b``; hybrid: ``zamba2-2.7b``; vlm: ``pixtral-12b``;
    audio: ``whisper-small``): token embedding (after a vlm model's
    patches), an audio model's encoder (``enc_layers``, ``enc_norm``), a
    MoE model's dense ``prefix``, a stack of `Block`s (an audio model's
    with cross attention) or `MambaBlock`s (and the hybrid's
    ``shared_block``), a final RMSNorm and the logits,
    read through the embedding when ``cfg.tie_embeddings``, else through
    a ``head`` of its own, (d_model, vocab) as in the JAX package.

    ``generator`` seeds a random init that follows the JAX package's
    scales (N(0, 0.02) embedding, N(0, 1/d_model) head, N(0, 1/fan_in)
    projections, zero norms, `ssm.Mamba2.reset_parameters`' mixer,
    `moe.MoE.reset_parameters`' experts),
    drawn leaf by leaf on the generator's
    device (a CPU generator gives the same weights on every device,
    `layers.init_normal_`); without it the weights are left
    uninitialized, for `repro_torch.weights.from_jax_params` to fill."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(
                f"{cfg.name}: unknown family {cfg.family!r}; the port runs "
                f"the {', '.join(FAMILIES)} families")
        if cfg.family == "hybrid" and cfg.num_layers % cfg.shared_attn_every:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not "
                             f"whole blocks of {cfg.shared_attn_every}")
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              device=device))
        self.head = None if cfg.tie_embeddings else nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab_size, device=device))
        self.prefix = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.first_dense_layers))
        self.layers = nn.ModuleList(trunk_layer(cfg, device=device)
                                    for _ in range(cfg.n_trunk))
        self.shared_block = Block(cfg, device=device) \
            if cfg.family == "hybrid" else None
        self.enc_layers = nn.ModuleList(
            Block(cfg, device=device) for _ in range(cfg.encoder_layers))
        self.enc_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, device=device) \
            if cfg.encoder_layers else None
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        if generator is not None:
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        L.init_normal_(self.embed, 0.02, generator)
        if self.head is not None:
            L.init_normal_(self.head, 1.0 / math.sqrt(self.cfg.d_model),
                           generator)
        for blk in [*self.prefix, *self.layers]:
            if isinstance(blk, MambaBlock):
                blk.mamba.reset_parameters(generator)
            else:
                blk.reset_parameters(generator)
        if self.shared_block is not None:
            self.shared_block.reset_parameters(generator)
        for blk in self.enc_layers:
            blk.reset_parameters(generator)

    # -- embedding / head / encoder -----------------------------------------

    def embed_tokens(self, tokens: torch.Tensor,
                     patches: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (B, S) -> (B, S, d); a vlm model's ``patches`` (B, P, d)
        go ahead of the text (JAX ``embed_tokens(extra_embeds=)``)."""
        return embed_rows(self.cfg, self.embed, tokens, patches)

    def encode_audio(self, frames: torch.Tensor, *, remat: bool = False,
                     block_k: int = 512) -> torch.Tensor:
        """The whisper encoder over the stub frame embeddings (B, Se, d)
        (JAX ``encode_audio``): `encode` with this model's layers."""
        return encode(self.cfg, self.enc_layers, self.enc_norm, frames,
                      remat=remat, block_k=block_k)

    def lm_logits(self, h: torch.Tensor) -> torch.Tensor:
        return head_logits(self.cfg, self.final_norm(h), self.embed,
                           self.head)

    # -- training forward ---------------------------------------------------

    def trunk_forward(self, h: torch.Tensor, positions: torch.Tensor, *,
                      num_stages: int = 1,
                      boundary_fn: Optional[Callable] = None,
                      boundary_state=None, remat: bool = False,
                      block_k: int = 512,
                      enc: Optional[torch.Tensor] = None):
        """The trunk over whole sequences.  h: (B, S, d) after the
        embedding, positions ``arange(S)`` a row.  A MoE model's dense
        ``prefix`` runs first, outside the stage groups and any
        checkpoint, as in JAX.  ``boundary_fn(state, h, idx) -> (state,
        h)`` runs between stage groups (idx = 0 .. num_stages-2), which
        cut the units: the layers (dense, moe: its MoE layers, windows
        offset by the prefix; ssm) or the hybrid's blocks.  ``remat``
        checkpoints each unit, as JAX's ``_scan_layers`` does: its
        activations are recomputed in the backward.  The boundaries stay
        outside every checkpoint, since they draw noise from explicit
        generators (which a recompute would not restore) and write the
        message buffers.  ``block_k`` is the attention backward's key
        block; ``enc`` an audio model's encoder output (B, Se, d), which
        every decoder layer's cross attention reads.  Returns (h, aux,
        boundary_state), as JAX's: aux the MoE layers' router losses
        summed (0.0 in the other families)."""
        cfg, seq = self.cfg, h.shape[1]
        aux = 0.0
        h = prefix_forward(cfg, self.prefix, h, positions, block_k)
        per = stage_size(cfg, num_stages)
        n = per * num_stages
        for u in range(n):
            h, a = run_remat(self.unit(u, positions, seq, block_k, enc), h,
                             remat=remat)
            aux = aux + a
            if boundary_fn is not None and (u + 1) % per == 0 \
                    and u + 1 < n:
                boundary_state, h = boundary_fn(boundary_state, h,
                                                (u + 1) // per - 1)
        return h, aux, boundary_state

    def unit(self, u: int, positions: torch.Tensor, seq: int,
             block_k: int, enc: Optional[torch.Tensor] = None) -> Callable:
        """The training function of unit ``u``, h -> (h, aux): a layer
        (dense, moe, ssm, vlm, audio: over ``enc``), or a hybrid block
        (its mamba layers, the shared block after the last,
        `layer_fn`)."""
        cfg = self.cfg
        if cfg.family != "hybrid":
            return layer_fn(cfg, u + cfg.first_dense_layers, self.layers[u],
                            positions, seq, block_k, enc=enc)
        per = cfg.shared_attn_every
        fns = [layer_fn(cfg, i, self.layers[i], positions, seq, block_k,
                        self.shared_block
                        if cfg.layer_has_shared_attn(i) else None)
               for i in range(u * per, (u + 1) * per)]

        def block(x):
            for fn in fns:
                x = fn(x)[0]
            return x, 0.0
        return block

    # -- caches -------------------------------------------------------------

    def init_caches(self, batch_size: int, cache_len: int,
                    dtype: torch.dtype = torch.bfloat16, device=None,
                    kv_codec=None) -> dict:
        """Zero caches for prefill/decode (JAX ``init_caches``): dense
        and moe (and vlm, audio), raw k, v (L, B, Sc, Hk, hd) over the
        trunk's L layers, or, with a quantizing ``kv_codec``, its
        ``{k,v}_codes`` and ``{k,v}_scale`` stores for that shape (the
        layout of JAX `quantize_caches`; no raw store is allocated), a
        MoE model's dense prefix raw ``pk``, ``pv`` (first_dense_layers,
        B, Sc, Hk, hd) and an audio model's raw cross caches ``xk``,
        ``xv`` (L, B, encoder_seq, Hk, hd), whatever the codec; ssm and
        hybrid, the ``ssm`` states f32 (L, B, h, p, n) and ``conv``
        windows (L, B, width-1, conv_dim),
        and for hybrid raw k, v (n_blocks, B, Sc, Hk, hd).  The family
        rules of JAX `quantize_caches` hold
        (`serving.kvcache.store_codec`): ssm has nothing to quantize, so
        ``kv_codec`` passes through; hybrid with ``kv_codec.bits``
        raises."""
        cfg = self.cfg
        device = device if device is not None else self.embed.device
        # imported here: the serving package imports this module
        from repro_torch.serving.kvcache import store_codec
        kv_codec = store_codec(cfg, kv_codec)
        caches: dict = {"pos": 0}
        if cfg.family in ("ssm", "hybrid"):
            b, L_ = batch_size, cfg.num_layers
            conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            caches["ssm"] = torch.zeros(
                (L_, b, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
                dtype=torch.float32, device=device)
            caches["conv"] = torch.zeros(
                (L_, b, cfg.ssm_conv_width - 1, conv_dim), dtype=dtype,
                device=device)
            if cfg.family == "ssm":
                return caches
        n_kv = cfg.n_blocks if cfg.family == "hybrid" else cfg.n_trunk
        shape = (n_kv, batch_size, cache_len, cfg.num_kv_heads,
                 cfg.head_dim)
        if cfg.first_dense_layers:
            for name in ("pk", "pv"):
                caches[name] = torch.zeros(
                    (cfg.first_dense_layers, *shape[1:]), dtype=dtype,
                    device=device)
        if cfg.cross_attention:
            for name in ("xk", "xv"):
                caches[name] = torch.zeros(
                    (cfg.num_layers, batch_size, cfg.encoder_seq,
                     cfg.num_kv_heads, cfg.head_dim), dtype=dtype,
                    device=device)
        for name in ("k", "v"):
            if kv_codec is not None and kv_codec.bits:
                store = kv_codec.empty(shape, device=device)
                caches[name + "_codes"] = store["codes"]
                caches[name + "_scale"] = store["scale"]
            else:
                caches[name] = torch.zeros(shape, dtype=dtype, device=device)
        return caches

    # -- prefill / decode ---------------------------------------------------

    @torch.no_grad()
    def forward_with_caches(self, tokens: torch.Tensor, caches: dict, *,
                            patches: Optional[torch.Tensor] = None,
                            frames: Optional[torch.Tensor] = None,
                            logits_last_only: bool = False,
                            num_stages: int = 1,
                            boundary_fn: Optional[Callable] = None,
                            kv_codec=None):
        """tokens (B, S).  Returns (logits (B, S or 1, V) f32, caches),
        the caches updated in place (see the module docstring);
        ``caches["pos"]`` an int or a (B,) int32 tensor of per-row
        heads.  A vlm prefill's ``patches`` (B, P, d) go ahead of the
        text, at positions ``pos .. pos + P - 1``, and their rows are
        dropped from the logits; an audio step with ``frames`` (B, Se,
        d) runs the encoder and writes every layer's cross keys and
        values into the raw ``xk``/``xv`` caches, cast to their dtype
        (JAX: at prefill), which the step and later ones read."""
        cfg = self.cfg
        pos0 = caches["pos"]
        quant = kv_codec is not None and bool(kv_codec.bits) \
            and cfg.family not in ("ssm", "hybrid")
        if frames is not None:
            enc = self.encode_audio(frames)
            for i, blk in enumerate(self.layers):
                for name, t in zip(("xk", "xv"), blk.xattn.cross_kv(enc)):
                    caches[name][i].copy_(t)
            del enc
        h = self.embed_tokens(tokens, patches)
        b, s = h.shape[0], h.shape[1]
        steps = torch.arange(s, dtype=torch.int32, device=h.device)
        positions = pos0[:, None] + steps \
            if isinstance(pos0, torch.Tensor) else pos0 + steps.expand(b, s)
        if cfg.family == "ssm":
            # no KV: the step reads no position and writes no row
            cache_len, write_at = 0, None
        else:
            cache_len = caches["k_codes" if quant else "k"].shape[2]
            # per-row heads: the raw-cache writes take them clamped, once
            # a step; B3's append clamps in the kernel
            write_at = clamp_heads(pos0, cache_len, s) \
                if isinstance(pos0, torch.Tensor) else pos0
        per = stage_size(cfg, num_stages)
        n = per * num_stages
        boundary_state = {"m": caches["hop_m"]} if "hop_m" in caches \
            else None
        # a MoE dispatch: a prefill's per sequence, the pool's per row
        # (JAX's batcher vmaps a one-row step), a uniform decode step's
        # over its B rows
        per_sequence = s > 1 or isinstance(pos0, torch.Tensor)
        for i, blk in enumerate(self.prefix):
            h = blk(h, positions, cfg.layer_window(i, cache_len),
                    caches["pk"][i], caches["pv"][i], write_at)[0]

        for u in range(n):
            if cfg.family not in ("ssm", "hybrid"):
                h = self._attn_cached(u, h, positions, cache_len, caches,
                                      write_at, kv_codec if quant else None,
                                      per_sequence)
            elif cfg.family == "ssm":
                h = self.layers[u].step(h, caches["ssm"][u],
                                        caches["conv"][u])
            else:
                per_b = cfg.shared_attn_every
                for i in range(u * per_b, (u + 1) * per_b):
                    h = self.layers[i].step(h, caches["ssm"][i],
                                            caches["conv"][i])
                h = self.shared_block(
                    h, positions, cfg.sliding_window or cache_len,
                    caches["k"][u], caches["v"][u], write_at)[0]
            if boundary_fn is not None and (u + 1) % per == 0 \
                    and u + 1 < n:
                boundary_state, h = boundary_fn(boundary_state, h,
                                                (u + 1) // per - 1)

        caches["pos"] = pos0 + s
        if boundary_state is not None:
            caches["hop_m"] = boundary_state["m"]
        if patches is not None:
            h = h[:, patches.shape[1]:]
        if logits_last_only:
            h = h[:, -1:]
        return self.lm_logits(h), caches

    def _attn_cached(self, i, h, positions, cache_len, caches, write_at,
                     kv_codec, per_sequence):
        """Trunk layer ``i`` (dense or MoE) of a serving step: attention
        over its raw cache, or with ``kv_codec`` over its dequantized
        store, the fresh rows encoded back."""
        cfg = self.cfg
        window = cfg.layer_window(i + cfg.first_dense_layers, cache_len)
        if kv_codec is not None:
            ck, cv = kv_codec.decode_pair(
                (caches["k_codes"][i], caches["v_codes"][i]),
                (caches["k_scale"][i], caches["v_scale"][i]),
                cfg.torch_dtype)
        else:
            ck, cv = caches["k"][i], caches["v"][i]
        xkv = (caches["xk"][i], caches["xv"][i]) \
            if cfg.cross_attention else None
        h, fk, fv, _ = self.layers[i](h, positions, window, ck, cv, write_at,
                                      per_sequence=per_sequence, xkv=xkv)
        if kv_codec is not None:
            # encode ONLY this step's fresh rows: old tokens keep their
            # original single encoding
            kv_codec.append_pair(
                (caches["k_codes"][i], caches["v_codes"][i]),
                (caches["k_scale"][i], caches["v_scale"][i]),
                (fk, fv), caches["pos"])
        return h


def prefix_forward(cfg: ModelConfig, prefix: nn.ModuleList, h: torch.Tensor,
                   positions: torch.Tensor, block_k: int,
                   around: Optional[Callable] = None) -> torch.Tensor:
    """A MoE model's dense ``prefix`` layers over whole sequences (JAX
    runs them outside the stacked layers and any checkpoint).
    ``around(i)``: a context layer i runs in (the distributed trainer's
    gather of its sharded weights)."""
    for i, blk in enumerate(prefix):
        with around(i) if around is not None else contextlib.nullcontext():
            h = blk(h, positions, cfg.layer_window(i, h.shape[1]),
                    block_k=block_k)[0]
    return h


def stage_size(cfg: ModelConfig, num_stages: int) -> int:
    """Units of the trunk (its layers past a MoE model's dense prefix,
    or the hybrid's blocks) a stage group holds: the JAX package's rule,
    the units split evenly."""
    if cfg.family == "hybrid":
        n, what = cfg.n_blocks, (f"{cfg.n_blocks} blocks of "
                                 f"{cfg.shared_attn_every} layers")
    else:
        n, what = cfg.n_trunk, f"{cfg.n_trunk} layers"
        if cfg.first_dense_layers:
            what += f" after the {cfg.first_dense_layers} dense ones"
    if num_stages < 1 or n % num_stages:
        raise ValueError(f"{cfg.name}: {what} do not split into "
                         f"{num_stages} stage groups")
    return n // num_stages


def embed_rows(cfg: ModelConfig, embed: torch.Tensor,
               tokens: torch.Tensor,
               patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The embedding's rows of ``tokens``, in the model's dtype, after a
    vlm model's ``patches`` (B, P, d) where given (JAX ``embed_tokens``
    with ``extra_embeds``).  Through `F.embedding`, whose backward adds a
    repeated token's gradients in a fixed order on the CPU too (an
    indexing's backward, ``index_put_`` with accumulation, adds them in
    the threads' order there), so a training run is bit-reproducible, as
    a resumed run needs."""
    h = F.embedding(tokens, embed.to(cfg.torch_dtype))
    if patches is None:
        return h
    return torch.cat([patches.to(h.dtype), h], dim=-2)


def encode(cfg: ModelConfig, enc_layers: nn.ModuleList, enc_norm: nn.Module,
           frames: torch.Tensor, *, remat: bool = False,
           block_k: int = 512, around: Optional[Callable] = None
           ) -> torch.Tensor:
    """The whisper encoder (JAX ``encode_audio``): dense layers whose
    self-attention is non-causal over the frames (B, Se, d), window
    `layers.BIG_WINDOW`, RoPE at ``arange(Se)``, each a remat unit; then
    ``enc_norm``.  ``around(i)``: a context layer i runs in, inside its
    unit (so its recompute too: the distributed trainer's gathered
    weights)."""
    b, se = frames.shape[0], frames.shape[1]
    pos = torch.arange(se, dtype=torch.int32,
                       device=frames.device).expand(b, se)
    h = frames
    for i, blk in enumerate(enc_layers):
        def layer(x, i=i, blk=blk):
            with around(i) if around is not None \
                    else contextlib.nullcontext():
                return blk(x, pos, L.BIG_WINDOW, block_k=block_k,
                           causal=False)[0]
        h = run_remat(layer, h, remat=remat)
    return enc_norm(h)


def head_logits(cfg: ModelConfig, h: torch.Tensor, embed: torch.Tensor,
                head: Optional[torch.Tensor]) -> torch.Tensor:
    """Logits of final-normed h, f32, final-softcapped (JAX ``lm_logits``
    after its norm), read through the untied ``head`` (d_model, vocab),
    or with ``head`` None through the embedding's transpose."""
    w = embed.t() if head is None else head
    return L.softcap((h @ w.to(h.dtype)).float(), cfg.final_softcap)


def run_remat(fn: Callable, h: torch.Tensor, *,
              remat: bool) -> torch.Tensor:
    """``fn(h)``, under `torch.utils.checkpoint` with ``remat``.  A unit
    of the trunk draws no random numbers, so the checkpoint stashes no
    generator state."""
    if not remat:
        return fn(h)
    return checkpoint(fn, h, use_reentrant=False, preserve_rng_state=False)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """logits (B, S, V) f32; targets (B, S) int; mask (B, S) {0, 1}.
    Mean negative log-likelihood over the unmasked tokens."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    return nll.sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(model: Transformer, batch: dict, *, num_stages: int = 1,
            boundary_fn: Optional[Callable] = None, boundary_state=None,
            remat: bool = False, block_k: int = 512):
    """batch: tokens, targets, mask (B, S) tensors, and a vlm model's
    optional ``patches`` (B, P, d) (without them it trains text-only, as
    JAX's) or an audio model's ``frames`` (B, Se, d), which it needs.
    Returns (loss, {"ce", "aux", "boundary_state"}): a MoE model's loss
    is ce + ``router_aux_weight`` x aux, its MoE layers' router losses
    summed, as JAX's; the other families have no auxiliary loss (aux
    0.0, the loss is ce).  The patches' rows run through the trunk
    (and the stage boundaries) and are dropped before the head.
    ``remat`` and ``block_k``: `Transformer.trunk_forward`."""
    cfg = model.cfg
    patches = batch.get("patches")
    h = model.embed_tokens(batch["tokens"], patches)
    b, s = h.shape[0], h.shape[1]
    positions = torch.arange(s, dtype=torch.int32,
                             device=h.device).expand(b, s)
    enc = None
    if cfg.cross_attention:
        if "frames" not in batch:
            raise KeyError(f"{cfg.name}: the audio family's loss reads "
                           f"batch['frames'] (B, {cfg.encoder_seq}, "
                           f"{cfg.d_model}), which this batch lacks")
        enc = model.encode_audio(batch["frames"], remat=remat,
                                 block_k=block_k)
    h, aux, boundary_state = model.trunk_forward(
        h, positions, num_stages=num_stages, boundary_fn=boundary_fn,
        boundary_state=boundary_state, remat=remat, block_k=block_k,
        enc=enc)
    if patches is not None:                    # drop the patch positions
        h = h[:, patches.shape[1]:]
    ce = cross_entropy(model.lm_logits(h), batch["targets"], batch["mask"])
    total = ce + cfg.router_aux_weight * aux if cfg.has_moe else ce
    return total, {"ce": ce, "aux": aux, "boundary_state": boundary_state}
