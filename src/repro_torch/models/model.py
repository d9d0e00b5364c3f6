"""The dense-family Transformer: training forward and loss, and serving
with KV caches and stage groups (port of `repro.models.model`).

`loss_fn` is the training forward over whole sequences, with autograd:
`Transformer.trunk_forward` cuts the layer stack into ``num_stages``
stage groups and runs ``boundary_fn(state, h, idx) -> (state, h)``
between them, where the simulated trainer plugs in the AQ-SGD
boundary (`repro_torch.core.aqsgd.apply_boundary`); with ``remat``
each layer (`run_layer`), never a boundary, is recomputed in the
backward.

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
writes B rows per layer instead of copying the whole store).  The
write head ``caches["pos"]`` is a Python int for a uniform batch, or a
(B,) int32 tensor on the device, a head a row: the continuous
batcher's pool (`repro_torch.serving.batcher`), whose rows sit at
different depths.  Such a step decodes one token a row; each row's
positions start at its own head, its raw-cache row and KV append are
written at the head clamped into the store (``dynamic_update_slice``'s
rule, which the JAX batcher applies row by row under ``vmap``), and
the heads advance on the device, so the step reads no position on the
host.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cache_rows import clamp_heads
from repro_torch.models import layers as L


class Block(nn.Module):
    """One dense decoder layer: pre-norm attention + pre-norm MLP."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.norm1 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.attn = L.Attention(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                                cfg.head_dim, cfg.rope_theta,
                                cfg.attn_softcap, device=device)
        self.norm2 = L.RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        self.ffn = L.MLP(cfg.d_model, cfg.d_ff, cfg.act, cfg.mlp_gated,
                         device=device)

    def forward(self, h, positions, window, k_cache=None, v_cache=None,
                cache_index=0, block_k=512):
        """Returns (h, fresh_k, fresh_v)."""
        a, k, v = self.attn(self.norm1(h), positions, window, k_cache,
                            v_cache, cache_index, block_k)
        h = h + a
        return h + self.ffn(self.norm2(h)), k, v


class Transformer(nn.Module):
    """Dense-family decoder (``gpt2-xl-paper``, ``gemma2-9b``,
    ``gemma2-27b``, ``stablelm-12b``: per-layer sliding windows, GQA,
    attention and final logit softcaps, gated or plain MLP): token
    embedding, a stack of `Block`s, a final RMSNorm and the logits, read
    through the embedding when ``cfg.tie_embeddings``, else through a
    ``head`` of its own, (d_model, vocab) as in the JAX package.

    ``generator`` seeds a random init that follows the JAX package's
    scales (N(0, 0.02) embedding, N(0, 1/d_model) head, N(0, 1/fan_in)
    projections, zero norms), drawn leaf by leaf on the generator's
    device (a CPU generator gives the same weights on every device,
    `layers.init_normal_`); without it the weights are left
    uninitialized, for `repro_torch.weights.from_jax_params` to fill."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the port runs the dense family; the "
                f'{cfg.family} family is ROADMAP queue A, "The other '
                f'families"')
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              device=device))
        self.head = None if cfg.tie_embeddings else nn.Parameter(
            torch.empty(cfg.d_model, cfg.vocab_size, device=device))
        self.layers = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, device=device)
        if generator is not None:
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        L.init_normal_(self.embed, 0.02, generator)
        if self.head is not None:
            L.init_normal_(self.head, 1.0 / math.sqrt(self.cfg.d_model),
                           generator)
        for blk in self.layers:
            blk.attn.reset_parameters(generator)
            blk.ffn.reset_parameters(generator)

    # -- embedding / head ---------------------------------------------------

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> (B, S, d)."""
        return embed_rows(self.cfg, self.embed, tokens)

    def lm_logits(self, h: torch.Tensor) -> torch.Tensor:
        return head_logits(self.cfg, self.final_norm(h), self.embed,
                           self.head)

    # -- training forward ---------------------------------------------------

    def trunk_forward(self, h: torch.Tensor, positions: torch.Tensor, *,
                      num_stages: int = 1,
                      boundary_fn: Optional[Callable] = None,
                      boundary_state=None, remat: bool = False,
                      block_k: int = 512):
        """The layer trunk over whole sequences.  h: (B, S, d) after the
        embedding, positions ``arange(S)`` a row.  ``boundary_fn(state,
        h, idx) -> (state, h)`` runs between stage groups (idx = 0 ..
        num_stages-2).  ``remat`` checkpoints each layer, as JAX's
        ``_scan_layers`` does: its activations are recomputed in the
        backward.  The boundaries stay outside every checkpoint, since
        they draw noise from explicit generators (which a recompute
        would not restore) and write the message buffers.  ``block_k``
        is the attention backward's key block.  Returns (h,
        boundary_state)."""
        n = self.cfg.num_layers
        if n % num_stages:
            raise ValueError(f"{n} layers do not split into {num_stages} "
                             f"stage groups")
        per = n // num_stages
        seq = h.shape[1]
        for i, blk in enumerate(self.layers):
            h = run_layer(blk, h, positions, self.cfg.layer_window(i, seq),
                          remat=remat, block_k=block_k)
            if boundary_fn is not None and (i + 1) % per == 0 \
                    and i + 1 < n:
                boundary_state, h = boundary_fn(boundary_state, h,
                                                (i + 1) // per - 1)
        return h, boundary_state

    # -- caches -------------------------------------------------------------

    def init_caches(self, batch_size: int, cache_len: int,
                    dtype: torch.dtype = torch.bfloat16, device=None,
                    kv_codec=None) -> dict:
        """Zero caches for prefill/decode: raw k, v (L, B, Sc, Hk, hd),
        or, with a quantizing ``kv_codec``, its ``{k,v}_codes`` and
        ``{k,v}_scale`` stores for that shape (the layout of JAX
        `quantize_caches`; no raw store is allocated)."""
        cfg = self.cfg
        device = device if device is not None else self.embed.device
        shape = (cfg.num_layers, batch_size, cache_len, cfg.num_kv_heads,
                 cfg.head_dim)
        caches: dict = {"pos": 0}
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
                            logits_last_only: bool = False,
                            num_stages: int = 1,
                            boundary_fn: Optional[Callable] = None,
                            kv_codec=None):
        """tokens (B, S).  Returns (logits (B, S or 1, V) f32, caches),
        the caches updated in place (see the module docstring);
        ``caches["pos"]`` an int or a (B,) int32 tensor of per-row
        heads."""
        cfg = self.cfg
        pos0 = caches["pos"]
        quant = kv_codec is not None and bool(kv_codec.bits)
        h = self.embed_tokens(tokens)
        b, s = h.shape[0], h.shape[1]
        steps = torch.arange(s, dtype=torch.int32, device=h.device)
        positions = pos0[:, None] + steps \
            if isinstance(pos0, torch.Tensor) else pos0 + steps.expand(b, s)
        cache_len = caches["k_codes" if quant else "k"].shape[2]
        # per-row heads: the raw-cache writes take them clamped, once a
        # step; B3's append clamps in the kernel
        write_at = clamp_heads(pos0, cache_len, s) \
            if isinstance(pos0, torch.Tensor) else pos0
        n = cfg.num_layers
        if n % num_stages:
            raise ValueError(f"{n} layers do not split into {num_stages} "
                             f"stage groups")
        per = n // num_stages
        boundary_state = {"m": caches["hop_m"]} if "hop_m" in caches \
            else None

        for i, blk in enumerate(self.layers):
            window = cfg.layer_window(i, cache_len)
            if quant:
                ck, cv = kv_codec.decode_pair(
                    (caches["k_codes"][i], caches["v_codes"][i]),
                    (caches["k_scale"][i], caches["v_scale"][i]),
                    cfg.torch_dtype)
            else:
                ck, cv = caches["k"][i], caches["v"][i]
            h, fk, fv = blk(h, positions, window, ck, cv, write_at)
            if quant:
                # encode ONLY this step's fresh rows: old tokens keep
                # their original single encoding
                kv_codec.append_pair(
                    (caches["k_codes"][i], caches["v_codes"][i]),
                    (caches["k_scale"][i], caches["v_scale"][i]),
                    (fk, fv), pos0)
            if boundary_fn is not None and (i + 1) % per == 0 \
                    and i + 1 < n:
                boundary_state, h = boundary_fn(boundary_state, h,
                                                (i + 1) // per - 1)

        caches["pos"] = pos0 + s
        if boundary_state is not None:
            caches["hop_m"] = boundary_state["m"]
        if logits_last_only:
            h = h[:, -1:]
        return self.lm_logits(h), caches


def embed_rows(cfg: ModelConfig, embed: torch.Tensor,
               tokens: torch.Tensor) -> torch.Tensor:
    """The embedding's rows of ``tokens``, in the model's dtype.  Through
    `F.embedding`, whose backward adds a repeated token's gradients in a
    fixed order on the CPU too (an indexing's backward, ``index_put_``
    with accumulation, adds them in the threads' order there), so a
    training run is bit-reproducible, as a resumed run needs."""
    return F.embedding(tokens, embed.to(cfg.torch_dtype))


def head_logits(cfg: ModelConfig, h: torch.Tensor, embed: torch.Tensor,
                head: Optional[torch.Tensor]) -> torch.Tensor:
    """Logits of final-normed h, f32, final-softcapped (JAX ``lm_logits``
    after its norm), read through the untied ``head`` (d_model, vocab),
    or with ``head`` None through the embedding's transpose."""
    w = embed.t() if head is None else head
    return L.softcap((h @ w.to(h.dtype)).float(), cfg.final_softcap)


def run_layer(blk: Block, h: torch.Tensor, positions: torch.Tensor,
              window: int, *, remat: bool, block_k: int) -> torch.Tensor:
    """One training layer, under `torch.utils.checkpoint` with
    ``remat``.  A layer draws no random numbers, so the checkpoint
    stashes no generator state."""
    def layer(x):
        return blk(x, positions, window, block_k=block_k)[0]

    if not remat:
        return layer(h)
    return checkpoint(layer, h, use_reentrant=False,
                      preserve_rng_state=False)


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
    """batch: tokens, targets, mask (B, S) tensors.  Returns (loss,
    {"ce", "aux", "boundary_state"}); the dense family has no auxiliary
    loss.  ``remat`` and ``block_k``: `Transformer.trunk_forward`."""
    h = model.embed_tokens(batch["tokens"])
    b, s = h.shape[0], h.shape[1]
    positions = torch.arange(s, dtype=torch.int32,
                             device=h.device).expand(b, s)
    h, boundary_state = model.trunk_forward(
        h, positions, num_stages=num_stages, boundary_fn=boundary_fn,
        boundary_state=boundary_state, remat=remat, block_k=block_k)
    ce = cross_entropy(model.lm_logits(h), batch["targets"], batch["mask"])
    return ce, {"ce": ce, "aux": 0.0, "boundary_state": boundary_state}
