"""Transformer building blocks (port of `repro.models.layers`).

Weights keep the JAX package's layout — ``x @ W`` with ``W`` of shape
``(in, out)`` — so parameters move between the packages unchanged
(`repro_torch.weights`).  Activations are ``(B, S, ...)`` as there.

Attention has three paths, chosen by which step runs:

* serving prefill (a KV cache and S > 1): the flash-attention kernel
  (`repro_torch.kernels.ops.flash_attention`, the port of the Pallas
  ``flash_attention_fwd``) over the whole cache, query rows at
  ``cache_index + i``, the kv heads read in place (GQA, no repeat);
  on CPU tensors its plain version;
* decode (S = 1): `onehot_attention`, single-shot scores, as in JAX;
* the cache-free training forward: `flash_attention`, plain masked
  softmax with autograd, the counterpart of the JAX-level
  ``custom_vjp`` scan (`repro.models.layers.flash_attention`), which
  has no kernel in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.cache_rows import write_rows_
from repro_torch.kernels import ops

NEG_INF = -1.0e9


@torch.no_grad()
def init_normal_(w: torch.Tensor, std: float,
                 generator: torch.Generator) -> None:
    """Fill ``w`` with N(0, std**2) drawn on ``generator``'s device: a
    CPU generator draws the leaf on the CPU and copies it to ``w``'s
    device, so the weights do not depend on where they live, and only
    one leaf is on the host at a time."""
    if w.device == generator.device:
        w.normal_(0.0, std, generator=generator)
    else:
        w.copy_(torch.empty(w.shape, dtype=w.dtype,
                            device=generator.device).normal_(
            0.0, std, generator=generator))


# ---------------------------------------------------------------------------
# Norms, RoPE, softcap
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """RMSNorm in the ``1 + scale`` form (scale starts at zero)."""

    def __init__(self, d: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.zeros(d, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self.scale, x, self.eps)


def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embeddings.  x: (B, S, H, hd); positions: (B, S)."""
    half = x.shape[-1] // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq                  # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Attention over a KV cache
# ---------------------------------------------------------------------------

def _visible(q_pos, k_pos, window, causal: bool) -> torch.Tensor:
    """(B, Sq, Sk) mask: key j visible to query i iff j <= i (causal)
    and j > i - window."""
    qp = q_pos[:, :, None]
    kp = k_pos[:, None, :]
    vis = kp > qp - window
    if causal:
        vis &= kp <= qp
    return vis


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hk, hd) -> (B, S, Hk*groups, hd)."""
    if groups == 1:
        return k
    b, s, hk, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, hk, groups, hd).reshape(
        b, s, hk * groups, hd)


def flash_attention(q, k, v, *, q_pos, k_pos, window, causal=True,
                    attn_softcap=0.0):
    """Training attention over a call's own keys.  q: (B, Sq, H, hd);
    k, v: (B, Sk, H, hd) (kv already head-repeated).  Plain
    masked-softmax attention, differentiable by autograd."""
    hd = q.shape[-1]
    qf = (q * (1.0 / math.sqrt(hd))).float().transpose(1, 2)  # (B,H,Sq,hd)
    s = torch.matmul(qf, k.float().permute(0, 2, 3, 1))       # (B,H,Sq,Sk)
    s = softcap(s, attn_softcap)
    vis = _visible(q_pos, k_pos, window, causal)[:, None]
    p = torch.softmax(torch.where(vis, s, NEG_INF), dim=-1)
    out = torch.matmul(p, v.float().transpose(1, 2))           # (B,H,Sq,hd)
    return out.transpose(1, 2).to(q.dtype)


def onehot_attention(q, k, v, *, q_pos, k_pos, window, causal=True,
                     attn_softcap=0.0):
    """Single-shot attention for decode (Sq small).  GQA-aware: k/v may
    have fewer heads than q (H = Hk * G), used in place, never repeated
    in memory."""
    b, sq, h, hd = q.shape
    hk = k.shape[2]
    g = h // hk
    qg = (q * (1.0 / math.sqrt(hd))).float().reshape(b, sq, hk, g, hd)
    # (B, Hk, G, Sq, hd) @ (B, Hk, 1, hd, Sk) -> (B, Hk, G, Sq, Sk)
    s = torch.matmul(qg.permute(0, 2, 3, 1, 4),
                     k.float().permute(0, 2, 3, 1)[:, :, None])
    s = softcap(s, attn_softcap)
    vis = _visible(q_pos, k_pos, window, causal)[:, None, None]
    p = torch.softmax(torch.where(vis, s, NEG_INF), dim=-1)
    out = torch.matmul(p, v.float().transpose(1, 2)[:, :, None])
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


class Attention(nn.Module):
    """Attention sublayer with RoPE and a KV cache the fresh rows are
    scattered into."""

    def __init__(self, d_model: int, num_heads: int, num_kv_heads: int,
                 head_dim: int, rope_theta: float, attn_softcap: float = 0.0,
                 device=None):
        super().__init__()
        self.num_heads, self.num_kv_heads = num_heads, num_kv_heads
        self.head_dim, self.rope_theta = head_dim, rope_theta
        self.attn_softcap = attn_softcap
        qd, kd = num_heads * head_dim, num_kv_heads * head_dim
        self.wq = nn.Parameter(torch.empty(d_model, qd, device=device))
        self.wk = nn.Parameter(torch.empty(d_model, kd, device=device))
        self.wv = nn.Parameter(torch.empty(d_model, kd, device=device))
        self.wo = nn.Parameter(torch.empty(qd, d_model, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """N(0, 1/fan_in) init, as `repro.models.layers.init_attention`."""
        s = 1.0 / math.sqrt(self.wq.shape[0])
        for w in (self.wq, self.wk, self.wv):
            init_normal_(w, s, generator)
        init_normal_(self.wo, 1.0 / math.sqrt(self.wo.shape[0]), generator)

    def forward(self, x, positions, window, k_cache=None, v_cache=None,
                cache_index=0):
        """x: (B, S, d).  k_cache, v_cache: (B, Sc, Hk, hd), written in
        place at ``cache_index`` with this step's fresh rows; attention
        runs over the whole cache (rows past the write head are masked
        by the causal check).  ``cache_index`` is an int, or for a
        decode step (S = 1) a (B,) int64 tensor, a head a row (the
        continuous batcher's pool), already clamped to [0, Sc - 1]
        (`repro_torch.core.cache_rows.clamp_heads`): each write is one
        scatter launch.  Without caches
        (training) attention runs over this call's own keys.  The
        attention path follows from the call (see the module
        docstring), never from a caught error.  Returns (out, fresh_k,
        fresh_v)."""
        b, s, _ = x.shape
        dtype = x.dtype
        hk, hd = self.num_kv_heads, self.head_dim
        q = (x @ self.wq.to(dtype)).reshape(b, s, self.num_heads, hd)
        k = (x @ self.wk.to(dtype)).reshape(b, s, hk, hd)
        v = (x @ self.wv.to(dtype)).reshape(b, s, hk, hd)
        q = rope(q, positions, self.rope_theta)
        k = rope(k, positions, self.rope_theta)
        cached = k_cache is not None
        if not cached:
            k_cache, v_cache, k_pos = k, v, positions
        else:
            if isinstance(cache_index, torch.Tensor) and s != 1:
                raise ValueError(f"per-row write heads take one token a "
                                 f"row (a decode step), got S={s}")
            write_rows_(k_cache, k, cache_index)
            write_rows_(v_cache, v, cache_index)
            sc = k_cache.shape[1]
            k_pos = torch.arange(sc, dtype=torch.int32,
                                 device=x.device).expand(b, sc)
        kw = dict(q_pos=positions, k_pos=k_pos, window=window,
                  attn_softcap=self.attn_softcap)
        if s == 1:
            out = onehot_attention(q, k_cache, v_cache, **kw)
        elif cached:
            # prefill: the kernel over head-major views of q and the
            # cache, read in place; its output is (B, S, H, hd) memory
            out = ops.flash_attention(
                q.transpose(1, 2), k_cache.transpose(1, 2),
                v_cache.transpose(1, 2), causal=True, window=window,
                softcap=self.attn_softcap, q_offset=cache_index
            ).transpose(1, 2)
        else:
            groups = self.num_heads // hk
            out = flash_attention(q, _repeat_kv(k_cache, groups),
                                  _repeat_kv(v_cache, groups), **kw)
        out = out.reshape(b, s, self.num_heads * hd) @ self.wo.to(dtype)
        return out, k, v


# ---------------------------------------------------------------------------
# MLP (gated SwiGLU/GeGLU or plain)
# ---------------------------------------------------------------------------

def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu if name == "silu" else \
        (lambda x: F.gelu(x, approximate="tanh"))


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, act: str = "silu",
                 gated: bool = True, device=None):
        super().__init__()
        self.act = act
        self.w_up = nn.Parameter(torch.empty(d_model, d_ff, device=device))
        self.w_down = nn.Parameter(torch.empty(d_ff, d_model, device=device))
        self.w_gate = nn.Parameter(torch.empty(d_model, d_ff, device=device)) \
            if gated else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """N(0, 1/fan_in) init, as `repro.models.layers.init_mlp`."""
        s_in = 1.0 / math.sqrt(self.w_up.shape[0])
        for w in (self.w_gate, self.w_up):
            if w is not None:
                init_normal_(w, s_in, generator)
        init_normal_(self.w_down, 1.0 / math.sqrt(self.w_down.shape[0]),
                     generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        fn = _act(self.act)
        up = x @ self.w_up.to(dtype)
        if self.w_gate is not None:
            up = fn(x @ self.w_gate.to(dtype)) * up
        else:
            up = fn(up)
        return up @ self.w_down.to(dtype)
