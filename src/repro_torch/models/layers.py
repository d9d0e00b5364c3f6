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
* the cache-free training forward: `flash_attention`, the counterpart
  of the JAX-level ``custom_vjp`` (`repro.models.layers.flash_attention`)
  and as lean in memory: a `torch.autograd.Function` whose forward is
  the same kernel (on CPU tensors its plain version) asked for the
  rows' log-sum-exp, and which saves only q, k, v, o and that lse; its
  backward is JAX's ``_bwd`` in PyTorch, a loop over blocks of
  ``block_k`` keys that recomputes ``p = exp(s - lse)`` block by block.
  No ``(B, H, S, S)`` tensor is built, and the kv heads are never
  repeated: the kernel reads them in place, and the backward sums dk
  and dv over each group of query heads.

The whisper model adds two non-causal calls, with a window of
`BIG_WINDOW` that lets every row see every key: its encoder's
self-attention (``causal=False`` in `Attention.forward`) and each
decoder layer's cross attention over the encoder's output
(`Attention.cross`, JAX ``attention(cross_kv=)``: q without RoPE, the
keys of another length, the training attention's kernel in a prefill,
`onehot_attention` in a decode step).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.cache_rows import write_rows_
from repro_torch.kernels import ops

NEG_INF = -1.0e9
BIG_WINDOW = 10 ** 9


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


def _flash_bwd(q, k, v, o, lse, g, *, window: int, cap: float,
               block_k: int, causal: bool = True):
    """JAX's ``_bwd`` (`repro.models.layers`, ``_make_flash``) line for
    line, with GQA: q, o, g (B, Sq, H, hd); k, v (B, Sk, Hk, hd); lse (B,
    H, Sq) f32; query row i and key j at positions i and j, key j
    visible iff j > i - window and, if ``causal``, j <= i.  Keys go in
    blocks of ``block_k``, Sk padded up to a multiple of it (the padded
    keys hidden, as JAX's at position -1e9).  The G = H / Hk query
    heads of a kv head are the rows of one matrix product, so dk and dv
    come out summed over the group.
    Returns (dq, dk, dv) in the inputs' dtypes."""
    b, sq, h, hd = q.shape
    sk, hk = k.shape[1], k.shape[2]
    grp = h // hk
    scale = 1.0 / math.sqrt(hd)

    def rows(x):                    # (B, S, H, hd) -> (B, Hk, G * S, hd)
        return x.float().transpose(1, 2).reshape(b, hk, grp * sq, hd)

    qf, gf, of = rows(q), rows(g), rows(o)
    delta = torch.sum(gf * of, dim=-1).reshape(b, hk, grp, sq, 1)
    lse = lse.reshape(b, hk, grp, sq, 1)
    nblk = -(-sk // block_k)
    pad = nblk * block_k - sk
    kf = F.pad(k.float().transpose(1, 2), (0, 0, 0, pad))  # (B,Hk,Skp,hd)
    vf = F.pad(v.float().transpose(1, 2), (0, 0, 0, pad))
    qpos = torch.arange(sq, device=q.device)[:, None]
    dq = torch.zeros_like(qf)
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    for j in range(nblk):
        sl = slice(j * block_k, (j + 1) * block_k)
        kb, vb = kf[:, :, sl], vf[:, :, sl]
        kp = torch.arange(sl.start, sl.stop, device=q.device)[None, :]
        vis = (kp > qpos - window) & (kp < sk)                # (Sq, bk)
        if causal:
            vis &= kp <= qpos
        u = (torch.matmul(qf, kb.transpose(-1, -2)) * scale).reshape(
            b, hk, grp, sq, block_k)
        if cap > 0.0:
            s = cap * torch.tanh(u / cap)
            dsdu = 1.0 - torch.square(s / cap)
        else:
            s, dsdu = u, 1.0
        s = torch.where(vis, s, NEG_INF)
        p = torch.exp(s - lse)                             # (B,Hk,G,Sq,bk)
        pr = p.reshape(b, hk, grp * sq, block_k)
        dv[:, :, sl] = torch.matmul(pr.transpose(-1, -2), gf)
        dp = torch.matmul(gf, vb.transpose(-1, -2)).reshape(p.shape)
        ds = p * (dp - delta) * dsdu
        ds = torch.where(vis, ds, 0.0).reshape(pr.shape)
        dq = dq + torch.matmul(ds, kb) * scale
        dk[:, :, sl] = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dq = dq.reshape(b, h, sq, hd).transpose(1, 2)
    return (dq.to(q.dtype), dk[:, :, :sk].transpose(1, 2).to(k.dtype),
            dv[:, :, :sk].transpose(1, 2).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """The training attention: the kernel's forward with the rows'
    log-sum-exp, JAX's ``_bwd`` as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, window, cap, block_k, causal):
        o, lse = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, softcap=cap, return_lse=True)
        o = o.transpose(1, 2)                    # (B, S, H, hd), q's layout
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (window, cap, block_k, causal)
        return o

    @staticmethod
    def backward(ctx, g):
        window, cap, block_k, causal = ctx.args
        dq, dk, dv = _flash_bwd(*ctx.saved_tensors, g, window=window,
                                cap=cap, block_k=block_k, causal=causal)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, window: int, attn_softcap: float = 0.0,
                    block_k: int = 512, causal: bool = True):
    """Training attention over a call's keys, differentiable.  q: (B, Sq,
    H, hd); k, v: (B, Sk, Hk, hd) with H % Hk == 0 (GQA, read
    unrepeated).  Query row i and key j sit at positions i and j: both
    trainers' positions are ``arange(S)``, so the kernel runs at
    ``q_offset = 0``.  Causal calls have Sq = Sk; a non-causal one
    (``causal=False``) with a window covering every key (`BIG_WINDOW`:
    the whisper encoder's self-attention, and cross attention, whose
    keys are the encoder's frames) lets every row see every key and
    takes any Sk.  The forward keeps no score tensor; ``block_k`` is the
    backward's key block (JAX's default, 512)."""
    return _FlashAttention.apply(q, k, v, int(window), float(attn_softcap),
                                 int(block_k), bool(causal))


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
                cache_index=0, block_k=512, causal=True):
        """x: (B, S, d).  k_cache, v_cache: (B, Sc, Hk, hd), written in
        place at ``cache_index`` with this step's fresh rows; attention
        runs over the whole cache (rows past the write head are masked
        by the causal check).  ``cache_index`` is an int, or for a
        decode step (S = 1) a (B,) int64 tensor, a head a row (the
        continuous batcher's pool), already clamped to [0, Sc - 1]
        (`repro_torch.core.cache_rows.clamp_heads`): each write is one
        scatter launch.  Without caches (training) attention runs over
        this call's own keys at positions ``arange(S)``
        (`flash_attention`, whose backward takes key blocks of
        ``block_k``); ``causal=False`` there, with a window of
        `BIG_WINDOW`, is the whisper encoder's self-attention (JAX
        ``encode_audio``: RoPE still at ``arange(S)``).  The attention
        path follows from the call (see the module docstring), never
        from a caught error.  Returns (out, fresh_k, fresh_v)."""
        b, s, _ = x.shape
        dtype = x.dtype
        hk, hd = self.num_kv_heads, self.head_dim
        q = (x @ self.wq.to(dtype)).reshape(b, s, self.num_heads, hd)
        k = (x @ self.wk.to(dtype)).reshape(b, s, hk, hd)
        v = (x @ self.wv.to(dtype)).reshape(b, s, hk, hd)
        q = rope(q, positions, self.rope_theta)
        k = rope(k, positions, self.rope_theta)
        if k_cache is None:
            out = flash_attention(q, k, v, window=window,
                                  attn_softcap=self.attn_softcap,
                                  block_k=block_k, causal=causal)
        else:
            if isinstance(cache_index, torch.Tensor) and s != 1:
                raise ValueError(f"per-row write heads take one token a "
                                 f"row (a decode step), got S={s}")
            write_rows_(k_cache, k, cache_index)
            write_rows_(v_cache, v, cache_index)
            if s == 1:
                sc = k_cache.shape[1]
                k_pos = torch.arange(sc, dtype=torch.int32,
                                     device=x.device).expand(b, sc)
                out = onehot_attention(q, k_cache, v_cache, q_pos=positions,
                                       k_pos=k_pos, window=window,
                                       attn_softcap=self.attn_softcap)
            else:
                # prefill: the kernel over head-major views of q and the
                # cache, read in place; a raw store of another dtype (the
                # batcher's bf16 rows) is read in q's, as JAX's attention
                # promotes it; its output is (B, S, H, hd) memory
                kc, vc = (c.transpose(1, 2).to(q.dtype)
                          for c in (k_cache, v_cache))
                out = ops.flash_attention(
                    q.transpose(1, 2), kc, vc, causal=True, window=window,
                    softcap=self.attn_softcap, q_offset=cache_index
                ).transpose(1, 2)
        out = out.reshape(b, s, self.num_heads * hd) @ self.wo.to(dtype)
        return out, k, v

    def cross_kv(self, enc: torch.Tensor):
        """This layer's cross keys and values of the encoder's output
        ``enc`` (B, Se, d): (B, Se, Hk, hd) each, no RoPE (JAX
        ``_cross_kv_all``, the pipeline's ``_apply_layer``)."""
        b, se, _ = enc.shape
        hk, hd = self.num_kv_heads, self.head_dim
        return tuple((enc @ w.to(enc.dtype)).reshape(b, se, hk, hd)
                     for w in (self.wk, self.wv))

    def cross(self, x, positions, xk, xv, *, block_k: int = 512):
        """Cross attention of x (B, S, d) over the encoder's keys and
        values ``xk``, ``xv`` (B, Se, Hk, hd), as JAX ``attention`` with
        ``cross_kv``: q without RoPE, no causal mask, window
        `BIG_WINDOW` (every row sees every frame, the keys at position
        0), the kv heads never repeated, read in q's dtype (as JAX's
        attention promotes a cache of another).  A decode step (S = 1)
        runs `onehot_attention` over them, a longer call the kernel
        through the training attention (`flash_attention`)."""
        b, s, _ = x.shape
        dtype = x.dtype
        q = (x @ self.wq.to(dtype)).reshape(b, s, self.num_heads,
                                             self.head_dim)
        if s == 1:
            se = xk.shape[1]
            out = onehot_attention(
                q, xk, xv, q_pos=positions,
                k_pos=torch.zeros((b, se), dtype=torch.int32,
                                  device=x.device),
                window=BIG_WINDOW, causal=False)
        else:
            out = flash_attention(q, xk.to(dtype), xv.to(dtype),
                                  window=BIG_WINDOW, block_k=block_k,
                                  causal=False)
        return out.reshape(b, s, -1) @ self.wo.to(dtype)


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
