"""Mamba2 (SSD — state-space duality) block (port of `repro.models.ssm`).

Chunked matmul formulation for train/prefill (arXiv:2405.21060 §6):
within-chunk terms are attention-like matmuls, the inter-chunk
recurrence a Python loop over chunk states (JAX's ``lax.scan``).
Decode uses the O(1) recurrent state update.  As in the JAX package all
of it is plain tensor algebra, in f32, outside any hand-written kernel.

Shapes (g = ssm_groups = 1 throughout):
  x_in   (B, L, d_model)
  z, xh  (B, L, d_inner),  d_inner = expand * d_model
  Bc, Cc (B, L, n)         n = ssm_state
  dt     (B, L, h)         h = d_inner // headdim
  state  (B, h, p, n)      p = headdim
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


class Mamba2(nn.Module):
    """The Mamba2 mixer's parameters, under the JAX package's names and
    shapes (``x @ W`` layout): ``in_proj`` (d, 2 d_inner + 2 g n + h),
    ``conv_w`` (conv_dim, width), ``conv_b``, ``dt_bias``, ``A_log``,
    ``D``, the gated ``norm`` (d_inner) and ``out_proj`` (d_inner, d)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner
        n, h, w = cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv_width
        conv_dim = di + 2 * cfg.ssm_groups * n

        def empty(*shape):
            return nn.Parameter(torch.empty(shape, device=device))

        self.in_proj = empty(d, 2 * di + 2 * cfg.ssm_groups * n + h)
        self.conv_w = empty(conv_dim, w)
        self.conv_b = empty(conv_dim)
        self.dt_bias = empty(h)
        self.A_log = empty(h)
        self.D = empty(h)
        self.norm = L.RMSNorm(di, cfg.norm_eps, device=device)
        self.out_proj = empty(di, d)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """`repro.models.ssm.init_mamba2`'s scales: N(0, 1/d) ``in_proj``,
        N(0, 1/width^2) ``conv_w``, N(0, 1/d_inner) ``out_proj``; zero
        ``conv_b`` and norm scale, ``D`` ones, ``dt_bias`` the softplus
        inverse of linspace(1e-3, 1e-1, h), ``A_log`` log(linspace(1,
        16, h))."""
        d, w = self.in_proj.shape[0], self.conv_w.shape[1]
        h = self.A_log.shape[0]
        L.init_normal_(self.in_proj, 1.0 / math.sqrt(d), generator)
        L.init_normal_(self.conv_w, 1.0 / w, generator)
        L.init_normal_(self.out_proj, 1.0 / math.sqrt(self.out_proj.shape[0]),
                       generator)
        self.conv_b.zero_()
        lin = torch.linspace(1e-3, 1e-1, h, dtype=torch.float32)
        self.dt_bias.copy_(torch.log(torch.exp(lin) - 1.0))
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, h,
                                                  dtype=torch.float32)))
        self.D.fill_(1.0)
        self.norm.scale.zero_()


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    return torch.split(proj, [di, di + 2 * g * n, cfg.ssm_heads], dim=-1)


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, then silu.  xBC: (B, L, C); w: (C, width).
    The taps are added in JAX's order, i = 0 .. width-1, in f32."""
    width, l = w.shape[-1], xBC.shape[1]
    pads = F.pad(xBC, (0, 0, width - 1, 0))
    out = torch.zeros(xBC.shape, dtype=torch.float32, device=xBC.device)
    for i in range(width):
        out = out + pads[:, i:i + l, :].float() * w[:, i].float()
    return F.silu(out + b.float()).to(xBC.dtype)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., q) -> (..., q, q) with out[i, j] = sum_{j < m <= i} x[m]:
    the difference of two cumsums, -inf above the diagonal (JAX's
    formula, so it rounds as JAX's does)."""
    xc = torch.cumsum(x, dim=-1)
    diff = xc[..., :, None] - xc[..., None, :]
    q = x.shape[-1]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(xh, dt, A, Bc, Cc, chunk: int, initial_state=None):
    """Chunked SSD scan.

    xh (B,L,h,p) dt (B,L,h) A (h,) Bc,Cc (B,L,n).  The tail is padded to
    whole chunks at dt = 0 (a no-op step).  Returns y (B,L,h,p) and the
    final state (B,h,p,n) f32."""
    b, l, h, p = xh.shape
    n = Bc.shape[-1]
    pad = (-l) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))                      # dt=0 -> no-op
        Bc = F.pad(Bc, (0, 0, 0, pad))
        Cc = F.pad(Cc, (0, 0, 0, pad))
    c = (l + pad) // chunk
    xf, dtf = xh.float(), dt.float()
    xs = (xf * dtf[..., None]).reshape(b, c, chunk, h, p)   # input-scaled
    dA = (dtf * A.float()).reshape(b, c, chunk, h)
    Bc = Bc.float().reshape(b, c, chunk, n)
    Cc = Cc.float().reshape(b, c, chunk, n)

    dA_cs = torch.cumsum(dA, dim=2)                         # (b,c,q,h)
    # --- intra-chunk (diagonal blocks) ---
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))       # (b,c,h,q,q)
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)            # (b,c,q,q)
    M = Lmat * CB[:, :, None, :, :]
    y_diag = torch.einsum("bchij,bcjhp->bcihp", M, xs)
    # --- chunk states ---
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)   # (b,c,q,h)
    states = torch.einsum("bcin,bcih,bcihp->bchpn", Bc, decay_states, xs)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])             # (b,c,h)
    # --- the recurrence over chunks: each chunk sees the state before it
    carry = torch.zeros((b, h, p, n), dtype=torch.float32,
                        device=xh.device) if initial_state is None \
        else initial_state.float()
    incoming = []
    for ci in range(c):
        incoming.append(carry)
        carry = carry * chunk_decay[:, ci, :, None, None] + states[:, ci]
    state_in = torch.stack(incoming, dim=1)                 # (b,c,h,p,n)
    # --- inter-chunk contribution ---
    y_off = torch.einsum("bcin,bchpn,bcih->bcihp", Cc, state_in,
                         torch.exp(dA_cs))
    y = (y_diag + y_off).reshape(b, l + pad, h, p)[:, :l]
    return y.to(xh.dtype), carry


def mamba2_forward(m: Mamba2, x: torch.Tensor, cfg: ModelConfig,
                   initial_state=None):
    """The full Mamba2 mixer.  x: (B, L, d_model) -> (out, state dict).

    The state dict carries the recurrent handoff for decode: ``ssm``,
    the final SSD state, and ``conv``, the raw (pre-conv) tail window
    that feeds the causal conv."""
    b, l, _ = x.shape
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dtype = x.dtype
    proj = x @ m.in_proj.to(dtype)
    z, xBC_raw, dt_raw = _split_proj(cfg, proj)
    conv_tail = xBC_raw[:, -(cfg.ssm_conv_width - 1):, :]
    xBC = _causal_conv(xBC_raw, m.conv_w, m.conv_b)
    xh, Bc, Cc = torch.split(xBC, [di, n, xBC.shape[-1] - di - n], dim=-1)
    xh = xh.reshape(b, l, h, cfg.ssm_headdim)
    dt = F.softplus(dt_raw.float() + m.dt_bias.float())
    A = -torch.exp(m.A_log.float())
    y, final_state = ssd_chunked(xh, dt, A, Bc, Cc, cfg.ssm_chunk,
                                 initial_state)
    y = y + xh.float() * m.D.float()[:, None]
    y = y.reshape(b, l, di).to(dtype)
    y = m.norm(y * F.silu(z))
    return y @ m.out_proj.to(dtype), {"ssm": final_state, "conv": conv_tail}


def mamba2_decode_step(m: Mamba2, x: torch.Tensor, cfg: ModelConfig,
                       ssm_state: torch.Tensor, conv_state: torch.Tensor):
    """The single-token recurrent update.  x: (B, 1, d_model); ssm_state
    (B, h, p, n); conv_state (B, width-1, conv_dim).  Returns (out (B,
    1, d_model), new ssm state in ssm_state's dtype, new conv state)."""
    b = x.shape[0]
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dtype = x.dtype
    proj = x[:, 0] @ m.in_proj.to(dtype)
    z, xBC, dt_raw = _split_proj(cfg, proj)
    # the conv over the stored window
    window = torch.cat([conv_state, xBC[:, None, :].to(conv_state.dtype)],
                       dim=1)
    conv_out = torch.sum(window.float() * m.conv_w.float().t()[None], dim=1)
    xBC = F.silu(conv_out + m.conv_b.float()).to(dtype)
    new_conv_state = window[:, 1:]
    xh, Bc, Cc = torch.split(xBC, [di, n, xBC.shape[-1] - di - n], dim=-1)
    xh = xh.reshape(b, h, cfg.ssm_headdim).float()
    dt = F.softplus(dt_raw.float() + m.dt_bias.float())      # (B, h)
    A = -torch.exp(m.A_log.float())
    dA = torch.exp(dt * A)                                   # (B, h)
    Bf, Cf = Bc.float(), Cc.float()
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, xh, Bf)
    new_state = ssm_state.float() * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cf)
    y = y + xh * m.D.float()[:, None]
    y = y.reshape(b, di).to(dtype)
    y = m.norm(y * F.silu(z))
    out = (y @ m.out_proj.to(dtype))[:, None, :]
    return out, new_state.to(ssm_state.dtype), new_conv_state
