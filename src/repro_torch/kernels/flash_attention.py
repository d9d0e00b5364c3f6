"""Wrapper of the CUDA flash-attention forward kernel
(``csrc/flash_attention.cu``), the port of the Pallas
``flash_attention_fwd``.

`flash_attention_fwd` takes head-major tensors, q ``(B, H, Sq, hd)``
and k, v ``(B, Hk, Sk, hd)`` with ``H % Hk == 0`` (GQA: query head h
reads kv head ``h // (H // Hk)``, never a repeated copy), query row i
at position ``q_offset + i`` and key j at position j.  A non-causal
call whose window covers every key (the whisper encoder's
self-attention, a cross attention over its 1500 frames) may have more
query rows than keys; any other call keeps its rows' positions among
the keys.  Any strides are taken as long as the last dim is
contiguous: the kernel reads views
(a serving prefill's transposed ``(B, S, H, hd)`` queries and cache) in
place, and the output has q's memory layout.  A tensor on the
CPU goes to the plain version `repro_torch.kernels.ref.flash_attention_ref`;
a CUDA tensor goes to the kernel, launched on the current stream, or
the wrapper raises; nothing falls back.  With ``return_lse`` the
kernel also writes each row's log-sum-exp, ``(B, H, Sq)`` f32, which
the training attention saves for its backward
(`repro_torch.models.layers.flash_attention`); without it the launch
writes no such row.  Launches are counted in
`repro_torch.kernels.quant_pack.LAUNCHES` under ``flash_attention_fwd``
(the CPU path does not count).

The kernel is compiled for head dims `HEAD_DIMS`.  A head dim of
`PADDED_HEAD_DIMS` (zamba2's 80) is a kernel path too: the wrapper
zero-pads q, k and v to the next instance (96 columns), launches it
with the scale of the true head dim, ``1/sqrt(80)``, and returns the
first 80 columns of its output (a view).  The zero columns add nothing
to ``q k^T``, so the scores, the lse and the first 80 output columns are
those of the unpadded call; the pads are three copies beside the one
launch.  Any other head dim raises on CUDA.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels import quant_pack as _qp
from repro_torch.kernels import ref

HEAD_DIMS = (32, 64, 96, 128, 160, 256)
# head dims the wrapper zero-pads to a compiled instance
PADDED_HEAD_DIMS = {80: 96}
DTYPES = (torch.float32, torch.bfloat16)
BIG_WINDOW = 10 ** 9
_INT_MAX = 2 ** 31 - 1


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: int, q_offset: int) -> None:
    """Raise on what neither version takes: every query row must see at
    least one key (`ref.check_rows_see_keys`: ``q_offset + Sq <= Sk``
    and ``window >= 1``, or, where every row sees every key, any
    ``q_offset + Sq``)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, H, Sq, hd) and k, v (B, Hk, Sk, "
                         f"hd), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, sq, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head_dim")
    if h % k.shape[1]:
        raise ValueError(f"{h} query heads do not share {k.shape[1]} kv "
                         f"heads evenly")
    ref.check_rows_see_keys(sq, k.shape[2], causal=causal, window=window,
                            q_offset=q_offset)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = BIG_WINDOW,
                        softcap: float = 0.0, q_offset: int = 0,
                        return_lse: bool = False):
    """Attention forward: softmax over the visible keys of
    ``softcap(q k^T / sqrt(hd))``, times v.  Returns ``(B, H, Sq, hd)``
    in q's dtype, or with ``return_lse`` the pair (that, the rows'
    log-sum-exp ``m + log(max(l, 1e-30))`` as (B, H, Sq) f32)."""
    window, q_offset = int(window), int(q_offset)
    _check_shapes(q, k, v, causal=bool(causal), window=window,
                  q_offset=q_offset)
    if not _qp._on_cuda(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, q_offset=q_offset,
                                       return_lse=return_lse)
    b, h, sq, hd = q.shape
    hk, sk = k.shape[1], k.shape[2]
    width = PADDED_HEAD_DIMS.get(hd, hd)
    if width not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head_dim {HEAD_DIMS} (and "
                         f"{tuple(PADDED_HEAD_DIMS)} zero-padded), got {hd}")
    if q.dtype not in DTYPES:
        raise TypeError(f"the kernel takes {DTYPES}, got {q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: expected {q.dtype}, got {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: its last dim must be contiguous")
    if max(h, b) > 65535:
        raise ValueError(f"batch {b} or heads {h} past the kernel's grid "
                         f"(65535)")
    if width != hd:
        q, k, v = (pad_head_dim(t, width) for t in (q, k, v))
    out = torch.empty_like(q)             # q's layout, if q's is dense
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if q.numel():
        lib = build.load("flash_attention")
        strides = (ctypes.c_longlong * 12)(
            *(t.stride(i) for t in (q, k, v, out) for i in range(3)))
        rc = lib.rt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            strides, b, h, hk, sq, sk, width, q_offset, int(bool(causal)),
            min(window, _INT_MAX), 1.0 / math.sqrt(hd), float(softcap),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"rt_flash_attention_fwd failed to launch: "
                               f"CUDA error {rc}")
        _qp.LAUNCHES["flash_attention_fwd"] += 1
    out = out[..., :hd]
    return (out, lse) if return_lse else out


def pad_head_dim(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` (..., hd) zero-padded to (..., width): a new dense tensor."""
    return F.pad(t, (0, width - t.shape[-1]))
