"""Architecture config schema + registry (port of `repro.configs.base`).

Each arch the port runs has one ``configs/<id>.py`` with the full-scale
``CONFIG`` and a reduced ``SMOKE`` variant (<=2 layers, d_model<=512)
for the CPU tests.  The registry lists only the archs whose families
the port implements; any other name raises.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    source: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # --- attention details -------------------------------------------------
    rope_theta: float = 10_000.0
    sliding_window: int = 0         # 0 = no local attention anywhere
    local_global_period: int = 0    # 2 -> alternate local/global
    attn_softcap: float = 0.0
    final_softcap: float = 0.0

    # --- misc --------------------------------------------------------------
    act: str = "silu"               # silu (SwiGLU) | gelu
    mlp_gated: bool = True          # gated (3-matrix) FFN vs plain 2-matrix
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "float32"          # runtime compute dtype

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def layer_is_local(self, i: int) -> bool:
        """Sliding-window (local) attention at layer i?"""
        if self.sliding_window == 0:
            return False
        if self.local_global_period:
            return i % self.local_global_period == 0
        return True

    def layer_window(self, i: int, seq_len: int) -> int:
        return self.sliding_window if self.layer_is_local(i) else seq_len

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry: only the archs the port runs
# ---------------------------------------------------------------------------
ARCHS = ("gpt2-xl-paper", "gemma2-9b", "stablelm-12b", "gemma2-27b")


def _module_name(arch: str) -> str:
    return "repro_torch.configs." + arch.replace("-", "_").replace(".", "_")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"arch {arch!r} is not ported; the port runs "
                       f"{ARCHS}")
    mod = importlib.import_module(_module_name(arch))
    return mod.SMOKE if smoke else mod.CONFIG
