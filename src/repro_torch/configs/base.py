"""Architecture config schema + registry (port of `repro.configs.base`).

Each arch the port runs has one ``configs/<id>.py`` with the full-scale
``CONFIG`` and a reduced ``SMOKE`` variant (a few layers, d_model<=512)
for the CPU tests.  The registry lists every arch of the JAX package:
the dense, moe, ssm, hybrid, audio (an encoder and cross attention) and
vlm (a patch prefix) families.
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

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0               # routed-expert hidden size
    first_dense_layers: int = 0     # deepseek-moe: leading dense FFN layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM (Mamba2 / SSD) ---------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_groups: int = 1

    # --- hybrid (zamba2) --------------------------------------------------
    shared_attn_every: int = 0      # shared-weight attention block cadence

    # --- encoder/decoder (whisper) ---------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0            # precomputed frame embeddings (stub)
    cross_attention: bool = False

    # --- multimodal stub (pixtral) ----------------------------------------
    num_patches: int = 0            # leading positions fed by patch embeds

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

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def n_trunk(self) -> int:
        """Layers of the stacked trunk: all of them but a MoE model's
        leading dense ``prefix`` (JAX ``init_params``' ``n_scan``)."""
        return self.num_layers - self.first_dense_layers

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def n_blocks(self) -> int:
        """Hybrid: blocks of ``shared_attn_every`` mamba layers, each
        followed by the shared block."""
        return self.num_layers // self.shared_attn_every

    def layer_is_local(self, i: int) -> bool:
        """Sliding-window (local) attention at layer i?"""
        if self.sliding_window == 0:
            return False
        if self.local_global_period:
            return i % self.local_global_period == 0
        return True

    def layer_window(self, i: int, seq_len: int) -> int:
        return self.sliding_window if self.layer_is_local(i) else seq_len

    def layer_is_mamba(self, i: int) -> bool:
        return self.family in ("ssm", "hybrid")

    def layer_has_shared_attn(self, i: int) -> bool:
        if not self.shared_attn_every:
            return False
        return i % self.shared_attn_every == self.shared_attn_every - 1

    def layer_is_moe(self, i: int) -> bool:
        return self.has_moe and i >= self.first_dense_layers

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def params_count(self) -> int:
        """The JAX package's analytic parameter count (its 6ND model
        FLOPs).  Like JAX's, it counts
        two norms a layer in every family, so a mamba layer, which has
        one, is over-counted by d_model."""
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d                      # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d
        per_attn = (self.num_heads * self.head_dim * d       # wq
                    + 2 * self.num_kv_heads * self.head_dim * d  # wk, wv
                    + self.num_heads * self.head_dim * d)    # wo
        per_dense_ffn = (3 if self.mlp_gated else 2) * d * self.d_ff
        for i in range(L):
            if self.layer_is_mamba(i):
                di, hs = self.d_inner, self.ssm_heads
                conv_dim = di + 2 * self.ssm_groups * self.ssm_state
                n += d * (2 * di + 2 * self.ssm_groups * self.ssm_state + hs)
                n += conv_dim * self.ssm_conv_width
                n += 2 * hs + di                    # A_log, D, gated-norm
                n += di * d                          # out_proj
            else:
                n += per_attn                        # ssm/hybrid: no FFN
                if self.layer_is_moe(i):
                    n += 3 * d * self.moe_d_ff * self.n_experts
                    n += 3 * d * self.moe_d_ff * self.n_shared_experts
                    n += d * self.n_experts          # router
                else:
                    n += per_dense_ffn
            n += 2 * d                               # 2 norms
        if self.shared_attn_every:                   # zamba2 shared block
            n += per_attn + per_dense_ffn + 2 * d
        if self.encoder_layers:                      # whisper encoder
            n += self.encoder_layers * (per_attn + per_dense_ffn + 2 * d)
            n += L * (per_attn + d)                  # decoder cross-attn
        n += d                                       # final norm
        return n

    def active_params_count(self) -> int:
        """Active params per token (MoE: top_k + shared only)."""
        if not self.has_moe:
            return self.params_count()
        inactive = 3 * self.d_model * self.moe_d_ff * \
            (self.n_experts - self.top_k) * self.n_trunk
        return self.params_count() - inactive


# ---------------------------------------------------------------------------
# Registry: every arch of the JAX package
# ---------------------------------------------------------------------------
ARCHS = ("gpt2-xl-paper", "gemma2-9b", "stablelm-12b", "gemma2-27b",
         "mamba2-1.3b", "zamba2-2.7b", "mixtral-8x22b", "deepseek-moe-16b",
         "moonshot-v1-16b-a3b", "whisper-small", "pixtral-12b")


def _module_name(arch: str) -> str:
    return "repro_torch.configs." + arch.replace("-", "_").replace(".", "_")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"arch {arch!r} is not ported; the port runs "
                       f"{ARCHS}")
    mod = importlib.import_module(_module_name(arch))
    return mod.SMOKE if smoke else mod.CONFIG
