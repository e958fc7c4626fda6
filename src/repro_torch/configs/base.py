"""Model configuration schema and registry (own copy of the reference's
``repro/configs/base.py``).

One ``<arch>.py`` per architecture the port serves defines ``CONFIG`` with
the exact published hyperparameters; ``get_config(name)`` loads it.
Reduced ("smoke") variants for CPU tests come from
:func:`ModelConfig.reduced`.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | rwkv | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None    # default d_model // n_heads
    # --- attention ---------------------------------------------------------
    rope_theta: float = 1e4
    window: Optional[int] = None            # sliding-window size
    local_global_alternating: bool = False  # gemma2: odd layers global
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    mrope_sections: Optional[tuple] = None  # qwen2-vl M-RoPE (t, h, w)
    post_norm: bool = False                 # gemma2 post-block RMSNorm
    # --- MLP ----------------------------------------------------------------
    mlp_gated: bool = True
    act: str = "silu"               # silu | gelu | relu2
    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: Optional[int] = None  # expert hidden dim (defaults to d_ff)
    n_shared_experts: int = 0       # DeepSeek-style always-on experts
    first_k_dense: int = 0          # leading dense layers in an MoE stack
    moe_capacity: float = 1.25      # capacity factor vs balanced routing
    # --- SSM (mamba2 / zamba2) ----------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    shared_attn_every: int = 0      # zamba2: shared attn block period
    # --- rwkv ----------------------------------------------------------------
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    # --- enc-dec --------------------------------------------------------------
    n_enc_layers: int = 0
    # --- frontend -------------------------------------------------------------
    input_mode: str = "tokens"      # tokens | embeddings (stub frontends)
    # --- misc ------------------------------------------------------------------
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    source: str = ""                # provenance note

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff else self.d_ff

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def reduced(self, *, n_layers=2, d_model=64, n_heads=4, n_kv_heads=None,
                d_ff=128, vocab=512, num_experts=None, ssm_state=16,
                **kw) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        changes = dict(
            name=self.name + "-smoke",
            n_layers=n_layers, d_model=d_model, n_heads=n_heads,
            n_kv_heads=n_kv_heads if n_kv_heads is not None
            else max(1, min(self.n_kv_heads, n_heads // 2)),
            d_ff=d_ff, vocab=vocab, d_head=None,
        )
        if self.is_moe:
            changes["num_experts"] = (num_experts if num_experts
                                      else min(self.num_experts, 8))
            changes["top_k"] = min(self.top_k, 2)
            changes["moe_d_ff"] = d_ff
            changes["first_k_dense"] = min(self.first_k_dense, 1)
            changes["moe_capacity"] = 8.0   # no capacity drops at smoke N
        if self.family == "hybrid":
            changes["ssm_state"] = ssm_state
            changes["ssm_head_dim"] = 16
            changes["shared_attn_every"] = 2
            changes["n_layers"] = max(n_layers, 4)
        if self.family == "rwkv":
            changes["rwkv_head_dim"] = 16
            changes["rwkv_decay_lora"] = 8
        if self.family == "encdec":
            changes["n_enc_layers"] = n_layers
        if self.window:
            changes["window"] = 32
        if self.mrope_sections:
            # sections sum to head_dim // 2
            hd = d_model // n_heads
            changes["mrope_sections"] = (hd // 2 - 2 * (hd // 8),
                                         hd // 8, hd // 8)
        changes.update(kw)
        return dataclasses.replace(self, **changes)


ARCH_IDS = ["dbrx_132b", "kimi_k2_1t", "mistral_nemo_12b", "zamba2_7b",
            "rwkv6_7b"]

# canonical dash-style aliases
ALIASES = {"dbrx-132b": "dbrx_132b", "kimi-k2-1t-a32b": "kimi_k2_1t",
           "mistral-nemo-12b": "mistral_nemo_12b",
           "kimi-k2-1t": "kimi_k2_1t", "zamba2-7b": "zamba2_7b",
           "rwkv6-7b": "rwkv6_7b"}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_")
    if mod_name not in ARCH_IDS:
        raise ValueError(f"the port has no config {name!r}; it carries "
                         f"{ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


# ---------------------------------------------------------------------------
# Shapes from the assignment (per-arch shape sets)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
