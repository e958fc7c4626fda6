"""Zamba2-7B [arXiv:2411.15242; hf:Zyphra/Zamba2-7B; unverified tier].

Hybrid: 81 Mamba2 blocks with one SHARED attention+MLP block invoked every
6 layers (the released model alternates two shared blocks with
per-invocation LoRA deltas; one shared block here, as in the reference).
d_model 3584, ssm_state 64, mamba2 head_dim 64, expand 2; shared attention
32 heads, kv 32 (MHA), head_dim 112, d_ff 14336.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2_7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    shared_attn_every=6,
    mlp_gated=True, act="silu",
    tie_embeddings=True,
    source="arXiv:2411.15242; unverified",
)
