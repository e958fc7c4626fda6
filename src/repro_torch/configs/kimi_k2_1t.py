"""Kimi-K2 1T-A32B [arXiv:2501.kimi2 paper table; unverified tier].

Trillion-parameter MoE (DeepSeek-V3-family): 61 layers, d_model 7168,
384 experts top-8 with expert d_ff 2048, 1 shared expert, first layer
dense, GQA kv=8 per the assignment table (the released model uses MLA;
the table pins GQA — noted in DESIGN.md §Arch-applicability), vocab
163840.  The flagship MultiWrite cell: EP spans pods.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi_k2_1t", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=18432,               # dense-layer FFN (DeepSeek-V3 family value)
    vocab=163840,
    num_experts=384, top_k=8, moe_d_ff=2048,
    n_shared_experts=1, first_k_dense=1,
    mlp_gated=True, act="silu", rope_theta=5e4,
    tie_embeddings=False,
    source="arXiv:2501.kimi2 (paper table); unverified",
)
