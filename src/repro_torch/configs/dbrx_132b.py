"""DBRX-132B [hf:databricks/dbrx-base; unverified tier].

Fine-grained MoE decoder: 16 experts, top-4, expert d_ff 10752,
GQA kv=8, vocab 100352, rope_theta 5e5.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx_132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352,
    num_experts=16, top_k=4, moe_d_ff=10752,
    mlp_gated=True, act="silu", rope_theta=5e5,
    tie_embeddings=False,
    source="hf:databricks/dbrx-base; unverified",
)
