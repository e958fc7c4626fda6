"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407].

Dense decoder, GQA kv=8, explicit head_dim=128 (d_model 5120 / 32 heads
would give 160; the released model uses 128), gated SiLU MLP, 128k ctx
(rope_theta 1e6), vocab 131072 (Tekken).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral_nemo_12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=131072,
    mlp_gated=True, act="silu", rope_theta=1e6,
    tie_embeddings=False,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)
