"""Minitron-8B (pruned Nemotron-4) [arXiv:2407.14679; hf:nvidia/Minitron-8B-Base].

Dense decoder, GQA kv=8, squared-ReLU non-gated MLP (Nemotron family),
256k vocab.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron_8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab=256000,
    mlp_gated=False, act="relu2", rope_theta=1e4,
    tie_embeddings=False,
    source="arXiv:2407.14679; hf",
)
