"""Qwen2-VL-2B [arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B].

VLM: the assignment covers the transformer BACKBONE only; the vision
frontend is a stub (input_specs supplies precomputed patch embeddings +
3-D M-RoPE position ids).  28 layers, d_model 1536, GQA kv=2, M-RoPE
sections (t,h,w) = (16, 24, 24) over head_dim 128, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2_vl_2b", family="dense",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936,
    mrope_sections=(16, 24, 24), rope_theta=1e6,
    mlp_gated=True, act="silu",
    input_mode="embeddings",
    tie_embeddings=True,
    source="arXiv:2409.12191; hf",
)
