"""StarCoder2-15B [arXiv:2402.19173; hf:bigcode/starcoder2-15b].

Dense decoder, GQA (4 kv heads), RoPE, non-gated GELU MLP (4x),
learned-bias-free; vocab 49152 (GQA, RoPE per the assignment table).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2_15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
    d_ff=24576, vocab=49152,
    mlp_gated=False, act="gelu", rope_theta=1e5,
    tie_embeddings=False,
    source="arXiv:2402.19173; hf",
)
