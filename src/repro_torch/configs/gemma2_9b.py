"""Gemma2-9B [arXiv:2408.00118; hf:google/gemma-2-9b].

Dense decoder, GQA kv=8, head_dim 256, alternating local (4096-window)
/ global attention, attn logit softcap 50, final logit softcap 30,
post-block RMSNorm, gated GELU MLP, 256k vocab, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2_9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_head=256,
    d_ff=14336, vocab=256000,
    mlp_gated=True, act="gelu",
    window=4096, local_global_alternating=True,
    attn_softcap=50.0, final_softcap=30.0, post_norm=True,
    tie_embeddings=True,
    source="arXiv:2408.00118; hf",
)
