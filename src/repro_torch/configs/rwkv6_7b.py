"""RWKV6-7B "Finch" [arXiv:2404.05892; hf:RWKV/rwkv-6-world-7b].

Attention-free: 32 layers of time-mix (WKV6 with data-dependent decay via
a rank-64 LoRA) and channel-mix (squared ReLU), d_model 4096, wkv head dim
64 (64 heads), d_ff 14336, vocab 65536, untied unembedding.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6_7b", family="rwkv",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
    d_ff=14336, vocab=65536,
    rwkv_head_dim=64, rwkv_decay_lora=64,
    tie_embeddings=False,
    source="arXiv:2404.05892; hf",
)
