"""SeamlessM4T-medium [arXiv:2308.11596; hf:facebook/seamless-m4t-medium].

Encoder-decoder audio backbone: 12 encoder + 12 decoder layers,
d_model 1024, MHA (kv=16 == heads), non-gated GELU FFN 4096, vocab
256206.  The speech frontend is a stub: input_specs supplies precomputed
frame embeddings to the encoder; the decoder consumes tokens.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless_m4t_medium", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206,
    mlp_gated=False, act="gelu",
    input_mode="embeddings",
    tie_embeddings=True,
    source="arXiv:2308.11596; hf",
)
