"""Single-rank MoE dispatch / combine (the multi-rank lowering comes later)."""
