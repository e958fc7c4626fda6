"""MoE dispatch / combine over ranks and the rank-bitmap helpers."""
