"""Transformer blocks, MoE layer and the model API."""
