"""PyTorch / CUDA port of the MultiWrite MoE system for NVIDIA Hopper.

A second package beside the JAX reference ``repro``: the same module names,
PyTorch idiom inside, and hand-written CUDA kernels where the reference has
Pallas kernels.  It imports nothing of JAX or of ``repro``.  Entry points
run on CUDA unless the caller passes ``device="cpu"``.
"""
