"""Rank meshes over ``torch.distributed`` and the fixed-policy parallel
context (the reference's ``shard_map`` axes and ``ParallelContext``)."""
