"""MoE dispatch / combine over ranks, the rank-bitmap helpers, and the
planner's control plane (topology, MultiWrite simulator, plan IR, latency
model, schedules, planner), copied from the reference."""
