"""Checkpoints of parameter and optimizer trees."""
