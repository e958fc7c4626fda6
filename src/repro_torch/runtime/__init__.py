"""Runtime: the serving engine."""
