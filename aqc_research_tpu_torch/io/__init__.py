"""IO layer: checkpoints of optimization state."""
