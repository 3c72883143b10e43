"""Training: optimizer and partition, state, step, checkpoints and loop."""
