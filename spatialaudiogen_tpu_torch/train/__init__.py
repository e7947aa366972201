"""Training: learning-rate schedule and optimizer, train state, train step, checkpoints, trainer loop."""
