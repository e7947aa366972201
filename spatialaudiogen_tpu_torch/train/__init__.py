"""Training: learning-rate schedule and optimizer, train state, train step,
checkpoints, trainer loop, and the generic fit/evaluate/predict harness."""
