"""Training: optimizer, train step, checkpoints and the trainer."""
