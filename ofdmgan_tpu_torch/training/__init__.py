"""The CWGAN-GP training step, its optimizers and the trainer."""
