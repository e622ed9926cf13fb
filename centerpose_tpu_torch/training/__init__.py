"""Training: losses and the train / eval step."""
