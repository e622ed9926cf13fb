"""Host utilities: checkpoints, the experiment logger, TensorBoard events."""
