"""Training data: the synthetic generator, the dataset and its loader, target rendering, video readers (host-side numpy)."""
