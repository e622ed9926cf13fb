"""Scripts of the PyTorch package, each run as `python -m
centerpose_tpu_torch.scripts.<name>`: twins of the JAX package's `scripts/`
that drive this package's CLIs and models."""
