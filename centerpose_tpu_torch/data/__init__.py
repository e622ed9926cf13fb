"""Training data: ground-truth target rendering (host-side numpy)."""
