"""Networks of the PyTorch package."""
