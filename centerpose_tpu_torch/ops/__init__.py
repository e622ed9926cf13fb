"""Tensor operations of the PyTorch package (NHWC at every public function)."""
