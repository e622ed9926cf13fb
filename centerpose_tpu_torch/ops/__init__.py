"""Tensor operations of the PyTorch package (NHWC at every public function but
`psroi.dcn_v2_psroi_pooling`, which keeps the reference module's NCHW)."""
