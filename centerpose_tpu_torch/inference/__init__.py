"""Detector pipeline of the PyTorch package."""
