"""Serving front ends of the PyTorch port."""
