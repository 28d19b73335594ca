"""Utilities of the PyTorch port (own copies of the JAX package's numpy-only
helpers)."""
