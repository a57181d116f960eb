"""Measurement helpers of the port (its own copies, not the JAX package's)."""
