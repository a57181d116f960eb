"""Parallel layers of the port. This slice holds only ``full_attention``."""
