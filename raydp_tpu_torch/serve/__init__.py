"""Serving of the port: the paged KV cache and the decode engine."""
