"""Models of the port: ``TransformerLM`` and its flax weight converter."""
