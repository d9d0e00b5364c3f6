"""Model configs: the `ModelConfig` schema and the archs the port runs."""
