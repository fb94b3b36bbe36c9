"""Experiment configuration (the TOML surface)."""
