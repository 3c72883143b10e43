"""Core utilities: the config loader."""
