"""Ops: LayerNorm, attention and resize, each kernel beside its plain PyTorch version."""
