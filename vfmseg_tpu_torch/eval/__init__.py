"""Evaluation: the gated slide engine and the per-image predictor."""
