"""Evaluation: the dense and compact gated slide engines, the other
inference modes, TTA, the predictors, the stream and the IoU metric."""
