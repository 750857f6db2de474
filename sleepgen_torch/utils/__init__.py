"""Weights, device rule, run dirs, metrics and checkpoints."""
