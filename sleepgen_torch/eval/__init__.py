"""Evaluation: the artifact PSD."""
