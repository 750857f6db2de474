"""Samplers and the sampling entry points."""
