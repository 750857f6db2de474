"""Weights and device helpers."""
