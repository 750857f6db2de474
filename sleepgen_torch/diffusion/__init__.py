"""Noise schedules and diffusion steps."""
