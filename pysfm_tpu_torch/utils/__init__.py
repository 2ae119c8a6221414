"""Precision policy, configuration and timing fences."""
