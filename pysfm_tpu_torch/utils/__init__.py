"""Precision policy, configuration, timing fences, tracing, and the
collectives of the distributed path."""
