"""Observability: metrics registry and per-job trace spans (copies of
the JAX package's ``obs/metrics.py`` and ``obs/trace.py``)."""
