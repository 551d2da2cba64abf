"""Sequence parallelism: the ring context and the plain ring attention."""
