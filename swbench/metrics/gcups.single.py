"""``gcups`` in the single-query cell, which the host's own speed spreads
too widely for ``gcups``'s bound: the reading of ``metrics/gcups.py``."""

from swbench.metrics.gcups import read  # noqa: F401
