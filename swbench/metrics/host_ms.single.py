"""``host_ms`` in the single-query cell, where it moves ``gcups.single``:
the reading of ``metrics/host_ms.py``."""

from swbench.metrics.host_ms import read  # noqa: F401
