"""``h2d_ms`` in the single-query cell, where it moves ``gcups.single``:
the reading of ``metrics/h2d_ms.py``."""

from swbench.metrics.h2d_ms import read  # noqa: F401
