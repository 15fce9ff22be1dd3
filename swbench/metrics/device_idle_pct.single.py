"""``device_idle_pct`` in the single-query cell, where it moves ``gcups.single``:
the reading of ``metrics/device_idle_pct.py``."""

from swbench.metrics.device_idle_pct import read  # noqa: F401
