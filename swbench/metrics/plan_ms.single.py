"""``plan_ms`` in the single-query cell, where it moves ``gcups.single``:
the reading of ``metrics/plan_ms.py``."""

from swbench.metrics.plan_ms import read  # noqa: F401
