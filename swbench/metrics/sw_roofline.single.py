"""``sw_roofline`` in the single-query cell, where it moves ``gcups.single``:
the reading of ``metrics/sw_roofline.py``."""

from swbench.metrics.sw_roofline import read  # noqa: F401
