"""``plan_hit_pct`` in the single-query cell, where it moves
``gcups.single``: the reading of ``metrics/plan_hit_pct.py``."""

from swbench.metrics.plan_hit_pct import read  # noqa: F401
