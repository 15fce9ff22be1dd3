"""Metric readers, one module per metric of ``BENCHMARK.json``, found by
the metric's name. Each has ``read(run)``, which returns the metric's value
from a finished run (``swbench.cell.Run``) or None where the run holds
nothing to read it from; the harness then leaves the metric out."""
