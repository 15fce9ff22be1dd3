"""A copy of the benchmark at a size the CPU runs in seconds, for the tests:
the same traffic kinds and metric readers, tiny databases and queries."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

SWBENCH = Path(__file__).resolve().parent.parent
CHECK = {"searches": 3, "records": 64, "extremes": 4, "samples": 2}


def tiny_config(name: str, matrix: str, gap_open: int, gap_extend: int) -> dict:
    config = json.loads((SWBENCH / "configs" / "swissprot-blosum62.json").read_text())
    config.update(name=name, scoring={"matrix": matrix, "gap_open": gap_open,
                                      "gap_extend": gap_extend})
    config["database"] = dict(config["database"], records=48,
                              lengths=dict(config["database"]["lengths"], gamma_scale=30.0, max=90))
    del config["database"]["residues"]
    return config


CELLS = {
    "tiny-single": ("tiny-blosum62", "single",
                    {"lengths": [9, 23, 40, 120], "mutate": 0.0}),
    "tiny-batch": ("tiny-blosum62", "batch",
                   {"queries": 4, "lengths": {"min": 32, "max": 40}, "mutate": 0.3}),
    "tiny-pam": ("tiny-pam250", "single", {"lengths": [40], "mutate": 0.0}),
    "tiny-align": ("tiny-pam250", "align",
                   {"lengths": [9, 23, 40, 120], "mutate": 0.0, "k": 3}),
}


def make_root(tmp: Path) -> Path:
    """A benchmark root under ``tmp``: ``BENCHMARK.json`` and
    ``swbench/{configs,workloads,traffic,metrics}`` with the tiny cells, the
    traffic kinds and metric readers copied from the benchmark."""
    root = tmp / "swbench"
    for sub in ("traffic", "metrics"):
        shutil.copytree(SWBENCH / sub, root / sub)
    (root / "configs").mkdir()
    (root / "workloads").mkdir()
    for name, args in (("tiny-blosum62", ("BLOSUM62", -11, -1)),
                       ("tiny-pam250", ("PAM250", -2, -1))):
        (root / "configs" / f"{name}.json").write_text(json.dumps(tiny_config(name, *args)))
    bench = json.loads((SWBENCH.parent / "BENCHMARK.json").read_text())
    bench["workloads"] = []
    for cell, (config, kind, params) in CELLS.items():
        (root / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"name": cell, "config": config, "traffic": cell, "kind": kind,
             "params": params, "check": CHECK, "why": "a test"}))
        bench["workloads"].append({"name": cell, "config": config, "traffic": cell,
                                   "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
