"""The control of ``correct``: the reference in the program's place,
computed in saturating integers narrower than the configuration's int32
scores, must come out not correct.

    python -m swbench.control --workload <cell> --seeds 11,12,13 [--requests 64]

The configurations guarantee exact int32 scores with no saturation. The
step below them that would tempt a later change is the one SWIPE and
CUDASW++ take first: scores in saturating 8-bit, and 16-bit, integers.
For each seed this makes the cell's data at its own size, draws the run's
first ``--requests`` requests, chooses the searches a run would compare,
scores them with the reference at each width of ``--bits`` in the
program's place, compares them as a run does, and prints one JSON line a
width: the mismatches, the scores compared, and the largest exact score.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import check
from .cell import load_cell
from .data import make_database
from .reference import sw_scores
from .scoring import load_table


def control_readings(cell, seed: int, requests: int, device: torch.device,
                     widths=(8, 16)) -> list[dict]:
    config, spec = cell.config, cell.workload["check"]
    table = load_table(config["scoring"]["matrix"])
    go, ge = config["scoring"]["gap_open"], config["scoring"]["gap_extend"]
    db = make_database(config, seed, device)
    samples = check.sample_pool(db.lengths, spec, seed)
    stream = cell.traffic.requests(cell.workload["params"], config, db, seed)
    drawn = [next(stream) for _ in range(requests)]
    queries = [qs for qs, _ in drawn]
    chosen = check.chosen_searches(queries, [True] * requests, spec, seed)
    out = []
    for bits in widths:
        answers: list = [None] * requests
        for k in chosen:
            records = np.union1d(samples[k % len(samples)], np.asarray(drawn[k][1], dtype=np.int64))
            seq, lengths = db.records(records)
            answers[k] = (records, sw_scores(queries[k], seq, lengths, table, go, ge, device,
                                             bits=bits))
        got = check.compare(db, len(samples), queries, answers, chosen, table, go, ge, device)
        out.append({"workload": cell.name, "seed": seed, "bits": bits, "searches": len(chosen),
                    "mismatches": got["mismatches"], "compared": got["compared"],
                    "max_score": got["max_score"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m swbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--requests", type=int, default=64,
                    help="requests drawn, of which the run's choice is compared")
    ap.add_argument("--bits", default="8,16", help="comma-separated widths")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    widths = [int(b) for b in args.bits.split(",")]
    for seed in (int(s) for s in args.seeds.split(",")):
        for reading in control_readings(cell, seed, args.requests, torch.device(args.device),
                                        widths):
            print(json.dumps(reading), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
