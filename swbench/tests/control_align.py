"""The control of the alignment check: the program's alignment step, and
tampered ones in its place, judged as a run judges them, at a cell's own
size.

    python -m swbench.tests.control_align --workload blosum62-align10 --seeds 11,12,13 [--requests 96]

For each seed this makes the cell's data, draws the run's first
``--requests`` requests, and chooses the searches a run would compare. It
searches each of them with the program (``pipeline.search_database``, as
the ``align`` kind's ``submit`` does) and aligns its ``k + 1`` best records
with the program's ``ops.traceback.topk_alignments``. Then it answers each
query with every variant of the step below, keeps the scores a run would
keep (a sample, the records the query copies, the records of the hits),
and judges the hits with ``alignments.compare``. It prints one JSON line a
variant: ``alignment_mismatches``, ``alignments_compared``, and
``planted``, the queries the variant changed.

- ``program``: the program's ``k`` best hits. Its line also holds the
  scores' check against the reference (``check.compare``: ``mismatches``,
  ``scores_compared``); a run with these readings is ``correct`` when both
  mismatch counts are 0 and both compared counts at least 1.
- Each fault of ``tamper.py``, planted in each query's hits where it
  can be.
- ``banded32``: each of the ``k`` best records aligned in a band of
  half-width 32 around the diagonal of the program's end cell, on the
  program's recurrence (``banded_hit``).
- ``argpartition``: an unstable top-k: the ``k`` best records as
  ``np.argpartition`` chooses them, ordered by score alone (ties in
  ``argpartition``'s order), each aligned by the program's traceback.

A variant that comes out with 0 mismatches is a fault that ``correct``
does not catch at this traffic.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

import numpy as np
import torch

from .. import alignments, check
from ..alignments import Hit
from ..cell import encoded, load_cell, program_scoring
from ..data import make_database
from ..scoring import STAR, load_table
from .tamper import TAMPERS, from_port

NEG = np.int64(-(1 << 40))
BAND = 32


def letter(c) -> str:
    return "*" if c == STAR else chr(64 + int(c))


def banded_hit(record: int, q: np.ndarray, d: np.ndarray, table: np.ndarray, gap_open: int,
               gap_extend: int, diagonal: int, width: int = BAND) -> Hit:
    """The best local alignment of ``q`` against record ``record``'s residues
    ``d`` among those whose cells lie within ``width`` of the diagonal
    ``i - j == diagonal`` (query position ``i``, record position ``j``, both
    1-based), on the program's recurrence (``ops.traceback``: H takes the
    diagonal's best of H, E and F, every matrix floored at 0, ties to H and
    then E) and walked back as the program walks back. Cell ``(j, i)`` is
    kept in column ``i - j - diagonal + width`` of row ``j``."""
    q, d = np.asarray(q, dtype=np.int64), np.asarray(d, dtype=np.int64)
    lq, lb, cols = len(q), len(d), 2 * width + 1
    go, ge = int(gap_open) + int(gap_extend), int(gap_extend)
    tab = np.asarray(table, dtype=np.int64)
    offs = np.arange(cols) - width + diagonal  # i - j in each column
    ramp = np.arange(cols, dtype=np.int64) * ge
    H = np.full((lb + 1, cols), NEG)
    E, F = H.copy(), H.copy()
    src = np.zeros((3, lb + 1, cols), dtype=np.uint8)  # H's, E's and F's sources
    H[0, (offs >= 0) & (offs <= lq)] = E[0, (offs >= 0) & (offs <= lq)] = 0
    F[0] = E[0]
    best, at = 0, (0, 0)
    for j in range(1, lb + 1):
        i = offs + j
        inside = (i >= 1) & (i <= lq)
        H[j, i == 0] = E[j, i == 0] = F[j, i == 0] = 0
        s = tab[q[np.clip(i - 1, 0, lq - 1)], d[j - 1]]
        # H from the diagonal: the cell above and to the left, same column.
        dh, de, df = H[j - 1], E[j - 1], F[j - 1]
        h = np.maximum(np.maximum(dh, de), df) + s
        from_ = np.where(df > np.maximum(dh, de), 3, np.where(de > dh, 2, 1))
        H[j] = np.where(inside, np.maximum(h, 0), H[j])
        src[0, j] = np.where(inside & (h >= 0), from_, 0)
        # E from the cell above: the next column of the row above.
        eh, ee, ef = (np.append(x[1:], NEG) for x in (dh + go, de + ge, df + go))
        e = np.maximum(np.maximum(eh, ee), ef)
        from_ = np.where(ef > np.maximum(eh, ee), 3, np.where(ee > eh, 2, 1))
        E[j] = np.where(inside, np.maximum(e, 0), E[j])
        src[1, j] = np.where(inside & (e >= 0), from_, 0)
        # F from the cell to the left, the previous column: a max-plus scan.
        m = np.where((i >= 0) & (i <= lq), np.maximum(H[j], E[j]), NEG)
        pref = np.maximum.accumulate(m + go - ramp)
        f = np.append(0, np.maximum(pref[:-1] + ramp[:-1], 0))
        F[j] = np.where(inside, f, F[j])
        fh, fe = np.append(NEG, H[j, :-1] + go), np.append(NEG, E[j, :-1] + go)
        ff = np.append(NEG, F[j, :-1] + ge)
        from_ = np.where(ff > np.maximum(fh, fe), 3, np.where(fe > fh, 2, 1))
        src[2, j] = np.where(inside & (f > 0), from_, 0)
        row = np.where(inside, H[j], -1)
        k = int(row.argmax())
        if row[k] > best:
            best, at = int(row[k]), (j, int(i[k]))
    j, i = at
    mat, cols_q, cols_r = 1, [], []
    while j > 0 and i > 0:
        came = int(src[mat - 1, j, i - j - diagonal + width])
        if mat == 1 and came == 0:
            break
        cols_q.append(letter(q[i - 1]) if mat != 2 else alignments.GAP)
        cols_r.append(letter(d[j - 1]) if mat != 3 else alignments.GAP)
        i, j = i - (mat != 2), j - (mat != 3)
        if came == 0:
            break
        mat = came
    query_aligned, record_aligned = "".join(cols_q[::-1]), "".join(cols_r[::-1])
    ops = alignments.columns(query_aligned, record_aligned)
    cigar = "".join(f"{len(list(run))}{op}" for op, run in itertools.groupby(ops))
    return Hit(record, best, i, at[1], j, at[0], query_aligned, record_aligned, cigar)


def banded(found: list[tuple[int, object]], query, db, table, go: int, ge: int) -> list[Hit]:
    """The ``k`` best records, each aligned in the band around the diagonal
    of the program's own end cell of it."""
    return [banded_hit(rec, query, db.records(np.array([rec]))[0], table, go, ge,
                       a.query_end - a.db_end) for rec, a in found[:-1]]


def argpartition_top(scores: np.ndarray, k: int, query, db, table, go: int, ge: int):
    from seqalign_tpu_torch.ops import traceback

    top = np.argpartition(-scores, k - 1)[:k]
    top = top[np.argsort(-scores[top], kind="stable")]
    return from_port([(int(rec), traceback.sw_traceback(query, db.records(np.array([rec]))[0],
                                                         table, go, ge)) for rec in top])


def readings(cell, seed: int, requests: int, device: torch.device) -> list[dict]:
    from seqalign_tpu_torch import pipeline
    from seqalign_tpu_torch.ops import traceback

    config, spec, k = cell.config, cell.workload["check"], int(cell.workload["params"]["k"])
    table = load_table(config["scoring"]["matrix"])
    go, ge = config["scoring"]["gap_open"], config["scoring"]["gap_extend"]
    scoring = program_scoring(config, table)
    db = make_database(config, seed, device)
    whole = encoded(db)
    samples = check.sample_pool(db.lengths, spec, seed)
    stream = cell.traffic.requests(cell.workload["params"], config, db, seed)
    drawn = [next(stream) for _ in range(requests)]
    queries = [qs for qs, _ in drawn]
    chosen = check.chosen_searches(queries, [True] * requests, spec, seed)
    scores, found = {}, {}
    for s in chosen:
        query = queries[s][0]
        scores[s] = pipeline.search_database(query, whole, scoring)[0]
        found[s] = traceback.topk_alignments(query, whole, scores[s], k + 1, scoring.table,
                                             scoring.gap_open, scoring.gap_extend)

    def variants():
        yield "program", lambda s: from_port(found[s][:-1])
        for tamper in TAMPERS:
            yield tamper.__name__, lambda s, t=tamper: t(from_port(found[s]), table, go, ge)
        yield f"banded{BAND}", lambda s: banded(found[s], queries[s][0], db, table, go, ge)
        yield "argpartition", lambda s: argpartition_top(scores[s], k, queries[s][0], db,
                                                         table, go, ge)

    out = []
    for name, answer in variants():
        answers, hits, planted = [None] * requests, [None] * requests, 0
        for s in chosen:
            sound = from_port(found[s][:-1])
            try:
                given = answer(s)
            except AssertionError:  # a fault with nowhere to go in this query
                given = sound
            planted += given != sound
            records = np.union1d(samples[s % len(samples)],
                                 np.asarray(drawn[s][1] + [h.record for h in given]))
            answers[s] = (records, scores[s][None, records])
            hits[s] = [given]
        got = alignments.compare(db, queries, answers, hits, chosen, k, table, go, ge)
        line = {"workload": cell.name, "seed": seed, "variant": name, "searches": len(chosen),
                "planted": planted, "alignment_mismatches": got["mismatches"],
                "alignments_compared": got["compared"]}
        if name == "program":
            exact = check.compare(db, len(samples), queries, answers, chosen, table, go, ge,
                                  device)
            line.update(mismatches=exact["mismatches"], scores_compared=exact["compared"])
        out.append(line)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m swbench.tests.control_align")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--requests", type=int, default=96,
                    help="requests drawn, of which the run's choice is compared")
    ap.add_argument("--device", default="cuda", help="where the data and the reference run")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        for reading in readings(cell, seed, args.requests, torch.device(args.device)):
            print(json.dumps(reading), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
