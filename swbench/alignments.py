"""How ``correct`` judges the alignments a traffic kind returns with its
scores.

A kind may answer each query of a request with its best hits, in the
program's order, each a ``Hit``: the record, the score, the aligned spans
of the query and the record (0-based, end exclusive), the two gapped
strings and the CIGAR (``M`` a column of two residues, ``I`` a gap in the
record, ``D`` a gap in the query). Once the window has closed, the hits of
the searches ``check.chosen_searches`` draws are judged against the
residues the benchmark made and the scores it kept. A hit counts one
mismatch where any of these fails:

(a) its strings, their gaps removed, are the query's and the record's
    residues over the stated spans;
(b) its CIGAR expands to exactly the strings' columns;
(c) the strings rescored give its score: the table's score for each
    column of two residues, and ``gap_open + k * gap_extend`` for each
    run of ``k`` columns with a gap on the same side (a run of ``I``
    beside a run of ``D`` is two gaps);
(d) its score is the program's score of its record;
(e) it stands in its place in the program's ranking: by score, high
    first, ties to the lower record (``np.argsort(-scores,
    kind="stable")``).

Besides, every hit missing from a query's ``min(k, records)`` and every
kept record outside the hits that ranks above the last of them counts
one. The program's scores are held to the reference by ``check.compare``,
which also scores each hit's record. With (a)-(d), each hit is then an
optimal local alignment of a correctly ranked record, whichever of the
equal alignments the program's traceback chose.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from .data import Database
from .scoring import code

GAP = "-"
_CIGAR = re.compile(r"([1-9][0-9]*)([MID])")


@dataclasses.dataclass(frozen=True)
class Hit:
    """One aligned hit, as a traffic kind returns it."""

    record: int
    score: int
    query_start: int
    query_end: int
    record_start: int
    record_end: int
    query_aligned: str
    record_aligned: str
    cigar: str


def expand_cigar(cigar: str) -> str | None:
    """One letter a column, or None where ``cigar`` is not runs of
    ``<count><M|I|D>``."""
    runs = _CIGAR.findall(cigar)
    if "".join(n + op for n, op in runs) != cigar:
        return None
    return "".join(op * int(n) for n, op in runs)


def columns(query_aligned: str, record_aligned: str) -> str | None:
    """The strings' columns as CIGAR letters, or None where the strings
    differ in length or a column holds two gaps."""
    if len(query_aligned) != len(record_aligned):
        return None
    ops = []
    for a, b in zip(query_aligned, record_aligned):
        if a == GAP and b == GAP:
            return None
        ops.append("D" if a == GAP else "I" if b == GAP else "M")
    return "".join(ops)


def residues(aligned: str) -> np.ndarray | None:
    """The codes of a gapped string's residues, or None where it holds a
    letter that is not a residue's."""
    try:
        return np.array([code(c) for c in aligned if c != GAP], dtype=np.int64)
    except ValueError:
        return None


def rescore(hit: Hit, table: np.ndarray, gap_open: int, gap_extend: int) -> int | None:
    """The score of ``hit``'s strings, or None where they are no alignment."""
    ops = columns(hit.query_aligned, hit.record_aligned)
    if ops is None:
        return None
    score = 0
    for run in re.finditer(r"M+|I+|D+", ops):
        a, b = run.span()
        if run.group()[0] == "M":
            q, r = residues(hit.query_aligned[a:b]), residues(hit.record_aligned[a:b])
            if q is None or r is None:
                return None
            score += int(np.asarray(table, dtype=np.int64)[q, r].sum())
        else:
            score += int(gap_open) + (b - a) * int(gap_extend)
    return score


def hit_faults(hit: Hit, query: np.ndarray, record: np.ndarray, table: np.ndarray,
               gap_open: int, gap_extend: int) -> list[str]:
    """Which of (a)-(c) ``hit`` fails, against the query's and the record's
    residue codes."""
    out = []
    q, r = residues(hit.query_aligned), residues(hit.record_aligned)
    spans_ok = (0 <= hit.query_start <= hit.query_end <= len(query)
                and 0 <= hit.record_start <= hit.record_end <= len(record))
    if not (spans_ok and q is not None and r is not None
            and np.array_equal(q, np.asarray(query[hit.query_start : hit.query_end]))
            and np.array_equal(r, np.asarray(record[hit.record_start : hit.record_end]))):
        out.append("residues")
    ops = columns(hit.query_aligned, hit.record_aligned)
    if ops is None or expand_cigar(hit.cigar) != ops:
        out.append("cigar")
    if rescore(hit, table, gap_open, gap_extend) != hit.score:
        out.append("rescore")
    return out


def judge_query(hits: list[Hit], query: np.ndarray, db: Database, records: np.ndarray,
                scores: np.ndarray, k: int, table: np.ndarray, gap_open: int,
                gap_extend: int) -> tuple[int, list[dict]]:
    """``(mismatches, what each was)`` of one query's ``hits``, against the
    program's ``scores`` of the kept ``records`` (sorted; the hits' among
    them)."""
    bad: list[dict] = []
    scores = np.asarray(scores, dtype=np.int64)
    prev = None
    for rank, hit in enumerate(hits):
        at = int(np.searchsorted(records, hit.record))
        if at == len(records) or records[at] != hit.record:
            bad.append({"rank": rank, "record": hit.record, "faults": ["not kept"]})
            continue
        seq, _ = db.records(np.array([hit.record]))
        faults = hit_faults(hit, query, seq, table, gap_open, gap_extend)
        if hit.score != scores[at]:
            faults.append("program score")
        key = (-int(scores[at]), int(hit.record))
        if prev is not None and not prev < key:
            faults.append("order")
        prev = key
        if faults:
            bad.append({"rank": rank, "record": hit.record, "faults": faults})
    wanted = min(k, len(db.lengths))
    for rank in range(len(hits), wanted):
        bad.append({"rank": rank, "faults": ["missing"]})
    if len(hits) > wanted:
        bad.append({"rank": wanted, "faults": [f"{len(hits) - wanted} past k"]})
    if prev is not None:
        chosen = {h.record for h in hits}
        above = [int(r) for r, s in zip(records, scores)
                 if int(r) not in chosen and (-int(s), int(r)) < prev]
        bad.extend({"record": r, "faults": ["skipped"]} for r in above)
    return len(bad), bad


def compare(db: Database, queries: list, answers: list, hits: list, chosen: list[int],
            k: int, table: np.ndarray, gap_open: int, gap_extend: int) -> dict:
    """Judge the hits of the ``chosen`` searches, ``k`` asked a query:
    ``hits[s]`` holds one list of ``Hit`` a query of ``queries[s]`` (None
    where the kind returned none), ``answers[s]`` the kept ``(records,
    (queries, records) scores)``. Returns the counts and the first few
    mismatches."""
    out = {"mismatches": 0, "compared": 0, "examples": []}
    for s in chosen:
        if hits[s] is None:
            continue
        records, scores = answers[s]
        if len(hits[s]) > len(queries[s]):
            out["mismatches"] += 1
            out["examples"].append({"search": s, "faults": ["more queries answered than sent"]})
        per_query = list(hits[s]) + [[]] * (len(queries[s]) - len(hits[s]))
        for i, (query, found) in enumerate(zip(queries[s], per_query)):
            n, bad = judge_query(found, np.asarray(query), db, records, scores[i], k, table,
                                 gap_open, gap_extend)
            out["mismatches"] += n
            out["compared"] += len(found)
            for b in bad[: 5 - len(out["examples"])]:
                out["examples"].append({"search": s, "query": i, **b})
    return out
