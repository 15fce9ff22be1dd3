"""How ``correct`` is decided: the program's scores against the reference.

Before the window a pool of record samples is drawn from the seed, each
with the database's longest and shortest records in it. Each search of the
window keeps its scores of one sample (search ``k`` of sample ``k`` mod the
pool), of the records its queries were copied from, whose scores are the
search's highest, and of the records of the hits it aligned, where its
traffic kind returns them (``alignments.py`` judges the alignments
themselves). Once the window has closed, a number of the finished searches
drawn from the seed, and always the one with the most query residues, are
scored again by the reference on their sample, and every score is compared
exactly: the limit on mismatches is 0, since a score either is the
recurrence's or is not.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .data import Database, seed_words
from .reference import sw_scores

# Device memory the reference's working tensors may take at once (about
# eight (queries, residues) int64 tensors).
REFERENCE_BYTES = 16 << 30


def sample_pool(lengths: np.ndarray, spec: dict, seed: int) -> list[np.ndarray]:
    """``spec["samples"]`` sorted record samples of ``spec["records"]``
    records each: the ``spec["extremes"]`` longest and shortest in every
    one, the rest drawn from the seed."""
    n = len(lengths)
    size = min(spec["records"], n)
    ext = min(spec["extremes"], size // 4)
    order = np.argsort(lengths, kind="stable")
    fixed = np.union1d(order[:ext], order[n - ext :])
    rest = np.setdiff1d(np.arange(n), fixed)
    rng = np.random.default_rng(seed_words(seed, 3))
    return [np.sort(np.concatenate([fixed, rng.choice(rest, size - len(fixed), replace=False)]))
            for _ in range(spec["samples"])]


def chosen_searches(queries: list, answered: list[bool], spec: dict, seed: int) -> list[int]:
    """The searches compared: ``spec["searches"]`` of the answered ones
    drawn from the seed, and the answered one with the most query
    residues."""
    done = [k for k, ok in enumerate(answered) if ok]
    if not done:
        return []
    rng = np.random.default_rng(seed_words(seed, 4))
    pick = set(rng.choice(done, min(spec["searches"], len(done)), replace=False).tolist())
    pick.add(max(done, key=lambda k: sum(len(q) for q in queries[k])))
    return sorted(pick)


def compare(
    db: Database, pool: int, queries: list, answers: list, chosen: list[int],
    table: np.ndarray, gap_open: int, gap_extend: int, device: torch.device,
) -> dict:
    """Score the ``chosen`` searches' queries (``queries[k]``, a list)
    with the reference against the records of their answers
    (``answers[k]``: ``(records, (queries, records) scores)``) and compare.
    The searches that share a sample of the ``pool`` are scored together.
    Returns the counts and the first few mismatches."""
    groups: dict[int, list[int]] = {}
    for k in chosen:
        groups.setdefault(k % pool, []).append(k)
    out = {"mismatches": 0, "compared": 0, "max_score": 0, "examples": []}
    for ks in groups.values():
        records = functools.reduce(np.union1d, [answers[k][0] for k in ks])
        seq, lengths = db.records(records)
        rows = int(max(1, min(64, REFERENCE_BYTES // (64 * max(len(seq), 1)))))
        items = sorted(((k, i) for k in ks for i in range(len(queries[k]))),
                       key=lambda ki: len(queries[ki[0]][ki[1]]))
        for a in range(0, len(items), rows):
            part = items[a : a + rows]
            want = sw_scores([queries[k][i] for k, i in part], seq, lengths,
                             table, gap_open, gap_extend, device)
            out["max_score"] = max(out["max_score"], int(want.max(initial=0)))
            for (k, i), row in zip(part, want):
                cols, scores = answers[k]
                got = np.asarray(scores[i], dtype=np.int64)
                expect = row[np.searchsorted(records, cols)]
                bad = np.flatnonzero(got != expect)
                out["mismatches"] += len(bad)
                out["compared"] += got.size
                for c in bad[: 5 - len(out["examples"])]:
                    out["examples"].append({"search": k, "query": i, "record": int(cols[c]),
                                            "got": int(got[c]), "want": int(expect[c])})
    return out
