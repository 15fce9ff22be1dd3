"""Batches of queries, one search of the whole batch each, back to back.

``params["queries"]`` queries a batch, their lengths spread evenly over
``params["lengths"]["min"]..["max"]`` (the uniform distribution's
quantiles, so that every batch holds the same lengths and so the same
work), shuffled from the seed. A batch is a family: every query copies a
window of one database record drawn for the batch (``data.Homologs``),
with a share ``params["mutate"]`` of its residues drawn afresh for each.
The program's entry: ``pipeline.search_database_multi(queries, db,
scoring)``.
"""

from __future__ import annotations

import numpy as np

from swbench.data import Homologs, seed_words


def batch_lengths(params: dict) -> list[int]:
    n, lo, hi = params["queries"], params["lengths"]["min"], params["lengths"]["max"]
    return [lo + (2 * k + 1) * (hi - lo + 1) // (2 * n) for k in range(n)]


def requests(params: dict, config: dict, db, seed: int):
    lengths = np.asarray(batch_lengths(params), dtype=np.int64)
    homologs = Homologs(config, db)
    rng = np.random.default_rng(seed_words(seed, 2))

    def stream():
        while True:
            record = homologs.record(rng, lengths.max())
            yield [homologs.query(rng, record, n, params["mutate"])
                   for n in rng.permutation(lengths)], [record]

    return stream()


def warmup(params: dict) -> list[list[int]]:
    return [batch_lengths(params)]


def submit(pipeline, queries, db, scoring):
    return pipeline.search_database_multi(queries, db, scoring)
