"""Single queries, one search each, back to back.

``params["lengths"]``: the query lengths of one pass. Every pass sends each
length once, in the order listed, so that a pass the window cuts short
does the same work whatever the seed. Each query is a copy of a database record
(``data.Homologs``) with a share ``params["mutate"]`` of its residues
drawn afresh. The program's entry: ``pipeline.search_database(query, db,
scoring)``.
"""

from __future__ import annotations

import numpy as np

from swbench.data import Homologs, seed_words


def requests(params: dict, config: dict, db, seed: int):
    lengths = [int(n) for n in params["lengths"]]
    homologs = Homologs(config, db)
    rng = np.random.default_rng(seed_words(seed, 2))

    def stream():
        while True:
            for n in lengths:
                record = homologs.record(rng, n)
                yield [homologs.query(rng, record, n, params["mutate"])], [record]

    return stream()


def warmup(params: dict) -> list[list[int]]:
    return [[n] for n in sorted(set(params["lengths"]))]


def submit(pipeline, queries, db, scoring):
    scores, kernel_s = pipeline.search_database(queries[0], db, scoring)
    return scores[None], kernel_s
