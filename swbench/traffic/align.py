"""Single queries, each searched and then its best hits aligned: the CLI's
``--align``.

``params`` are ``single``'s and ``k``, the hits aligned a query. The
requests are ``single``'s. The program's entry is ``cli._run_align``'s:
``pipeline.search_database(query, db, scoring)``, then
``ops.traceback.topk_alignments`` of its ``k`` best records on the
search's device. Each hit goes back as an ``alignments.Hit``, and the
kernel seconds are the search's, so the alignment step counts as host
time.
"""

from __future__ import annotations

from swbench.alignments import Hit
from swbench.traffic import single

# ``params["k"]``, noted by ``requests`` and ``warmup``: the harness calls
# them before any ``submit``, and each cell loads its own copy of this
# module.
_asked = {"k": None}


def requests(params: dict, config: dict, db, seed: int):
    _asked["k"] = int(params["k"])
    return single.requests(params, config, db, seed)


def warmup(params: dict) -> list[list[int]]:
    _asked["k"] = int(params["k"])
    return single.warmup(params)


def submit(pipeline, queries, db, scoring):
    # Looked up through their modules, so that a test's patch takes.
    from seqalign_tpu_torch import device
    from seqalign_tpu_torch.ops import traceback

    query = queries[0]
    scores, kernel_s = pipeline.search_database(query, db, scoring)
    found = traceback.topk_alignments(query, db, scores, _asked["k"], scoring.table,
                                      scoring.gap_open, scoring.gap_extend,
                                      device=device.resolve_device())
    hits = [Hit(int(rec), int(a.score), a.query_start, a.query_end, a.db_start, a.db_end,
                a.query_aligned, a.db_aligned, a.cigar) for rec, a in found]
    return scores[None], kernel_s, [hits]
