"""Scalar NumPy oracle for Smith-Waterman affine-gap (Gotoh) scoring.

The port's own copy of ``seqalign_tpu/ops/oracle.py`` (pure NumPy, no
JAX): the ``oracle`` engine of ``pipeline.search_database``, and the
bit-exactness anchor for every accelerated engine (it replaces the
reference repo's prebuilt upstream oracle binary, ``test/tests.py``). It
implements *exactly* the recurrences of the reference
kernel (``src/alignment.c:122-161``), in the reference's formulation where H
folds E/F in at the diagonal and all three matrices are floored at zero:

    go = gap_open + gap_extend    # cost of opening (a length-1 gap)
    ge = gap_extend               # cost of extending

    H[j][i] = max(0, H[j-1][i-1]+s, E[j-1][i-1]+s, F[j-1][i-1]+s)
    E[j][i] = max(0, H[j-1][i]+go, E[j-1][i]+ge, F[j-1][i]+go)   # gap in query
    F[j][i] = max(0, H[j][i-1]+go, E[j][i-1]+go, F[j][i-1]+ge)   # gap in db

    score = max over all cells of H

with i indexing the query (seq_a) and j the database sequence (seq_b), and
zero boundary row/column (local alignment).

Deliberate divergence from the reference: arithmetic is int64 here (and int32
in the accelerated engines), so scores above 32767 do not wrap the way the
reference's int16 kernel does (SURVEY.md §7.4) — the reference's wrapping is
undefined-envelope behavior, not a feature.
"""

from __future__ import annotations

import numpy as np


def sw_score_single(
    query_idx: np.ndarray,
    db_idx: np.ndarray,
    table: np.ndarray,
    gap_open: int,
    gap_extend: int,
) -> int:
    """Score one query vs one database sequence. Pure scalar loops.

    Args:
      query_idx: (Lq,) int array of alphabet indices for the query (seq_a).
      db_idx: (Lb,) int array of alphabet indices for the db sequence (seq_b).
      table: (32, 32) int substitution table.
      gap_open: gap-open penalty (negative), *excluding* the first extend.
      gap_extend: gap-extend penalty (negative).

    Returns:
      The optimal local-alignment score (int).
    """
    go = int(gap_open) + int(gap_extend)
    ge = int(gap_extend)
    lq, lb = len(query_idx), len(db_idx)
    # Single rolling row over the query dimension, matching the reference's
    # linear-space layout (one row each of H/E/F, length Lq+1).
    h = np.zeros(lq + 1, dtype=np.int64)
    e = np.zeros(lq + 1, dtype=np.int64)
    f = np.zeros(lq + 1, dtype=np.int64)
    best = 0
    for j in range(lb):
        row = table[:, int(db_idx[j])]
        h_diag, e_diag, f_diag = 0, 0, 0  # boundary column = 0
        h_left, e_left, f_left = 0, 0, 0
        for i in range(lq):
            s = int(row[int(query_idx[i])])
            h_up, e_up, f_up = int(h[i + 1]), int(e[i + 1]), int(f[i + 1])
            h_new = max(0, h_diag + s, e_diag + s, f_diag + s)
            e_new = max(0, h_up + go, e_up + ge, f_up + go)
            f_new = max(0, h_left + go, e_left + go, f_left + ge)
            best = max(best, h_new)
            h_diag, e_diag, f_diag = h_up, e_up, f_up
            h_left, e_left, f_left = h_new, e_new, f_new
            h[i + 1], e[i + 1], f[i + 1] = h_new, e_new, f_new
    return int(best)


def sw_score_batch(
    query_idx: np.ndarray,
    db_batch: list[np.ndarray] | np.ndarray,
    table: np.ndarray,
    gap_open: int,
    gap_extend: int,
) -> np.ndarray:
    """Score one query against a batch of database sequences."""
    return np.array(
        [
            sw_score_single(query_idx, db, table, gap_open, gap_extend)
            for db in db_batch
        ],
        dtype=np.int64,
    )
