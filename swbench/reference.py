"""The plain reference: best local-alignment scores under affine gaps.

Smith-Waterman with Gotoh's affine gaps, written from the recurrence and
nothing else; it imports nothing of the program. With ``o`` the cost of a
gap's first residue (``-(gap_open + gap_extend)``) and ``e`` the cost of
each further one (``-gap_extend``), query row ``i``, database position
``j`` and substitution score ``s(i, j)``:

    F[i, j] = max(H[i-1, j] - o, F[i-1, j] - e)        gap along the query
    E[i, j] = max(H[i, j-1] - o, E[i, j-1] - e)        gap along the record
    H[i, j] = max(0, H[i-1, j-1] + s(i, j), E[i, j], F[i, j])
    score   = max over i, j of H[i, j]

with H = 0 and E = F = -inf outside the matrix. Rows are computed one
after another for every record at once, the records laid end to end. E is
the only dependency along a row, and it needs no loop: with
``Hp = max(0, H[i-1, j-1] + s, F)``,

    E[i, j] = max over k < j of (Hp[i, k] + k e) - o - (j - 1) e

since a gap opened from a cell whose H came from E costs more than
extending that E (``o >= e``). That maximum is a cumulative max, kept
within each record by adding a large multiple of the record's number, and
taken in two levels (within pieces of ``_PIECE`` residues, then across
pieces) so that it runs in parallel over many rows. Everything is int64:
no score is rounded or saturated, unless ``bits`` asks for the scores of a
saturating signed integer of that width (the control of ``correct``). Then
``H[i-1, j-1] + s(i, j)`` stops at ``2**(bits-1) - 1``, the only sum that
can pass it (E and F lie at least ``o`` below an H, and no sum
that falls below 0 matters), so a score is the exact one or, where
that passes the top, the top.
"""

from __future__ import annotations

import numpy as np
import torch

# Records are kept apart in the cumulative max by this many bits of
# offset each; a row's values within a record stay far below it.
_SEGMENT_SHIFT = 32
_PIECE = 512


def _running_max(x: torch.Tensor) -> torch.Tensor:
    """The cumulative max of ``x`` along its last axis, whose length is a
    multiple of ``_PIECE``."""
    rows, t = x.shape
    within = torch.cummax(x.view(rows, t // _PIECE, _PIECE), dim=2).values
    carried = torch.cummax(within[:, :, -1], dim=1).values
    before = torch.cat([carried.new_full((rows, 1), torch.iinfo(torch.int64).min),
                        carried[:, :-1]], dim=1)
    return torch.maximum(within, before.unsqueeze(2)).view(rows, t)


def sw_scores(
    queries: list[np.ndarray],
    seq: np.ndarray,
    lengths: np.ndarray,
    table: np.ndarray,
    gap_open: int,
    gap_extend: int,
    device: torch.device | str = "cpu",
    bits: int | None = None,
) -> np.ndarray:
    """``(len(queries), len(lengths))`` int64 best scores of each query
    (residue codes) against each record, the records' residues ``seq``
    laid end to end with ``lengths`` (each at least 1). A gap of ``k``
    residues costs ``-(gap_open + k * gap_extend)``; both are at most 0.
    ``bits``: the width of the saturating integers to score in, or None
    for exact scores."""
    o, e = -(int(gap_open) + int(gap_extend)), -int(gap_extend)
    if e < 0 or o < e:
        raise ValueError(f"gap costs open {o}, extend {e}: need open >= extend >= 0")
    lengths = np.asarray(lengths, dtype=np.int64)
    if (lengths < 1).any() or int(lengths.sum()) != len(seq):
        raise ValueError("record lengths must be positive and sum to the residues given")
    nq, n = len(queries), len(lengths)
    lq = max((len(q) for q in queries), default=0)
    if nq == 0 or n == 0 or lq == 0:
        return np.zeros((nq, n), dtype=np.int64)
    tab = torch.as_tensor(np.asarray(table, dtype=np.int64), device=device)
    if int(tab.abs().max()) * lq + int(lengths.max()) * (e + 1) >= 1 << (_SEGMENT_SHIFT - 2):
        raise ValueError("scores could reach the records' separation in the cumulative max")
    dev = tab.device
    # A last record of padding makes the residues a whole number of pieces;
    # its scores are dropped.
    tail = -len(seq) % _PIECE
    codes = torch.as_tensor(np.concatenate([np.asarray(seq, dtype=np.int64),
                                            np.zeros(tail, np.int64)]), device=dev)
    lens = torch.as_tensor(np.append(lengths, tail) if tail else lengths, device=dev)
    record = torch.repeat_interleave(torch.arange(len(lens), device=dev), lens)
    starts = torch.cumsum(lens, 0) - lens
    pos = torch.arange(len(codes), device=dev) - starts[record]  # k, within its record
    first = pos == 0
    # a_k = Hp + k e + record offset; E_j = max_{k<j} a_k + ebase_j.
    abase = pos * e + (record << _SEGMENT_SHIFT)
    ebase = -(record << _SEGMENT_SHIFT) - o - (pos - 1) * e
    neg = -(1 << 40)
    top = (1 << (bits - 1)) - 1 if bits else None
    # Row i's scores for every residue: table[q_i, :] gathered along the
    # records, as (32, T) so that a row of queries is one index_select.
    by_residue = tab[:, codes]
    qrows = torch.zeros((nq, lq), dtype=torch.int64)
    live = torch.zeros((nq, lq), dtype=torch.bool)
    for k, q in enumerate(queries):
        qrows[k, : len(q)] = torch.as_tensor(np.asarray(q, dtype=np.int64))
        live[k, : len(q)] = True
    qrows, live = qrows.to(dev), live.to(dev)

    shape = (nq, len(codes))
    h = torch.zeros(shape, dtype=torch.int64, device=dev)
    f = torch.full(shape, neg, dtype=torch.int64, device=dev)
    best = torch.zeros(shape, dtype=torch.int64, device=dev)
    for i in range(lq):
        f = torch.maximum(h - o, f - e)
        diag = torch.roll(h, 1, dims=1).masked_fill_(first, 0)
        hp = torch.maximum(diag + by_residue.index_select(0, qrows[:, i]), f).clamp_(0, top)
        run = _running_max(hp + abase)
        gap = (torch.roll(run, 1, dims=1) + ebase).masked_fill_(first, neg)
        h = torch.maximum(hp, gap)
        best = torch.where(live[:, i : i + 1], torch.maximum(best, h), best)
    out = torch.zeros((nq, len(lens)), dtype=torch.int64, device=dev)
    out.scatter_reduce_(1, record.expand(nq, -1), best, reduce="amax")
    return out[:, :n].cpu().numpy()
