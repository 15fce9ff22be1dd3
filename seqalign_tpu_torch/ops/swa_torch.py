"""Plain PyTorch Smith-Waterman affine-gap engines (no custom kernel).

The counterparts of ``seqalign_tpu.ops.swa_xla``, written as eager PyTorch
on int32 tensors of any device:

- :func:`sw_scan`: a loop over database positions with an inner loop over
  query positions carrying the rolling H/E/F rows, the reference's own
  loop nest. Exact and very sequential; a readable second implementation
  for small inputs.
- :func:`sw_wavefront`: marches anti-diagonals ``d = i + j``; every cell of
  a diagonal is independent, so each step is one vector op over
  ``(Lq, B)``. The engine the pipeline routes to when the stream kernel's
  scoring guard rejects a system.
- :func:`sw_wavefront_ends`: the wavefront that also reports a best cell
  per lane, which localizes the top hits' alignments for the traceback
  (``ops.traceback``). The JAX package computes it in XLA, not in a
  Pallas kernel, so this plain version is its counterpart on the card.

Conventions (shared with the JAX package):
- ``profile``: ``(Lq, 32)`` int32 query profile, ``profile[i, c] =
  table[query[i], c]`` (see :func:`make_profile`).
- ``db``: ``(Lb, B)`` int database batch, position-major / lane-minor,
  padded with ``PAD_INDEX`` ('*').
- ``go``/``ge``: *total* gap-open (``gap_open + gap_extend``) and gap-extend
  penalties, negative ints. The NumPy oracle takes ``gap_open`` and
  ``gap_extend`` separately instead.
- returns ``(B,)`` int32 best local-alignment score per lane.
"""

from __future__ import annotations

import numpy as np
import torch


def make_profile(table: np.ndarray, query_idx: np.ndarray) -> np.ndarray:
    """Build the (Lq, 32) int32 query profile: ``P[i, c] = table[q_i, c]``."""
    return np.asarray(table, dtype=np.int32)[np.asarray(query_idx)]


def sw_scan(
    profile: torch.Tensor, db: torch.Tensor, go: int, ge: int
) -> torch.Tensor:
    """Exact-work double-loop engine. See module docstring for conventions."""
    profile = profile.to(torch.int32)
    db = db.to(torch.int32)
    lq = profile.shape[0]
    lb, b = db.shape
    zero = torch.zeros(b, dtype=torch.int32, device=db.device)
    h_rows = [zero] * lq
    e_rows = [zero] * lq
    f_rows = [zero] * lq
    best = zero
    for j in range(lb):
        s_rows = profile[:, db[j].long()]  # (Lq, B)
        h_diag = e_diag = f_diag = zero
        h_left = e_left = f_left = zero
        for i in range(lq):
            h_up, e_up, f_up = h_rows[i], e_rows[i], f_rows[i]
            diag = torch.maximum(torch.maximum(h_diag, e_diag), f_diag)
            h_new = torch.clamp_min(diag + s_rows[i], 0)
            e_new = torch.clamp_min(
                torch.maximum(torch.maximum(h_up, f_up) + go, e_up + ge), 0
            )
            f_new = torch.clamp_min(
                torch.maximum(torch.maximum(h_left, e_left) + go, f_left + ge),
                0,
            )
            best = torch.maximum(best, h_new)
            h_diag, e_diag, f_diag = h_up, e_up, f_up
            h_left, e_left, f_left = h_new, e_new, f_new
            h_rows[i], e_rows[i], f_rows[i] = h_new, e_new, f_new
    return best


def sw_wavefront(
    profile: torch.Tensor, db: torch.Tensor, go: int, ge: int
) -> torch.Tensor:
    """Anti-diagonal wavefront engine: one vector step per diagonal.

    On diagonal ``d``, query position ``i`` holds cell ``(i, j=d-i)``.
    Dependencies: F needs ``(i-1, j)`` = diagonal ``d-1`` shifted by one in
    ``i``; E needs ``(i, j-1)`` = diagonal ``d-1`` unshifted; H needs
    ``max(H,E,F)`` at ``(i-1, j-1)`` = diagonal ``d-2`` shifted. Invalid
    cells (``j`` outside ``[0, Lb)``) are masked to zero, which reproduces
    the zero boundary row/column of local alignment for free.
    """
    return _wavefront(profile, db, go, ge, track_ends=False)


def sw_wavefront_ends(
    profile: torch.Tensor, db: torch.Tensor, go: int, ge: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Wavefront engine variant that also reports a best cell per lane.

    Returns ``(best, end_j, end_i)``, each ``(B,)`` int32: 1-based
    coordinates (database position, query position) of a maximal H cell, 0
    where ``best == 0``. The tie rule is the JAX package's: a later
    diagonal updates only on a strictly greater value, and within a
    diagonal the smallest query index wins. ``sw_wavefront_ends.calls``
    counts the calls.
    """
    sw_wavefront_ends.calls += 1
    return _wavefront(profile, db, go, ge, track_ends=True)


sw_wavefront_ends.calls = 0


def _wavefront(profile, db, go, ge, track_ends: bool):
    """The anti-diagonal body of :func:`sw_wavefront` and
    :func:`sw_wavefront_ends` (``track_ends`` also carries each lane's
    best cell)."""
    profile = profile.to(torch.int32)
    db = db.to(torch.int32)
    dev = db.device
    lq = profile.shape[0]
    lb, b = db.shape
    best = torch.zeros(b, dtype=torch.int32, device=dev)
    bj = torch.zeros(b, dtype=torch.int32, device=dev)
    bi = torch.zeros(b, dtype=torch.int32, device=dev)
    if lq == 0 or lb == 0:
        return (best, bj, bi) if track_ends else best
    iota_i = torch.arange(lq, device=dev)
    col_i = iota_i.to(torch.int32)[:, None]
    zrow = torch.zeros((1, b), dtype=torch.int32, device=dev)

    def shift(x):  # out[i] = x[i-1], out[0] = 0
        return torch.cat([zrow, x[:-1]], dim=0)

    z = torch.zeros((lq, b), dtype=torch.int32, device=dev)
    h1, e1, f1, t2 = z, z, z, z  # 1 = diagonal d-1, t2 = max3 at d-2
    for d in range(lq + lb - 1):
        j = d - iota_i
        valid = ((j >= 0) & (j < lb))[:, None]
        db_diag = db[j.clamp(0, lb - 1)].long()  # (Lq, B)
        s = torch.gather(profile, 1, db_diag)
        h_new = torch.clamp_min(shift(t2) + s, 0)
        e_new = torch.clamp_min(
            torch.maximum(torch.maximum(h1, f1) + go, e1 + ge), 0
        )
        f_new = torch.clamp_min(
            torch.maximum(
                torch.maximum(shift(h1), shift(e1)) + go, shift(f1) + ge
            ),
            0,
        )
        h_new = torch.where(valid, h_new, 0)
        e_new = torch.where(valid, e_new, 0)
        f_new = torch.where(valid, f_new, 0)
        # The next step's "two-diagonals-back" max3 is this step's d-1 max3.
        t2 = torch.maximum(torch.maximum(h1, e1), f1)
        colbest = h_new.amax(dim=0)
        if track_ends:
            # The first (smallest i) maximum of the diagonal, and only a
            # strictly greater value than the lane's best so far.
            coli = torch.where(h_new == colbest, col_i, lq).amin(dim=0)
            upd = colbest > best
            bi = torch.where(upd, coli + 1, bi)
            bj = torch.where(upd, d - coli + 1, bj)
        best = torch.maximum(best, colbest)
        h1, e1, f1 = h_new, e_new, f_new
    return (best, bj, bi) if track_ends else best
