"""Alignment traceback for the top-k hits: the port's copy of
``seqalign_tpu.ops.traceback``.

The scan is score-only; ``--align`` re-aligns the k best database records
*once* each with a full traceback. This two-phase design keeps the hot scan
linear-space while making alignment output O(k) instead of O(N).

The DP here follows the exact same folded Gotoh recurrence as the engines
(:mod:`.oracle`), so the traceback score always equals the scan score —
asserted by tests. Output is the pair of gapped strings plus a CIGAR.

The fill runs in the native traceback library (``native/traceback.cc``,
built at first use by ``seqalign_tpu_torch.native``), or in NumPy on a host
with no C++ compiler or for a table outside int8. Pairs above
``_DIRECT_CELLS`` are localized first: a forward ends pass, a windowed
reverse one, then the fill of the alignment's rectangle. A pair's route is
written once, as a generator of the passes it needs (``_direct_steps``,
``_localized_steps``): :func:`sw_traceback` runs each pass on the host as
it comes; :func:`topk_alignments` on a CUDA device drives all k hits
together and runs each pass of every hit in one launch of
``csrc/tb_fill.cu`` (``ops.traceback_cuda``). On another device its ends
come from one call of the plain-torch ``sw_wavefront_ends`` where the
table's '*' row and column score at most 0; under BLOSUM62 and PAM250,
which score '*' against '*' +1, from the host's forward pass over each pair
(``_score_ends``: the native ``sw_tb_ends``, one thread).

Spans (``seqalign_tpu_torch.trace``, recorded only under a profiler):
``align``, the whole of :func:`topk_alignments` (counter ``hits``: the hits
asked, at most the records); inside it ``select``, the top-k choice
(``records``); ``ends``, each localization of ends (``cells_host``: a host
pass's rows x columns, the forward pass or the windowed reverse one;
``cells_device``: a launch's pairs' rows x columns, or the wavefront
engine's query residues x the records' residues, no padding); ``fill``,
each traceback-state fill (``cells_host``: its rows x columns: a direct
pair, a localized pair's rectangle, or a rectangle past ``MAX_CELLS`` that
``_myers_miller`` aligns, whose passes step about twice its cells;
``cells_device``: a launch's rows x columns); and ``walk``, the walk back
to the gapped strings and the CIGAR. A launch, its upload and its
download lie inside its span, and no torch op does.

Memory: O(Lq * Lb) bytes (one uint8 state per cell per matrix). For
pathological pairs beyond ``MAX_CELLS`` the caller should band or chunk; the
top-k use case (protein vs protein) is far below the limit.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

from .. import native, trace
from . import traceback_cuda as tbc
from .traceback_cuda import Pass

MAX_CELLS = 1 << 30  # 1G cells * 3 bytes ~ 3 GB hard cap

_lib = None


def _load_native():
    """ctypes handle to native/traceback.cc (None with no C++ compiler)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = native.load("traceback")
    if lib is None:
        return None
    lib.sw_tb_fill.restype = ctypes.c_int64
    lib.sw_tb_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sw_tb_ends.restype = ctypes.c_int64
    lib.sw_tb_ends.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_native() is not None


def _native_for(table):
    """The native library handle, or None when the table is outside its
    int8 envelope (the engines support |score| up to 256 = bf16-exact;
    casting such a table to int8 would silently wrap)."""
    if int(np.abs(np.asarray(table)).max(initial=0)) > 127:
        return None
    return _load_native()


# Module-global growable buffer shared by sequential traceback calls.
# NOT thread-safe: two concurrent sw_traceback calls would receive
# overlapping views. All current callers (CLI --align, pipeline top-k
# re-alignment) run tracebacks sequentially; guard here if that changes.
_states_cache = np.empty(0, dtype=np.uint8)
_STATES_CACHE_CAP = 64 << 20  # don't pin more than 64 MB across calls


def _states_buffer(cells: int) -> np.ndarray:
    """Reusable traceback-state buffer.

    A fresh multi-MB ``np.empty`` can cost more in page faults than the
    whole native fill; reusing one growable buffer across top-k
    re-alignments removes that entirely.
    Oversized requests (up to MAX_CELLS ~ 1 GB) allocate fresh instead of
    pinning that much host memory for the process lifetime.
    """
    global _states_cache
    if cells > _STATES_CACHE_CAP:
        return np.empty(cells, dtype=np.uint8)
    if _states_cache.size < cells:
        _states_cache = np.empty(cells, dtype=np.uint8)
    return _states_cache[:cells]


@dataclass
class Alignment:
    """One local alignment: score, coordinates, gapped strings, CIGAR."""

    score: int
    query_start: int  # 0-based inclusive
    query_end: int  # 0-based exclusive
    db_start: int
    db_end: int
    query_aligned: str
    db_aligned: str
    cigar: str  # M/I/D run-length ops (I = gap in db, consumes query)


def _fill_matrices(q, d, table, go, ge):
    """Fill H/E/F + traceback-state matrices, fully vectorized along ``q``.

    Returns (H, tb_h, tb_e, tb_f, best, best_pos). The only sequential loop
    is over ``d`` rows; within a row the horizontal-gap chain
    ``F[i] = max(0, max(H,E)[i-1]+go, F[i-1]+ge)`` is computed by a
    max-plus prefix scan: with ``B[k] = max(H,E)[k] + go - (k+1)*ge``,
    ``F[i] = max(0, prefix_max(B)[i-1] + i*ge)`` — the zero floor commutes
    with the scan because a floored-to-zero F contributes only candidates
    ``<= ge < 0`` downstream, which the outer ``max(0, .)`` subsumes.
    """
    lq, lb = len(q), len(d)
    H = np.zeros((lb + 1, lq + 1), dtype=np.int64)
    E = np.zeros((lb + 1, lq + 1), dtype=np.int64)
    F = np.zeros((lb + 1, lq + 1), dtype=np.int64)
    # Traceback states: which predecessor matrix fed each cell.
    # 0 = none (terminates at zero floor), 1 = H, 2 = E, 3 = F.
    tb_h = np.zeros((lb + 1, lq + 1), dtype=np.uint8)
    tb_e = np.zeros((lb + 1, lq + 1), dtype=np.uint8)
    tb_f = np.zeros((lb + 1, lq + 1), dtype=np.uint8)

    ramp = np.arange(lq, dtype=np.int64) * ge  # i*ge for the scan un-bias
    best, best_pos = 0, (0, 0)
    for j in range(1, lb + 1):
        srow = table[q, d[j - 1]]  # (lq,)
        hprev, eprev, fprev = H[j - 1], E[j - 1], F[j - 1]

        # H candidates from the diagonal of row j-1.
        diag_h, diag_e, diag_f = hprev[:-1], eprev[:-1], fprev[:-1]
        # max3 with priority H > E > F (matches MAX4 macro order semantics:
        # ties resolved toward H; tie order does not affect scores).
        m_he = np.where(diag_e > diag_h, diag_e, diag_h)
        src_he = np.where(diag_e > diag_h, 2, 1).astype(np.uint8)
        m3 = np.where(diag_f > m_he, diag_f, m_he)
        src3 = np.where(diag_f > m_he, 3, src_he).astype(np.uint8)
        h_val = m3 + srow
        h_src = src3.copy()
        zero_mask = h_val < 0
        h_val = np.where(zero_mask, 0, h_val)
        h_src = np.where(zero_mask, 0, h_src).astype(np.uint8)
        H[j, 1:] = h_val
        tb_h[j, 1:] = h_src

        # E from row j-1 (vertical gap).
        e_h = hprev[1:] + go
        e_e = eprev[1:] + ge
        e_f = fprev[1:] + go
        m_he_e = np.where(e_e > e_h, e_e, e_h)
        src_he_e = np.where(e_e > e_h, 2, 1).astype(np.uint8)
        e_val = np.where(e_f > m_he_e, e_f, m_he_e)
        e_src = np.where(e_f > m_he_e, 3, src_he_e).astype(np.uint8)
        ez = e_val < 0
        E[j, 1:] = np.where(ez, 0, e_val)
        tb_e[j, 1:] = np.where(ez, 0, e_src)

        # F along the row (horizontal gap) via the prefix-max scan.
        hrow, erow = H[j], E[j]
        m_f = np.maximum(hrow[:-1], erow[:-1])  # (lq,) at i-1
        pref = np.maximum.accumulate(m_f + go - ramp)
        f_val = np.maximum(pref + ramp, 0)
        F[j, 1:] = f_val
        # Sources, reconstructed vectorized from the final neighbors:
        # priority H > E > F, 0 when floored (matches the scalar loop).
        fh = hrow[:-1] + go
        fe = erow[:-1] + go
        ff = F[j, :-1] + ge
        s = np.where(fe > fh, 2, 1).astype(np.uint8)
        mhe = np.where(fe > fh, fe, fh)
        s = np.where(ff > mhe, 3, s).astype(np.uint8)
        tb_f[j, 1:] = np.where(f_val == 0, 0, s).astype(np.uint8)

        jmax = int(H[j].argmax())
        if H[j, jmax] > best:
            best = int(H[j, jmax])
            best_pos = (j, jmax)
    return H, tb_h, tb_e, tb_f, best, best_pos


def _score_ends(q, d, table, go, ge):
    """Best score + its (j, i) end cell, linear-space (no traceback state).

    Native when built; NumPy rolling rows otherwise. Positions follow the
    fill's first-encountered rule (j outer ascending, i inner ascending).
    """
    lq, lb = len(q), len(d)
    with trace.span("ends", cells_host=lq * lb):
        lib = _native_for(table)
        if lib is not None:
            q8 = np.ascontiguousarray(q, dtype=np.int8)
            d8 = np.ascontiguousarray(d, dtype=np.int8)
            t8 = np.ascontiguousarray(table, dtype=np.int8)
            bj = ctypes.c_int64()
            bi = ctypes.c_int64()
            best = int(
                lib.sw_tb_ends(
                    q8.ctypes.data, lq, d8.ctypes.data, lb, t8.ctypes.data,
                    go, ge, ctypes.byref(bj), ctypes.byref(bi),
                )
            )
            if best == np.iinfo(np.int64).min:
                raise MemoryError("native ends pass allocation failed")
            return best, (int(bj.value), int(bi.value))
        qv = np.asarray(q, dtype=np.int64)
        ramp = np.arange(lq, dtype=np.int64) * ge
        h_prev = np.zeros(lq + 1, dtype=np.int64)
        e_prev = np.zeros(lq + 1, dtype=np.int64)
        f_prev = np.zeros(lq + 1, dtype=np.int64)
        best, pos = 0, (0, 0)
        for j in range(1, lb + 1):
            srow = table[qv, d[j - 1]]
            m = np.maximum(np.maximum(h_prev[:-1], e_prev[:-1]), f_prev[:-1])
            h = np.zeros(lq + 1, dtype=np.int64)
            h[1:] = np.maximum(m + srow, 0)
            e = np.zeros(lq + 1, dtype=np.int64)
            e[1:] = np.maximum(
                np.maximum(h_prev[1:] + go, e_prev[1:] + ge), f_prev[1:] + go
            )
            e[1:] = np.maximum(e[1:], 0)
            f = np.zeros(lq + 1, dtype=np.int64)
            pref = np.maximum.accumulate(
                np.maximum(h[:-1], e[:-1]) + go - ramp
            )
            f[1:] = np.maximum(pref + ramp, 0)
            rm = int(h.max())
            if rm > best:
                best = rm
                pos = (j, int(h.argmax()))
            h_prev, e_prev, f_prev = h, e, f
        return best, pos


def _fill_states(q, d, table, go, ge):
    """Traceback states ``(lb + 1, lq + 1)`` (row ``j``, column ``i``), the
    best score and its (j, i) cell: the native fill, or NumPy's."""
    lq, lb = len(q), len(d)
    with trace.span("fill", cells_host=lq * lb):
        lib = _native_for(table)
        if lib is not None:
            states = _states_buffer((lb + 1) * (lq + 1)).reshape(lb + 1, lq + 1)
            q8 = np.ascontiguousarray(q, dtype=np.int8)
            d8 = np.ascontiguousarray(d, dtype=np.int8)
            t8 = np.ascontiguousarray(table, dtype=np.int8)
            bj = ctypes.c_int64()
            bi = ctypes.c_int64()
            best = int(
                lib.sw_tb_fill(
                    q8.ctypes.data, lq, d8.ctypes.data, lb, t8.ctypes.data,
                    go, ge, states.ctypes.data,
                    ctypes.byref(bj), ctypes.byref(bi),
                )
            )
            if best == np.iinfo(np.int64).min:
                raise MemoryError("native traceback fill allocation failed")
            return states, best, (int(bj.value), int(bi.value))
        _, tb_h, tb_e, tb_f, best, best_pos = _fill_matrices(q, d, table, go, ge)
        # Pack to the native layout so one walkback serves both paths.
        return tb_h | (tb_e << 2) | (tb_f << 4), best, best_pos


def _host_pass(p: Pass, table, go, ge):
    """Run the pass ``p`` on the host: ``(best, (j, i))`` of the ends, or
    ``(states, best, (j, i))`` of the fill."""
    t = np.ascontiguousarray(table.T) if p.flip else table
    if p.states:
        return _fill_states(np.asarray(p.q, dtype=np.int64),
                            np.asarray(p.d, dtype=np.int64), t, go, ge)
    return _score_ends(p.q, p.d, t, go, ge)


# Above this many cells, localize the alignment first (two linear-space
# score passes) and fill traceback states only for its bounding rectangle.
_DIRECT_CELLS = 4 << 20


def _run_on_host(steps, table, gap_open, gap_extend):
    """Drive the traceback ``steps`` of one pair (a generator of the
    ``Pass``es it needs), each pass on the host; its Alignment."""
    go = int(gap_open) + int(gap_extend)
    ge = int(gap_extend)
    try:
        p = next(steps)
        while True:
            p = steps.send(_host_pass(p, table, go, ge))
    except StopIteration as stop:
        return stop.value


def sw_traceback(
    query_idx: np.ndarray,
    db_idx: np.ndarray,
    table: np.ndarray,
    gap_open: int,
    gap_extend: int,
    query_str: str | None = None,
    db_str: str | None = None,
    end: tuple[int, int] | None = None,
) -> Alignment:
    """Smith-Waterman with affine gaps and traceback.

    Recurrence identical to the engines' (reference ``src/alignment.c:122-161``):
    H folds E/F at the diagonal; all matrices floored at zero. The row sweep
    runs over the SHORTER sequence (gap penalties are symmetric across
    dimensions, so the DP transposes exactly) so the vectorized width is the
    longer one — a 144-residue query vs a 35 kb record fills at full NumPy
    vector efficiency either way round.

    Pairs above ``_DIRECT_CELLS`` use the linear-space recompute: a forward
    score-only pass finds the alignment's end cell, a reverse windowed pass
    finds its start, and the full traceback fill runs only on the
    [start..end] rectangle — O(min(Lq,Lb)) memory for the passes plus
    O(extent^2) for the rectangle, instead of O(Lq*Lb). This removes the
    former 3 GB full-matrix cliff for any realistic pair.
    """
    lq, lb = len(query_idx), len(db_idx)
    if (lq + 1) * (lb + 1) > _DIRECT_CELLS and min(lq, lb) > 0:
        return _localized_traceback(
            query_idx, db_idx, table, gap_open, gap_extend,
            query_str=query_str, db_str=db_str, end=end,
        )
    return _direct_traceback(
        query_idx, db_idx, table, gap_open, gap_extend,
        query_str=query_str, db_str=db_str,
    )


def _traceback_steps(query_idx, db_idx, table, gap_open, gap_extend, query_str=None):
    """:func:`sw_traceback`'s route as steps, for :func:`topk_alignments`
    on the card."""
    lq, lb = len(query_idx), len(db_idx)
    if (lq + 1) * (lb + 1) > _DIRECT_CELLS and min(lq, lb) > 0:
        return _localized_steps(query_idx, db_idx, table, gap_open, gap_extend,
                                query_str=query_str)
    return _direct_steps(query_idx, db_idx, table, gap_open, gap_extend,
                         query_str=query_str)


def _direct_traceback(query_idx, db_idx, table, gap_open, gap_extend,
                      query_str=None, db_str=None) -> Alignment:
    """Full-matrix fill + walkback (see sw_traceback for semantics)."""
    return _run_on_host(
        _direct_steps(query_idx, db_idx, table, gap_open, gap_extend,
                      query_str=query_str, db_str=db_str),
        table, gap_open, gap_extend)


def _localized_traceback(query_idx, db_idx, table, gap_open, gap_extend,
                         query_str=None, db_str=None, end=None) -> Alignment:
    """Linear-space recompute for huge pairs (see sw_traceback docstring)."""
    return _run_on_host(
        _localized_steps(query_idx, db_idx, table, gap_open, gap_extend,
                         query_str=query_str, db_str=db_str, end=end),
        table, gap_open, gap_extend)


def _direct_steps(
    query_idx: np.ndarray,
    db_idx: np.ndarray,
    table: np.ndarray,
    gap_open: int,
    gap_extend: int,
    query_str: str | None = None,
    db_str: str | None = None,
):
    """The full-matrix fill's steps: one fill ``Pass``, whose states are
    sent back, then the walk; returns the Alignment."""
    from ..models.alphabet import decode

    lq, lb = len(query_idx), len(db_idx)
    if (lq + 1) * (lb + 1) > MAX_CELLS:
        raise MemoryError(
            f"traceback matrix {lq+1}x{lb+1} exceeds MAX_CELLS; band or chunk"
        )
    q = np.asarray(query_idx, dtype=np.int64)
    d = np.asarray(db_idx, dtype=np.int64)
    if query_str is None:
        query_str = decode(q)
    if db_str is None:
        db_str = decode(d)

    if lb > lq:
        # Transposed fill: the row loop must run over the SHORTER sequence
        # (here the query) so the vectorized width is the longer one.
        flipped = _walk(*(yield Pass(True, d, q, True)), db_str, query_str)
        return Alignment(
            score=flipped.score,
            query_start=flipped.db_start,
            query_end=flipped.db_end,
            db_start=flipped.query_start,
            db_end=flipped.query_end,
            query_aligned=flipped.db_aligned,
            db_aligned=flipped.query_aligned,
            cigar=flipped.cigar.translate(str.maketrans("ID", "DI")),
        )
    return _walk(*(yield Pass(True, q, d, False)), query_str, db_str)


def _walk(states, best, best_pos, query_str, db_str) -> Alignment:
    """Walk back from the best H cell ``best_pos`` = (j, i) over ``states``
    (row j, column i) to the gapped strings and the CIGAR."""
    with trace.span("walk"):
        j, i = best_pos
        mat = 1  # start in H
        qa, da, ops = [], [], []
        while j > 0 and i > 0:
            st = int(states[j, i])
            if mat == 1:  # H cell: came from diagonal (or terminates)
                src = st & 3
                if src == 0:  # floored cell (H == 0): the alignment starts here
                    break
                qa.append(query_str[i - 1])
                da.append(db_str[j - 1])
                ops.append("M")
                i -= 1
                j -= 1
                mat = src
            elif mat == 2:  # E cell: gap in query dimension... consumes db char
                src = (st >> 2) & 3
                qa.append("-")
                da.append(db_str[j - 1])
                ops.append("D")
                j -= 1
                if src == 0:
                    break
                mat = src
            else:  # F cell: gap in db, consumes query char
                src = (st >> 4) & 3
                qa.append(query_str[i - 1])
                da.append("-")
                ops.append("I")
                i -= 1
                if src == 0:
                    break
                mat = src

        qa.reverse()
        da.reverse()
        ops.reverse()
        # Run-length encode the CIGAR.
        cigar = []
        k = 0
        while k < len(ops):
            r = k
            while r < len(ops) and ops[r] == ops[k]:
                r += 1
            cigar.append(f"{r-k}{ops[k]}")
            k = r
        return Alignment(
            score=best,
            query_start=i,
            query_end=best_pos[1],
            db_start=j,
            db_end=best_pos[0],
            query_aligned="".join(qa),
            db_aligned="".join(da),
            cigar="".join(cigar),
        )


def _localized_steps(
    query_idx: np.ndarray,
    db_idx: np.ndarray,
    table: np.ndarray,
    gap_open: int,
    gap_extend: int,
    query_str: str | None = None,
    db_str: str | None = None,
    end: tuple[int, int] | None = None,
):
    """Linear-space recompute for huge pairs, as steps (see sw_traceback).

    1. Forward score-only pass -> best score + END cell (rolling rows) —
       skipped when the caller supplies ``end`` (e.g. from
       ``sw_wavefront_ends``, one call for all top-k hits).
    2. Reverse score-only pass on the reversed prefixes, windowed by the
       provable extent bound (every aligned db char is either matched —
       bounded by the query extent — or a gap char costing >= |ge|, bounded
       by score/|ge| <= extent * max(table)/|ge|) -> START cell.
    3. Full traceback fill on the [start..end] rectangle only; its local
       optimum must equal the global best (checked; on mismatch the pair
       falls back to the direct full-matrix fill when it fits MAX_CELLS).
    """
    ge = int(gap_extend)
    q = np.asarray(query_idx)
    d = np.asarray(db_idx)
    lq, lb = len(q), len(d)

    def _inconsistent(what: str):
        # Localization produced contradictory scores (e.g. a stale
        # caller-supplied end cell). Recover with the always-correct direct
        # fill when it fits; otherwise fail loudly — a bare assert would be
        # stripped under python -O and return a silently wrong alignment.
        if (lq + 1) * (lb + 1) <= MAX_CELLS:
            return (yield from _direct_steps(
                q, d, table, gap_open, gap_extend,
                query_str=query_str, db_str=db_str,
            ))
        raise RuntimeError(
            f"localized traceback self-check failed ({what}) and the "
            f"{lq+1}x{lb+1} pair exceeds MAX_CELLS for the direct fallback"
        )

    if end is not None:
        ej, ei = int(end[0]), int(end[1])
        best = None  # established by the reverse pass below
    elif lq >= lb:
        # Forward pass, vector width on the longer dimension.
        best, (ej, ei) = yield Pass(False, q, d, False)
    else:
        best, (ei, ej) = yield Pass(False, d, q, True)
    if best == 0 or ej == 0 or ei == 0:
        return Alignment(
            score=0, query_start=0, query_end=0, db_start=0, db_end=0,
            query_aligned="", db_aligned="", cigar="",
        )

    # Reverse pass over the windowed, reversed prefixes.
    smax = max(1, int(np.max(table)))
    gabs = max(1, -ge)
    wq = min(ei, ej + (ej * smax) // gabs + 2)
    wd = min(ej, ei + (ei * smax) // gabs + 2)
    qr = np.ascontiguousarray(q[ei - wq : ei][::-1])
    dr = np.ascontiguousarray(d[ej - wd : ej][::-1])
    if wq >= wd:
        r_best, (rj, ri) = yield Pass(False, qr, dr, False)
    else:
        r_best, (ri, rj) = yield Pass(False, dr, qr, True)
    if best is None:  # caller-supplied end: the reverse pass sets the score
        best = r_best
    if r_best != best:
        return (yield from _inconsistent(
            f"reverse-pass score {r_best} != forward {best}"))
    i0, j0 = ei - ri, ej - rj

    rq, rd = q[i0:ei], d[j0:ej]
    if (len(rq) + 1) * (len(rd) + 1) <= MAX_CELLS:
        sub = yield from _direct_steps(
            rq, rd, table, gap_open, gap_extend,
            query_str=query_str[i0:ei] if query_str is not None else None,
            db_str=db_str[j0:ej] if db_str is not None else None,
        )
    else:
        # The alignment extent itself is huge (cheap gap-extends make
        # whole-sequence LCS-style alignments optimal for big random-ish
        # pairs): Myers-Miller divide-and-conquer in O(min) memory. The
        # optimal local alignment between its own end cells is an optimal
        # *anchored global* alignment of the substrings (the zero floor
        # can only raise H, so no anchored path exceeds it).
        go = int(gap_open) + ge
        with trace.span("fill", cells_host=len(rq) * len(rd)):
            ops = _myers_miller(rq, rd, table, go, ge)
        sub = _alignment_from_ops(
            ops, rq, rd,
            query_str[i0:ei] if query_str is not None else None,
            db_str[j0:ej] if db_str is not None else None,
            go, ge, table,
        )
    if sub.score != best:
        return (yield from _inconsistent(
            f"rectangle score {sub.score} != best {best}"))
    return Alignment(
        score=sub.score,
        query_start=i0 + sub.query_start,
        query_end=i0 + sub.query_end,
        db_start=j0 + sub.db_start,
        db_end=j0 + sub.db_end,
        query_aligned=sub.query_aligned,
        db_aligned=sub.db_aligned,
        cigar=sub.cigar,
    )


# ---------------------------------------------------------------------------
# Myers-Miller linear-space global alignment (for huge anchored rectangles).
# Gap model: a run of k costs go + (k-1)*ge = g + k*h with g = go - ge (pure
# open) and h = ge (per residue). Ops: "M" consumes both, "I" consumes query
# only (gap in db), "D" consumes db only (gap in query).
# ---------------------------------------------------------------------------

_MM_BASE_CELLS = 1 << 21  # dense NW base-case threshold


def _nw_rows(a, b, table, g, h, topflag):
    """Forward global-DP rows: returns (CC, DD) after consuming all of ``a``.

    CC[j] = best global score of a vs b[:j]; DD[j] = best ending in an
    I-run (consuming a). ``topflag`` is the open charge for I-runs starting
    at the top border (g normally, 0 when merged with a glued gap above).
    Vector along b; the in-row D-chain uses the max-plus prefix scan.
    """
    n = len(b)
    NEG = np.int64(-(1 << 60))
    ramp = np.arange(n + 1, dtype=np.int64) * h
    CC = np.empty(n + 1, dtype=np.int64)
    CC[0] = 0
    CC[1:] = g + ramp[1:]
    DD = np.full(n + 1, NEG, dtype=np.int64)
    for i, ach in enumerate(a):
        srow = table[ach, b]  # (n,)
        open_cost = topflag if i == 0 else g
        DD = np.maximum(CC + open_cost, DD) + h
        tmp = np.empty(n + 1, dtype=np.int64)
        tmp[0] = DD[0]  # column 0: vertical only
        tmp[1:] = np.maximum(CC[:-1] + srow, DD[1:])
        pref = np.maximum.accumulate(tmp[:-1] + g - ramp[:-1])
        newCC = tmp.copy()
        newCC[1:] = np.maximum(tmp[1:], pref + ramp[1:])
        CC = newCC
    return CC, DD


def _mm_one_row(a0, b, table, g, h, tb, te, ops):
    """Analytic m == 1 base: one query char vs b, flag-aware."""
    n = len(b)
    gap = lambda x: g + h * x if x > 0 else 0
    svec = table[a0, b].astype(np.int64)
    ks = np.arange(n, dtype=np.int64)
    cand = (
        np.where(ks > 0, g + h * ks, 0)
        + svec
        + np.where(n - 1 - ks > 0, g + h * (n - 1 - ks), 0)
    )
    k = int(np.argmax(cand))
    best_match = int(cand[k])
    best_del = min(tb, te) + h + gap(n)
    if best_match >= best_del:
        ops.extend("D" * k)
        ops.append("M")
        ops.extend("D" * (n - 1 - k))
    elif tb <= te:  # merge the lone deletion with the glue above
        ops.append("I")
        ops.extend("D" * n)
    else:
        ops.extend("D" * n)
        ops.append("I")


def _mm_rec(a, b, table, g, h, tb, te, ops):
    """Myers-Miller recursion: append ops for the global alignment of a vs b.

    ``tb``/``te``: open charge for I-runs touching the top/bottom border
    (0 when the parent glued a deletion there — the merged run's open is
    already paid; concatenated-ops re-scoring makes the accounting real).
    """
    m, n = len(a), len(b)
    if m == 0:
        ops.extend("D" * n)
        return
    if n == 0:
        ops.extend("I" * m)
        return
    if m == 1:
        _mm_one_row(int(a[0]), b, table, g, h, tb, te, ops)
        return
    if (m + 1) * (n + 1) <= _MM_BASE_CELLS:
        _nw_dense(a, b, table, g, h, tb, te, ops)
        return
    im = m // 2
    CC_f, DD_f = _nw_rows(a[:im], b, table, g, h, tb)
    CC_r, DD_r = _nw_rows(
        np.ascontiguousarray(a[im:][::-1]),
        np.ascontiguousarray(b[::-1]),
        table, g, h, te,
    )
    t1 = CC_f + CC_r[::-1]
    t2 = DD_f + DD_r[::-1] - g  # merged crossing I-run: refund one open
    j1 = int(np.argmax(t1))
    j2 = int(np.argmax(t2))
    if t1[j1] >= t2[j2]:
        _mm_rec(a[:im], b[:j1], table, g, h, tb, g, ops)
        _mm_rec(a[im:], b[j1:], table, g, h, g, te, ops)
    else:
        _mm_rec(a[: im - 1], b[:j2], table, g, h, tb, 0, ops)
        ops.extend("II")  # the crossing deletion pair around the split row
        _mm_rec(a[im + 1 :], b[j2:], table, g, h, 0, te, ops)


def _nw_dense(a, b, table, g, h, tb, te, ops):
    """Dense global-NW traceback base case (flag-aware, full state matrix)."""
    m, n = len(a), len(b)
    NEG = -(1 << 60)
    H = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    V = np.full((m + 1, n + 1), NEG, dtype=np.int64)  # ends in I (consumes a)
    W = np.full((m + 1, n + 1), NEG, dtype=np.int64)  # ends in D (consumes b)
    H[0, 0] = 0
    for j in range(1, n + 1):
        W[0, j] = g + h * j
        H[0, j] = W[0, j]
    for i in range(1, m + 1):
        open_i = tb if i == 1 else g
        for j in range(n + 1):
            V[i, j] = max(H[i - 1, j] + open_i + h, V[i - 1, j] + h)
            if j > 0:
                W[i, j] = max(H[i, j - 1] + g + h, W[i, j - 1] + h)
                diag = H[i - 1, j - 1] + int(table[a[i - 1], b[j - 1]])
                H[i, j] = max(diag, V[i, j], W[i, j])
            else:
                H[i, j] = V[i, j]
    # Terminal state: an I-run ending at the bottom-right corner may merge
    # with a glued deletion below (te refund). A run spanning ALL rows was
    # charged tb (not g) at its open, so handle those shapes analytically.
    end_h = H[m, n]
    end_v = V[m, n] - g + te  # swap the run's open charge g -> te
    full_run = min(tb, te) + h * m + (g + h * n if n > 0 else 0)
    if full_run > max(end_h, end_v):
        if tb <= te:  # I-column first (merges above), then the D-run
            ops.extend("I" * m)
            ops.extend("D" * n)
        else:
            ops.extend("D" * n)
            ops.extend("I" * m)
        return
    state = "V" if end_v > end_h else "H"
    # Walk back.
    i, j = m, n
    out = []
    st = state
    while i > 0 or j > 0:
        if st == "V":
            out.append("I")
            # did this run start here?
            prev_open = tb if i == 1 else g
            if i >= 1 and V[i, j] == H[i - 1, j] + prev_open + h:
                st = "H"
            i -= 1
        elif st == "W":
            out.append("D")
            if j >= 1 and W[i, j] == H[i, j - 1] + g + h:
                st = "H"
            j -= 1
        else:
            if i == 0:
                out.append("D")
                j -= 1
                continue
            if j == 0:
                st = "V"
                continue
            diag = H[i - 1, j - 1] + int(table[a[i - 1], b[j - 1]])
            if H[i, j] == diag:
                out.append("M")
                i -= 1
                j -= 1
            elif H[i, j] == V[i, j]:
                st = "V"
            else:
                st = "W"
    ops.extend(reversed(out))


def _myers_miller(q, d, table, go, ge):
    """Ops ('M'/'I'/'D') of an optimal anchored global alignment of q vs d."""
    g = int(go) - int(ge)
    h = int(ge)
    a = np.ascontiguousarray(q, dtype=np.int64)
    b = np.ascontiguousarray(d, dtype=np.int64)
    ops: list[str] = []
    _mm_rec(a, b, table, g, h, g, g, ops)
    return ops


def _alignment_from_ops(ops, q, d, query_str, db_str, go, ge, table):
    """Build an Alignment (strings, cigar, re-scored) from global ops."""
    from ..models.alphabet import decode

    if query_str is None:
        query_str = decode(np.asarray(q))
    if db_str is None:
        db_str = decode(np.asarray(d))
    with trace.span("walk"):
        qa, da = [], []
        qi = di = 0
        score = 0
        prev = None
        for op in ops:
            if op == "M":
                qa.append(query_str[qi])
                da.append(db_str[di])
                score += int(table[q[qi], d[di]])
                qi += 1
                di += 1
            elif op == "I":
                qa.append(query_str[qi])
                da.append("-")
                score += go if prev != "I" else ge
                qi += 1
            else:
                qa.append("-")
                da.append(db_str[di])
                score += go if prev != "D" else ge
                di += 1
            prev = op
        cigar = []
        k = 0
        while k < len(ops):
            r = k
            while r < len(ops) and ops[r] == ops[k]:
                r += 1
            cigar.append(f"{r - k}{ops[k]}")
            k = r
        return Alignment(
            score=score,
            query_start=0,
            query_end=qi,
            db_start=0,
            db_end=di,
            query_aligned="".join(qa),
            db_aligned="".join(da),
            cigar="".join(cigar),
        )


def align_pair(
    seq_a: str,
    seq_b: str,
    scoring,
) -> Alignment:
    """Align two sequences directly (the upstream seq-align use case the
    reference specialized away). Convenience wrapper over sw_traceback."""
    qa = scoring.query_indices(seq_a)
    from ..models.alphabet import encode

    return sw_traceback(
        qa,
        encode(seq_b),
        scoring.table,
        scoring.gap_open,
        scoring.gap_extend,
        query_str=seq_a,
        db_str=seq_b,
    )


def _batched_engine_ends(query_idx, db, recs, table, gap_open, gap_extend,
                         device):
    """Localize alignment ENDS for several records in one call of the
    wavefront ends engine (``swa_torch.sw_wavefront_ends``) on ``device``,
    in place of a host forward pass over each pair. Returns {record:
    (end_j, end_i)}, or None when the scoring table's '*' pad column could
    outscore real residues (the padded lanes would then move the ends). A
    failure on the device raises.
    """
    import torch

    from ..models.alphabet import PAD_INDEX
    from .swa_torch import make_profile, sw_wavefront_ends

    t = np.asarray(table)
    if t[PAD_INDEX, :].max() > 0 or t[:, PAD_INDEX].max() > 0:
        return None
    seqs = [db.record(int(r)) for r in recs]
    with trace.span("ends",
                    cells_device=len(query_idx) * sum(len(s) for s in seqs)):
        lb = -(-max(len(s) for s in seqs) // 256) * 256
        dbm = np.full((lb, len(recs)), PAD_INDEX, dtype=np.int32)
        for kth, s in enumerate(seqs):
            dbm[: len(s), kth] = s
        prof = torch.from_numpy(make_profile(t, query_idx)).to(device)
        go = int(gap_open) + int(gap_extend)
        _, bj, bi = sw_wavefront_ends(
            prof, torch.from_numpy(dbm).to(device), go, int(gap_extend)
        )
        bj, bi = bj.cpu().numpy(), bi.cpu().numpy()
    return {int(r): (int(bj[kth]), int(bi[kth])) for kth, r in enumerate(recs)}


def _run_on_card(steps: list, table, gap_open, gap_extend, device) -> list:
    """Drive several pairs' traceback ``steps`` together: every pending
    ends pass in one launch of ``csrc/tb_fill.cu`` (the ends first, so
    that the fills wait for them and go together), then every pending
    fill; a pass the kernel cannot take exactly (``traceback_cuda.fits``)
    runs on the host. Each launch, its upload and its download lie inside
    one ``ends`` or ``fill`` span, counted as ``cells_device``. Returns the
    Alignments in the order of ``steps``."""
    go = int(gap_open) + int(gap_extend)
    ge = int(gap_extend)
    done = [None] * len(steps)
    waiting = {}

    def advance(k, result):
        try:
            waiting[k] = steps[k].send(result)
        except StopIteration as stop:
            done[k] = stop.value

    for k in range(len(steps)):
        advance(k, None)
    while waiting:
        states = all(p.states for p in waiting.values())
        card = []
        for k in sorted(k for k, p in waiting.items() if p.states == states):
            p = waiting.pop(k)
            if tbc.fits(p, table, go, ge):
                card.append((k, p))
            else:
                advance(k, _host_pass(p, table, go, ge))
        keys = iter(k for k, _ in card)
        for batch in tbc.batches([p for _, p in card], states):
            launch = tbc.plan(batch, table, states)
            prepared = tbc.prepare(launch, device)
            cells = sum(len(p.q) * len(p.d) for p in batch)
            with trace.span("fill" if states else "ends", cells_device=cells):
                found = tbc.run(launch, prepared, go, ge)
            del prepared
            for result in found:  # walks the states before the next launch
                advance(next(keys), result)
    return done


def topk_alignments(
    query_idx: np.ndarray,
    db,
    scores: np.ndarray,
    k: int,
    table: np.ndarray,
    gap_open: int,
    gap_extend: int,
    query_str: str | None = None,
    engine_ends: bool | None = None,
    device=None,
) -> list[tuple[int, Alignment]]:
    """Re-align the k best-scoring database records with traceback.

    ``db`` is an EncodedDatabase (or anything with ``record(i)``); returns
    [(record_id, Alignment)] sorted by descending score (stable).

    ``device`` defaults to ``device.resolve_device()``, the search's. On a
    CUDA device the hits' dynamic-programming passes run on the card
    (:func:`_run_on_card`), each pass of every hit in one launch; the walks
    stay on the host. On another device, ``engine_ends`` None (auto)
    localizes the ends of the pairs beyond the direct-fill threshold in one
    call of the wavefront ends engine on ``device``. ``engine_ends=False``
    keeps every pass on the host, on any device.
    """
    n = len(scores)
    with trace.span("align", hits=min(k, n)):
        with trace.span("select", records=n):
            order = np.argsort(-np.asarray(scores), kind="stable")[:k]
        recs = [int(r) for r in order]
        card = _card(device) if engine_ends is not False else None
        if card is not None:
            found = _run_on_card(
                [_traceback_steps(query_idx, db.record(rec), table, gap_open,
                                  gap_extend, query_str=query_str) for rec in recs],
                table, gap_open, gap_extend, card)
            return list(zip(recs, found))
        ends: dict[int, tuple[int, int]] = {}
        if engine_ends is not False:
            lq = len(query_idx)
            big = [
                r for r in recs
                if (len(db.record(r)) + 1) * (lq + 1) > _DIRECT_CELLS
            ]
            if big:
                if device is None:
                    from ..device import resolve_device

                    device = resolve_device()
                ends = _batched_engine_ends(
                    query_idx, db, big, table, gap_open, gap_extend, device
                ) or {}
        out = []
        for rec in recs:
            aln = sw_traceback(
                query_idx,
                db.record(rec),
                table,
                gap_open,
                gap_extend,
                query_str=query_str,
                end=ends.get(rec),
            )
            out.append((rec, aln))
        return out


def _card(device):
    """``device`` (None: the search's default, where a card is present) if
    it is a CUDA device, else None."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        from ..device import resolve_device

        device = resolve_device()
    device = torch.device(device)
    return device if device.type == "cuda" else None
