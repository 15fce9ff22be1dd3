"""Database batch packing: length sort, lane batching, bucketed padding.

The port's copy of ``seqalign_tpu.utils.packing``; the window streams it
packs feed the port's stream kernels as they fed the TPU's.

The reference packs 16 database sequences per AVX2 vector in lane-major
layout and *assumes* the database is pre-sorted by descending length
(``src/alignment_cmdline.c:429-450``, SURVEY.md §7.3). On TPU the lane batch
is 1024 (8 sublanes x 128 lanes of int32) per vector step, so padding waste
management matters far more. This module therefore:

- actually sorts (stable, descending length) instead of assuming sorted input
  — score-identical because '*'-padding never changes a score (asserted via
  ``ScoringModel.pad_column_is_nonpositive``);
- packs lane-batches position-major (``db[pos, lane]``), padded with '*';
- rounds every padded length up to a geometric lattice so the number of
  distinct compiled kernel shapes stays O(log max_len) for the whole run.

Short sequences are grouped together by the sort, so per-batch padding is
bounded by the lattice ratio (25%) instead of the longest database sequence.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from ..models.alphabet import PAD_INDEX

# Geometric length lattice: multiples of 8 up to 64, then ~1.25x steps.
_LATTICE: list[int] = [8, 16, 24, 32, 40, 48, 56, 64]
_v = 64
while _v < 1 << 26:
    _v = int(np.ceil(_v * 1.25 / 8) * 8)
    _LATTICE.append(_v)


def lattice_round_up(n: int) -> int:
    """Round a length up to the compile-shape lattice (multiple of 8)."""
    if n <= 0:
        return _LATTICE[0]
    for v in _LATTICE:
        if v >= n:
            return v
    raise ValueError(f"sequence length {n} exceeds lattice maximum")


@dataclass
class PackedBatch:
    """One lane-batch of encoded database sequences, ready for an engine."""

    db: np.ndarray  # (Lb_pad, lanes) int8, '*'-padded
    n_valid: int  # lanes actually holding real sequences
    record_ids: np.ndarray  # (n_valid,) original stream positions


def pack_encoded(
    encoded: Sequence[np.ndarray],
    lanes: int,
    sort: bool = True,
) -> Iterator[PackedBatch]:
    """Pack encoded sequences into '*'-padded lane-batches.

    Args:
      encoded: per-record int index arrays (any int dtype, values 0..31).
      lanes: lane-batch width (reference uses 16; TPU kernel uses 1024).
      sort: length-sort (descending, stable) before batching. Disable only
        for inputs already sorted (reference-compatible mode).
    """
    n = len(encoded)
    if n == 0:
        return
    order = np.arange(n)
    if sort:
        lengths = np.fromiter((len(e) for e in encoded), dtype=np.int64, count=n)
        order = np.argsort(-lengths, kind="stable")
    for start in range(0, n, lanes):
        ids = order[start : start + lanes]
        group = [encoded[i] for i in ids]
        max_len = max((len(g) for g in group), default=1)
        lb_pad = lattice_round_up(max(max_len, 1))
        db = np.full((lb_pad, lanes), PAD_INDEX, dtype=np.int8)
        for lane, g in enumerate(group):
            db[: len(g), lane] = g
        yield PackedBatch(db=db, n_valid=len(group), record_ids=ids)


@dataclass
class StreamPack:
    """A whole database packed as NW segmented window streams.

    Input format of the single-dispatch segmented Pallas kernel
    (``ops.swa_pallas.sw_pallas_stream``): each window stream is a
    back-to-back concatenation of '*'-padded lane-group segments; ``fs``
    tells the kernel where segments end (flush + reset). This replaces the
    reference's stream of OpenMP batch dispatches
    (``src/alignment_cmdline.c:501-527``) with one device launch.
    """

    streams: np.ndarray  # (nw, L, win) int8, '*'-padded
    fs: np.ndarray  # (L//jb, nw, 2) int32 segment table (see kernel)
    slot_ids: list[np.ndarray]  # per output slot: original record ids
    real_residues: int
    padded_cells_per_query_row: int  # nw * L * win (perf accounting)


@dataclass
class StreamPlan:
    """Where :func:`pack_streams` puts every record, before any byte moves.

    Slot ``s`` holds the records ``order[s*win : (s+1)*win]`` (lane ``l``
    the ``l``-th of them) at positions ``[slot_start[s], slot_start[s] +
    slot_lb[s])`` of stream ``slot_w[s]``; every other position of a stream,
    up to ``L``, is '*' padding. ``fs`` is the segment table the kernel
    reads. The plan is host work; :func:`pack_streams` fills it on the host,
    ``ops.pack_cuda.pack_streams_device`` on the card.
    """

    order: np.ndarray  # record ids in packing order
    nw: int
    win: int
    jb: int
    L: int
    slot_w: np.ndarray  # (nslots,) int64 stream of each slot
    slot_start: np.ndarray  # (nslots,) int64 its first position there
    slot_lb: np.ndarray  # (nslots,) int64 its positions (a grain multiple)
    fs: np.ndarray  # (L//jb, nw, 2) int32 segment table (see kernel)
    real_residues: int
    padded_cells_per_query_row: int  # nw * L * win (perf accounting)

    @property
    def slot_ids(self) -> list[np.ndarray]:
        """Per output slot: original record ids."""
        return [self.order[s * self.win : (s + 1) * self.win]
                for s in range(len(self.slot_lb))]


def plan_streams(
    lengths: np.ndarray,
    order: np.ndarray,
    nw: int,
    win: int = 1024,
    jb: int = 4,
    grain: int = 32,
    target_len: int | None = None,
) -> StreamPlan:
    """Place lane-groups of a sorted database on NW balanced window streams.

    Args:
      lengths: every record's residue count (``EncodedDatabase.lengths``).
      order, nw, win, jb, grain, target_len: as :func:`pack_streams`.

    Lane-groups of ``win`` consecutive records (descending length, so
    near-uniform within a group) become segments; segments are dealt to the
    currently-shortest stream, the lowest-numbered of equals (greedy
    balancing — they arrive in descending length order, so streams end
    within one segment of each other).
    """
    if grain % jb:
        raise ValueError(f"{grain=} must be a multiple of {jb=}")
    order = np.asarray(order)
    n = len(order)
    nslots = -(-n // win)
    seg = lengths[order].astype(np.int64)
    top = np.maximum.reduceat(seg, np.arange(0, n, win)) if n else seg
    slot_lb = np.maximum(-(-top // grain) * grain, grain)
    # Greedy balance: place each segment on the shortest stream (a heap of
    # (length, stream) pops the lowest stream of equal lengths).
    heap = [(0, w) for w in range(nw)]
    slot_w = np.zeros(nslots, np.int64)
    slot_start = np.zeros(nslots, np.int64)
    for s, lb in enumerate(slot_lb.tolist()):
        off, w = heap[0]
        slot_w[s], slot_start[s] = w, off
        heapq.heapreplace(heap, (off + lb, w))
    L = max(max(off for off, _ in heap), grain)
    if target_len is not None:
        if target_len < L or target_len % jb:
            raise ValueError(
                f"{target_len=} must be a jb multiple >= natural length {L}"
            )
        L = target_len
    else:
        # Round up with ~3% granularity (multiples of grain) so kernel
        # shapes recur across similar databases without meaningful padding
        # (tail padding is real DP work; the coarse geometric lattice used
        # for per-batch shapes wastes up to 25% here).
        step = max(grain, (L >> 5) // grain * grain)
        L = -(-L // step) * step
    fs = np.zeros((L // jb, nw, 2), dtype=np.int32)
    # A segment that starts after another on its stream flushes that one
    # at its first block; each stream's last segment flushes at the end.
    slots = np.arange(nslots)
    by_stream = np.lexsort((slot_start, slot_w))
    w_sorted = slot_w[by_stream]
    same = w_sorted[1:] == w_sorted[:-1]
    later = np.flatnonzero(same) + 1
    fs[slot_start[by_stream[later]] // jb, w_sorted[later], 0] = slots[by_stream[later - 1]] + 1
    last = np.flatnonzero(np.append(~same, nslots > 0))
    fs[L // jb - 1, w_sorted[last], 1] = slots[by_stream[last]] + 1
    return StreamPlan(
        order=order, nw=nw, win=win, jb=jb, L=L, slot_w=slot_w,
        slot_start=slot_start, slot_lb=slot_lb, fs=fs,
        real_residues=int(seg.sum()),
        padded_cells_per_query_row=nw * L * win,
    )


def pack_streams(
    db,
    order: np.ndarray,
    nw: int,
    win: int = 1024,
    jb: int = 4,
    grain: int = 32,
    target_len: int | None = None,
) -> StreamPack:
    """Pack a sorted database into NW balanced segmented window streams.

    Args:
      db: EncodedDatabase (flat-buffer records).
      order: record ids in descending length order (the caller sorts).
      nw: number of independent window streams (kernel interleave factor).
      win: lanes per window (1024 on TPU).
      jb: kernel j-block size; segment boundaries are multiples of it.
      grain: segment-length rounding (multiple of jb); coarser = fewer
        boundary entries, finer = less padding.

    The host fill of :func:`plan_streams`' placement (which see).
    ``target_len`` pads every stream to a fixed length (must be a multiple
    of ``jb`` and >= the natural length) so compiled kernel shapes can be
    reused across databases; tail padding is '*' continuation of the final
    segment, which never changes its score. ``pack_streams.calls`` counts
    the calls.
    """
    from .native_io import pack_batch

    pack_streams.calls += 1
    plan = plan_streams(db.lengths, order, nw, win=win, jb=jb, grain=grain,
                        target_len=target_len)
    streams = np.full((nw, plan.L, win), PAD_INDEX, dtype=np.int8)
    slot_ids = plan.slot_ids
    for s, (w, off, lb) in enumerate(zip(plan.slot_w.tolist(), plan.slot_start.tolist(),
                                         plan.slot_lb.tolist())):
        pack_batch(db, slot_ids[s], win, lb, out=streams[w, off : off + lb])
    return StreamPack(
        streams=streams,
        fs=plan.fs,
        slot_ids=slot_ids,
        real_residues=plan.real_residues,
        padded_cells_per_query_row=plan.padded_cells_per_query_row,
    )


pack_streams.calls = 0


# NOTE: a windowed-sort streaming packer (pack_stream) used to live here;
# bounded-memory scanning is served by pipeline.search_files_streaming,
# which chunks records and reuses the per-chunk sort in pack_encoded.
