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

    Lane-groups of ``win`` consecutive records (descending length, so
    near-uniform within a group) become segments; segments are dealt to the
    currently-shortest stream (greedy balancing — they arrive in descending
    length order, so streams end within one segment of each other).
    ``target_len`` pads every stream to a fixed length (must be a multiple
    of ``grain`` and >= the natural length) so compiled kernel shapes can be
    reused across databases; tail padding is '*' continuation of the final
    segment, which never changes its score.
    """
    from .native_io import pack_batch

    if grain % jb:
        raise ValueError(f"{grain=} must be a multiple of {jb=}")
    n = len(order)
    lengths = db.lengths
    nslots = -(-n // win)
    slot_ids = [order[s * win : (s + 1) * win] for s in range(nslots)]
    slot_lb = [
        max(grain, -(-int(lengths[ids].max(initial=1)) // grain) * grain)
        for ids in slot_ids
    ]
    # Greedy balance: place each segment on the shortest stream.
    stream_len = [0] * nw
    placement: list[list[int]] = [[] for _ in range(nw)]
    for s in range(nslots):
        w = min(range(nw), key=stream_len.__getitem__)
        placement[w].append(s)
        stream_len[w] += slot_lb[s]
    L = max(max(stream_len), grain)
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
    streams = np.full((nw, L, win), PAD_INDEX, dtype=np.int8)
    fs = np.zeros((L // jb, nw, 2), dtype=np.int32)
    for w in range(nw):
        off = 0
        for k, s in enumerate(placement[w]):
            if k > 0:
                # A new segment starts at this block: flush the previous one.
                fs[off // jb, w, 0] = placement[w][k - 1] + 1
            pack_batch(
                db, slot_ids[s], win, slot_lb[s],
                out=streams[w, off : off + slot_lb[s]],
            )
            off += slot_lb[s]
        if placement[w]:
            fs[L // jb - 1, w, 1] = placement[w][-1] + 1
    return StreamPack(
        streams=streams,
        fs=fs,
        slot_ids=slot_ids,
        real_residues=int(lengths[order].sum()),
        padded_cells_per_query_row=nw * L * win,
    )


# NOTE: a windowed-sort streaming packer (pack_stream) used to live here;
# bounded-memory scanning is served by pipeline.search_files_streaming,
# which chunks records and reuses the per-chunk sort in pack_encoded.
