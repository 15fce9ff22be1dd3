"""Query-vs-database search: the port of ``seqalign_tpu.pipeline``'s
single-query and multi-query paths.

Reads the query and the database FASTA (the port's copy of the JAX
package's numpy host code), length-sorts the records, copies the encoded
database to the device once a search (``convert.database_to_torch``), plans
each chunk's segmented window streams on the host
(``utils.packing.plan_streams``; the order, the chunks and their plans are
kept between searches of the same records, :class:`PlanMemo`) and packs them
on the device
(``ops.pack_cuda.pack_streams_device``), scores each chunk in one launch of
the stream kernel (``ops.swa_cuda.sw_stream``; ``sw_stream_multi`` per
block of queries for a multi-query search; ``sw_stream_striped``, one
launch per row stripe, for a query over ``MAX_QUERY_ROWS``), puts the bests
in database order on the device (:func:`scatter_slots`) and fetches them
once. The timer covers the launches, the kernels, that reorder and the
fetch; parsing, planning, the copy and the pack stay outside it, the same
boundary as the JAX package's and the reference's. Each step is a span of
:mod:`.trace`, recorded while ``torch.profiler`` records.
``search_files_streaming`` reads the database in parts on a prefetch
thread for a bounded-memory search, and ``checkpoint_dir=`` makes a scan
resumable chunk by chunk (``_ScanCheckpoint``).

The device comes from ``SEQALIGN_PLATFORM`` (``cuda``, the default, or
``cpu``; ``device.resolve_device``). With no GPU, ``cuda`` is an error,
never a silent run on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from . import trace
from .convert import PinnedPieces, database_to_torch, profile_stripes, profile_to_torch
from .device import resolve_device
from .host import (
    EncodedDatabase, ScoringModel, SeqRecord, StreamPlan, encode,
    lattice_round_up, pack_batch, parse_file_cached, plan_streams, read_fasta,
    read_first,
)
from .ops import swa_cuda
from .ops.pack_cuda import pack_streams_device
from .ops.oracle import sw_score_batch
from .ops.swa_cuda import (
    STREAM_JB, supported_scoring, sw_stream, sw_stream_multi, sw_stream_striped,
    sw_windows_engine,
)
from .ops.swa_torch import make_profile, sw_scan, sw_wavefront

# ``pallas`` is the JAX package's name for its kernel route: here the
# stream engine. ``oracle`` is the scalar NumPy oracle, record by record.
ENGINES = ("stream", "pallas", "wavefront", "scan", "oracle")

# Lanes of one window stream: one 256-thread CTA of the kernel.
WINDOW_LANES = 256
STREAM_GRAIN = 16  # segment-length rounding, a multiple of STREAM_JB
# Output slots per launch; bounds the host-side chunk (slots * lanes
# records per launch).
MAX_STREAM_SLOTS = 4096
# Lane-batch width of the wavefront and scan engines.
BATCH_LANES = 512
# Device memory one multi-query launch may take for its output
# (choose_query_block); sets the queries per launch. The kernel keeps no DP
# state in device memory.
MULTI_SCRATCH_BYTES = 8 << 30
# Device memory one chunk of a striped (long-query) search may take for its
# two boundary arrays, 16 B per stream cell (Gg and F, in and out): the only
# scratch the striped kernel keeps, its DP rows living in registers. Chunks
# are cut before packing, by real residues at half this many cells, which
# leaves room for the streams' padding; the Swiss-Prot-scale database
# (205 M residues, 3.5 GB of boundaries) stays one chunk.
STRIPED_SCRATCH_BYTES = 8 << 30
# Databases whose plans PlanMemo keeps, the last searched (and of each, its
# last cuts into chunks).
PLAN_MEMO_SIZE = 4


@dataclasses.dataclass
class MultiSearchResult:
    """Scores for several queries against one database, in stream order."""

    query_names: list[str]
    query_seqs: list[str]
    names: list[str]
    scores: np.ndarray  # (NQ, N) int32
    kernel_time: float  # seconds in launches + execution + reorder + fetch
    total_entries: int


@dataclasses.dataclass
class SearchResult:
    """Scores for one query against a database, in database stream order."""

    query_name: str
    query_seq: str
    names: list[str]
    seqs: list[str] | None
    scores: np.ndarray  # (N,) int32
    kernel_time: float  # seconds in launch + execution + reorder + fetch
    total_entries: int


def get_engine(name: str) -> Callable:
    """Resolve a lane-batch engine name to fn(profile, db, go, ge) -> scores.

    ``windows`` is the fixed-batch kernel (K4, ``sw_windows_engine``), the
    JAX package's ``pallas`` lane-batch engine; like there, no search route
    runs it. The stream engine is not a lane-batch engine:
    ``search_database`` runs it through ``_stream_search``.
    """
    if name == "windows":
        return sw_windows_engine
    if name == "wavefront":
        return sw_wavefront
    if name == "scan":
        return sw_scan
    raise KeyError(f"unknown engine {name!r}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def search_database(
    query_idx: np.ndarray,
    db: EncodedDatabase,
    scoring: ScoringModel,
    engine: str | None = None,
    lanes: int | None = None,
    sort: bool = True,
    checkpoint_dir: str | None = None,
    device: torch.device | str | None = None,
) -> tuple[np.ndarray, float]:
    """Score an encoded query against an EncodedDatabase.

    Returns (scores in database stream order (N,) int32, kernel seconds).
    ``engine`` is one of ``ENGINES`` (default ``stream``; ``pallas`` is
    ``stream``); ``device`` defaults to :func:`resolve_device`. The
    ``oracle`` engine scores each record with the NumPy oracle on the host,
    timed as the JAX package times it. ``checkpoint_dir`` makes the stream
    kernels' scan resumable chunk by chunk (:class:`_ScanCheckpoint`); the
    lane-batch engines, as in the JAX package, do not checkpoint.
    """
    eng = _engine(engine)
    dev = resolve_device() if device is None else torch.device(device)
    with trace.span("search"):
        n = db.n
        scores = np.zeros(n, dtype=np.int32)
        if n == 0 or len(query_idx) == 0:
            return scores, 0.0

        if eng == "oracle":
            t0 = time.perf_counter()
            scores = sw_score_batch(
                query_idx, [db.record(i) for i in range(n)], scoring.table,
                scoring.gap_open, scoring.gap_extend,
            ).astype(np.int32)
            return scores, time.perf_counter() - t0

        with trace.span("make_profile"):
            profile = make_profile(scoring.table, query_idx)
        go, ge = scoring.gap_open_total, scoring.gap_extend
        with trace.span("sort"):
            planned = PLANS.find(db, sort)

        if eng == "stream":
            if not supported_scoring(profile, go, ge):
                _note_wavefront()
                eng = "wavefront"
            else:
                return _stream_search(
                    profile, db, go, ge, planned, lanes, dev,
                    checkpoint_dir=checkpoint_dir,
                )

        engine_fn = get_engine(eng)
        prof_dev = torch.from_numpy(profile).to(dev)
        kernel_time = 0.0
        for ids, batch in lane_batches(db, planned.order, lanes or BATCH_LANES):
            batch = torch.from_numpy(batch).to(dev)
            _sync(dev)
            t0 = time.perf_counter()
            out = engine_fn(prof_dev, batch, go, ge).cpu()
            kernel_time += time.perf_counter() - t0
            scores[ids] = out.numpy()[: len(ids)]
        return scores, kernel_time


def _engine(engine: str | None) -> str:
    """The engine a search runs for ``engine`` (None: ``stream``)."""
    eng = engine or "stream"
    if eng not in ENGINES:
        raise KeyError(f"unknown engine {eng!r}; expected one of {ENGINES}")
    return "stream" if eng == "pallas" else eng


def lane_batches(
    db: EncodedDatabase, order: np.ndarray, lanes: int
) -> Iterable[tuple[np.ndarray, np.ndarray]]:
    """``(record ids, (Lb, lanes) int8 batch)`` of each lane batch of a
    lane-batch engine: the records of ``order``, ``lanes`` at a time, each
    batch '*'-padded to ``lattice_round_up`` of its longest record."""
    for start in range(0, db.n, lanes):
        ids = order[start : start + lanes]
        lb_pad = lattice_round_up(int(db.lengths[ids].max(initial=1)))
        yield ids, pack_batch(db, ids, lanes, lb_pad)


def _note_wavefront() -> None:
    print(
        "Note: scoring system outside the stream kernel's int32 "
        "G-form envelope (it needs gap_extend >= gap_open + "
        "gap_extend, gap_extend <= 0, no int32 overflow); using "
        "wavefront.",
        file=sys.stderr,
    )


def search_database_multi(
    query_idxs: Sequence[np.ndarray],
    db: EncodedDatabase,
    scoring: ScoringModel,
    engine: str | None = None,
    lanes: int | None = None,
    sort: bool = True,
    device: torch.device | str | None = None,
) -> tuple[np.ndarray, float]:
    """Score many encoded queries against an EncodedDatabase.

    Returns ((NQ, N) int32 scores in database stream order, kernel seconds).
    The ``stream`` engine (the default) scores blocks of queries over the
    same packed streams in one launch of the multi-query kernel each; a
    query over ``MAX_QUERY_ROWS`` rows is searched on its own through the
    striped kernel (:func:`search_database`), and the search says so. The
    ``wavefront``, ``scan`` and ``oracle`` engines, and a scoring system
    outside the stream kernel's envelope (which says so and uses
    ``wavefront``), search each query on its own through
    :func:`search_database`.
    """
    eng = _engine(engine)
    dev = resolve_device() if device is None else torch.device(device)
    nq = len(query_idxs)
    with trace.span("search"):
        scores = np.zeros((nq, db.n), dtype=np.int32)
        if nq == 0 or db.n == 0:
            return scores, 0.0

        go, ge = scoring.gap_open_total, scoring.gap_extend
        kernel_time = 0.0
        each = range(nq)
        if eng == "stream":
            # Only the short queries form the padded (NQ, Lq, 32) batch
            # profile; search_database checks each long query's scoring on
            # its own.
            rows = swa_cuda.MAX_QUERY_ROWS
            short = [k for k, q in enumerate(query_idxs) if len(q) <= rows]
            long = [k for k, q in enumerate(query_idxs) if len(q) > rows]
            with trace.span("make_profile"):
                batch = (
                    multi_profile(scoring.table, [query_idxs[k] for k in short])
                    if short else None
                )
            if batch is None or supported_scoring(batch, go, ge):
                each = long
                if long:
                    print(
                        f"Note: {len(long)} of {nq} queries exceed "
                        f"MAX_QUERY_ROWS={rows}; each is searched on its own "
                        "through the row-striped kernel, the rest as one batch.",
                        file=sys.stderr,
                    )
                if short:
                    with trace.span("sort"):
                        planned = PLANS.find(db, sort)
                    fetched, kernel_time = _stream_search(
                        batch, db, go, ge, planned, lanes, dev,
                        query_residues=sum(len(query_idxs[k]) for k in short),
                    )
                    with trace.span("copy_out"):
                        scores[short] = fetched
            else:
                _note_wavefront()
                eng = "wavefront"

        for k in each:
            q = query_idxs[k]
            scores[k], dt = search_database(
                q, db, scoring, engine=eng, lanes=lanes, sort=sort, device=dev
            )
            kernel_time += dt
        return scores, kernel_time


def multi_profile(table: np.ndarray, query_idxs: Sequence[np.ndarray]) -> np.ndarray:
    """``(NQ, lqmax, 32)`` profiles of encoded queries.

    Shorter queries pad to lqmax with P = 0 rows: an appended row gives
    H' = G_diag, which never exceeds the best, so no score changes; an
    empty query is all zero and scores 0.
    """
    lqmax = max(len(q) for q in query_idxs)
    profiles = np.zeros((len(query_idxs), max(lqmax, 1), 32), dtype=np.int32)
    for k, q in enumerate(query_idxs):
        if len(q):
            profiles[k, : len(q)] = make_profile(table, q)
    return profiles


def choose_query_block(nq: int, nslots: int, win: int) -> int:
    """Queries per multi-query launch.

    As many as fit ``MULTI_SCRATCH_BYTES``: per query, the launch's output,
    ``4 B x win`` per slot for ``nslots`` slots (the kernel keeps no DP
    state in device memory); then evened out so the blocks differ by at
    most one query and the last block pads as few as it can.
    """
    per_query = 4 * win * max(nslots, 1)
    cap = max(1, MULTI_SCRATCH_BYTES // per_query)
    n_blocks = -(-nq // cap)
    return -(-nq // n_blocks)


def resident_lanes(device: torch.device) -> int | None:
    """Threads the card holds at once (SMs x threads per SM), None on CPU.

    More lanes than this only queue behind the first wave.
    """
    if device.type != "cuda":
        return None
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count * props.max_threads_per_multi_processor


def choose_windows(
    lengths: np.ndarray, win: int, lanes: int | None,
    max_lanes: int | None = None,
) -> int:
    """Window streams for one chunk of records (in packing order).

    No more windows than segments, no more than ``max_lanes`` lanes (the
    card's :func:`resident_lanes`), and no more windows than would leave a
    stream shorter than the longest segment: every stream is padded to the
    longest one, so past that point more windows only add padding.
    ``lanes`` (total lanes) overrides the last two.
    """
    nslots = -(-len(lengths) // win)
    if lanes is not None:
        return max(1, min(nslots, lanes // win))
    seg = np.maximum.reduceat(lengths, np.arange(0, len(lengths), win))
    seg = np.maximum(-(-seg // STREAM_GRAIN) * STREAM_GRAIN, STREAM_GRAIN)
    nw = min(nslots, int(seg.sum() // seg.max()))
    if max_lanes is not None:
        nw = min(nw, max_lanes // win)
    return max(1, nw)


def query_blocks(
    profile: np.ndarray, go: int, n: int, device: torch.device,
) -> list[torch.Tensor]:
    """The blocks of queries a multi-query search over ``n`` records
    launches, one multi-query launch each per chunk.

    ``profile`` is ``(NQ, Lq, 32)``; each block is ``(nq_b, lqe, 32)``
    biased, on ``device`` (:func:`choose_query_block`, for the most slots a
    chunk of ``n`` records takes), the last one filled up with zero
    profiles.
    """
    prof = profile_to_torch(profile, go, "cpu")
    win = WINDOW_LANES
    nslots = min(-(-n // win), MAX_STREAM_SLOTS)
    nq_b = choose_query_block(prof.shape[0], nslots, win)
    pad = prof.new_zeros((-prof.shape[0] % nq_b, *prof.shape[1:]))
    return [b.to(device) for b in torch.cat([prof, pad]).split(nq_b)]


def chunk_bounds(
    db: EncodedDatabase, order: np.ndarray, max_residues: int | None = None,
) -> list[tuple[int, int]]:
    """``(start, stop)`` in ``order`` of each chunk a search launches on:
    ``MAX_STREAM_SLOTS`` lane groups at a time. With ``max_residues`` (the
    striped search, :func:`striped_chunk_residues`) a chunk also ends, at a
    lane group's end, before its real residues pass that many; it keeps at
    least one lane group."""
    win = WINDOW_LANES
    csum = np.cumsum(db.lengths[order]) if max_residues else None
    bounds = []
    start = 0
    while start < db.n:
        stop = min(start + MAX_STREAM_SLOTS * win, db.n)
        if max_residues:
            base = csum[start - 1] if start else 0
            fit = int(np.searchsorted(csum, base + max_residues, side="right"))
            if fit < stop:
                stop = max(start + win, fit // win * win)
        bounds.append((start, stop))
        start = stop
    return bounds


def plan_chunk(
    lengths: np.ndarray, chunk: np.ndarray, lanes: int | None,
    max_lanes: int | None, win: int = WINDOW_LANES,
) -> StreamPlan:
    """The placement of ``chunk``'s records (ids into ``lengths``) on
    :func:`choose_windows` streams of ``win`` lanes."""
    nw = choose_windows(lengths[chunk], win, lanes, max_lanes)
    return plan_streams(lengths, chunk, nw, win=win, jb=STREAM_JB, grain=STREAM_GRAIN)


@dataclasses.dataclass
class Cut:
    """One way of cutting a database's order into chunks: their bounds
    (:func:`chunk_bounds`) and the stream plans made of them so far
    (:func:`plan_chunk`), by the chunk's start."""

    bounds: list[tuple[int, int]]
    plans: dict[int, StreamPlan]


class Planned:
    """The length-derived plan of one database's records: its length order
    (``np.argsort(-lengths, kind="stable")``, ``arange`` unsorted) and its
    cuts into chunks, by ``(lanes, max_lanes, max_residues)`` and the
    constants the plan reads. Host arrays only, from the memo's own copy of
    the offsets."""

    def __init__(self, offsets: np.ndarray, sort: bool):
        self.offsets = np.array(offsets)
        self.lengths = np.diff(self.offsets)
        self.sort = sort
        self.order = (np.argsort(-self.lengths, kind="stable") if sort
                      else np.arange(len(self.lengths)))
        self.cuts: dict[tuple, Cut] = {}


class PlanMemo:
    """The plans of the last ``PLAN_MEMO_SIZE`` databases searched, kept
    between searches: what a search plans depends on the records' lengths,
    the lanes and the card, never on the query.

    An entry is found by the content of ``db.offsets``, compared with the
    entry's own copy (under 1 ms at Swiss-Prot scale), never by the object:
    a database changed in place, or another of the same size, misses and is
    planned afresh, exactly as without the memo. Of each database it keeps
    its last ``PLAN_MEMO_SIZE`` cuts. A lock guards it, since a search may
    run on any thread. What it returns is shared by every search of the
    records, and nothing writes it.
    """

    def __init__(self):
        self.lock = threading.Lock()
        self.entries: list[Planned] = []  # the last used last

    def find(self, db: EncodedDatabase, sort: bool) -> Planned:
        """The entry of ``db``'s records, sorted by length or not."""
        with self.lock:
            for k, e in enumerate(self.entries):
                if e.sort == sort and np.array_equal(e.offsets, db.offsets):
                    self.entries.append(self.entries.pop(k))
                    return e
            self.entries.append(Planned(db.offsets, sort))
            del self.entries[:-PLAN_MEMO_SIZE]
            return self.entries[-1]

    def cut(self, planned: Planned, db: EncodedDatabase, lanes: int | None,
            max_lanes: int | None, max_residues: int | None) -> Cut:
        """``planned``'s chunks for these arguments of :func:`chunk_bounds`
        and :func:`plan_chunk`."""
        key = (lanes, max_lanes, max_residues, MAX_STREAM_SLOTS, WINDOW_LANES,
               STREAM_GRAIN, STREAM_JB)
        with self.lock:
            cut = planned.cuts.pop(key, None)
            if cut is None:
                cut = Cut(chunk_bounds(db, planned.order, max_residues), {})
            planned.cuts[key] = cut
            for old in list(planned.cuts)[:-PLAN_MEMO_SIZE]:
                del planned.cuts[old]
            return cut

    def plans(self, planned: Planned, cut: Cut, chunks: list[tuple[int, int]],
              lanes: int | None, max_lanes: int | None) -> list[StreamPlan]:
        """The plans of ``cut``'s chunks ``(start, stop)``, those the memo
        lacks made now, in the search's ``plan`` span, which counts both."""
        with self.lock:
            hits = sum(start in cut.plans for start, _ in chunks)
            with trace.span("plan", plan_hits=hits, plan_misses=len(chunks) - hits):
                for start, stop in chunks:
                    if start not in cut.plans:
                        cut.plans[start] = plan_chunk(
                            planned.lengths, planned.order[start:stop], lanes, max_lanes)
                return [cut.plans[start] for start, _ in chunks]


PLANS = PlanMemo()


def device_free_bytes(device: torch.device) -> int | None:
    """Bytes a search may still take on ``device`` (the card's free memory,
    ``torch.cuda.mem_get_info``, and PyTorch's cached blocks); None, no
    limit, off a card."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)


def chunk_device_bytes(plan: StreamPlan, queries: int = 1, striped: bool = False) -> int:
    """Device bytes a chunk's launch holds: its streams and segment table,
    its bests for ``queries`` (padded) queries twice over (a batch's blocks
    are concatenated), and for the striped kernel its two boundary arrays
    (16 B a stream cell)."""
    cells = plan.nw * plan.L * plan.win
    out = 4 * queries * len(plan.slot_lb) * plan.win
    return cells * (17 if striped else 1) + plan.fs.nbytes + 2 * out


def chunk_database(db: EncodedDatabase, chunk: np.ndarray) -> EncodedDatabase:
    """The records ``chunk`` of ``db`` as a database of their own, in that
    order (a host gather)."""
    lengths = db.lengths[chunk]
    offsets = np.zeros(len(chunk) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    idx = np.repeat(db.offsets[chunk] - offsets[:-1], lengths) + np.arange(offsets[-1])
    return EncodedDatabase(seq=db.seq[idx], offsets=offsets, names=[""] * len(chunk))


class DevicePacker:
    """Packs chunks of ``db`` on ``device`` (:func:`pack_streams_device`).

    The first call copies the whole encoded database to the device, once
    for every chunk after it; where it does not fit beside ``held_bytes``
    (what the largest chunk's launch holds, :func:`chunk_device_bytes`) in
    :func:`device_free_bytes`, each chunk copies only its own records,
    gathered on the host (:func:`chunk_database`). Every copy, the
    database's and each pack's inputs, goes through the packer's one pair
    of page-locked buffers (``convert.PinnedPieces``). Nothing outlives the
    packer: each search makes its own.
    """

    def __init__(self, db: EncodedDatabase, device: torch.device, held_bytes: int = 0):
        self.db, self.device, self.held_bytes = db, device, held_bytes
        self.whole: tuple[torch.Tensor, torch.Tensor] | None = None
        self.per_chunk = False
        self.pieces = PinnedPieces()

    def __call__(self, plan: StreamPlan) -> tuple[torch.Tensor, torch.Tensor]:
        if self.whole is None and not self.per_chunk:
            with trace.span("h2d"):
                free = device_free_bytes(self.device)
                need = self.db.seq.nbytes + self.db.offsets.nbytes + self.held_bytes
                self.per_chunk = free is not None and need > free
                if not self.per_chunk:
                    self.whole = database_to_torch(self.db, self.device, self.pieces)
        if self.per_chunk:
            with trace.span("h2d"):
                with trace.span("gather"):
                    local = chunk_database(self.db, plan.order)
                data = database_to_torch(local, self.device, self.pieces)
            plan = dataclasses.replace(plan, order=np.arange(len(plan.order)))
            return pack_streams_device(*data, plan, self.pieces)
        return pack_streams_device(*self.whole, plan, self.pieces)


def stream_chunks(
    db: EncodedDatabase, lanes: int | None, device: torch.device,
    max_residues: int | None = None,
) -> Iterable[tuple[np.ndarray, tuple[torch.Tensor, torch.Tensor, int]]]:
    """``(records, (streams, fs, nslots))`` of each chunk a search of
    ``db``'s records in length order launches on, its order, bounds and plans
    taken from :data:`PLANS` as :func:`_stream_search` takes them (after a
    search of the same records nothing is planned), packed on ``device`` by
    one :class:`DevicePacker`."""
    max_lanes = resident_lanes(device)
    planned = PLANS.find(db, True)
    cut = PLANS.cut(planned, db, lanes, max_lanes, max_residues)
    plans = PLANS.plans(planned, cut, cut.bounds, lanes, max_lanes)
    striped = max_residues is not None
    packer = DevicePacker(db, device, max(
        (chunk_device_bytes(p, striped=striped) for p in plans), default=0))
    for (start, stop), plan in zip(cut.bounds, plans):
        yield planned.order[start:stop], (*packer(plan), len(plan.slot_lb))


def striped_chunk_residues() -> int:
    """Real residues per chunk of a striped search: the cells whose
    boundaries fit ``STRIPED_SCRATCH_BYTES``, halved for the padding the
    packer adds (1.06x the real residues at Swiss-Prot scale)."""
    return STRIPED_SCRATCH_BYTES // 16 // 2


def _stream_search(
    profile: np.ndarray,
    db: EncodedDatabase,
    go: int,
    ge: int,
    planned: Planned,
    lanes: int | None,
    device: torch.device,
    checkpoint_dir: str | None = None,
    query_residues: int | None = None,
) -> tuple[np.ndarray, float]:
    """Whole-database search through the segmented stream kernels.

    The database, in ``planned``'s order (:meth:`PlanMemo.find`), becomes
    NW window streams scored in one launch per chunk of
    ``MAX_STREAM_SLOTS`` segments (:func:`chunk_bounds`), each chunk
    planned on the host (once for the records, :class:`PlanMemo`) and
    packed on the device from one copy of the database
    (:class:`DevicePacker`). A 3-D
    ``(NQ, Lq, 32)`` profile runs one multi-query launch per block of
    queries (:func:`query_blocks`) over the same device-resident streams.
    The chunks are the single-query search's: the JAX package's smaller
    chunks for a batch (``MAX_STREAM_SLOTS // nq_b`` segments) pad each
    stream to a longer segment, and on an H100 that cost 1.27x the K3 time
    at 8 x 17 and 1.54x at 64 x 144 (PERF.md). A query over
    ``MAX_QUERY_ROWS`` rows runs the striped kernel, one launch per stripe
    of ``STRIPE_ROWS`` rows, in chunks whose boundaries fit
    ``STRIPED_SCRATCH_BYTES``. Each launch's bests go to their records in a
    device ``(N,)`` or ``(NQ, N)`` tensor (:func:`scatter_slots`), fetched
    once at the end into page-locked memory. Returns ``(N,)`` or ``(NQ,
    N)`` scores.

    With ``checkpoint_dir`` each chunk's scores persist as it finishes
    (:class:`_ScanCheckpoint`); a rerun of the same scan reads them back,
    copies, packs and launches nothing for them, and adds nothing to the
    kernel time.

    ``query_residues`` (the profile's rows where None) counts the real cells
    of each launch for the trace (:mod:`.trace`): a batch's profile pads its
    queries to the longest.
    """
    n = db.n
    multi = profile.ndim == 3
    striped = not multi and profile.shape[0] > swa_cuda.MAX_QUERY_ROWS
    if device.type == "cuda":
        from .ops import _build

        _build.load()  # a first use builds the kernel: set-up, not timed
        # The reorder's first use in a process loads its kernels: set-up too.
        scatter_slots(torch.zeros((1, 1), dtype=torch.int32, device=device),
                      np.zeros(1, np.int64), torch.zeros((1, 1, 1), dtype=torch.int32,
                                                         device=device))
    queries = 1
    # The query rows the stream kernels score: the ROW_ALIGN padding of the
    # profile never raises a score, and the one-pass kernel skips it.
    rows = profile.shape[-2]
    # The query rows each chunk's launches step on a card, for the trace:
    # each team's T x R rows, a block's zero queries and each stripe's warp.
    with trace.span("profile"):
        if multi:
            blocks = query_blocks(profile, go, n, device)
            queries = sum(b.shape[0] for b in blocks)
            launched_rows = sum(swa_cuda.stream_rows_stepped(rows, b.shape[0]) for b in blocks)
        elif striped:
            stripes = profile_stripes(profile, go, swa_cuda.STRIPE_ROWS, device)
            launched_rows = sum(swa_cuda.stripe_rows_stepped(s.shape[0]) for s in stripes)
        else:
            prof_dev = profile_to_torch(profile, go, device)
            launched_rows = swa_cuda.stream_rows_stepped(rows)
    if query_residues is None:
        query_residues = rows
    shape = (profile.shape[0], n) if multi else (n,)
    scores = torch.zeros(shape, dtype=torch.int32, device=device)
    max_lanes = resident_lanes(device)
    order = planned.order
    with trace.span("plan"):
        cut = PLANS.cut(planned, db, lanes, max_lanes,
                        striped_chunk_residues() if striped else None)
    ckpt = (
        _ScanCheckpoint(checkpoint_dir, profile, db, go, ge, order, cut.bounds)
        if checkpoint_dir
        else None
    )
    chunks = []
    for start, stop in cut.bounds:
        done = ckpt.load(start) if ckpt is not None else None
        if done is not None:
            ids = torch.from_numpy(order[start:stop]).to(device)
            scores[..., ids] = torch.from_numpy(done).to(device)
        else:
            chunks.append((start, stop))
    plans = PLANS.plans(planned, cut, chunks, lanes, max_lanes)
    todo = [(start, order[start:stop], plan) for (start, stop), plan in zip(chunks, plans)]
    packer = DevicePacker(db, device, scores.numel() * 4 + max(
        (chunk_device_bytes(p, queries, striped) for *_, p in todo), default=0))
    fetched = _host_scores(shape, device)
    kernel_time = 0.0
    for start, chunk, plan in todo:
        streams, fs = packer(plan)
        ids = torch.from_numpy(chunk).to(device)
        kw = dict(nslots=len(plan.slot_lb), jb=STREAM_JB)
        with trace.span("wait"):
            _sync(device)
        t0 = time.perf_counter()
        with trace.span("launch", cells_real=query_residues * plan.real_residues,
                        cells_launched=launched_rows * plan.padded_cells_per_query_row):
            if multi:
                # Every block's launch is enqueued before the reorder.
                out = torch.cat([sw_stream_multi(b, streams, fs, go, ge, rows=rows, **kw)
                                 for b in blocks], dim=1)
            elif striped:
                # Every stripe's launch is enqueued before the reorder.
                out = sw_stream_striped(stripes, streams, fs, go, ge, **kw)
            else:
                out = sw_stream(prof_dev, streams, fs, go, ge, rows=rows, **kw)
        with trace.span("reorder"):
            scatter_slots(scores, ids, out)
        with trace.span("wait"):
            _sync(device)
        kernel_time += time.perf_counter() - t0
        del streams, fs, out
        if ckpt is not None:
            ckpt.save(start, scores[..., ids].cpu().numpy())
    with trace.span("fetch"):
        t0 = time.perf_counter()
        fetched.copy_(scores)
        if todo:
            kernel_time += time.perf_counter() - t0
    return fetched.numpy(), kernel_time


def _host_scores(shape: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The host tensor a search's bests are fetched into: page-locked where
    they come from a card."""
    return torch.empty(shape, dtype=torch.int32, pin_memory=device.type == "cuda")


def scatter_slots(scores, chunk, out: torch.Tensor) -> None:
    """Write a stream launch's ``(nslots, win)`` bests, or a multi-query
    launch's ``(nslots, nq_b, win)`` (blocks concatenated on the query
    axis, zero-profile padding queries past ``scores``' rows), into
    ``scores[..., chunk]``.

    :func:`plan_chunk` puts chunk records ``[s*win, (s+1)*win)`` in slot
    ``s`` (``plan.slot_ids``), so the flattened slots are the chunk in
    packing order, the final group's padding lanes past its end.

    A numpy ``scores`` takes fetched bests (the host form, which the tests
    hold the device form to); a tensor ``scores`` takes them where they
    lie, ``chunk`` made a tensor there if it is not one.
    """
    if isinstance(scores, torch.Tensor):
        chunk = torch.as_tensor(chunk, device=scores.device)
        if out.ndim == 3:
            out = out.transpose(0, 1).reshape(out.shape[1], -1)[: scores.shape[0]]
        scores[..., chunk] = out.reshape(*scores.shape[:-1], -1)[..., : chunk.numel()]
        return
    if out.ndim == 3:
        flat = out.numpy().transpose(1, 0, 2).reshape(out.shape[1], -1)
        scores[:, chunk] = flat[: scores.shape[0], : len(chunk)]
    else:
        scores[chunk] = out.numpy().reshape(-1)[: len(chunk)]


class _ScanCheckpoint:
    """Chunk-level resume for huge database scans.

    Each chunk's scores (records ``order[start:stop]``, in that order)
    persist to ``dir/chunk_<start>.npy`` under ``dir/manifest.json``, keyed
    by a fingerprint of the scan: the query profile, the database (offsets
    and sampled residues), the record order, the penalties and the chunk
    plan (every chunk's bounds, which ``MAX_STREAM_SLOTS``,
    ``WINDOW_LANES`` and, for the striped search,
    ``STRIPED_SCRATCH_BYTES`` decide). Re-running the same scan skips its
    completed chunks; any other scan, a chunk plan included, starts
    afresh, since the same start would hold other records.
    """

    def __init__(self, path, profile, db, go, ge, order, bounds):
        import hashlib
        import json

        self.dir = path
        os.makedirs(path, exist_ok=True)
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(profile).tobytes())
        h.update(np.ascontiguousarray(db.offsets).tobytes())
        # Sampled content fingerprint: cheap but catches edits.
        h.update(np.ascontiguousarray(db.seq[:: max(1, len(db.seq) // 65536)]).tobytes())
        # The chunk->record mapping depends on the sort order and the
        # chunk plan: a chunk file indexes the records order[start:stop].
        h.update(np.ascontiguousarray(order).tobytes())
        h.update(str((int(go), int(ge))).encode())
        h.update(np.asarray(bounds, dtype=np.int64).tobytes())
        self.key = h.hexdigest()[:16]
        self.manifest = os.path.join(path, "manifest.json")
        try:
            with open(self.manifest) as f:
                state = json.load(f)
            if state.get("key") != self.key:
                state = {"key": self.key, "chunks": []}
        except (OSError, ValueError):
            state = {"key": self.key, "chunks": []}
        self.state = state
        self._flush()

    def _flush(self):
        import json

        tmp = f"{self.manifest}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.state, f)
        os.replace(tmp, self.manifest)

    def _file(self, start):
        return os.path.join(self.dir, f"chunk_{start}.npy")

    def load(self, start):
        if start not in self.state["chunks"]:
            return None
        try:
            return np.load(self._file(start))
        except (OSError, ValueError):
            return None

    def save(self, start, chunk_scores):
        np.save(self._file(start), chunk_scores)
        self.state["chunks"].append(start)
        self._flush()


def _db_from_encoded(encoded: Sequence[np.ndarray], names=None) -> EncodedDatabase:
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    seq = (
        np.concatenate([np.asarray(e, dtype=np.int8) for e in encoded])
        if encoded
        else np.zeros(0, dtype=np.int8)
    )
    return EncodedDatabase(
        seq=seq,
        offsets=offsets,
        names=list(names) if names else [""] * len(encoded),
    )


def search_encoded(
    query_idx: np.ndarray,
    encoded_db: Sequence[np.ndarray],
    scoring: ScoringModel,
    engine: str | None = None,
    lanes: int | None = None,
    sort: bool = True,
    device: torch.device | str | None = None,
) -> tuple[np.ndarray, float]:
    """Score an encoded query against a list of encoded sequences:
    :func:`search_database` over them, scores in list order."""
    return search_database(
        query_idx, _db_from_encoded(encoded_db), scoring,
        engine=engine, lanes=lanes, sort=sort, device=device,
    )


def _warn_padding(scoring: ScoringModel, query_idx: np.ndarray) -> None:
    if not scoring.padding_safe_for_query(query_idx):
        print(
            "Warning: query contains characters with positive '*' scores; "
            "padded batches may not be score-invariant (same limitation as "
            "the reference engine).",
            file=sys.stderr,
        )


def search(
    query: SeqRecord,
    db_records: Iterable[SeqRecord],
    scoring: ScoringModel,
    engine: str | None = None,
    lanes: int | None = None,
    sort: bool = True,
) -> SearchResult:
    """Search from in-memory records (records kept for output)."""
    query_idx = scoring.query_indices(query.seq)
    names, seqs, encoded = [], [], []
    for rec in db_records:
        names.append(rec.name)
        seqs.append(rec.seq)
        encoded.append(encode(rec.seq))
    _warn_padding(scoring, query_idx)
    scores, kernel_time = search_encoded(
        query_idx, encoded, scoring, engine=engine, lanes=lanes, sort=sort
    )
    return SearchResult(
        query_name=query.name,
        query_seq=query.seq,
        names=names,
        seqs=seqs,
        scores=scores,
        kernel_time=kernel_time,
        total_entries=len(names),
    )


def search_files(
    query_path: str,
    db_path: str,
    scoring: ScoringModel,
    engine: str | None = None,
    lanes: int | None = None,
    keep_seqs: bool = False,
    checkpoint_dir: str | None = None,
    db_cache: str | None = None,
    sort: bool = True,
) -> SearchResult:
    """Search a query FASTA (first record) against a database FASTA.

    ``keep_seqs`` retains the original sequence strings (needed for
    ``--printseq``) via the Python reader, and then, as in the JAX
    package, keeps no checkpoint.
    """
    query = read_first(query_path)
    query_idx = scoring.query_indices(query.seq)
    if keep_seqs:
        return search(
            query, read_fasta(db_path), scoring,
            engine=engine, lanes=lanes, sort=sort,
        )
    _warn_padding(scoring, query_idx)
    db = parse_file_cached(db_path, db_cache)
    scores, kernel_time = search_database(
        query_idx, db, scoring, engine=engine, lanes=lanes, sort=sort,
        checkpoint_dir=checkpoint_dir,
    )
    return SearchResult(
        query_name=query.name,
        query_seq=query.seq,
        names=db.names,
        seqs=None,
        scores=scores,
        kernel_time=kernel_time,
        total_entries=db.n,
    )


def search_files_streaming(
    query_path: str,
    db_path: str,
    scoring: ScoringModel,
    engine: str | None = None,
    lanes: int | None = None,
    chunk_records: int = 512 * 1024,
    checkpoint_dir: str | None = None,
    db_cache: str | None = None,
) -> SearchResult:
    """Bounded-memory search: stream the database in record chunks.

    ``search_files``' whole-file parse holds the database in memory, which
    a larger-than-RAM database breaks. This variant reads, encodes and
    scores ``chunk_records`` records at a time (each part length-sorted on
    its own) and keeps only names and scores; the ingest runs through the
    native chunked reader (``native_io.stream_chunks``). Scores are
    identical to :func:`search_files`'. Part ``k`` checkpoints under
    ``checkpoint_dir/part<k>``.

    ``db_cache``: when a FRESH .sqc cache exists ("auto" = sidecar), the
    parts are zero-copy views of its mmap (``iter_cache_chunks``), so the
    FASTA is never re-read and cache-only deployments stream too. A missing
    or stale cache streams from the FASTA and says so; it is not built
    here (building one needs a whole-file parse, which would defeat this
    mode's memory bound).
    """
    import queue
    import threading

    from .utils.native_io import iter_cache_chunks, load_cache, stream_chunks

    query = read_first(query_path)
    query_idx = scoring.query_indices(query.seq)
    _warn_padding(scoring, query_idx)

    chunk_iter = None
    if db_cache is not None:
        cache_path = db_path + ".sqc" if db_cache == "auto" else db_cache
        cached = load_cache(cache_path, src_path=db_path)
        if cached is not None:
            chunk_iter = iter_cache_chunks(cached, chunk_records)
        else:
            print(
                f"Note: database cache {cache_path} absent or stale; "
                "streaming from the FASTA (a streaming run does not "
                "build caches).",
                file=sys.stderr,
            )
    if chunk_iter is None:
        chunk_iter = stream_chunks(db_path, chunk_records)

    # One-deep ingest prefetch: a thread parses and encodes part k+1 while
    # the device scores part k. The native reader's ctypes calls and the
    # device's fetch release the GIL, so the two really overlap; memory
    # holds two parts (one scoring, one staged).
    staged: queue.Queue = queue.Queue(maxsize=1)
    # Consumer-driven cancellation: if the consume loop dies mid-iteration
    # (a kernel error, a checkpoint write failure, KeyboardInterrupt), the
    # producer must not block forever on the full queue, which would leak
    # the thread, the open reader and two parsed parts.
    cancel = threading.Event()

    def put(item) -> bool:
        while not cancel.is_set():
            try:
                staged.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in chunk_iter:
                if not put(item):
                    break
            else:
                put(None)
        except BaseException as e:  # re-raised on the consumer
            put(e)
        finally:
            if cancel.is_set():
                close = getattr(chunk_iter, "close", None)
                if close is not None:
                    close()

    threading.Thread(target=produce, daemon=True).start()

    def consume():
        try:
            while True:
                item = staged.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # Runs on exhaustion and when the loop below closes the
            # generator after an exception: releases the producer.
            cancel.set()

    names: list[str] = []
    parts: list[np.ndarray] = []
    kernel_time = 0.0
    for k, db in enumerate(consume()):
        ck = os.path.join(checkpoint_dir, f"part{k}") if checkpoint_dir else None
        s, dt = search_database(
            query_idx, db, scoring, engine=engine, lanes=lanes,
            checkpoint_dir=ck,
        )
        kernel_time += dt
        names.extend(db.names)
        parts.append(s)

    scores = np.concatenate(parts) if parts else np.zeros(0, dtype=np.int32)
    return SearchResult(
        query_name=query.name,
        query_seq=query.seq,
        names=names,
        seqs=None,
        scores=scores,
        kernel_time=kernel_time,
        total_entries=len(names),
    )


def search_files_multi(
    query_path: str,
    db_path: str,
    scoring: ScoringModel,
    engine: str | None = None,
    lanes: int | None = None,
    db_cache: str | None = None,
) -> MultiSearchResult:
    """Search every record of a query FASTA against a database FASTA."""
    queries = list(read_fasta(query_path))
    if not queries:
        raise ValueError(f"no sequences in {query_path}")
    query_idxs = [scoring.query_indices(q.seq) for q in queries]
    for q in query_idxs:
        _warn_padding(scoring, q)
    db = parse_file_cached(db_path, db_cache)
    scores, kernel_time = search_database_multi(
        query_idxs, db, scoring, engine=engine, lanes=lanes
    )
    return MultiSearchResult(
        query_names=[q.name for q in queries],
        query_seqs=[q.seq for q in queries],
        names=db.names,
        scores=scores,
        kernel_time=kernel_time,
        total_entries=db.n,
    )
