"""Query-vs-database search: the port of ``seqalign_tpu.pipeline``'s
single-query path.

Reads the query and the database FASTA (the JAX package's numpy host code),
length-sorts the records, packs them into segmented window streams, scores
each chunk of streams in one launch of the stream kernel
(``ops.swa_cuda.sw_stream``) and scatters the scores back to database
order. The timer covers the launch, the kernel and the fetch of the scores;
parsing, packing and the host-to-device copy stay outside it, the same
boundary as the JAX package's and the reference's.

The device comes from ``SEQALIGN_PLATFORM`` (``cuda``, the default, or
``cpu``). With no GPU, ``cuda`` is an error, never a silent run on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from .convert import profile_to_torch, stream_pack_to_torch
from .host import (
    EncodedDatabase, ScoringModel, SeqRecord, encode, lattice_round_up,
    pack_batch, pack_streams, parse_file_cached, read_fasta, read_first,
)
from .ops.swa_cuda import MAX_QUERY_ROWS, STREAM_JB, supported_scoring, sw_stream
from .ops.swa_torch import make_profile, sw_scan, sw_wavefront

ENGINES = ("stream", "wavefront", "scan")

# Lanes of one window stream: one 256-thread CTA of the kernel.
WINDOW_LANES = 256
STREAM_GRAIN = 16  # segment-length rounding, a multiple of STREAM_JB
# Output slots per launch; bounds the host-side chunk (slots * lanes
# records per launch).
MAX_STREAM_SLOTS = 4096
# Lane-batch width of the wavefront and scan engines.
BATCH_LANES = 512


@dataclasses.dataclass
class SearchResult:
    """Scores for one query against a database, in database stream order."""

    query_name: str
    query_seq: str
    names: list[str]
    seqs: list[str] | None
    scores: np.ndarray  # (N,) int32
    kernel_time: float  # seconds in launch + execution + score fetch
    total_entries: int


def resolve_device(platform: str | None = None) -> torch.device:
    """The device named by ``platform`` or ``SEQALIGN_PLATFORM``."""
    plat = platform or os.environ.get("SEQALIGN_PLATFORM") or "cuda"
    if plat == "cpu":
        return torch.device("cpu")
    if plat != "cuda":
        raise ValueError(
            f"SEQALIGN_PLATFORM={plat!r}: expected 'cpu' or 'cuda'"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (SEQALIGN_PLATFORM=cuda is the "
            "default); set SEQALIGN_PLATFORM=cpu to run on the CPU"
        )
    return torch.device("cuda")


def get_engine(name: str) -> Callable:
    """Resolve a lane-batch engine name to fn(profile, db, go, ge) -> scores.

    The stream engine is not a lane-batch engine: ``search_database`` runs
    it through ``_stream_search``.
    """
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
    device: torch.device | str | None = None,
) -> tuple[np.ndarray, float]:
    """Score an encoded query against an EncodedDatabase.

    Returns (scores in database stream order (N,) int32, kernel seconds).
    ``engine`` is one of ``ENGINES`` (default ``stream``); ``device``
    defaults to :func:`resolve_device`.
    """
    eng = engine or "stream"
    if eng not in ENGINES:
        raise KeyError(f"unknown engine {eng!r}; expected one of {ENGINES}")
    dev = resolve_device() if device is None else torch.device(device)

    n = db.n
    scores = np.zeros(n, dtype=np.int32)
    if n == 0 or len(query_idx) == 0:
        return scores, 0.0

    profile = make_profile(scoring.table, query_idx)
    go, ge = scoring.gap_open_total, scoring.gap_extend
    lengths = db.lengths
    order = np.argsort(-lengths, kind="stable") if sort else np.arange(n)

    if eng == "stream":
        if not supported_scoring(profile, go, ge):
            print(
                "Note: scoring system outside the stream kernel's int32 "
                "G-form envelope (it needs gap_extend >= gap_open + "
                "gap_extend, gap_extend <= 0, no int32 overflow); using "
                "wavefront.",
                file=sys.stderr,
            )
            eng = "wavefront"
        elif len(query_idx) > MAX_QUERY_ROWS:
            raise NotImplementedError(
                f"query of {len(query_idx)} residues exceeds the stream "
                f"kernel's MAX_QUERY_ROWS={MAX_QUERY_ROWS}; longer queries "
                "need the K2 row-striped kernel, which is not yet ported "
                "(--engine wavefront scores them)"
            )
        else:
            return _stream_search(profile, db, go, ge, order, lanes, dev)

    win = lanes or BATCH_LANES
    engine_fn = get_engine(eng)
    prof_dev = torch.from_numpy(profile).to(dev)
    kernel_time = 0.0
    for start in range(0, n, win):
        ids = order[start : start + win]
        lb_pad = lattice_round_up(int(lengths[ids].max(initial=1)))
        batch = torch.from_numpy(pack_batch(db, ids, win, lb_pad)).to(dev)
        _sync(dev)
        t0 = time.perf_counter()
        out = engine_fn(prof_dev, batch, go, ge).cpu()
        kernel_time += time.perf_counter() - t0
        scores[ids] = out.numpy()[: len(ids)]
    return scores, kernel_time


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


def _stream_search(
    profile: np.ndarray,
    db: EncodedDatabase,
    go: int,
    ge: int,
    order: np.ndarray,
    lanes: int | None,
    device: torch.device,
) -> tuple[np.ndarray, float]:
    """Whole-database search through the segmented stream kernel.

    The database becomes NW window streams scored in one launch per chunk
    of ``MAX_STREAM_SLOTS`` segments.
    """
    n = db.n
    win = WINDOW_LANES
    scores = np.zeros(n, dtype=np.int32)
    kernel_time = 0.0
    prof_dev = profile_to_torch(profile, go, device)
    if device.type == "cuda":
        from .ops import _build

        _build.load()  # a first use builds the kernel: set-up, not timed
    max_lanes = resident_lanes(device)
    per_chunk = MAX_STREAM_SLOTS * win
    for start in range(0, n, per_chunk):
        chunk = order[start : start + per_chunk]
        nw = choose_windows(db.lengths[chunk], win, lanes, max_lanes)
        pack = pack_streams(
            db, chunk, nw, win=win, jb=STREAM_JB, grain=STREAM_GRAIN
        )
        streams, fs = stream_pack_to_torch(pack, device)
        _sync(device)
        t0 = time.perf_counter()
        out = sw_stream(
            prof_dev, streams, fs, go, ge,
            nslots=len(pack.slot_ids), jb=STREAM_JB,
        ).cpu()
        kernel_time += time.perf_counter() - t0
        # Slot s holds chunk records [s*win, (s+1)*win): the flattened slots
        # are the chunk in packing order, the final group's padding lanes
        # past its end.
        scores[chunk] = out.numpy().reshape(-1)[: len(chunk)]
    return scores, kernel_time


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
    scores, kernel_time = search_database(
        query_idx, _db_from_encoded(encoded), scoring,
        engine=engine, lanes=lanes, sort=sort,
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
    db_cache: str | None = None,
    sort: bool = True,
) -> SearchResult:
    """Search a query FASTA (first record) against a database FASTA.

    ``keep_seqs`` retains the original sequence strings (needed for
    ``--printseq``) via the Python reader.
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
        query_idx, db, scoring, engine=engine, lanes=lanes, sort=sort
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
