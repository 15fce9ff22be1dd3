"""bench.py's synthetic Swiss-Prot, and where a search over it spends its time.

:func:`swissprot_db` rebuilds the database of ``bench.py:308-332``: 565,247
records with gamma(1.8, 202) lengths clipped to 2..35,000 (about 205 M
residues), UniProt amino-acid frequencies, seed 42, plus a query drawn from
the same stream.

    python -m seqalign_tpu_torch.swissprot [--lq 17,144,512,1536,2000]
        [--stripe-rows 256,512,768] [--windows 132,264,396,528,1056]
        [--nq N] [--fixed [--teams]] [--stream-chunk N] [--out FILE.json]

times each layer of a search over it on the GPU, PAM250, gaps -2/-1: the
FASTA parse and the host packer ``pack_streams``, each native (the fastio
library that ``seqalign_tpu_torch.native`` builds) and pure Python; then
the pipeline's steps: the sort, the plan (``pipeline.plan_chunk``), the
database's copy to the card (``convert.database_to_torch``'s page-locked
pieces beside a pageable copy and the arrays registered in place, each
twice: :func:`copy_database`), the pack kernel (``pack_streams_device``,
CUDA events), the kernel (CUDA events), the reorder on the card and the
fetch into page-locked memory; beside them the host packer's steps they
replaced (pack, copy of the streams, fetch and numpy scatter); the whole
``search_database`` call, and the device's busy share under
``torch.profiler``. It then times the kernel at
each query length of ``--lq`` (the pipeline's own window count) and, with
the 144-residue query, at each window count of ``--windows``. A query
longer than ``MAX_QUERY_ROWS`` runs the row-striped kernel (K2) at each
stripe height of ``--stripe-rows`` (default ``STRIPE_ROWS``; a height of 32
R rows runs K2's instance of R rows per thread, so 256,512,768,1024 sweeps
R over 8, 16, 24 and 32): the number of passes, R and the registers of
the instances the passes launch, each pass's time and the whole search's;
then, at ``STRIPE_ROWS``, the last pass at each R built that holds its
rows, K2 over streams of each window count of ``--windows``, and three
``search_database`` calls at that length. Every line printed names
the card and its power limit; ``--out`` gets the same as JSON. The FASTA is
written to and parsed from ``build/`` of the checkout.

With ``--nq N`` it times the multi-query search instead, for a batch of N
random queries of each length of ``--lq`` (``--nq 8 --lq 17`` is
bench.py's multi-query point): the plan, copy and pack of every chunk,
the multi-query kernel (CUDA events, every launch of the batch), the
reorder on the card and the fetch (beside the host scatter it replaced),
the whole ``search_database_multi`` call and the device's busy share;
beside them, the single-query kernel looped over the N queries on
the same streams. Where the length runs a team of one thread (up to 24
rows: the solo kernel), K3 is also timed at each Q built (queries a
thread, ``queries=``), in turns: the sweep ``swa_cuda.
stream_solo_queries``' rule rests on (``--lq 10,12,16,17,20,24`` covers
every solo R), once every Q in {1, 2, 4} is built again at each R.

With ``--fixed`` it times the fixed-batch kernel (K4) and its constant-S
mode (K5) instead: the database, length-sorted, cut into the lane batches
of ``pipeline.lane_batches`` at each width of ``FIXED_LANES``, every batch one
launch on device-resident windows, for each query length of ``--lq``; K4
and K5 in turns (K4, K5, K5, K4), the (T, R) the launches run and the cells
K4 runs (each warp to its own end, as ``swa_cuda.windows_cells`` models
them from the batch) beside the real and the batches' cells,
and K1 over the pipeline's streams at the same query length beside them.
K5 runs every batch cell. With ``--teams`` it also times K4 at each team
size that holds the rows (at its smallest R), the measurements
``swa_cuda.windows_team``'s rule rests on.

With ``--stream-chunk N`` it times the bounded-memory search instead
(``pipeline.search_files_streaming``, parts of N records, the 144-residue
query): its wall beside ``search_files``', the device's busy share, the
chunked reader alone and the parts' searches alone, and how much of the
ingest the prefetch thread hides behind the device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .host import EncodedDatabase, ScoringModel, encode, load_builtin
from .models import decode

AA = "ACDEFGHIKLMNPQRSTVWY"
AA_FREQS = np.array([
    8.25, 1.37, 5.45, 6.75, 3.86, 7.07, 2.27, 5.96, 5.84, 9.66,
    2.42, 4.06, 4.70, 3.93, 5.53, 6.56, 5.34, 6.87, 1.08, 2.92,
])
AA_FREQS = AA_FREQS / AA_FREQS.sum()
N_ENTRIES = 565_247
QUERY_LEN = 144
# The lane-batch widths at which the fixed-batch kernel (K4) is measured:
# the JAX package's TPU lane batch, a middle width, and 66 windows of 1,024
# lanes (one wave of 2 CTAs x 256 threads on each of an H100's 132 SMs).
FIXED_LANES = (4096, 16384, 67584)
# The long pair's cells (chip_smoke's phase 13, ``turns --longpair``): one
# titin-class query (the JAX tool's --lq 35000) against the LONGPAIR_RECORDS
# longest records as one lane batch, through ``parallel.sw_longpair`` on
# entries of one card: (entries, data slices, jb), a 1-D mesh for one data
# slice, else data x seq.
LONGPAIR_LQ = 35_000
LONGPAIR_RECORDS = 1024
LONGPAIR_RUNS = ((1, 1, 128), (2, 1, 128), (4, 1, 128), (2, 2, 128), (4, 1, 512))


def swissprot_db(seed: int = 42):
    """(encoded 144-residue query, EncodedDatabase), records in descending
    length."""
    rng = np.random.default_rng(seed)
    aa20 = np.array(encode(AA), dtype=np.int8)
    query = aa20[rng.choice(20, QUERY_LEN, p=AA_FREQS)].astype(np.int32)
    lengths = np.clip(
        rng.gamma(shape=1.8, scale=202.0, size=N_ENTRIES).astype(np.int64),
        2, 35_000,
    )
    lengths = np.sort(lengths)[::-1].copy()
    offsets = np.zeros(N_ENTRIES + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    seq = aa20[rng.choice(20, int(offsets[-1]), p=AA_FREQS)]
    return query, EncodedDatabase(seq=seq, offsets=offsets, names=[""] * N_ENTRIES)


def random_query(lq: int, seed: int) -> np.ndarray:
    """An encoded query of ``lq`` residues at UniProt frequencies."""
    rng = np.random.default_rng(seed)
    aa20 = np.array(encode(AA), dtype=np.int32)
    return aa20[rng.choice(20, lq, p=AA_FREQS)]


def pam250() -> ScoringModel:
    return load_builtin(
        "PAM250", ScoringModel(gap_open=-2, gap_extend=-1, use_match_mismatch=False)
    )


def longpair_case(db: EncodedDatabase):
    """The long pair's inputs over ``db`` (``swissprot_db``'s): (the
    encoded LONGPAIR_LQ-residue query, its profile, PAM250, the
    LONGPAIR_RECORDS longest records as an EncodedDatabase, their ``(L,
    records)`` lane batch)."""
    from .host import pack_batch
    from .ops.swa_torch import make_profile
    from .pipeline import PLANS, _db_from_encoded

    sc = pam250()
    query = random_query(LONGPAIR_LQ, LONGPAIR_LQ)
    ids = PLANS.find(db, True).order[:LONGPAIR_RECORDS]
    sub = _db_from_encoded([db.seq[db.offsets[i]:db.offsets[i + 1]] for i in ids])
    batch = pack_batch(sub, np.arange(sub.n), sub.n, int(sub.lengths.max()))
    return query, make_profile(sc.table, query), sc, sub, batch


def longpair_mesh(dev, entries: int, data: int):
    """A run of LONGPAIR_RUNS on ``dev``: (the mesh, ``sw_longpair``'s axis
    keywords, its name)."""
    if data == 1:
        return [dev] * entries, {}, f"x{entries}"
    return ([[dev] * entries for _ in range(data)], {"axis": "seq", "data_axis": "data"},
            f"{data}x{entries} data x seq")


def write_fasta(db: EncodedDatabase, path: Path) -> None:
    letters = np.zeros(32, dtype=np.uint8)
    letters[np.array(encode(AA))] = np.frombuffer(AA.encode(), dtype=np.uint8)
    buf = letters[db.seq].tobytes()
    off = db.offsets
    with open(path, "wb") as f:
        f.write(b"".join(
            b">r%d\n%s\n" % (k, buf[off[k] : off[k + 1]]) for k in range(db.n)
        ))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def striped_pass_ms(stripes, streams, fs, go, ge, nslots, reps) -> list[float]:
    """CUDA-event ms of each K2 pass of ``stripes`` over the streams, each
    reading the boundary of the pass before (from its own timed runs)."""
    from .ops.swa_cuda import STREAM_JB, sw_stream_striped_pass

    bnd = torch.empty((2, 2, *streams.shape), dtype=torch.int32, device=streams.device)
    out = []
    for p, st in enumerate(stripes):
        kw = dict(nslots=nslots, jb=STREAM_JB,
                  bnd_in=bnd[(p - 1) % 2] if p else None,
                  bnd_out=bnd[p % 2] if p < len(stripes) - 1 else None)
        out.append(cuda_ms(lambda: sw_stream_striped_pass(st, streams, fs, go, ge, **kw), reps))
    return out


def last_pass_ms(stripes, streams, fs, go, ge, nslots, reps) -> dict[int, float]:
    """CUDA-event ms of the last of two or more K2 passes at each R of
    ``STRIPE_ROWS_PER_THREAD_BUILT`` whose team holds its rows, reading the
    boundary the passes before it wrote; the bests must not depend on R."""
    from .ops.swa_cuda import (
        STREAM_JB, STRIPE_ROWS_PER_THREAD_BUILT, STRIPE_TEAM, sw_stream_striped_pass,
    )

    bnd = torch.empty((2, 2, *streams.shape), dtype=torch.int32, device=streams.device)
    kw = dict(nslots=nslots, jb=STREAM_JB)
    for p, st in enumerate(stripes[:-1]):
        sw_stream_striped_pass(st, streams, fs, go, ge,
                               bnd_in=bnd[(p - 1) % 2] if p else None,
                               bnd_out=bnd[p % 2], **kw)
    last, bnd_in = stripes[-1], bnd[(len(stripes) - 2) % 2]
    out, want = {}, None
    for r in STRIPE_ROWS_PER_THREAD_BUILT:
        if STRIPE_TEAM * r < last.shape[0]:
            continue

        def run():
            return sw_stream_striped_pass(last, streams, fs, go, ge, bnd_in=bnd_in,
                                          rows_per_thread=r, **kw)[0]

        got = run()
        want = got if want is None else want
        if not torch.equal(got, want):
            raise SystemExit(f"swissprot: the last K2 pass at R={r} differs")
        out[r] = cuda_ms(run, reps)
    return out


def _seconds(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_busy(fn):
    """(wall seconds, device-busy ms, top kernels) of fn under torch.profiler;
    device-side events only (a host op such as aten::copy_ also reports
    the device time of the memcpy it issued)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        _, wall = _seconds(fn)
    on_device = [e for e in p.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in on_device)
    top = sorted(((e.key, e.self_device_time_total / 1e3) for e in on_device),
                 key=lambda kv: -kv[1])[:6]
    return wall, busy_us / 1e3, top


def copy_database(db: EncodedDatabase, dev, how: str) -> tuple[torch.Tensor, torch.Tensor]:
    """``convert.database_to_torch``'s copy (``how="pinned"``: page-locked
    pieces), or one of the two it was measured against: ``"pageable"``
    (one copy from the arrays as they lie) or ``"registered"`` (the arrays
    page-locked in place for the copy)."""
    from .convert import database_to_torch

    if how == "pinned":
        return database_to_torch(db, dev)
    arrays = (db.seq, np.asarray(db.offsets, np.int64))
    if how == "pageable":
        return tuple(torch.from_numpy(a).to(dev) for a in arrays)
    if how != "registered":
        raise ValueError(f"unknown copy {how!r}")
    cudart = torch.cuda.cudart()
    out = []
    for a in arrays:
        src = torch.from_numpy(a)
        err = cudart.cudaHostRegister(src.data_ptr(), a.nbytes, 0)
        if int(err):
            raise RuntimeError(f"cudaHostRegister failed: {err}")
        try:
            out.append(src.to(dev, non_blocking=True))
            torch.cuda.current_stream(dev).synchronize()
        finally:
            cudart.cudaHostUnregister(src.data_ptr())
    return tuple(out)


def reorder_and_fetch(outs, shape, dev) -> tuple[float, np.ndarray]:
    """Seconds to put each chunk's launch output ``(chunk, out)`` in
    database order on the card and fetch it once into page-locked memory,
    as the pipeline's timer ends (the page-locked buffer made first, as
    the pipeline makes it before its timer); and the scores."""
    from . import pipeline

    fetched = pipeline._host_scores(shape, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = torch.zeros(shape, dtype=torch.int32, device=dev)
    for chunk, out in outs:
        pipeline.scatter_slots(scores, chunk, out)
    fetched.copy_(scores)
    return time.perf_counter() - t0, fetched.numpy()


@contextlib.contextmanager
def python_ingest():
    """``native_io``'s pure-Python parse and pack in place of the native
    library, for timing the two side by side."""
    from .utils import native_io

    load = native_io._load
    native_io._load = lambda: None
    try:
        yield
    finally:
        native_io._load = load


def ingest_breakdown(db: EncodedDatabase, fasta: Path, say) -> dict:
    """The whole database's FASTA parse and stream pack (the pipeline's
    windows), native and pure Python: the seconds of each, the outputs
    checked equal to each other and the parse to ``db``."""
    from . import pipeline
    from .host import pack_streams
    from .ops.swa_cuda import STREAM_JB
    from .utils import native_io

    if not native_io.available():
        raise SystemExit("swissprot: the native fastio library is not available")
    out = {}
    t0 = time.perf_counter()
    parsed = native_io.parse_file(str(fasta))
    out["parse_native_s"] = time.perf_counter() - t0
    with python_ingest():
        t0 = time.perf_counter()
        plain = native_io.parse_file(str(fasta))
        out["parse_python_s"] = time.perf_counter() - t0
    for got in (parsed, plain):
        if not (np.array_equal(got.seq, db.seq) and np.array_equal(got.offsets, db.offsets)):
            raise SystemExit("swissprot: the parsed FASTA differs from the database")
    if parsed.names != plain.names:
        raise SystemExit("swissprot: native and Python parses name the records differently")
    del plain
    order = pipeline.PLANS.find(db, True).order
    win = pipeline.WINDOW_LANES
    nw = pipeline.choose_windows(db.lengths[order], win, None,
                                 pipeline.resident_lanes(pipeline.resolve_device()))
    kw = dict(win=win, jb=STREAM_JB, grain=pipeline.STREAM_GRAIN)
    t0 = time.perf_counter()
    pack = pack_streams(parsed, order, nw, **kw)
    out["pack_native_s"] = time.perf_counter() - t0
    with python_ingest():
        t0 = time.perf_counter()
        plain = pack_streams(parsed, order, nw, **kw)
        out["pack_python_s"] = time.perf_counter() - t0
    if not (np.array_equal(pack.streams, plain.streams) and np.array_equal(pack.fs, plain.fs)):
        raise SystemExit("swissprot: native and Python packs differ")
    say(f"[ingest] {db.n} records, {int(db.offsets[-1])} residues: parse native "
        f"{out['parse_native_s']} s, Python {out['parse_python_s']} s; pack (nw={nw}) "
        f"native {out['pack_native_s']} s, Python {out['pack_python_s']} s; "
        "outputs equal")
    return out


def streaming_breakdown(query_fa: Path, fasta: Path, sc, chunk_records: int, say) -> dict:
    """``search_files_streaming`` in parts of ``chunk_records`` records
    against ``search_files`` over the same FASTA: both walls (best of two),
    the streaming search's device busy share, the chunked reader alone, the
    parts' searches alone (parsed beforehand), and the ingest seconds the
    prefetch thread hides (reader + searches - streaming wall)."""
    from . import pipeline
    from .host import read_first
    from .utils import native_io

    dev = pipeline.resolve_device()
    tag = f"[stream-chunk {chunk_records}]"
    query_idx = sc.query_indices(read_first(str(query_fa)).seq)
    t0 = time.perf_counter()
    parts = list(native_io.stream_chunks(str(fasta), chunk_records))
    ingest_s = time.perf_counter() - t0
    pipeline.search_database(query_idx, parts[0], sc, device=dev)  # builds the kernel
    _, search_s = _seconds(
        lambda: [pipeline.search_database(query_idx, p, sc, device=dev) for p in parts])
    n_parts = len(parts)
    del parts

    def streaming():
        return pipeline.search_files_streaming(
            str(query_fa), str(fasta), sc, chunk_records=chunk_records)

    stream_walls = [_seconds(streaming)[1] for _ in range(2)]
    whole_walls = [_seconds(lambda: pipeline.search_files(str(query_fa), str(fasta), sc))[1]
                   for _ in range(2)]
    wall, busy_ms, top = device_busy(streaming)
    hidden_s = ingest_s + search_s - min(stream_walls)
    out = {"chunk_records": chunk_records, "parts": n_parts, "ingest_s": ingest_s,
           "parts_search_s": search_s, "streaming_wall_s": stream_walls,
           "search_files_wall_s": whole_walls, "hidden_ingest_s": hidden_s,
           "hidden_share": hidden_s / ingest_s,
           "profile": {"wall_s": wall, "device_ms": busy_ms,
                       "busy_share": busy_ms / 1e3 / wall, "top_ms": top}}
    say(f"{tag} {n_parts} parts: streaming wall {stream_walls} s, search_files wall "
        f"{whole_walls} s; chunked reader alone {ingest_s} s, the parts' searches "
        f"alone {search_s} s; prefetch hides {hidden_s} s of the ingest "
        f"({hidden_s / ingest_s} of it); device busy {busy_ms} ms in a {wall} s "
        f"streaming wall, share {busy_ms / 1e3 / wall}; {top}")
    return out


def fixed_profiles(query, lqs, dev) -> dict[int, torch.Tensor]:
    """The biased PAM250 profile of ``query`` at its own length, and of a
    random query at each other length of ``lqs``, keyed by length."""
    from .convert import profile_to_torch
    from .ops.swa_torch import make_profile

    sc = pam250()
    return {lq: profile_to_torch(make_profile(
        sc.table, query if lq == len(query) else random_query(lq, lq)),
        sc.gap_open_total, dev) for lq in lqs}


def stream_k1_ms(db, profs) -> dict[int, float]:
    """CUDA-event ms of K1 over the pipeline's streams of the whole
    database, for each profile of ``profs``."""
    from . import pipeline
    from .convert import stream_pack_to_torch
    from .host import pack_streams
    from .ops.swa_cuda import STREAM_JB, sw_stream

    dev = torch.device("cuda")
    sc = pam250()
    order = pipeline.PLANS.find(db, True).order
    win = pipeline.WINDOW_LANES
    nw = pipeline.choose_windows(db.lengths[order], win, None, pipeline.resident_lanes(dev))
    pack = pack_streams(db, order, nw, win=win, jb=STREAM_JB, grain=pipeline.STREAM_GRAIN)
    streams, fs = stream_pack_to_torch(pack, dev)
    kw = dict(nslots=len(pack.slot_ids), jb=STREAM_JB)
    return {lq: cuda_ms(lambda: sw_stream(p, streams, fs, sc.gap_open_total,
                                          sc.gap_extend, rows=lq, **kw), 2)
            for lq, p in profs.items()}


def fixed_breakdown(db, profs, k1_ms, say, teams: bool = False) -> list[dict]:
    """K4 and K5 over the fixed lane batches at each width of FIXED_LANES
    and each profile of ``profs`` (keyed by query length), in turns (K4,
    K5, K5, K4), beside ``k1_ms``, K1's time at each length; with
    ``teams``, K4 at each team size's smallest R that holds the rows too."""
    from . import pipeline
    from .convert import batch_windows
    from .ops.swa_cuda import (
        FIXED_WINDOW_LANES, STREAM_JB, STREAM_TEAMS, WINDOWS_ROWS_PER_THREAD_BUILT,
        sw_windows, windows_cells, windows_launch_team,
    )

    dev = torch.device("cuda")
    sc = pam250()
    go, ge = sc.gap_open_total, sc.gap_extend
    residues = int(db.offsets[-1])
    order = pipeline.PLANS.find(db, True).order
    out = []
    for lanes in FIXED_LANES:
        t0 = time.perf_counter()
        batches = list(pipeline.lane_batches(db, order, lanes))
        pack_s = time.perf_counter() - t0
        wins = [batch_windows(b, FIXED_WINDOW_LANES, STREAM_JB, dev) for _, b in batches]
        cells_per_row = sum(w.numel() for w in wins)
        tag = f"[fixed B={lanes}]"
        say(f"{tag} {len(batches)} batches, Lb {wins[0].shape[1]}..{wins[-1].shape[1]}, "
            f"padded/real cells {cells_per_row / residues}, pack {pack_s} s")
        for lq, p in profs.items():
            turns = {False: [], True: []}
            for const_s in (False, True, True, False):
                turns[const_s].append(cuda_ms(lambda: [
                    sw_windows(p, w, go, ge, const_s=const_s) for w in wins], 1))
            k4, k5 = min(turns[False]), min(turns[True])
            # The PAM250 query holds no '*': K4 stops each warp at its end.
            # The cells that runs are modelled from the batch (windows_cells);
            # the kernel counts none.
            team = windows_launch_team(p, wins[0])
            rows = p.shape[0]
            run = sum(windows_cells(w, rows, team)["run"] for w in wins)
            row = {"lanes": lanes, "lq": lq, "batches": len(batches), "team": team,
                   "k4_ms": turns[False], "k5_ms": turns[True], "k5_over_k4": k5 / k4,
                   "k1_ms": k1_ms[lq], "k4_over_k1": k4 / k1_ms[lq],
                   "gcups_real": lq * residues / k4 / 1e6,
                   "gcups_batch_cells": rows * cells_per_row / k4 / 1e6,
                   "padded_over_real": cells_per_row / residues,
                   "model_cells_run": run, "cells_real": rows * residues,
                   "cells_batch": rows * cells_per_row,
                   "model_run_over_real": run / (rows * residues)}
            if teams:
                row["teams_ms"] = {}
                for t in STREAM_TEAMS:
                    r = min((r for r in WINDOWS_ROWS_PER_THREAD_BUILT if t * r >= rows),
                            default=None)
                    if r is not None:
                        row["teams_ms"][f"{t}x{r}"] = cuda_ms(lambda: [
                            sw_windows(p, w, go, ge, team=(t, r)) for w in wins], 2)
                say(f"{tag} lq={lq}: K4 at each team (T x R: ms) {row['teams_ms']}")
            out.append(row)
            say(f"{tag} lq={lq}: (T, R) {team}; K4 {turns[False]} ms ({row['gcups_real']} "
                f"GCUPS over real residues), cells run (model) {run} = "
                f"{row['model_run_over_real']} of "
                f"the real {rows * residues} (the batches' {rows * cells_per_row}); K5 "
                f"{turns[True]} ms over every batch cell, K5/K4 {row['k5_over_k4']}; K1 "
                f"{k1_ms[lq]} ms, K4/K1 {row['k4_over_k1']}")
        del wins
    return out


def multi_breakdown(db, nq: int, lq: int, say) -> dict:
    """Where a multi-query search of nq queries of lq residues spends its
    time, and the single-query kernel looped over the same queries."""
    from . import pipeline
    from .convert import profile_to_torch
    from .ops.swa_cuda import (
        STREAM_JB, STREAM_SOLO_QUERIES, STREAM_SOLO_ROWS, stream_kernel_instance,
        stream_team, sw_stream, sw_stream_multi,
    )
    from .ops.swa_torch import make_profile

    dev = torch.device("cuda")
    sc = pam250()
    go, ge = sc.gap_open_total, sc.gap_extend
    kw = dict(jb=STREAM_JB)
    queries = [random_query(lq, 100 + k) for k in range(nq)]
    cells = nq * lq * int(db.offsets[-1])
    tag = f"[multi {nq}x{lq}]"
    pipeline.search_database_multi(queries, db, sc, device=dev)  # builds the kernel
    steps = {}
    t0 = time.perf_counter()
    blocks = pipeline.query_blocks(
        pipeline.multi_profile(sc.table, queries), go, db.n, dev)
    steps["profiles"] = time.perf_counter() - t0
    # Order and plans (the memo's, made by the search above), copy of the
    # database and pack kernel, chunk by chunk, as the pipeline runs them
    # before its timer.
    chunks, steps["plan_copy_pack"] = _seconds(
        lambda: [(chunk, *packed) for chunk, packed in
                 pipeline.stream_chunks(db, None, dev)])

    def k3_all():
        return [sw_stream_multi(b, s, f, go, ge, nslots=ns, rows=lq, **kw)
                for _, s, f, ns in chunks for b in blocks]

    steps["kernel"] = cuda_ms(k3_all, 3) / 1e3
    outs = [(chunk, torch.cat([sw_stream_multi(b, s, f, go, ge, nslots=ns, rows=lq, **kw)
                               for b in blocks], dim=1)) for chunk, s, f, ns in chunks]
    steps["reorder_and_fetch"], fetched = reorder_and_fetch(outs, (nq, db.n), dev)
    # The host packer's step it replaced: a pageable fetch, a numpy scatter.
    t0 = time.perf_counter()
    scores = np.zeros((nq, db.n), np.int32)
    for chunk, out in outs:
        pipeline.scatter_slots(scores, chunk, out.cpu())
    steps["host_fetch_and_scatter"] = time.perf_counter() - t0
    if not np.array_equal(scores, fetched):
        raise SystemExit(f"{tag} the reorder on the card != the host scatter")
    del outs
    shape = (f"{len(blocks)} block(s) of {blocks[0].shape[0]} x {blocks[0].shape[1]} "
             f"rows, {len(chunks)} chunk(s), nw="
             + "/".join(str(s.shape[0]) for _, s, _, _ in chunks)
             + " L=" + "/".join(str(s.shape[1]) for _, s, _, _ in chunks))
    say(f"{tag} {shape}")
    for k, v in steps.items():
        say(f"{tag} [steps] {k}: {v} s")
    nqb = blocks[0].shape[0]
    say(f"{tag} K3 {steps['kernel'] * 1e3} ms = {cells / steps['kernel'] / 1e9} GCUPS "
        f"({stream_kernel_instance(lq, nq=nqb)})")
    team = stream_team(lq)
    queries_ms = {}
    if team[0] == 1 and team[1] in STREAM_SOLO_ROWS:
        # In turns: each Q once up the list and once down it, the faster kept.
        qs = STREAM_SOLO_QUERIES[team[1]]
        for q in (*qs, *qs[::-1]):
            ms = cuda_ms(lambda: [sw_stream_multi(b, s, f, go, ge, nslots=ns, rows=lq,
                                                  queries=q, **kw)
                                  for _, s, f, ns in chunks for b in blocks], 3)
            queries_ms[q] = min(queries_ms.get(q, ms), ms)
        say(f"{tag} K3 at each Q (queries a thread) at (T, R) = {team}: "
            + ", ".join(f"Q={q} {stream_kernel_instance(lq, nq=nqb, queries=q)} "
                        f"{ms} ms" for q, ms in queries_ms.items()))

    walls = []
    for _ in range(3):
        (_, kernel_s), wall = _seconds(
            lambda: pipeline.search_database_multi(queries, db, sc, device=dev))
        walls.append({"wall_s": wall, "kernel_timer_s": kernel_s})
        say(f"{tag} [search] wall {wall} s, kernel timer {kernel_s} s = "
            f"{cells / kernel_s / 1e9} GCUPS")
    wall, busy_ms, top = device_busy(
        lambda: pipeline.search_database_multi(queries, db, sc, device=dev))
    say(f"{tag} [profile] device {busy_ms} ms in a {wall} s search wall, busy "
        f"share {busy_ms / 1e3 / wall}; {top}")

    # K1 over the same queries and streams: what nq single-query searches
    # launch.
    profs = [profile_to_torch(make_profile(sc.table, q), go, dev) for q in queries]
    k1_ms = cuda_ms(lambda: [sw_stream(p, s, f, go, ge, nslots=ns, rows=lq, **kw)
                             for _, s, f, ns in chunks for p in profs], 3)
    say(f"{tag} K1 x {nq}: {k1_ms} ms = {cells / k1_ms / 1e6} GCUPS")
    return {"nq": nq, "lq": lq, "shape": shape, "steps_s": steps, "search": walls,
            "profile": {"wall_s": wall, "device_ms": busy_ms, "top_ms": top},
            "k3_ms": steps["kernel"] * 1e3, "k3_instance": stream_kernel_instance(lq, nq=nqb),
            "k3_queries_ms": queries_ms, "k1_loop_ms": k1_ms}


def main(argv=None) -> int:
    from . import pipeline, sass
    from .convert import PinnedPieces, profile_stripes, profile_to_torch, stream_pack_to_torch
    from .host import pack_streams, plan_streams
    from .ops import _build
    from .ops.pack_cuda import pack_streams_device
    from .ops.swa_cuda import (
        MAX_QUERY_ROWS, STREAM_JB, STRIPE_ROWS, stripe_kernel_instance,
        stripe_rows_per_thread, sw_stream, sw_stream_striped,
    )
    from .ops.swa_torch import make_profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lq", default="17,144,512,1536")
    ap.add_argument("--stripe-rows", default=str(STRIPE_ROWS),
                    help="stripe heights at which to time a long query")
    ap.add_argument("--windows", default="132,264,396,528,1056")
    ap.add_argument("--nq", type=int, default=0,
                    help="time the multi-query search of this many queries")
    ap.add_argument("--fixed", action="store_true",
                    help="time the fixed-batch kernel (K4) and K5 instead")
    ap.add_argument("--teams", action="store_true",
                    help="with --fixed, time K4 at every team size too")
    ap.add_argument("--stream-chunk", type=int, default=0,
                    help="time the bounded-memory search in parts of this many records")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("swissprot: no CUDA device")
    lqs = [int(x) for x in args.lq.split(",")]
    stripe_rows = [int(x) for x in args.stripe_rows.split(",")]
    windows = [int(x) for x in args.windows.split(",") if x]
    smi = card()
    dev = torch.device("cuda")
    sc = pam250()
    go, ge = sc.gap_open_total, sc.gap_extend
    result = {"card": smi, "steps_s": {}, "lq": [], "windows": [], "long_search": [],
              "long_windows": [], "last_pass": []}
    steps = result["steps_s"]

    def say(msg):
        print(f"{msg} | {smi}", flush=True)

    query, db = swissprot_db()
    residues = int(db.offsets[-1])
    if args.nq:
        result["multi"] = [multi_breakdown(db, args.nq, lq, say) for lq in lqs]
        _write(args.out, result)
        return 0
    if args.fixed:
        profs = fixed_profiles(query, lqs, dev)
        result["fixed"] = fixed_breakdown(db, profs, stream_k1_ms(db, profs), say,
                                          args.teams)
        _write(args.out, result)
        return 0
    build = Path(__file__).resolve().parent.parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        fasta = Path(tmp) / "swissprot.fa"
        write_fasta(db, fasta)
        if args.stream_chunk:
            query_fa = Path(tmp) / "query.fa"
            query_fa.write_text(">query\n" + decode(query) + "\n")
            result["streaming"] = streaming_breakdown(
                query_fa, fasta, sc, args.stream_chunk, say)
            _write(args.out, result)
            return 0
        ingest = ingest_breakdown(db, fasta, say)
    result["ingest_s"] = ingest
    steps["parse"] = ingest["parse_native_s"]
    steps["parse_python"] = ingest["parse_python_s"]
    steps["pack_python"] = ingest["pack_python_s"]
    say(f"[steps] parse {db.n} records, {residues} residues: {steps['parse']} s "
        f"(Python {steps['parse_python']} s)")

    # The pipeline's steps one by one, as _stream_search runs them, and
    # the host packer's steps they replaced.
    pipeline.search_database(query, db, sc, device=dev)  # builds the kernel
    t0 = time.perf_counter()
    order = pipeline.PLANS.find(db, True).order
    steps["sort"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = pipeline.plan_chunk(db.lengths, order, None, pipeline.resident_lanes(dev))
    steps["plan"] = time.perf_counter() - t0
    nw, win = plan.nw, plan.win
    copies = {}
    for how in ("pageable", "pinned", "registered") * 2:
        dev_db, dt = _seconds(lambda: copy_database(db, dev, how))
        copies.setdefault(how, []).append(dt)
    steps["h2d_residues"] = min(copies["pinned"])
    result["database_copy_s"] = copies
    say(f"[steps] the database's copy ({db.seq.nbytes + db.offsets.nbytes} B), twice each "
        f"way: {copies}; the pipeline's: pinned")
    # The wrapper as the search calls it: through one kept pair of pieces,
    # each made at its first call (two calls here, before the clock).
    pieces = PinnedPieces()
    for _ in range(2):
        streams, fs = pack_streams_device(*dev_db, plan, pieces)
    steps["pack_kernel"] = cuda_ms(lambda: pack_streams_device(*dev_db, plan, pieces), 5) / 1e3
    prof = profile_to_torch(make_profile(sc.table, query), go, dev)
    kw = dict(nslots=len(plan.slot_lb), jb=STREAM_JB)
    kernel_ms = cuda_ms(lambda: sw_stream(prof, streams, fs, go, ge, **kw), 5)
    steps["kernel"] = kernel_ms / 1e3
    out = sw_stream(prof, streams, fs, go, ge, **kw)
    steps["reorder_and_fetch"], scores = reorder_and_fetch([(order, out)], (db.n,), dev)
    old = result["host_packer_steps_s"] = {}
    t0 = time.perf_counter()
    pack = pack_streams(db, order, nw, win=win, jb=STREAM_JB, grain=pipeline.STREAM_GRAIN)
    old["pack"] = time.perf_counter() - t0
    (h_streams, h_fs), old["h2d_streams"] = _seconds(lambda: stream_pack_to_torch(pack, dev))
    if not (torch.equal(h_streams, streams) and torch.equal(h_fs, fs)):
        raise SystemExit("swissprot: the pack kernel's streams != the host packer's")
    del h_streams, h_fs, pack
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = np.zeros(db.n, np.int32)
    pipeline.scatter_slots(host, order, out.cpu())
    old["fetch_and_scatter"] = time.perf_counter() - t0
    if not np.array_equal(host, scores):
        raise SystemExit("swissprot: the reorder on the card != the host scatter")
    padded = plan.padded_cells_per_query_row / residues
    for k, v in steps.items():
        say(f"[steps] {k}: {v} s")
    for k, v in old.items():
        say(f"[steps] the host packer's {k}: {v} s")

    walls = []
    for _ in range(3):
        (_, kernel_s), wall = _seconds(
            lambda: pipeline.search_database(query, db, sc, device=dev)
        )
        walls.append({"wall_s": wall, "kernel_timer_s": kernel_s})
        say(f"[search] wall {wall} s, kernel timer {kernel_s} s = "
            f"{len(query) * residues / kernel_s / 1e9} GCUPS")
    result["search"] = walls

    wall, busy_ms, top = device_busy(
        lambda: pipeline.search_database(query, db, sc, device=dev))
    result["profile"] = {"wall_s": wall, "device_ms": busy_ms,
                         "busy_share": busy_ms / 1e3 / wall, "top_ms": top}
    say(f"[profile] device {busy_ms} ms in a {wall} s search wall, "
        f"busy share {busy_ms / 1e3 / wall}; {top}")

    shape = f"nw={nw} L={streams.shape[1]} win={win} jb={STREAM_JB}"
    for lq in lqs:
        q = query if lq == len(query) else random_query(lq, lq)
        if lq > MAX_QUERY_ROWS:
            # The pipeline's own chunk at this length is this pack as long
            # as the database stays one striped chunk.
            if residues > pipeline.striped_chunk_residues():
                raise SystemExit("swissprot: the striped search takes several chunks")
            usage = {sass.kernel_key(m): u for m, u in
                     sass.resource_usage(_build.build()).items()}
            for sr in stripe_rows:
                stripes = profile_stripes(make_profile(sc.table, q), go, sr, dev)
                r = stripe_rows_per_thread(sr)
                regs = {}
                for p, st in enumerate(stripes):
                    key = stripe_kernel_instance(st.shape[0], p > 0, p < len(stripes) - 1)
                    regs[key] = usage.get(key, {}).get("REG")
                ms = cuda_ms(lambda: sw_stream_striped(stripes, streams, fs, go, ge, **kw), 3)
                pass_ms = striped_pass_ms(stripes, streams, fs, go, ge, kw["nslots"], 2)
                gcups = lq * residues / ms / 1e6
                result["lq"].append({
                    "lq": lq, "stripe_rows": sr, "rows_per_thread": r,
                    "registers": regs, "passes": len(stripes), "ms": ms,
                    "pass_ms": pass_ms, "gcups": gcups, "shape": shape,
                    "padded_over_real": padded})
                say(f"[lq] lq={lq} {shape}: K2, {len(stripes)} passes of {sr} rows "
                    f"(R={r}; registers {regs}): {ms} ms = {gcups} GCUPS over real "
                    f"residues; per pass {pass_ms} ms")
            stripes = profile_stripes(make_profile(sc.table, q), go, STRIPE_ROWS, dev)
            if len(stripes) > 1:
                rows = stripes[-1].shape[0]
                ms = last_pass_ms(stripes, streams, fs, go, ge, kw["nslots"], 3)
                result["last_pass"].append({"lq": lq, "rows": rows, "ms_by_r": ms})
                say(f"[last pass] lq={lq}: the last of {len(stripes)} passes, {rows} rows, at "
                    f"R = {list(ms)}: {list(ms.values())} ms")
            for w in windows:
                pw = plan_streams(db.lengths, order, w, win=win, jb=STREAM_JB,
                                  grain=pipeline.STREAM_GRAIN)
                s_w, fs_w = pack_streams_device(*dev_db, pw)
                kw_w = dict(nslots=len(pw.slot_lb), jb=STREAM_JB)
                ms = cuda_ms(lambda: sw_stream_striped(stripes, s_w, fs_w, go, ge, **kw_w), 2)
                pad_w = pw.padded_cells_per_query_row / residues
                result["long_windows"].append({"lq": lq, "nw": w, "L": s_w.shape[1],
                                               "ms": ms, "padded_over_real": pad_w})
                say(f"[windows] lq={lq} nw={w} L={s_w.shape[1]}: K2 at {STRIPE_ROWS} rows "
                    f"{ms} ms = {lq * residues / ms / 1e6} GCUPS (padded/real cells {pad_w})")
                del s_w, fs_w
            for _ in range(3):
                (_, kernel_s), wall = _seconds(
                    lambda: pipeline.search_database(q, db, sc, device=dev))
                result["long_search"].append(
                    {"lq": lq, "wall_s": wall, "kernel_timer_s": kernel_s})
                say(f"[search] lq={lq}: wall {wall} s, kernel timer {kernel_s} s = "
                    f"{lq * residues / kernel_s / 1e9} GCUPS")
            continue
        pq = profile_to_torch(make_profile(sc.table, q), go, dev)
        ms = cuda_ms(lambda: sw_stream(pq, streams, fs, go, ge, rows=lq, **kw), 3)
        gcups = lq * residues / ms / 1e6
        result["lq"].append({"lq": lq, "ms": ms, "gcups": gcups, "shape": shape,
                             "padded_over_real": padded})
        say(f"[lq] lq={lq} {shape}: kernel {ms} ms = {gcups} GCUPS over real "
            f"residues (padded/real cells {padded})")
    del streams, fs
    for w in windows:
        pw = plan_streams(db.lengths, order, w, win=win, jb=STREAM_JB,
                          grain=pipeline.STREAM_GRAIN)
        s_w, fs_w = pack_streams_device(*dev_db, pw)
        kw_w = dict(nslots=len(pw.slot_lb), jb=STREAM_JB)
        ms = cuda_ms(lambda: sw_stream(prof, s_w, fs_w, go, ge, **kw_w), 3)
        pad_w = pw.padded_cells_per_query_row / residues
        gcups = len(query) * residues / ms / 1e6
        result["windows"].append({"nw": w, "L": s_w.shape[1], "ms": ms,
                                  "gcups": gcups, "padded_over_real": pad_w})
        say(f"[windows] nw={w} L={s_w.shape[1]} lq={len(query)}: kernel {ms} ms = "
            f"{gcups} GCUPS (padded/real cells {pad_w})")
        del s_w, fs_w
    _write(args.out, result)
    return 0


def _write(out, result) -> None:
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    raise SystemExit(main())
