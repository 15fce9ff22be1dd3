#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (seqalign_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits nonzero:

1. device: the card's name, its power limit (nvidia-smi), torch, CUDA, nvcc;
2. build: compile csrc/*.cu (one source, both kernels) with nvcc for
   sm_90a into build/;
3. kernel: the single-query stream kernel (K1) against its plain PyTorch
   version on the card, int32-exact (torch.equal), over scoring systems,
   segment layouts, window widths and query lengths up to MAX_QUERY_ROWS;
   then the multi-query kernel (K3) the same way, over 2 to 64 queries of
   unequal lengths, an empty query, queries at MAX_QUERY_ROWS, a tail
   segment and empty windows;
4. main path: a Swiss-Prot-scale search (565,247 records, about 205 M
   residues, bench.py's generator, seed 42, PAM250, gaps -2/-1, a
   144-residue query) through seqalign_tpu_torch.pipeline.search_database on
   the card; the launch counters prove it ran K1 and no plain version;
   every score is checked against the plain version, and 256 against the
   wavefront engine, on the card;
5. multi-query path: 8 queries of 17 residues (bench.py's multi-query
   point), then 64 of 144 (the north-star batch), against the same
   database through pipeline.search_database_multi; the counters prove it
   ran K3 and neither K1 nor a plain version; every score equals K1 run
   per query, and the 8-query batch equals K3's plain version on the same
   card tensors; K3, the K1 loop and the plain version are timed;
6. CLI: the port's CLI with the stream kernels against the same CLI with
   --engine wavefront on a 3,000-record FASTA, for one query and for an
   8-record query file; identical but for Total Time.

The line before the last is a JSON object describing the kernels (route,
source, launches on their path, max error, times); the last line is
{"ok": true, "device": {...}}. Without a CUDA device the script exits 1
before printing either.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def scoring(name: str):
    from seqalign_tpu_torch.host import (
        PAD_INDEX, ScoringModel, load_builtin, sw_default_scoring,
    )

    if name in ("BLOSUM45", "BLOSUM62", "PAM250"):
        return load_builtin(
            name,
            ScoringModel(gap_open=-2, gap_extend=-1, use_match_mismatch=False),
        )
    if name == "match/mismatch":
        return sw_default_scoring()
    if name == "random":
        rng = np.random.default_rng(77)
        t = rng.integers(-6, 7, size=(32, 32)).astype(np.int32)
        t = np.triu(t) + np.triu(t, 1).T
        t[PAD_INDEX, :] = t[:, PAD_INDEX] = -4
        sc = ScoringModel(gap_open=-3, gap_extend=-1, use_match_mismatch=False)
        sc.table = t
        sc.defined[:] = True
        return sc
    if name == "go==ge":
        return load_builtin(
            "BLOSUM62",
            ScoringModel(gap_open=0, gap_extend=-2, use_match_mismatch=False),
        )
    raise KeyError(name)


def random_protein(rng, n: int) -> str:
    from seqalign_tpu_torch.swissprot import AA

    return "".join(AA[i] for i in rng.integers(0, 20, size=n))


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from seqalign_tpu_torch.ops import _build

    nvcc = subprocess.run(
        [_build._find_nvcc(), "--version"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[-1]
    print(f"[device] {name} | torch {torch.__version__} | "
          f"CUDA {torch.version.cuda} | nvcc {nvcc}")
    print(smi, flush=True)
    return name, smi


def phase_build():
    from seqalign_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    print(f"[build] {path.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0} s", flush=True)


class Checker:
    """Runs a kernel and its plain version on the same card tensors: K1
    for a 2-D profile, K3 for a 3-D one."""

    def __init__(self, torch):
        self.torch = torch
        self.max_abs_err = {"sw_stream": 0, "sw_stream_multi": 0}

    def compare(self, label, prof, streams, fs, go, ge, nslots, jb):
        from seqalign_tpu_torch.ops import swa_cuda

        torch = self.torch
        name = "sw_stream_multi" if prof.ndim == 3 else "sw_stream"
        kernel = getattr(swa_cuda, name)
        plain = getattr(swa_cuda, name + "_reference")
        k = kernel(prof, streams, fs, go, ge, nslots=nslots, jb=jb)
        torch.cuda.synchronize()
        r = plain(prof, streams, fs, go, ge, nslots=nslots, jb=jb)
        torch.cuda.synchronize()
        err = int((k.long() - r.long()).abs().max()) if k.numel() else 0
        self.max_abs_err[name] = max(self.max_abs_err[name], err)
        equal = torch.equal(k, r)
        nw, length, win = streams.shape
        queries = f"nq={prof.shape[0]} " if prof.ndim == 3 else ""
        print(f"[kernel] {name} {label}: {queries}rows={prof.shape[-2]} nw={nw} "
              f"L={length} win={win} jb={jb} slots={nslots} equal={equal} "
              f"max_abs_err={err}", flush=True)
        if not equal:
            fail(f"{name} != plain version for {label}")
        return k


def stream_case(name, lq, n, lo, hi, nw, win, seed, encoded=None, order=None):
    """A stream pack as the pipeline makes it (jb=STREAM_JB, grain=
    STREAM_GRAIN) and the kernel's arguments for it, on the card. A tuple
    ``lq`` gives one query of each length and a 3-D profile (K3)."""
    from seqalign_tpu_torch.convert import profile_to_torch, stream_pack_to_torch
    from seqalign_tpu_torch.host import encode, pack_streams
    from seqalign_tpu_torch.ops.swa_cuda import STREAM_JB as jb
    from seqalign_tpu_torch.ops.swa_torch import make_profile
    from seqalign_tpu_torch.pipeline import STREAM_GRAIN as grain
    from seqalign_tpu_torch.pipeline import _db_from_encoded, multi_profile

    sc = scoring(name)
    rng = np.random.default_rng(seed)
    if isinstance(lq, tuple):
        qs = [sc.query_indices(random_protein(rng, k)) for k in lq]
        profile = multi_profile(sc.table, qs)
    else:
        profile = make_profile(sc.table, sc.query_indices(random_protein(rng, lq)))
    if encoded is None:
        encoded = [encode(random_protein(rng, int(rng.integers(lo, hi))))
                   for _ in range(n)]
    db = _db_from_encoded(encoded)
    if order is None:
        order = np.argsort(-db.lengths, kind="stable")
    pack = pack_streams(db, order, nw, win=win, jb=jb, grain=grain)
    go, ge = sc.gap_open_total, sc.gap_extend
    prof = profile_to_torch(profile, go, "cuda")
    streams, fs = stream_pack_to_torch(pack, "cuda")
    return pack, (prof, streams, fs, go, ge, len(pack.slot_ids), jb)


def phase_kernel(chk: Checker):
    from seqalign_tpu_torch.host import encode
    from seqalign_tpu_torch.ops.swa_cuda import MAX_QUERY_ROWS

    cases = [
        # name, lq, n, lo, hi, nw, win, seed
        ("BLOSUM45", 144, 1500, 1, 200, 4, 256, 1),
        ("BLOSUM62", 17, 3000, 1, 300, 6, 256, 2),
        ("PAM250", 512, 800, 1, 150, 3, 256, 3),
        ("match/mismatch", 1, 2000, 1, 100, 5, 256, 4),
        ("random", 144, 1500, 1, 120, 4, 256, 5),
        ("go==ge", 17, 1000, 1, 80, 2, 256, 6),
        ("BLOSUM62", 144, 2048, 1, 64, 1, 1024, 7),
        ("BLOSUM62", 144, 6144, 1, 64, 3, 1024, 8),
        ("PAM250", 144, 16384, 1, 64, 8, 1024, 9),
        ("BLOSUM62", MAX_QUERY_ROWS, 1200, 1, 64, 2, 1024, 10),
    ]
    for name, lq, n, lo, hi, nw, win, seed in cases:
        _, args = stream_case(name, lq, n, lo, hi, nw, win, seed)
        chk.compare(f"{name} lq={lq}", *args)

    # A segment that starts on the final block: the start flush and the
    # end flush fire in the same step (segments of 48 and 16 positions,
    # blocks of 16).
    rng = np.random.default_rng(11)
    enc = [encode(random_protein(rng, 40)) for _ in range(256)]
    enc += [encode(random_protein(rng, 3)) for _ in range(256)]
    pack, args = stream_case("BLOSUM62", 8, 0, 0, 0, 1, 256, 11,
                             encoded=enc, order=np.arange(len(enc)))
    starts = np.nonzero(pack.fs[:, 0, 0])[0]
    if not (len(starts) == 1 and starts[0] == pack.fs.shape[0] - 1):
        fail("tail-segment case does not start on the final block")
    chk.compare("tail segment on the final block", *args)

    # More windows than segments: three streams hold only padding.
    pack, args = stream_case("PAM250", 17, 300, 1, 60, 5, 256, 12)
    if np.count_nonzero(pack.fs.any(axis=(0, 2))) != 2:
        fail("empty-window case does not leave windows empty")
    chk.compare("empty windows", *args)


def phase_kernel_multi(chk: Checker):
    from seqalign_tpu_torch.host import encode
    from seqalign_tpu_torch.ops.swa_cuda import MAX_QUERY_ROWS

    lq8 = (17, 12, 5, 17, 30, 1, 8, 22)
    rng = np.random.default_rng(30)
    lq64 = tuple(int(k) for k in rng.integers(1, 40, size=64))
    cases = [
        # name, query lengths, n, lo, hi, nw, win, seed
        ("BLOSUM45", (144, 60), 1500, 1, 200, 4, 256, 21),
        ("BLOSUM62", (17, 9, 0), 3000, 1, 300, 6, 256, 22),
        ("PAM250", lq8, 2000, 1, 150, 5, 256, 23),
        ("match/mismatch", (1, 7), 2000, 1, 100, 5, 256, 24),
        ("random", (144, 100, 33), 1500, 1, 120, 4, 256, 25),
        ("go==ge", (17, 3), 1000, 1, 80, 2, 256, 26),
        ("BLOSUM62", (144, 143, 20), 6144, 1, 64, 3, 1024, 27),
        ("PAM250", lq64, 3000, 1, 100, 4, 256, 28),
        ("BLOSUM62", (MAX_QUERY_ROWS, 700), 1200, 1, 64, 2, 1024, 29),
    ]
    for name, lqs, n, lo, hi, nw, win, seed in cases:
        _, args = stream_case(name, lqs, n, lo, hi, nw, win, seed)
        chk.compare(f"{name} lq={'/'.join(map(str, lqs))}"[:80], *args)

    rng = np.random.default_rng(31)
    enc = [encode(random_protein(rng, 40)) for _ in range(256)]
    enc += [encode(random_protein(rng, 3)) for _ in range(256)]
    pack, args = stream_case("BLOSUM62", (8, 13, 2), 0, 0, 0, 1, 256, 31,
                             encoded=enc, order=np.arange(len(enc)))
    starts = np.nonzero(pack.fs[:, 0, 0])[0]
    if not (len(starts) == 1 and starts[0] == pack.fs.shape[0] - 1):
        fail("multi tail-segment case does not start on the final block")
    chk.compare("tail segment on the final block", *args)

    pack, args = stream_case("PAM250", (17, 4), 300, 1, 60, 5, 256, 32)
    if np.count_nonzero(pack.fs.any(axis=(0, 2))) != 2:
        fail("multi empty-window case does not leave windows empty")
    chk.compare("empty windows", *args)


def cuda_ms(torch, fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def reset_counts(swa_cuda):
    for fn in (swa_cuda.sw_stream, swa_cuda.sw_stream_multi):
        fn.launches = 0
    for fn in (swa_cuda.sw_stream_reference, swa_cuda.sw_stream_multi_reference):
        fn.calls = 0


def read_counts(swa_cuda):
    return {
        "sw_stream": swa_cuda.sw_stream.launches,
        "sw_stream_multi": swa_cuda.sw_stream_multi.launches,
        "plain": swa_cuda.sw_stream_reference.calls
        + swa_cuda.sw_stream_multi_reference.calls,
    }


def phase_main_path(torch, chk: Checker, smi: str, query, db):
    from seqalign_tpu_torch import pipeline
    from seqalign_tpu_torch.convert import profile_to_torch, stream_pack_to_torch
    from seqalign_tpu_torch.host import pack_streams
    from seqalign_tpu_torch.ops import swa_cuda
    from seqalign_tpu_torch.ops.swa_torch import make_profile, sw_wavefront
    from seqalign_tpu_torch.swissprot import QUERY_LEN

    sc = scoring("PAM250")
    residues = int(db.offsets[-1])

    reset_counts(swa_cuda)
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        scores, kernel_s = pipeline.search_database(query, db, sc, device="cuda")
        runs.append((kernel_s, time.perf_counter() - t0))
    counts = read_counts(swa_cuda)
    launches = counts["sw_stream"]
    print(f"[main] launches: {counts}", flush=True)
    if launches < 1 or counts["sw_stream_multi"] or counts["plain"]:
        fail("the main path did not run through K1 alone")
    if scores.shape != (db.n,) or scores.dtype != np.int32 or scores.min() < 0:
        fail("main-path scores have the wrong shape, type or sign")
    cells = QUERY_LEN * residues
    for k, (kernel_s, wall_s) in enumerate(runs):
        print(f"[main] run {k}: kernel {kernel_s} s = {cells / kernel_s / 1e9} "
              f"GCUPS over real residues, {db.n / kernel_s} entries/s; "
              f"search wall {wall_s} s incl. host packing | {smi}", flush=True)

    # The whole database as the pipeline packs it (one launch at this
    # size): the kernel and its plain version on the same card tensors,
    # every record checked, both timed with CUDA events.
    order = np.argsort(-db.lengths, kind="stable")
    win, jb = pipeline.WINDOW_LANES, pipeline.STREAM_JB
    if db.n > pipeline.MAX_STREAM_SLOTS * win:
        fail("the database no longer fits one launch")
    nw = pipeline.choose_windows(
        db.lengths[order], win, None, pipeline.resident_lanes(torch.device("cuda"))
    )
    pack = pack_streams(db, order, nw, win=win, jb=jb, grain=pipeline.STREAM_GRAIN)
    go, ge = sc.gap_open_total, sc.gap_extend
    prof = profile_to_torch(make_profile(sc.table, query), go, "cuda")
    streams, fs = stream_pack_to_torch(pack, "cuda")
    kw = dict(nslots=len(pack.slot_ids), jb=jb)
    out = chk.compare(f"main path ({db.n} records)", prof, streams, fs, go, ge,
                      kw["nslots"], jb)
    full = np.zeros(db.n, np.int32)
    full[order] = out.cpu().numpy().reshape(-1)[: db.n]
    if not np.array_equal(full, scores):
        fail("main-path scores != plain version")
    print(f"[main] all {db.n} records: main-path scores == plain version",
          flush=True)
    ms = cuda_ms(torch, lambda: swa_cuda.sw_stream(prof, streams, fs, go, ge, **kw), 5)
    plain_ms = cuda_ms(
        torch, lambda: swa_cuda.sw_stream_reference(prof, streams, fs, go, ge, **kw), 1
    )
    shape = (f"nw={nw} L={streams.shape[1]} win={win} jb={jb} "
             f"rows={prof.shape[0]} slots={kw['nslots']}")
    print(f"[main] main-path shape {shape}: kernel {ms} ms "
          f"({cells / ms / 1e6} GCUPS), plain version {plain_ms} ms "
          f"({cells / plain_ms / 1e6} GCUPS) | {smi}", flush=True)

    # An independent formulation: the wavefront engine on the 128 longest
    # records and 128 others.
    rng = np.random.default_rng(7)
    pick = np.concatenate([order[:128], rng.choice(order[128:], 128, replace=False)])
    lb = int(db.lengths[pick].max())
    batch = np.full((lb, len(pick)), 31, dtype=np.int8)
    for lane, r in enumerate(pick):
        rec = db.record(int(r))
        batch[: len(rec), lane] = rec
    wf = sw_wavefront(
        torch.from_numpy(make_profile(sc.table, query)).cuda(),
        torch.from_numpy(batch).cuda(), go, ge,
    ).cpu().numpy()
    if not np.array_equal(wf, scores[pick]):
        fail("main-path scores != wavefront engine on 256 records")
    print("[main] 256 records: main-path scores == wavefront engine", flush=True)
    return {
        "launches": launches,
        "ms": ms,
        "plain_ms": plain_ms,
        "shape": f"main path, {db.n} records, lq={QUERY_LEN}, {shape}",
        "main_path_kernel_s": runs[-1][0],
        "main_path_gcups": cells / runs[-1][0] / 1e9,
    }, (order, streams, fs, kw["nslots"])


def k1_per_query(torch, queries, sc, db, k1_pack):
    """Every query through K1 on the single-query pack of the whole
    database: (NQ, N) scores, and the CUDA-event time of the NQ launches."""
    from seqalign_tpu_torch.convert import profile_to_torch
    from seqalign_tpu_torch.ops import swa_cuda
    from seqalign_tpu_torch.ops.swa_torch import make_profile

    order, streams, fs, nslots = k1_pack
    go, ge = sc.gap_open_total, sc.gap_extend
    profs = [profile_to_torch(make_profile(sc.table, q), go, "cuda") for q in queries]
    kw = dict(nslots=nslots, jb=swa_cuda.STREAM_JB)
    scores = np.zeros((len(queries), db.n), np.int32)
    for k, p in enumerate(profs):
        out = swa_cuda.sw_stream(p, streams, fs, go, ge, **kw)
        scores[k, order] = out.cpu().numpy().reshape(-1)[: db.n]
    ms = cuda_ms(torch, lambda: [swa_cuda.sw_stream(p, streams, fs, go, ge, **kw)
                                 for p in profs], 1)
    return scores, ms


def phase_multi_path(torch, chk: Checker, smi: str, db, k1_pack, nq, lq,
                     seed, check_plain):
    """One multi-query batch through pipeline.search_database_multi on the
    card, checked against K1 per query (and K3's plain version)."""
    from seqalign_tpu_torch import pipeline
    from seqalign_tpu_torch.convert import stream_pack_to_torch
    from seqalign_tpu_torch.ops import swa_cuda
    from seqalign_tpu_torch.swissprot import random_query

    tag = f"[multi {nq}x{lq}]"
    sc = scoring("PAM250")
    go, ge = sc.gap_open_total, sc.gap_extend
    residues = int(db.offsets[-1])
    queries = [random_query(lq, seed + k) for k in range(nq)]

    reset_counts(swa_cuda)
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        scores, kernel_s = pipeline.search_database_multi(queries, db, sc, device="cuda")
        runs.append((kernel_s, time.perf_counter() - t0))
    counts = read_counts(swa_cuda)
    print(f"{tag} launches: {counts}", flush=True)
    if counts["sw_stream_multi"] < 1 or counts["sw_stream"] or counts["plain"]:
        fail(f"{tag} the multi-query path did not run through K3 alone")
    if scores.shape != (nq, db.n) or scores.dtype != np.int32 or scores.min() < 0:
        fail(f"{tag} scores have the wrong shape, type or sign")
    cells = nq * lq * residues
    for k, (kernel_s, wall_s) in enumerate(runs):
        print(f"{tag} run {k}: kernel timer {kernel_s} s = "
              f"{cells / kernel_s / 1e9} GCUPS over real residues; search wall "
              f"{wall_s} s incl. host packing | {smi}", flush=True)

    # An independent route: K1 for each query.
    if check_plain:
        # Through the single-query pipeline itself, query by query.
        k1 = np.stack([pipeline.search_database(q, db, sc, device="cuda")[0]
                       for q in queries])
        if not np.array_equal(k1, scores):
            fail(f"{tag} K3 scores != pipeline.search_database per query")
        print(f"{tag} all {nq} x {db.n} scores == pipeline.search_database "
              "(K1) per query", flush=True)
    k1, k1_loop_ms = k1_per_query(torch, queries, sc, db, k1_pack)
    if not np.array_equal(k1, scores):
        fail(f"{tag} K3 scores != K1 per query")
    print(f"{tag} all {nq} x {db.n} scores == K1 per query", flush=True)

    # The launches as the pipeline makes them, on card tensors made once.
    order = np.argsort(-db.lengths, kind="stable")
    blocks = pipeline.query_blocks(
        pipeline.multi_profile(sc.table, queries), go, db.n, None, torch.device("cuda"))
    chunks = []
    for chunk, pack in pipeline.stream_chunks(db, order, None, torch.device("cuda")):
        streams, fs = stream_pack_to_torch(pack, "cuda")
        chunks.append((chunk, streams, fs, len(pack.slot_ids)))
    jb = swa_cuda.STREAM_JB

    def k3_all():
        return [swa_cuda.sw_stream_multi(b, s, f, go, ge, nslots=ns, jb=jb)
                for _, s, f, ns in chunks for b in blocks]

    k3_ms = cuda_ms(torch, k3_all, 3 if check_plain else 2)
    shape = (f"{len(blocks)} block(s) of {blocks[0].shape[0]} queries x "
             f"{blocks[0].shape[1]} rows, {len(chunks)} chunk(s), nw="
             f"{'/'.join(str(s.shape[0]) for _, s, _, _ in chunks)}")
    result = {
        "launches": counts["sw_stream_multi"], "ms": k3_ms,
        "k1_loop_ms": k1_loop_ms, "shape": f"{nq}x{lq} on {db.n} records: {shape}",
        "main_path_kernel_s": runs[-1][0],
        "main_path_gcups": cells / runs[-1][0] / 1e9,
    }
    if check_plain:
        full = np.zeros((nq, db.n), np.int32)
        for chunk, streams, fs, nslots in chunks:
            outs = [chk.compare(f"multi path {nq}x{lq} chunk of {len(chunk)}",
                                b, streams, fs, go, ge, nslots, jb) for b in blocks]
            out = torch.cat(outs, dim=1).cpu().numpy()
            full[:, chunk] = out.transpose(1, 0, 2).reshape(out.shape[1], -1)[:nq, : len(chunk)]
        if not np.array_equal(full, scores):
            fail(f"{tag} scores != K3's plain version")
        print(f"{tag} all {nq} x {db.n} scores == K3's plain version", flush=True)
        result["plain_ms"] = cuda_ms(torch, lambda: [
            swa_cuda.sw_stream_multi_reference(b, s, f, go, ge, nslots=ns, jb=jb)
            for _, s, f, ns in chunks for b in blocks], 1)
    print(f"{tag} {shape}: K3 {k3_ms} ms ({cells / k3_ms / 1e6} GCUPS), K1 looped "
          f"over the {nq} queries {k1_loop_ms} ms ({cells / k1_loop_ms / 1e6} GCUPS)"
          + (f", K3's plain version {result['plain_ms']} ms" if check_plain else "")
          + f" | {smi}", flush=True)
    return result


def phase_cli():
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(99)
    (out_dir / "q.fa").write_text(">q\n" + random_protein(rng, 144) + "\n")
    (out_dir / "db.fa").write_text("".join(
        f">r{i}\n{random_protein(rng, int(rng.integers(2, 400)))}\n"
        for i in range(3000)
    ))
    (out_dir / "q8.fa").write_text("".join(
        f">q{k} query {k}\n{random_protein(rng, int(rng.integers(5, 150)))}\n"
        for k in range(8)
    ))
    env = dict(os.environ, SEQALIGN_PLATFORM="cuda")
    for qfile, blocks in (("q.fa", 0), ("q8.fa", 8)):
        outs = []
        for extra in ([], ["--engine", "wavefront"]):
            cmd = [sys.executable, "-m", "seqalign_tpu_torch.cli",
                   "--substitution_matrix", "BLOSUM62",
                   "--files", str(out_dir / qfile), str(out_dir / "db.fa"), *extra]
            proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                                  text=True, timeout=600)
            if proc.returncode != 0 or "Note:" in proc.stderr:
                fail(f"CLI {qfile} {' '.join(extra) or 'stream'}: "
                     f"rc={proc.returncode} {proc.stderr[-2000:]}")
            lines = proc.stdout.splitlines()
            times = [ln for ln in lines if ln.startswith("Total Time:")]
            outs.append([ln for ln in lines if not ln.startswith("Total Time:")])
            print(f"[cli] {qfile} {' '.join(extra) or '--engine stream (default)'}: "
                  f"{times[0] if times else 'no Total Time line'}", flush=True)
        if outs[0] != outs[1]:
            fail(f"CLI {qfile}: stream output != wavefront output")
        entries = sum(ln.startswith("Entry #") for ln in outs[0])
        queries = sum(ln.startswith("Query #") for ln in outs[0])
        if (entries != 3000 * max(blocks, 1) or queries != blocks
                or "Total Entries: 3000" not in outs[0]):
            fail(f"CLI {qfile} printed {entries} entries in {queries} query "
                 "blocks")
        print(f"[cli] {qfile}: stream == wavefront on 3000 records, {queries} "
              "query blocks (Total Time dropped)", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on a GPU",
              file=sys.stderr)
        return 1
    name, smi = phase_device(torch)
    phase_build()
    chk = Checker(torch)
    phase_kernel(chk)
    phase_kernel_multi(chk)

    from seqalign_tpu_torch.swissprot import swissprot_db

    t0 = time.perf_counter()
    query, db = swissprot_db()
    print(f"[main] database: {db.n} records, {int(db.offsets[-1])} residues, "
          f"generated in {time.perf_counter() - t0} s", flush=True)
    main_path, k1_pack = phase_main_path(torch, chk, smi, query, db)
    multi8 = phase_multi_path(torch, chk, smi, db, k1_pack, 8, 17, 100, True)
    multi64 = phase_multi_path(torch, chk, smi, db, k1_pack, 64, 144, 200, False)
    phase_cli()
    kernels = [{
        "name": "sw_stream",
        "route": "cuda",
        "source": "seqalign_tpu_torch/csrc/sw_stream.cu",
        "replaces": "seqalign_tpu/ops/swa_pallas.py:559",
        "launches": main_path["launches"],
        "max_abs_err": chk.max_abs_err["sw_stream"],
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
        "shape": main_path["shape"],
        "main_path_kernel_s": main_path["main_path_kernel_s"],
        "main_path_gcups": main_path["main_path_gcups"],
        "card": smi,
    }, {
        "name": "sw_stream_multi",
        "route": "cuda",
        "source": "seqalign_tpu_torch/csrc/sw_stream.cu",
        "replaces": "seqalign_tpu/ops/swa_pallas.py:934",
        "launches": multi8["launches"],
        "max_abs_err": chk.max_abs_err["sw_stream_multi"],
        "ms": multi8["ms"],
        "plain_ms": multi8["plain_ms"],
        "k1_loop_ms": multi8["k1_loop_ms"],
        "shape": multi8["shape"],
        "main_path_kernel_s": multi8["main_path_kernel_s"],
        "main_path_gcups": multi8["main_path_gcups"],
        "north_star": {k: multi64[k] for k in
                       ("launches", "ms", "k1_loop_ms", "shape",
                        "main_path_kernel_s", "main_path_gcups")},
        "card": smi,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
