#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (seqalign_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits nonzero:

1. device: the card's name, its power limit (nvidia-smi), torch, CUDA, nvcc;
2. build: compile csrc/*.cu with nvcc for sm_90a into build/;
3. kernel: the stream kernel against its plain PyTorch version on the card,
   int32-exact (torch.equal), over scoring systems, segment layouts, window
   widths and query lengths up to MAX_QUERY_ROWS;
4. main path: a Swiss-Prot-scale search (565,247 records, about 205 M
   residues, bench.py's generator, seed 42, PAM250, gaps -2/-1, a
   144-residue query) through seqalign_tpu_torch.pipeline.search_database on
   the card; the launch counters prove it ran the kernel and no plain
   version; every score is checked against the plain version, and 256
   against the wavefront engine, on the card;
5. CLI: the port's CLI with the stream kernel against the same CLI with
   --engine wavefront on a 3,000-record FASTA; identical but for Total Time.

The line before the last is a JSON object describing the kernel (route,
source, launches on the main path, max error, times); the last line is
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
    """Runs the kernel and its plain version on the same card tensors."""

    def __init__(self, torch):
        self.torch = torch
        self.max_abs_err = 0

    def compare(self, label, prof, streams, fs, go, ge, nslots, jb):
        from seqalign_tpu_torch.ops.swa_cuda import (
            sw_stream, sw_stream_reference,
        )

        torch = self.torch
        k = sw_stream(prof, streams, fs, go, ge, nslots=nslots, jb=jb)
        torch.cuda.synchronize()
        r = sw_stream_reference(prof, streams, fs, go, ge, nslots=nslots, jb=jb)
        torch.cuda.synchronize()
        err = int((k.long() - r.long()).abs().max()) if k.numel() else 0
        self.max_abs_err = max(self.max_abs_err, err)
        equal = torch.equal(k, r)
        nw, length, win = streams.shape
        print(f"[kernel] {label}: rows={prof.shape[0]} nw={nw} L={length} "
              f"win={win} jb={jb} slots={nslots} equal={equal} "
              f"max_abs_err={err}", flush=True)
        if not equal:
            fail(f"kernel != plain version for {label}")
        return k


def stream_case(name, lq, n, lo, hi, nw, win, seed, encoded=None, order=None):
    """A stream pack as the pipeline makes it (jb=STREAM_JB, grain=
    STREAM_GRAIN) and the kernel's arguments for it, on the card."""
    from seqalign_tpu_torch.convert import profile_to_torch, stream_pack_to_torch
    from seqalign_tpu_torch.host import encode, pack_streams
    from seqalign_tpu_torch.ops.swa_cuda import STREAM_JB as jb
    from seqalign_tpu_torch.ops.swa_torch import make_profile
    from seqalign_tpu_torch.pipeline import STREAM_GRAIN as grain
    from seqalign_tpu_torch.pipeline import _db_from_encoded

    sc = scoring(name)
    rng = np.random.default_rng(seed)
    q = sc.query_indices(random_protein(rng, lq))
    if encoded is None:
        encoded = [encode(random_protein(rng, int(rng.integers(lo, hi))))
                   for _ in range(n)]
    db = _db_from_encoded(encoded)
    if order is None:
        order = np.argsort(-db.lengths, kind="stable")
    pack = pack_streams(db, order, nw, win=win, jb=jb, grain=grain)
    go, ge = sc.gap_open_total, sc.gap_extend
    prof = profile_to_torch(make_profile(sc.table, q), go, "cuda")
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


def cuda_ms(torch, fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_main_path(torch, chk: Checker, smi: str):
    from seqalign_tpu_torch import pipeline
    from seqalign_tpu_torch.convert import profile_to_torch, stream_pack_to_torch
    from seqalign_tpu_torch.host import pack_streams
    from seqalign_tpu_torch.ops import swa_cuda
    from seqalign_tpu_torch.ops.swa_torch import make_profile, sw_wavefront
    from seqalign_tpu_torch.swissprot import QUERY_LEN, swissprot_db

    t0 = time.perf_counter()
    query, db = swissprot_db()
    sc = scoring("PAM250")
    residues = int(db.offsets[-1])
    print(f"[main] database: {db.n} records, {residues} residues, "
          f"generated in {time.perf_counter() - t0} s", flush=True)

    swa_cuda.sw_stream.launches = 0
    swa_cuda.sw_stream_reference.calls = 0
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        scores, kernel_s = pipeline.search_database(query, db, sc, device="cuda")
        runs.append((kernel_s, time.perf_counter() - t0))
    launches = swa_cuda.sw_stream.launches
    plain_calls = swa_cuda.sw_stream_reference.calls
    print(f"[main] launches: sw_stream={launches} "
          f"sw_stream_reference={plain_calls}", flush=True)
    if launches < 1 or plain_calls != 0:
        fail("the main path did not run through the kernel alone")
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
    }


def phase_cli():
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(99)
    (out_dir / "q.fa").write_text(">q\n" + random_protein(rng, 144) + "\n")
    (out_dir / "db.fa").write_text("".join(
        f">r{i}\n{random_protein(rng, int(rng.integers(2, 400)))}\n"
        for i in range(3000)
    ))
    env = dict(os.environ, SEQALIGN_PLATFORM="cuda")
    outs = []
    for extra in ([], ["--engine", "wavefront"]):
        cmd = [sys.executable, "-m", "seqalign_tpu_torch.cli",
               "--substitution_matrix", "BLOSUM62",
               "--files", str(out_dir / "q.fa"), str(out_dir / "db.fa"), *extra]
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0 or "Note:" in proc.stderr:
            fail(f"CLI {' '.join(extra) or 'stream'}: rc={proc.returncode} "
                 f"{proc.stderr[-2000:]}")
        lines = proc.stdout.splitlines()
        times = [ln for ln in lines if ln.startswith("Total Time:")]
        outs.append([ln for ln in lines if not ln.startswith("Total Time:")])
        print(f"[cli] {' '.join(extra) or '--engine stream (default)'}: "
              f"{times[0] if times else 'no Total Time line'}", flush=True)
    if outs[0] != outs[1]:
        fail("CLI stream output != CLI wavefront output")
    entries = sum(ln.startswith("Entry #") for ln in outs[0])
    if entries != 3000 or "Total Entries: 3000" not in outs[0]:
        fail(f"CLI printed {entries} entries, expected 3000")
    print("[cli] stream == wavefront on 3000 records (Total Time dropped)",
          flush=True)


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
    main_path = phase_main_path(torch, chk, smi)
    phase_cli()
    kernel = {
        "name": "sw_stream",
        "route": "cuda",
        "source": "seqalign_tpu_torch/csrc/sw_stream.cu",
        "replaces": "seqalign_tpu/ops/swa_pallas.py:559",
        "launches": main_path["launches"],
        "max_abs_err": chk.max_abs_err,
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
        "shape": main_path["shape"],
        "main_path_kernel_s": main_path["main_path_kernel_s"],
        "main_path_gcups": main_path["main_path_gcups"],
        "card": smi,
    }
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
