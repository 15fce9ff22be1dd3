"""Time the stream kernels (K1, K3) of this checkout against another
checkout's, in turns, on one card; or, with ``--longpair``, its
sequence-parallel long pair; or, with ``--fixed``, its fixed-batch kernel;
or, with ``--wall``, its whole searches.

    python -m seqalign_tpu_torch.turns --against DIR [--longpair | --fixed | --wall]
        [--reps N] [--cells NAME,...] [--out FILE.json]

``DIR`` is the root of another checkout of the repo (for example the parent
commit, unpacked with ``git archive`` into ``build/parent``). A worker
process runs four times, in the order other, this, this, other; each one
imports ``seqalign_tpu_torch`` from its own checkout, builds that
checkout's kernels and, on the Swiss-Prot-scale database
(``swissprot.swissprot_db``, PAM250, gaps -2/-1), runs one search of each
cell of ``CELLS`` through that checkout's pipeline: K1 at lq=17, 144, 512
and 1536 and K2 at lq=2000 (``search_database``), K3 at 8 x 17, 64 x 17
and 64 x 144 (``search_database_multi``), and the stream pack P of the
lq=144 search; ``--cells`` keeps only the cells named (``"K1 1x17,K3
8x17"``). It records the kernel launches the search makes (the arguments
the pipeline passes to ``sw_stream``, ``sw_stream_striped``,
``sw_stream_multi`` or ``pack_streams_device``) and replays them
``--reps`` times under CUDA events (P's calls with their copies of the
plan's inputs, and a hash of the streams they return, which must be equal
in every run): the kernels' time as
each checkout's pipeline launches them, with its own windows, query blocks
and kernel instances; and the search's device-memory peak above what was
held before it. With ``--longpair`` it runs the long pair's cells instead
(``swissprot.LONGPAIR_RUNS``): ``parallel.sw_longpair`` at lq=35,000
against the 1,024 longest records, as chip_smoke's phase 13 lays them out
(``swissprot.longpair_case``, built once by this checkout and handed to
both checkouts' workers in ``build/turns/longpair.npz``), on entries of the
one card, each call once untimed and then ``--reps`` times under its own
CUDA-event timer (``events=``: first launch to merged result), with the
block kernel's launches and the call's device-memory peak; and the first
of them once more with every cell run (``parallel.longpair.skips`` made
false where the checkout has it: the path a query with a positive '*'
score takes, and a checkout without lane ends always takes). With
``--fixed`` it runs K4 and K5 (``sw_windows``, ``const_s``) over the lane
batches of ``pipeline.lane_batches`` at each width of
``swissprot.FIXED_LANES`` with the 144-residue query, each checkout's
windows on the card before the clock starts: every batch's launch once
untimed, then ``--reps`` passes under CUDA events, with each pass's
device-memory peak above the windows and the cells K4 runs, as
``swa_cuda.windows_cells`` models them from the batch (a checkout without
it is taken to run every batch cell). With ``--wall`` it times each
checkout's whole ``search_database`` (``search_database_multi``) call at
the cells of ``WALL_CELLS`` (lq=144, 64 x 144, lq=2000): one call
untimed, then ``--reps`` calls on the host clock (the search wall, from
the sorted database to the scores on the host) with their kernel timers,
and one more under ``torch.profiler`` for the device's busy share. The
scores of every run must be equal. Each line names the card and its power
limit; ``--out`` gets the same as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# (kernel, queries, query length, query seed): the main path's query (seed
# None: swissprot_db's own), the multi-query cells as chip_smoke draws them.
CELLS = (
    ("K1", 1, 17, 17), ("K1", 1, 144, None), ("K1", 1, 512, 512),
    ("K1", 1, 1536, 1536), ("K2", 1, 2000, 2000), ("K3", 8, 17, 100),
    ("K3", 64, 17, 300), ("K3", 64, 144, 200), ("P", 1, 144, None),
)
# The pipeline's name of each kernel's wrapper: the calls a cell replays
# (P: the stream pack's, its copy of the plan's inputs included).
WRAPPERS = {"K1": "sw_stream", "K2": "sw_stream_striped", "K3": "sw_stream_multi",
            "P": "pack_streams_device"}
LONGPAIR_INPUTS = Path("build/turns/longpair.npz")
# The whole searches --wall times, named and drawn as in CELLS.
WALL_CELLS = (("K1", 1, 144, None), ("K3", 64, 144, 200), ("K2", 1, 2000, 2000))


def _longpair_inputs(this: Path) -> Path:
    """The long pair's inputs (``swissprot.longpair_case``), written under
    this checkout for both checkouts' workers."""
    import numpy as np

    from seqalign_tpu_torch.swissprot import (
        LONGPAIR_RUNS, longpair_case, longpair_mesh, swissprot_db,
    )

    _, profile, sc, _, batch = longpair_case(swissprot_db()[1])
    path = this / LONGPAIR_INPUTS
    path.parent.mkdir(parents=True, exist_ok=True)
    names = [f"longpair {longpair_mesh(None, e, d)[2]} jb={jb}" for e, d, jb in LONGPAIR_RUNS]
    np.savez(path, profile=profile, batch=batch, runs=np.array(LONGPAIR_RUNS),
             names=np.array(names), gaps=np.array([sc.gap_open_total, sc.gap_extend]))
    return path


def _longpair_worker(root: str, reps: int, inputs: str) -> dict:
    """One checkout's long-pair cells on ``inputs``; imports its package
    from ``root``."""
    sys.path[0] = root
    import hashlib

    import numpy as np
    import torch

    from seqalign_tpu_torch.ops import swa_cuda
    from seqalign_tpu_torch.parallel import longpair, sw_longpair
    from seqalign_tpu_torch.swissprot import card

    data = np.load(inputs)
    profile, batch = data["profile"], data["batch"]
    go, ge = (int(x) for x in data["gaps"])
    # The block kernel's launch counter, under either checkout's name.
    counters = [f for f in (getattr(swa_cuda, "sw_stream_striped_block", None),
                            getattr(swa_cuda, "sw_stream_striped_step", None))
                if f is not None and hasattr(f, "launches")]
    out = {"root": root, "card": card(), "cells": {}}
    dev = torch.device("cuda", 0)
    runs = data["runs"].tolist()
    names = data["names"].tolist()
    skips = getattr(longpair, "skips", None)
    for k, ((entries, slices, jb), name) in enumerate(zip(runs + runs[:1],
                                                           names + [names[0] + " every cell"])):
        if k == len(runs) and skips is not None:
            longpair.skips = lambda prof: False
        mesh = [dev] * entries if slices == 1 else [[dev] * entries for _ in range(slices)]
        kw = {} if slices == 1 else {"axis": "seq", "data_axis": "data"}
        ms = []
        for rep in range(reps + 1):  # the first call untimed
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            for f in counters:
                f.launches = 0
            events = []
            scores = sw_longpair(profile, batch, go, ge, mesh, jb=jb, events=events,
                                 **kw).cpu().numpy()
            if rep:
                ms.append(events[0][0].elapsed_time(events[0][1]))
        out["cells"][name] = {
            "launches": sum(f.launches for f in counters), "ms": ms,
            "memory_peak_bytes": torch.cuda.max_memory_allocated() - base,
            "scores_sha256": hashlib.sha256(scores.tobytes()).hexdigest(),
        }
    if skips is not None:
        longpair.skips = skips
    return out


def _fixed_worker(root: str, reps: int) -> dict:
    """One checkout's fixed-batch cells (K4 and K5 at each width of
    ``FIXED_LANES``); imports its package from ``root``."""
    sys.path[0] = root
    import hashlib

    import numpy as np
    import torch

    from seqalign_tpu_torch import pipeline
    from seqalign_tpu_torch.convert import batch_windows, profile_to_torch
    from seqalign_tpu_torch.ops import swa_cuda
    from seqalign_tpu_torch.ops.swa_torch import make_profile
    from seqalign_tpu_torch.swissprot import FIXED_LANES, card, pam250, swissprot_db

    query, db = swissprot_db()
    sc = pam250()
    go, ge = sc.gap_open_total, sc.gap_extend
    dev = torch.device("cuda", 0)
    prof = profile_to_torch(make_profile(sc.table, query), go, dev)
    order = pipeline.PLANS.find(db, True).order
    out = {"root": root, "card": card(), "cells": {}}
    for lanes in FIXED_LANES:
        wins = [batch_windows(b, swa_cuda.FIXED_WINDOW_LANES, swa_cuda.STREAM_JB, dev)
                for _, b in pipeline.lane_batches(db, order, lanes)]
        rows = prof.shape[0]
        batch_cells = rows * sum(w.numel() for w in wins)
        for const_s in (False, True):
            run = batch_cells
            if not const_s and hasattr(swa_cuda, "windows_cells"):
                team = swa_cuda.windows_launch_team(prof, wins[0])
                run = sum(swa_cuda.windows_cells(w, rows, team)["run"] for w in wins)

            def one_pass():
                return [swa_cuda.sw_windows(prof, w, go, ge, const_s=const_s) for w in wins]

            scores = torch.cat(one_pass()).cpu().numpy()  # untimed
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for _ in range(reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                one_pass()
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end))
            out["cells"][f"{'K5' if const_s else 'K4'} B={lanes}"] = {
                "launches": len(wins), "ms": ms, "model_cells_run": run,
                "cells_batch": batch_cells,
                "memory_peak_bytes": torch.cuda.max_memory_allocated() - base,
                "scores_sha256": hashlib.sha256(scores.tobytes()).hexdigest(),
            }
        del wins
    return out


def _wall_worker(root: str, reps: int) -> dict:
    """One checkout's whole searches (``WALL_CELLS``); imports its package
    from ``root``."""
    sys.path[0] = root
    import hashlib
    import time

    import torch

    from seqalign_tpu_torch import pipeline
    from seqalign_tpu_torch.swissprot import (
        card, device_busy, pam250, random_query, swissprot_db,
    )

    query, db = swissprot_db()
    sc = pam250()
    out = {"root": root, "card": card(), "cells": {}}
    for kernel, nq, lq, seed in WALL_CELLS:
        if kernel == "K3":
            queries = [random_query(lq, seed + k) for k in range(nq)]

            def search():
                return pipeline.search_database_multi(queries, db, sc, device="cuda")
        else:
            q = query if seed is None else random_query(lq, seed)

            def search():
                return pipeline.search_database(q, db, sc, device="cuda")

        search()  # untimed: the kernels' build
        walls, timers = [], []
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(reps):
            t0 = time.perf_counter()
            scores, kernel_s = search()
            walls.append(time.perf_counter() - t0)
            timers.append(kernel_s)
        peak = torch.cuda.max_memory_allocated() - base
        wall, busy_ms, _ = device_busy(search)
        out["cells"][f"wall {kernel} {nq}x{lq}"] = {
            "launches": None, "ms": [w * 1e3 for w in walls], "memory_peak_bytes": peak,
            "kernel_timer_ms": [t * 1e3 for t in timers],
            "busy_share": busy_ms / 1e3 / wall, "profiled_wall_ms": wall * 1e3,
            "scores_sha256": hashlib.sha256(scores.tobytes()).hexdigest(),
        }
    return out


def _worker(root: str, reps: int, cells: list[str] | None = None) -> dict:
    """One checkout's cells (those named in ``cells``, or all); imports its
    package from ``root``."""
    sys.path[0] = root
    import hashlib

    import torch

    from seqalign_tpu_torch import pipeline
    from seqalign_tpu_torch.swissprot import (
        card, pam250, random_query, swissprot_db,
    )

    def cuda_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    query, db = swissprot_db()
    sc = pam250()
    out = {"root": root, "card": card(), "cells": {}}
    for kernel, nq, lq, seed in CELLS:
        if cells is not None and f"{kernel} {nq}x{lq}" not in cells:
            continue
        name = WRAPPERS[kernel]
        fn = getattr(pipeline, name)
        launches = []

        def spy(*a, **kw):
            launches.append((a, kw))
            return fn(*a, **kw)

        setattr(pipeline, name, spy)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        try:
            if kernel == "K3":
                queries = [random_query(lq, seed + k) for k in range(nq)]
                scores, _ = pipeline.search_database_multi(queries, db, sc, device="cuda")
            else:
                q = query if seed is None else random_query(lq, seed)
                scores, _ = pipeline.search_database(q, db, sc, device="cuda")
        finally:
            setattr(pipeline, name, fn)
        peak = torch.cuda.max_memory_allocated() - base
        ms = [cuda_ms(lambda: [fn(*a, **kw) for a, kw in launches]) for _ in range(reps)]
        out["cells"][f"{kernel} {nq}x{lq}"] = {
            "launches": len(launches), "ms": ms, "memory_peak_bytes": peak,
            "scores_sha256": hashlib.sha256(scores.tobytes()).hexdigest(),
        }
        if kernel == "P":  # the streams and fs each pack call returns
            digest = hashlib.sha256()
            for a, kw in launches:
                for t in fn(*a, **kw):
                    digest.update(t.cpu().numpy().tobytes())
            out["cells"][f"{kernel} {nq}x{lq}"]["streams_sha256"] = digest.hexdigest()
        del launches
    return out


def run(other: Path, reps: int = 3, say=print, longpair: bool = False,
        fixed: bool = False, cells: str | None = None, wall: bool = False) -> dict:
    """The four turns (other, this, this, other) and, per cell, each run's
    fastest replay (call, for the long pair; pass over the batches, for the
    fixed-batch kernel; search, with ``wall``), both checkouts' launches
    and other / this."""
    this = Path(__file__).resolve().parents[1]
    extra = ["--longpair", "--inputs", str(_longpair_inputs(this))] if longpair else []
    extra += ["--fixed"] if fixed else []
    extra += ["--wall"] if wall else []
    extra += ["--cells", cells] if cells else []
    runs = []
    for root in (other, this, this, other):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--worker", str(root),
             "--reps", str(reps)] + extra,
            cwd=root, capture_output=True, text=True, timeout=1200,
        )
        if proc.returncode:
            raise SystemExit(f"turns: the worker in {root} failed:\n{proc.stderr[-3000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        say(f"[turns] run {len(runs)}: {root} | {runs[-1]['card']}")
    cells = {}
    for cell in runs[0]["cells"]:
        got = [r["cells"][cell] for r in runs]
        if len({g["scores_sha256"] for g in got}) != 1:
            raise SystemExit(f"turns: {cell}: the checkouts' scores differ")
        if len({g.get("streams_sha256") for g in got}) != 1:
            raise SystemExit(f"turns: {cell}: the checkouts' streams differ")
        other_ms = [min(got[0]["ms"]), min(got[3]["ms"])]
        this_ms = [min(got[1]["ms"]), min(got[2]["ms"])]
        cells[cell] = {
            "other_ms": other_ms, "this_ms": this_ms,
            "other_launches": got[0]["launches"], "this_launches": got[1]["launches"],
            "other_memory_peak_bytes": got[0]["memory_peak_bytes"],
            "this_memory_peak_bytes": got[1]["memory_peak_bytes"],
            "other_over_this": sum(other_ms) / sum(this_ms),
        }
        for k in ("model_cells_run", "cells_batch"):
            if k in got[0]:
                cells[cell][f"other_{k}"] = got[0][k]
                cells[cell][f"this_{k}"] = got[1][k]
        if "busy_share" in got[0]:
            for k in ("kernel_timer_ms", "busy_share"):
                cells[cell][f"other_{k}"] = [got[0][k], got[3][k]]
                cells[cell][f"this_{k}"] = [got[1][k], got[2][k]]
            say(f"[turns] {cell}: kernel timer (ms) other {cells[cell]['other_kernel_timer_ms']}, "
                f"this {cells[cell]['this_kernel_timer_ms']}; busy share other "
                f"{cells[cell]['other_busy_share']}, this {cells[cell]['this_busy_share']} "
                f"| {runs[0]['card']}")
        say(f"[turns] {cell}: other {other_ms} ms ({got[0]['launches']} launches, "
            f"peak {got[0]['memory_peak_bytes']} B), this {this_ms} ms "
            f"({got[1]['launches']} launches, peak {got[1]['memory_peak_bytes']} B), "
            f"other/this {cells[cell]['other_over_this']}; scores equal"
            + (f"; cells run (model, windows_cells): other {got[0]['model_cells_run']}, "
               f"this {got[1]['model_cells_run']} of the batches' {got[1]['cells_batch']}"
               if "model_cells_run" in got[0] else "")
            + f" | {runs[0]['card']}")
    return {"other": str(other), "card": runs[0]["card"], "cells": cells}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="the root of the other checkout")
    ap.add_argument("--longpair", action="store_true",
                    help="time sw_longpair (swissprot.LONGPAIR_RUNS) instead of K1 and K3")
    ap.add_argument("--fixed", action="store_true",
                    help="time K4 and K5 over the fixed lane batches instead")
    ap.add_argument("--wall", action="store_true",
                    help="time whole searches (WALL_CELLS) instead")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cells", default=None,
                    help="only these cells of CELLS, comma-separated (\"K1 1x17,K3 8x17\")")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        if args.longpair:
            print(json.dumps(_longpair_worker(args.worker, args.reps, args.inputs)))
        elif args.fixed:
            print(json.dumps(_fixed_worker(args.worker, args.reps)))
        elif args.wall:
            print(json.dumps(_wall_worker(args.worker, args.reps)))
        else:
            cells = args.cells.split(",") if args.cells else None
            print(json.dumps(_worker(args.worker, args.reps, cells)))
        return 0
    if not args.against:
        ap.error("--against DIR is required")
    result = run(Path(args.against).resolve(), args.reps,
                 lambda msg: print(msg, flush=True), args.longpair, args.fixed, args.cells,
                 args.wall)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
