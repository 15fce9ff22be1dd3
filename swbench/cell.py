"""A cell found by name, and one run of it.

``BENCHMARK.json`` names the cell, its configuration, its traffic and the
metrics it reports; everything else is a file of the cell's own under
``swbench/``, found by name, so that a new cell, configuration, traffic
kind or metric is a new file and no edit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import time
import traceback
from pathlib import Path
from types import ModuleType

import numpy as np
import torch

from . import alignments, check, trace as tracing
from .data import Database, make_database, random_queries, seed_words
from .peaks import bytes_bound_s, nvidia_smi, ops_bound_s
from .scoring import load_table
from .stats import percentile

SWBENCH = Path(__file__).resolve().parent
BENCHMARK = SWBENCH.parent / "BENCHMARK.json"
# Warm-up searches every request shape over this many records of the
# database first, which loads each kernel the shape launches.
WARM_RECORDS = 4096


def load_module(path: Path) -> ModuleType:
    """The module in file ``path``."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    name = path.stem.replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(f"swbench.{path.parent.name}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    reader: ModuleType


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    workload: dict
    traffic: ModuleType
    end_to_end: list[Metric]
    per_layer: list[Metric]


def load_cell(name: str, benchmark: Path = BENCHMARK, root: Path = SWBENCH) -> Cell:
    """Cell ``name`` of ``benchmark``, its files under ``root``."""
    bench = json.loads(Path(benchmark).read_text())
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"{benchmark} has no workload {name!r}")
    entry = entries[0]
    workload = json.loads((root / "workloads" / f"{name}.json").read_text())
    for key in ("config", "traffic"):
        if workload[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key} {workload[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    config = json.loads((root / "configs" / f"{entry['config']}.json").read_text())

    def metrics(entries):
        return [Metric(m["name"], m["unit"], load_module(root / "metrics" / f"{m['name']}.py"))
                for m in entries]

    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name, entry["chips"], config, workload,
                load_module(root / "traffic" / f"{workload['kind']}.py"),
                metrics(e2e), metrics(layer))


@dataclasses.dataclass
class Search:
    start: float  # host clock, seconds
    end: float
    kernel_s: float  # the program's own timer, as the search returns it
    cells: int  # query residues x database residues
    ok: bool


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    setup_s: float
    window_s: float
    searches: list[Search]
    trace: tracing.Trace | None = None
    sms: int | None = None
    sm_clock_hz: float | None = None
    memory_peak_bytes: int | None = None  # the card's allocator, through the window


def program_scoring(config: dict, table: np.ndarray):
    from seqalign_tpu_torch.host import ScoringModel

    sc = config["scoring"]
    return ScoringModel(gap_open=sc["gap_open"], gap_extend=sc["gap_extend"],
                        use_match_mismatch=False, table=table.copy())


def encoded(db: Database, ids: np.ndarray | None = None):
    """The program's ``EncodedDatabase`` of ``db``, or of its records
    ``ids``, in that order."""
    from seqalign_tpu_torch.host import EncodedDatabase

    if ids is None:
        seq, offsets = db.seq, db.offsets
    else:
        seq, lengths = db.records(ids)
        offsets = np.concatenate(([0], np.cumsum(lengths)))
    return EncodedDatabase(seq=seq, offsets=offsets, names=[""] * (len(offsets) - 1))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _warm_up(cell: Cell, pipeline, db: Database, whole, scoring, seed: int) -> None:
    """Every request shape over a few records, then the heaviest and the
    lightest request over the whole database."""
    rng = np.random.default_rng(seed_words(seed, 5))
    shapes = cell.traffic.warmup(cell.workload["params"])
    small = encoded(db, np.arange(min(WARM_RECORDS, len(db.lengths))))
    for lengths in shapes:
        cell.traffic.submit(pipeline, random_queries(cell.config, rng, lengths), small, scoring)
    for lengths in (max(shapes, key=sum), min(shapes, key=sum)):
        cell.traffic.submit(pipeline, random_queries(cell.config, rng, lengths), whole, scoring)


def _window(cell: Cell, pipeline, requests, whole, scoring, samples, seconds: float,
            traced: bool, log):
    """The closed loop: ``(searches, their queries, their answers, their
    hits, the window's start, the profiler or None)``. Search ``k``'s
    answer is ``(records, scores)``: its scores of sample ``k`` mod the
    pool, of the records its queries were copied from and of the records
    of its hits. Its hits are what ``submit`` returned third, one list of
    ``alignments.Hit`` a query, or None where it returned two. The search
    in flight at ``seconds`` finishes and counts."""
    residues = int(whole.offsets[-1])
    searches: list[Search] = []
    queries, answers, hits = [], [], []
    profiler = contextlib.nullcontext()
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        profiler = profile(activities=acts)
    with profiler as prof:
        first = time.perf_counter()
        while True:
            qs, sources = next(requests)
            t0 = time.perf_counter()
            try:
                with (torch.profiler.record_function(tracing.SEARCH_SPAN) if traced
                      else contextlib.nullcontext()):
                    answer = cell.traffic.submit(pipeline, qs, whole, scoring)
                scores, kernel_s = answer[:2]
                ok = True
            except Exception:  # a failed search is counted, and the run goes on
                log(traceback.format_exc())
                ok, kernel_s = False, 0.0
            t1 = time.perf_counter()
            k = len(searches)
            searches.append(Search(t0, t1, kernel_s, sum(len(q) for q in qs) * residues, ok))
            queries.append(qs)
            if ok:
                records = np.union1d(samples[k % len(samples)], np.asarray(sources, dtype=np.int64))
                found = answer[2] if len(answer) > 2 else None
                if found is not None:
                    records = np.union1d(records, np.array([h.record for q in found for h in q],
                                                           dtype=np.int64))
                answers.append((records, np.asarray(scores)[:, records]))
                hits.append(found)
            else:
                answers.append(None)
                hits.append(None)
            if t1 - first >= seconds:
                break
    return searches, queries, answers, hits, first, prof


def execute(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device,
            started: float, log=print) -> dict:
    """Set up, run the window, read the metrics and check the answers.
    ``started`` is the process's start on ``time.time()``'s clock. Returns
    the result line's fields, ``checks`` last."""
    from seqalign_tpu_torch import pipeline

    config, spec = cell.config, cell.workload["check"]
    table = load_table(config["scoring"]["matrix"])
    scoring = program_scoring(config, table)
    db = make_database(config, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    whole = encoded(db)
    samples = check.sample_pool(db.lengths, spec, seed)
    requests = cell.traffic.requests(cell.workload["params"], config, db, seed)
    _warm_up(cell, pipeline, db, whole, scoring, seed)
    _sync(device)

    setup_s = time.time() - started
    searches, queries, answers, hits, first, prof = _window(
        cell, pipeline, requests, whole, scoring, samples, seconds, traced, log)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    run = Run(setup_s, searches[-1].end - first, searches, memory_peak_bytes=peak or None)
    out_device = {"platform": "gpu" if device.type == "cuda" else device.type,
                  "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                  "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced:
        run.trace = tracing.from_profiler(prof)
        if device.type == "cuda":
            run.sms = torch.cuda.get_device_properties(device).multi_processor_count
            mhz = nvidia_smi("clocks.max.sm")
            run.sm_clock_hz = mhz * 1e6 if mhz else None
        if run.trace is not None:
            out_device["busy_s"] = tracing.busy_seconds(run.trace)
            out_device["window_s"] = tracing.window_seconds(run.trace)
            breakdown = {"device_ops": tracing.top_device_ops(run.trace),
                         "idle_gaps": tracing.idle_by_host(run.trace)}
    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = m.reader.read(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}

    # The program's state is gone; the reference runs in the memory it held.
    del whole, prof
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    walls = [(s.end - s.start) * 1e3 for s in searches]
    log(f"searches: {len(walls)}, ms at quartiles " + ", ".join(
        f"{percentile(walls, q):.2f}" for q in (0, 25, 50, 75, 100)))
    chosen = check.chosen_searches(queries, [a is not None for a in answers], spec, seed)
    t0 = time.perf_counter()
    got = check.compare(db, len(samples), queries, answers, chosen, table,
                        config["scoring"]["gap_open"], config["scoring"]["gap_extend"], device)
    log(f"reference: {len(chosen)} searches, {got['compared']} scores in "
        f"{time.perf_counter() - t0:.1f} s; largest score {got['max_score']}")
    for ex in got["examples"]:
        log(f"mismatch: {ex}")
    correct = got["mismatches"] == 0 and got["compared"] >= 1
    aligned = None
    if any(h is not None for h in hits):
        t0 = time.perf_counter()
        aligned = alignments.compare(db, queries, answers, hits, chosen,
                                     cell.workload["params"]["k"], table,
                                     config["scoring"]["gap_open"],
                                     config["scoring"]["gap_extend"])
        log(f"alignments: {aligned['compared']} hits judged in "
            f"{time.perf_counter() - t0:.1f} s")
        for ex in aligned["examples"]:
            log(f"alignment mismatch: {ex}")
        correct = correct and aligned["mismatches"] == 0 and aligned["compared"] >= 1
    failed = sum(not s.ok for s in searches)
    line = {"correct": correct and failed == 0,
            "attempted": len(searches), "failed": failed, "metrics": metrics,
            "device": out_device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    if traced and run.sm_clock_hz:
        # Beside the roofline share: the card's limit and clock, and the
        # window's two bounds (operations; each residue read and each score
        # written once).
        done = [(s, qs) for s, qs in zip(searches, queries) if s.ok]
        line["card"] = {
            "power_limit_w": nvidia_smi("power.limit"), "sms": run.sms,
            "sm_clock_max_mhz": run.sm_clock_hz / 1e6,
            "ops_bound_s": ops_bound_s(sum(s.cells for s, _ in done), run.sms, run.sm_clock_hz),
            "bytes_bound_s": bytes_bound_s(sum(len(db.seq) + 4 * len(qs) * len(db.lengths)
                                               for _, qs in done))}
    line["checks"] = {"mismatches": {"value": got["mismatches"], "limit": 0},
                      "failed_searches": {"value": failed, "limit": 0},
                      "scores_compared": {"value": got["compared"], "at_least": 1}}
    if aligned is not None:
        line["checks"]["alignment_mismatches"] = {"value": aligned["mismatches"], "limit": 0}
        line["checks"]["alignments_compared"] = {"value": aligned["compared"], "at_least": 1}
    return line
