#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (seqalign_tpu_torch) on one GPU.

    python3 chip_smoke.py [--against DIR] [--phases 3,4,6,13]

Phases, each printing its own lines; any failure exits nonzero:

1. device: the card's name, its power limit (nvidia-smi), torch, CUDA, nvcc;
2. build: compile csrc/*.cu (sw_stream.cu: K1 and K3, the one-pass team
   kernel of sw_stream.cuh, an instance per R built; sw_stream_solo.cu:
   their solo kernel, one thread a lane scoring Q queries, an instance per
   (R, Q) built, each printed with its registers and its instructions a
   cell beside those of the team kernel's solo instance it replaced;
   sw_striped.cu: K2; all on the team step of
   sw_team.cuh, with K2's block instance; sw_windows.cu and
   sw_windows_const_s.cu: K4 and K5, the team kernel of sw_windows.cuh;
   tb_fill.cu: the alignment step's passes, an ends-only and a
   state-writing instance; isa_probe.cu: the issue-rate probe), one nvcc
   each in parallel, for
   sm_90a into build/;
   read every instance's registers, local memory and stack (no spills) and the
   inner DP loop of its SASS (integer instructions per cell, for the
   bound): K1 and K3 (a step of R rows, one instance per R built; 2 Q R
   cells a step for the solo kernel), K2, the fixed-batch kernel K4 and
   its constant-S mode K5 (a step of R rows, four a loop for K4's solo
   instances; K5's loop without LDS), and tb_fill_kernel (an LDS a cell);
   then measure the card's issue rate of VIADDMNMX, VIMNMX3, IADD3, IMNMX,
   IMAD, LDS and SHFL, alone and in pairs (seqalign_tpu_torch.probe), and
   the bound those rates give each kernel;
3. kernel: the single-query stream kernel (K1) against its plain PyTorch
   version on the card, int32-exact (torch.equal), at every (T, R) built
   (teams of T threads of R rows), over scoring systems, segment layouts,
   window widths (a window whose last CTA holds teams past its lanes), an
   empty query and query lengths up to MAX_QUERY_ROWS, 16-position
   segments (several in flight in one team) with empty lanes, and the solo
   kernel at lq = 1, 5, 17 and 24; then the
   multi-query kernel (K3) the same way, over 2 to 64 queries of unequal
   lengths, an empty query, queries at MAX_QUERY_ROWS, a tail segment,
   empty windows and forced teams; and its solo kernel at every (R, Q)
   built, at nq = 1, Q - 1, Q + 1 and 9 queries of unequal lengths up to R
   rows (one empty), and at lq <= 17 at every Q with 16-position segments
   and empty lanes, empty windows, go == ge and a BLOSUM62 query holding
   '*';
   then the row-striped kernel (K2), pass by pass (output slots and the
   boundary row) and as a whole search, at 1537 to 4096 query rows and at
   35,000 against a small database, over the same scoring systems, a
   partial final stripe, 32 R + 1 rows, a last pass where most threads
   have no rows, passes whose last row sits inside a thread, a full pass
   of every R built, segments of 16 positions with empty lanes, a tail
   segment and empty windows; and K2's block instance (sw_longpair's
   kernel) block by block against its plain version: bests, the carried
   left column (its coalesced layout) and the boundary row, at j0 = 0 and
   j0 > 0, every R built, kPartial passes, with and without a boundary in,
   lanes that are not a multiple of a CTA's warps; each case running every
   cell and again with the lanes' ends (lanes sorted by length too; the
   cases must hold dead CTAs, dead warps and stops inside a block, counted
   from the ends), word for word on filled tensors;
   then the fixed-batch kernel (K4) and its constant-S mode (K5) against
   their plain versions, over the six scoring systems, windows of 256 and
   1,024 lanes, 1 to 8 windows, lq = 1 to MAX_QUERY_ROWS, 3-D profiles of
   unequal lengths (an empty query, 64 queries), ragged batches sorted and
   unsorted, records with '*' inside and at their ends and all-'*' lanes,
   4,096-lane batches, every (T, R) built (solo instances included),
   warps whose ends fall on every residue of a step, a BLOSUM62 query
   holding '*' (its '*' row scores +1, so the kernel runs every warp to
   the batch's length; stopping at the warps' ends would change a best,
   which the plain version shows), a 3-D profile with '*' in one query
   only, a batch whose length needs '*' padding through the engine
   interface, one window (sw_window), and K5 against K4 on a biased
   profile of 7s;
4. main path: a Swiss-Prot-scale search (565,247 records, about 205 M
   residues, bench.py's generator, seed 42, PAM250, gaps -2/-1, a
   144-residue query) through seqalign_tpu_torch.pipeline.search_database on
   the card; the launch counters prove it ran K1 and no plain version, and
   packed its streams with the pack kernel (csrc/stream_pack.cu) once per
   chunk, calling neither the host packer nor the pack's plain version;
   every score is checked against the plain version, and 256 against the
   wavefront engine, on the card; the pack kernel against its plain
   version and the host packer, byte for byte, on small cases (empty
   records, '*' inside records, windows of 100 lanes, a target length,
   records starting at every byte offset mod 16, lengths 0-257 around its
   words and tiles, a slot longer than a CTA's run) and on the whole
   database, where it is timed with CUDA events (the launch alone, and
   the wrapper with its one copy of the plan's ids, runs and fs through
   the search's page-locked pieces; the wrapper's host steps on the host
   clock) beside its plain version, one torch.take over a prebuilt index
   (the library's yardstick) and its bound; its registers
   and no spills; the database's copy to the card three ways
   (pageable, through page-locked pieces, registered in place) beside the
   host packer's streams' copy; the search's wall and its device busy
   share under torch.profiler;
5. multi-query path: 8 queries of 17 residues (bench.py's multi-query
   point), then 64 of 144 (the north-star batch), against the same
   database through pipeline.search_database_multi; the counters prove it
   ran K3, one launch per chunk and block (at 64 x 144 one block), and
   neither K1 nor a plain version; every score equals K1 run per query,
   and the 8-query batch equals K3's plain version on the same card
   tensors; K3, the K1 loop and the plain version are timed, and the
   search's device-memory peak read; K3's instance (at 8 x 17 the solo
   kernel and its Q), registers and bound are printed beside its time, and
   the reorder + fetch of the bests (on the card, then one copy to
   page-locked memory) beside the host scatter it replaced;
6. long-query path: a 2000-residue query against the same database through
   pipeline.search_database; the counters prove it ran K2 (stripes x chunks
   passes) and nothing else; every score equals K2's plain version on the
   card, pass by pass, and 4,096 records (the 256 longest among them)
   equal the wavefront engine; the search's device-memory peak; K2 is
   timed per pass and whole, with its rows per thread and registers, and
   K1 and K2 side by side at lq=512 and 1536; then one step of K2's block
   instance at the long pair's shape (1,024 rows x 128 positions x 1,024
   lanes): five tasks of three instances (a first sub-pass without a
   boundary in, sub-passes with a carried left column, a partial sub-pass
   of 92 rows at R = 8, a last one of 184 rows without a boundary out) in
   three launches, exact against the step's plain version word for word,
   both timed, and its first task alone (one block) beside the block's
   plain version; all of it again with the lanes' ends;
7. fixed-batch path: the same database and 144-residue query, length-
   sorted and cut into pipeline.lane_batches of 4,096, 16,384 and 67,584
   lanes, one call of pipeline.get_engine("windows") each; the counters
   prove each B launched K4 once per batch and nothing else, and all
   565,247 scores equal phase 4's K1 scores; K4 and K5 are timed in turns
   over each B's batches on the card (swissprot.fixed_breakdown), with each
   B's (T, R), the cells K4 runs (each warp to its own end: below 1.2x the
   real cells at 67,584, or the phase fails) beside the real and the
   batches' cells, and K4's bound over the real cells at its instance's
   SASS count; at 67,584 lanes K4 and K5 equal their plain versions on
   every batch, and 8 queries of 17 residues through K4 with a 3-D profile
   equal phase 5's K3 scores;
8. CLI: the port's CLI with the stream kernels against the same CLI with
   --engine wavefront on a 3,000-record FASTA, for one query, an 8-record
   query file, a 2000-residue query and a 3-record file holding one;
   identical but for Total Time; and --engine pallas (the stream kernels)
   and --engine oracle (the NumPy oracle) on a 300-record FASTA, one query
   and a 3-record file, identical to --engine wavefront;
9. ingest: the host libraries (native/fastio.cc, native/traceback.cc)
   built from nothing, with their seconds; the phase-4 database written as
   FASTA under build/ and parsed natively, equal to the pure-Python parse;
   the chunked reader (parts of 131,072 records) and iter_cache_chunks over
   a fresh .sqc concatenating back to it; parse and pack timed native
   against Python (swissprot.ingest_breakdown);
10. streaming and resume: search_files_streaming over that FASTA in parts
   of 131,072 records with the 144-residue query (K1 once a part, nothing
   else; scores equal phase 4's), with --checkpoint (the first run writes
   every part, a rerun launches nothing, a chunk dropped from one part's
   manifest is the rerun's one launch), and the 2000-residue query the same
   way through K2 in one part (scores equal phase 6's); the streaming wall
   against search_files', the device busy share and the ingest the
   prefetch hides (swissprot.streaming_breakdown);
11. --align and --trace through the CLI: --align 10 over the FASTA for the
   144- and 2000-residue queries, with PAM250 whose '*' scores -8: K1 (K2)
   once, each hit's traceback score equal to its kernel score and the hits
   the 10 best, the hits' passes in the alignment step's kernel
   (tb_fill_kernel, csrc/tb_fill.cu) in one launch where every hit is
   direct, else three (the long hits' forward ends, their reverse ends,
   every fill), and every hit's alignment equal to the host route's (every
   pass on the host); on a 3,012-record FASTA with 12 long records,
   --align 10 equal to --engine wavefront --align 10 but for Total Time;
   --trace, in a CLI process of its own, writes a torch.profiler trace
   that names K1's kernel and holds its one launch; then tb_fill_kernel
   against the native passes it replaces (sw_tb_ends, sw_tb_fill) at the
   step's shapes, launch by launch as topk_alignments takes them: the
   lq=5,478 self-hit under BLOSUM62 11/1 and the two searches' 10 hits
   under the CLI's PAM250 and under BLOSUM62 11/1, each pass's best, end
   cell and state bytes equal; and the kernel's device times on the
   self-hit (python -m seqalign_tpu_torch.ops.traceback_cuda, a process of
   its own), with its bound at the card's rate and at one SM's;
12. multi-device and multi-host (seqalign_tpu_torch.parallel) on the one
   card, whose entries stand in for several cards: multi_device_search
   over local_devices() and over 2 and 4 entries of cuda:0 with the
   144-residue query (one K1 launch per entry and nothing else; all
   565,247 scores equal phase 4's), the 8 x 17 batch over 2 entries (K3
   only; scores equal phase 5's), a 2000-residue query refused with
   ValueError; sharded_engine and sharded_topk over
   get_engine("windows") on 4 entries, a 65,536-lane batch of the sorted
   database in 4 shards (4 K4 launches each; scores equal one K4 call on
   the whole batch, the top 10 a stable descending sort of them); and the
   CLI as two hosts (--hosts 2, one process each, gloo on a local port,
   one .sqc built up front): host 0's stdout equals the one-process CLI's
   but for Total Time, and with --topk 10 --json the stable top 10 of
   phase 4's scores; host 1 prints no result;
13. sequence-parallel long pair (seqalign_tpu_torch.parallel.sw_longpair)
   on the one card: a 35,000-residue query against the 1,024 longest records
   as one lane batch over 1, 2 and 4 entries of cuda:0 and a 2 x 2 data x
   seq mesh at jb=128, and 4 entries at jb=512; the counters prove each run
   launched K2's block instance alone, once per entry and step (twice
   where an entry's last sub-pass is another instance), and no plain
   version; every score equals the long-query search's (K2) of the same
   records; the launches, a CUDA-event kernel timer, the device-memory
   peak and the bound of each run, over the records' real cells (lq x
   residues) and over the padded batch, with the share of the batch's
   cells a CTA-level skip would leave (a model from the lengths); then the
   x1, jb=128 run in turns with the same run through tables without the
   lanes' ends (every cell, as a query with a positive '*' score runs):
   the same scores, and with ends at most SKIP_SHARE_MAX (0.8) of its
   time, measured; the same records shuffled, as sw_longpair sorts them
   and scored in the shuffled order (timed, scores checked, not gated);
   and that run's device busy share under torch.profiler.

With ``--phases`` only phases 1-2 and the named ones of 3, 4, 6 and 13
run (those that need no other phase's results), for a quick check of the
kernels, the main path and its pack, the long-query path and the long
pair; the line before the last then holds what those phases measured.

With ``--against DIR`` (another checkout, for example the parent commit
unpacked under build/) it then times K1 and K3 in turns against that
checkout's kernels, one process each, other, this, this, other
(seqalign_tpu_torch.turns): K1 at lq=17, 144, 512, 1536, K2 at lq=2000,
K3 at 8 x 17, 64 x 17 and 64 x 144, and the stream pack of the lq=144
search, as each checkout's own pipeline launches them, with each
search's device-memory peak.

The line before the last is a JSON object describing the kernels (route,
source, launches on their path, max error, times, the card's bound for the
same work, and that bound at the measured issue rates); the last line is
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


# The least time an H100 SXM could take for a kernel's work: the larger of
# its bytes over the device memory rate and its integer instructions over
# the int32 issue rate. Both from the published peaks: 3.35 TB/s, and
# 67 TFLOP/s float32 = 132 SMs x 128 lanes x 2 (FMA) x 1.98 GHz, of which an
# SM issues int32 work on 64 lanes of a pipe: 16.75 T instructions/s. IMAD
# issues on the FMA pipe beside the ALU pipe that takes the other integer
# instructions (the probe of phase 2 measures the pair at twice the rate
# of either), so the instructions counted are the busier pipe's
# (sass.inner_loop's pipe_per_cell).
HBM_BYTES_PER_S = 3.35e12


def bound(nbytes: int, cells: int, alu_per_cell: float) -> tuple[float, str]:
    """(bound_ms, bound_by) for ``nbytes`` read or written once and
    ``cells`` DP cells of ``alu_per_cell`` integer instructions each on the
    busier pipe.
    ``cells`` counts the work the kernel's contract asks for: for the stream
    kernels real query rows times real database residues (the packer's
    padding is not part of it), for the fixed-batch kernel query rows times
    every batch's Lb x lanes (the fixed batch is its input)."""
    from seqalign_tpu_torch.probe import INT32_PER_S

    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = cells * alu_per_cell / INT32_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
    """Build the kernels; return the inner DP loop of every instance's SASS
    (``sass.inner_loop``: integer instructions per cell on the busier pipe,
    ``pipe_per_cell``, and its opcodes), the registers of every instance
    (``cuobjdump -res-usage``), and the factor by which the issue rates
    measured on this card (``seqalign_tpu_torch.probe``) stretch each
    instance's bound."""
    from seqalign_tpu_torch import probe, sass
    from seqalign_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    print(f"[build] {path.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0} s", flush=True)
    raw_usage = sass.resource_usage(path)
    usage = {sass.kernel_key(m): u for m, u in raw_usage.items() if sass.kernel_key(m)}
    loops = {}
    for mangled, instrs in sass.sass_functions(path).items():
        key = sass.kernel_key(mangled)
        if key is None and "tb_fill_kernel" in mangled:
            # The alignment step's kernel is no team kernel of sass.KERNELS:
            # its instance by name, its loop's cells its LDS (a table gather
            # a cell), as the team kernels'.
            key = f"tb_fill_kernel<{'true' if 'tb_fill_kernelILb1E' in mangled else 'false'}>"
            usage[key] = raw_usage.get(mangled, {})
        if key is None:
            continue
        loop = sass.inner_loop(instrs, key)
        if loop is None:
            fail(f"no DP loop found in the SASS of {mangled}")
        res = usage.get(key, {})
        print(f"[build] SASS {key}: {res.get('REG')} registers, {res.get('LOCAL')} B "
              f"local memory, {res.get('STACK')} B of stack; {len(instrs)} instructions; "
              f"inner loop "
              f"{loop['instructions']} instructions for {loop['cells']} cells "
              f"(from {loop['cells_from']}), {loop['alu_per_cell']} integer per "
              f"cell, {loop['imad_per_cell']} of them IMAD (FMA pipe), "
              f"{loop['pipe_per_cell']} on the busier pipe; {loop['opcodes']}",
              flush=True)
        # ptxas spills to the stack frame, which LOCAL does not count.
        if res.get("LOCAL", 0) or res.get("STACK", 0):
            fail(f"{key}: {res.get('LOCAL')} B of local memory, {res.get('STACK')} B of "
                 "stack (spills)")
        # Only K5 (constant S) has a DP loop without the profile gather; a
        # gather's LDS count must be the loop's cells: a team kernel's 2 R
        # a step (four steps an iteration for a solo instance of K4).
        const_s = key.startswith("sw_windows_kernel<") and key.endswith("true>")
        if const_s != (loop["cells_from"] != "LDS"):
            fail(f"{key}: the DP loop {'has' if const_s else 'lacks'} a profile gather")
        if (not const_s and not key.startswith("tb_fill_kernel<")
                and loop["cells"] != sass.expected_cells(key)):
            fail(f"{key}: {loop['cells']} LDS per loop iteration, not "
                 f"{sass.expected_cells(key)}")
        loops[key] = loop
    from seqalign_tpu_torch.ops.swa_cuda import (
        STREAM_ROWS_PER_THREAD_BUILT, STREAM_SOLO_QUERIES, STRIPE_ROWS_PER_THREAD_BUILT,
        WINDOWS_ROWS_PER_THREAD_BUILT, WINDOWS_SOLO_ROWS, block_kernel_instance,
        team_threads, windows_kernel_instance,
    )

    team = {f"sw_stream_kernel<{r}, false>" for r in STREAM_ROWS_PER_THREAD_BUILT}
    solo = {f"sw_stream_solo_kernel<{r}, {q}>" for r, qs in STREAM_SOLO_QUERIES.items()
            for q in qs}
    team |= solo
    team |= {block_kernel_instance(32 * r - 4 * partial, b_out, r)
             for r in STRIPE_ROWS_PER_THREAD_BUILT for b_out in (False, True)
             for partial in ((0, 1) if b_out else (0,))}
    team |= {windows_kernel_instance(t * r, 1, const_s, (t, r))
             for r in WINDOWS_ROWS_PER_THREAD_BUILT for const_s in (False, True)
             for t in ((1, 2) if r in WINDOWS_SOLO_ROWS else (2,))}
    team |= {"tb_fill_kernel<false>", "tb_fill_kernel<true>"}
    if not team <= set(loops):
        fail(f"SASS of the kernels not all found: {sorted(loops)}")
    for key in sorted(solo, key=lambda k: [int(x) for x in k[22:-1].split(", ")]):
        print(f"[build] solo {key}: {usage.get(key, {}).get('REG')} registers, "
              f"{loops[key]['pipe_per_cell']} instructions a cell on the busier pipe over "
              f"{loops[key]['cells']} cells a loop iteration", flush=True)
    # windows_team's fill rule counts a CTA as the C++ side builds it.
    built = {r: _build.load().sw_windows_team_threads(r) for r in WINDOWS_ROWS_PER_THREAD_BUILT}
    if built != {r: team_threads(r) for r in built}:
        fail(f"swa_cuda.team_threads != the built instances' team_threads<R>(): {built}")

    rates = probe.rates()
    for name, r in rates.items():
        print(f"[probe] {name} (SASS {r['opcode']}): {r['per_s'] / 1e12} T/s, "
              f"{r['over_data_sheet']} of the data sheet's {probe.INT32_PER_S / 1e12} T/s; "
              f"loop {r['loop_opcodes']}", flush=True)
    factor = {key: probe.bound_factor(lp["opcodes"], rates) for key, lp in loops.items()}
    print(f"[probe] each kernel's bound at the measured rates over the data "
          f"sheet's: {factor}", flush=True)
    return loops, usage, factor


class Checker:
    """Runs a kernel and its plain version on the same card tensors: K1
    for a 2-D profile, K3 for a 3-D one."""

    def __init__(self, torch):
        self.torch = torch
        self.max_abs_err = {"sw_stream": 0, "sw_stream_multi": 0,
                            "sw_stream_striped": 0, "sw_stream_striped_block": 0,
                            "sw_windows": 0, "sw_windows_const_s": 0, "stream_pack": 0}

    def compare_pack(self, label, got, plain, host):
        """The pack kernel's ``(streams, fs)`` against its plain version's
        and the host packer's, byte for byte."""
        err = max(int((a.int() - b.int()).abs().max()) if a.numel() else 0
                  for want in (plain, host) for a, b in zip(got, want))
        self.max_abs_err["stream_pack"] = max(self.max_abs_err["stream_pack"], err)
        equal = all(self.torch.equal(a, b) for want in (plain, host) for a, b in zip(got, want))
        print(f"[pack] {label}: streams {tuple(got[0].shape)}, fs {tuple(got[1].shape)} == "
              f"plain version and host packer: {equal}, max_abs_err={err}", flush=True)
        if not equal:
            fail(f"stream_pack != plain version or host packer for {label}")

    def compare(self, label, prof, streams, fs, go, ge, nslots, jb, team=None,
                rows=None, queries=None):
        """K1 (K3 for a 3-D profile), scoring ``rows`` rows (all unless
        given) at ``team`` or the chooser's (T, R) and, for K3, ``queries``
        or the chooser's Q, against its plain version (every row)."""
        from seqalign_tpu_torch.ops import swa_cuda

        torch = self.torch
        name = "sw_stream_multi" if prof.ndim == 3 else "sw_stream"
        kernel = getattr(swa_cuda, name)
        plain = getattr(swa_cuda, name + "_reference")
        rows = prof.shape[-2] if rows is None else rows
        team = team or swa_cuda.stream_team(rows)
        kw = {} if queries is None else {"queries": queries}
        k = kernel(prof, streams, fs, go, ge, nslots=nslots, jb=jb, team=team, rows=rows, **kw)
        torch.cuda.synchronize()
        r = plain(prof, streams, fs, go, ge, nslots=nslots, jb=jb)
        torch.cuda.synchronize()
        err = int((k.long() - r.long()).abs().max()) if k.numel() else 0
        self.max_abs_err[name] = max(self.max_abs_err[name], err)
        equal = torch.equal(k, r)
        nw, length, win = streams.shape
        nq = prof.shape[0] if prof.ndim == 3 else 1
        key = swa_cuda.stream_kernel_instance(rows, team, nq, queries)
        print(f"[kernel] {name} {label}: {f'nq={nq} ' if prof.ndim == 3 else ''}"
              f"rows={rows}/{prof.shape[-2]} (T, R)={team} {key} "
              f"nw={nw} L={length} win={win} jb={jb} slots={nslots} equal={equal} "
              f"max_abs_err={err}", flush=True)
        if not equal:
            fail(f"{name} != plain version for {label}")
        return k

    def compare_striped(self, label, stripes, streams, fs, go, ge, nslots, jb,
                        plain_driver=True):
        """K2 against its plain version on the same card tensors: every
        pass (output slots and boundary row, each pass reading the plain
        version's boundary of the pass before), then the whole search
        (``sw_stream_striped``) against the plain passes' max, and, with
        ``plain_driver``, ``sw_stream_striped_reference`` too. Returns (the
        kernel's scores, the plain version's ms summed over its passes)."""
        from seqalign_tpu_torch.ops import swa_cuda

        torch = self.torch
        kw = dict(nslots=nslots, jb=jb)
        err, prev, plain_best, plain_ms = 0, None, None, 0.0
        for p, stripe in enumerate(stripes):
            last = p == len(stripes) - 1
            bufs = [None if last else torch.empty((2, *streams.shape), dtype=torch.int32,
                                                  device=streams.device)
                    for _ in range(2)]
            k, kb = swa_cuda.sw_stream_striped_pass(
                stripe, streams, fs, go, ge, bnd_in=prev, bnd_out=bufs[0], **kw)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            r, rb = swa_cuda.sw_stream_striped_pass_reference(
                stripe, streams, fs, go, ge, bnd_in=prev, bnd_out=bufs[1], **kw)
            end.record()
            torch.cuda.synchronize()
            plain_ms += start.elapsed_time(end)
            pairs = [(k, r)] + ([] if last else [(kb, rb)])
            err = max([err] + [int((a.long() - b.long()).abs().max()) for a, b in pairs])
            if not all(torch.equal(a, b) for a, b in pairs):
                fail(f"sw_stream_striped pass {p} != plain pass for {label}")
            prev = rb
            plain_best = r if plain_best is None else torch.maximum(plain_best, r)
        whole = swa_cuda.sw_stream_striped(stripes, streams, fs, go, ge, **kw)
        torch.cuda.synchronize()
        equal = torch.equal(whole, plain_best)
        if plain_driver:
            equal = equal and torch.equal(
                whole, swa_cuda.sw_stream_striped_reference(stripes, streams, fs, go, ge, **kw))
        err = max(err, int((whole.long() - plain_best.long()).abs().max()))
        self.max_abs_err["sw_stream_striped"] = max(self.max_abs_err["sw_stream_striped"], err)
        nw, length, win = streams.shape
        rows = sum(int(st.shape[0]) for st in stripes)
        print(f"[kernel] sw_stream_striped {label}: {len(stripes)} passes of "
              f"{'/'.join(str(st.shape[0]) for st in stripes[:2])}.. rows "
              f"(rows={rows}) nw={nw} L={length} win={win} jb={jb} slots={nslots} "
              f"passes+boundaries equal, whole search equal={equal} max_abs_err={err}",
              flush=True)
        if not equal:
            fail(f"sw_stream_striped != plain version for {label}")
        return whole, plain_ms

    def compare_block(self, label, stripe, windows, go, ge, blocks, bnd_in, bnd_out,
                      left_first=False, rows_per_thread=None, ends=None):
        """K2's block instance, a step of one task, against the block's
        plain version on the same card tensors, block by block over
        ``blocks`` ([(j0, j1)]): each block's
        bests and left column, both taking the plain version's left column
        of the block before (the kernel in place), none before the first
        block unless ``left_first`` (then a random column); then the whole
        boundary row written (``bnd_out``), outside the blocks too. With
        ``ends`` (the lanes' ends) each lane stops at its end, and the words
        both sides leave unwritten keep their fill, word for word."""
        from seqalign_tpu_torch.ops import swa_cuda

        torch = self.torch
        nw, length, win = windows.shape
        # The left column (2, R, nw, win, 32); words past the stripe's rows
        # are neither read nor written, so both sides start from one fill.
        lshape = swa_cuda.left_column(stripe.shape[0], windows, rows_per_thread).shape
        gen = torch.Generator(device=windows.device).manual_seed(len(label))
        left = (torch.randint(-4, 40, lshape, dtype=torch.int32, device=windows.device,
                              generator=gen) if left_first else None)
        outs = [None if not bnd_out else torch.full((2, *windows.shape), -9, dtype=torch.int32,
                                                    device=windows.device) for _ in range(2)]
        err = 0
        for j0, j1 in blocks:
            base = (torch.full(lshape, -9, dtype=torch.int32, device=windows.device)
                    if left is None else left)
            k_left = base.clone()
            k = torch.zeros((nw, win), dtype=torch.int32, device=windows.device)
            table = swa_cuda.BlockTable(windows, [swa_cuda.BlockTask(
                stripe, j0, j1, bnd_in, outs[0], None if left is None else k_left, k_left,
                rows_per_thread)], go, ge, ends)
            swa_cuda.sw_stream_striped_step(table, 0, 1, k)
            p_left = base.clone()
            r, _, _ = swa_cuda.sw_stream_striped_block_reference(
                stripe, windows, go, ge, j0=j0, j1=j1, bnd_in=bnd_in, bnd_out=outs[1],
                left_in=left, left_out=p_left, rows_per_thread=rows_per_thread, ends=ends)
            torch.cuda.synchronize()
            err = max(err, *(int((a.long() - b.long()).abs().max())
                             for a, b in ((k, r), (k_left, p_left))))
            if not (torch.equal(k, r) and torch.equal(k_left, p_left)):
                fail(f"sw_stream_striped_block != plain version for {label}, block "
                     f"[{j0}, {j1})")
            left = p_left
        if bnd_out:
            err = max(err, int((outs[0].long() - outs[1].long()).abs().max()))
            if not torch.equal(outs[0], outs[1]):
                fail(f"sw_stream_striped_block's boundary row != plain version for {label}")
        self.max_abs_err["sw_stream_striped_block"] = max(
            self.max_abs_err["sw_stream_striped_block"], err)
        key = swa_cuda.block_kernel_instance(stripe.shape[0], bnd_out, rows_per_thread)
        lanes = "" if ends is None else (
            f" with ends (lanes dead at the last block: "
            f"{int((ends <= blocks[-1][0]).sum())} of {ends.numel()})")
        print(f"[kernel] sw_stream_striped_block {label}{lanes}: {key} rows={stripe.shape[0]} "
              f"nw={nw} L={length} win={win} blocks {blocks} bests, left columns"
              f"{', boundary row' if bnd_out else ''} equal, max_abs_err={err}", flush=True)

    def compare_windows(self, label, prof, dbw, go, ge, const_s=False, kernel=None,
                        team=None, plain=None):
        """K4 (K5 with ``const_s``) at ``team`` or its wrapper's (T, R)
        against its plain version on the same card tensors; ``kernel`` is
        the kernel's output where a caller ran it (through the engine
        interface), ``plain`` the plain version's (scores, ms) where the
        caller has them. Returns (the kernel's scores, the plain version's
        ms)."""
        from seqalign_tpu_torch.ops import swa_cuda

        torch = self.torch
        name = "sw_windows_const_s" if const_s else "sw_windows"
        team = team or swa_cuda.windows_launch_team(prof, dbw)
        if kernel is None:
            kernel = swa_cuda.sw_windows(prof, dbw, go, ge, const_s=const_s, team=team)
        torch.cuda.synchronize()
        if plain is None:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            r = swa_cuda.sw_windows_reference(prof, dbw, go, ge, const_s=const_s)
            end.record()
            torch.cuda.synchronize()
            plain = (r, start.elapsed_time(end))
        r = plain[0]
        err = int((kernel.long() - r.long()).abs().max()) if kernel.numel() else 0
        self.max_abs_err[name] = max(self.max_abs_err[name], err)
        equal = torch.equal(kernel, r)
        nw, length, win = dbw.shape
        queries = f"nq={prof.shape[0]} " if prof.ndim == 3 else ""
        print(f"[kernel] {name} {label}: {queries}rows={prof.shape[-2]} (T, R)={team} "
              f"nw={nw} Lb={length} win={win} equal={equal} max_abs_err={err}", flush=True)
        if not equal:
            fail(f"{name} != plain version for {label}")
        return kernel, plain[1]


def stream_case(name, lq, n, lo, hi, nw, win, seed, encoded=None, order=None,
                striped=False):
    """A stream pack as the pipeline makes it (jb=STREAM_JB, grain=
    STREAM_GRAIN) and the kernel's arguments for it, on the card. A tuple
    ``lq`` gives one query of each length (a string: that query) and a 3-D
    profile (K3);
    ``striped`` gives the profile as K2's stripes of STRIPE_ROWS rows, or of
    ``striped`` rows where it is a number."""
    from seqalign_tpu_torch.convert import (
        profile_stripes, profile_to_torch, stream_pack_to_torch,
    )
    from seqalign_tpu_torch.ops.swa_cuda import STRIPE_ROWS
    from seqalign_tpu_torch.host import encode, pack_streams
    from seqalign_tpu_torch.ops.swa_cuda import STREAM_JB as jb
    from seqalign_tpu_torch.ops.swa_torch import make_profile
    from seqalign_tpu_torch.pipeline import STREAM_GRAIN as grain
    from seqalign_tpu_torch.pipeline import PLANS, _db_from_encoded, multi_profile

    sc = scoring(name)
    rng = np.random.default_rng(seed)
    if isinstance(lq, tuple):
        qs = [sc.query_indices(k if isinstance(k, str) else random_protein(rng, k))
              for k in lq]
        profile = multi_profile(sc.table, qs)
    else:
        profile = make_profile(sc.table, sc.query_indices(random_protein(rng, lq)))
    if encoded is None:
        encoded = [encode(random_protein(rng, int(rng.integers(lo, hi))))
                   for _ in range(n)]
    db = _db_from_encoded(encoded)
    if order is None:
        order = PLANS.find(db, True).order
    pack = pack_streams(db, order, nw, win=win, jb=jb, grain=grain)
    go, ge = sc.gap_open_total, sc.gap_extend
    if striped:
        rows = STRIPE_ROWS if striped is True else striped
        prof = profile_stripes(profile, go, rows, "cuda")
    else:
        prof = profile_to_torch(profile, go, "cuda")
    streams, fs = stream_pack_to_torch(pack, "cuda")
    return pack, (prof, streams, fs, go, ge, len(pack.slot_ids), jb)


def phase_kernel(chk: Checker):
    from seqalign_tpu_torch.host import encode
    from seqalign_tpu_torch.ops.swa_cuda import (
        MAX_QUERY_ROWS, STREAM_ROWS_PER_THREAD_BUILT, STREAM_TEAMS, stream_team,
    )

    # Every (T, R) built: a team of T threads of R rows, the query three
    # rows short of T R (the last thread's last rows are padding).
    for r in STREAM_ROWS_PER_THREAD_BUILT:
        for t in STREAM_TEAMS:
            if t * r <= MAX_QUERY_ROWS:
                _, args = stream_case("PAM250", t * r - 3, 600, 1, 60, 2, 256, 1000 + t * r)
                chk.compare(f"T={t} R={r}", *args, team=(t, r))

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
    # The query's own rows, as the pipeline launches them: the profile's
    # ROW_ALIGN padding skipped (17 of 20 rows, 145 of 148); the solo
    # kernel (one thread a lane, Q = 1) at lq = 1, 5, 17 and 24.
    for name, lq, seed in (("BLOSUM62", 17, 17), ("PAM250", 145, 18), ("PAM250", 1, 19),
                           ("BLOSUM45", 5, 20), ("PAM250", 17, 21), ("BLOSUM62", 24, 22)):
        _, args = stream_case(name, lq, 1500, 1, 120, 4, 256, seed)
        chk.compare(f"{name} lq={lq}, its rows", *args, rows=lq)
    cases += [
        # An empty query scores 0 everywhere.
        ("BLOSUM62", 0, 600, 1, 40, 2, 256, 13),
        # Windows of 100 lanes: the last CTA of a window holds teams past
        # its lanes, which run on lane 0's stream and write nothing.
        ("PAM250", 144, 900, 1, 17, 2, 100, 14),
        ("BLOSUM62", 17, 900, 1, 60, 3, 100, 15),
    ]
    for name, lq, n, lo, hi, nw, win, seed in cases:
        _, args = stream_case(name, lq, n, lo, hi, nw, win, seed)
        chk.compare(f"{name} lq={lq} win={win}", *args)

    # Segments of 16 positions (records of 1..16 residues), several in
    # flight in one team; 8 x 256 + 77 records leave 179 lanes of the last
    # lane group empty. At the chooser's team and at the widest one.
    pack, args = stream_case("BLOSUM62", 144, 8 * 256 + 77, 1, 17, 2, 256, 16)
    if pack.streams.shape[1] != 16 * (pack.fs[:, :, 0] > 0).sum(axis=0).max() + 16:
        fail("the 16-position case has a segment longer than one block")
    r0 = STREAM_ROWS_PER_THREAD_BUILT[0]
    for team in (stream_team(144), (32, r0), (16, -(-144 // 16 // r0) * r0)):
        chk.compare("segments of 16 positions, empty lanes", *args, team=team)

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
    from seqalign_tpu_torch.ops.swa_cuda import MAX_QUERY_ROWS, STREAM_ROWS_PER_THREAD_BUILT

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

    # Forced teams: the query axis with teams of 2 and 32 threads, and
    # 16-position segments with empty lanes.
    _, args = stream_case("BLOSUM45", (60, 33, 0, 57), 1500, 1, 100, 4, 256, 33)
    for team in ((2, 32), (32, STREAM_ROWS_PER_THREAD_BUILT[0])):
        chk.compare("forced team", *args, team=team)
    _, args = stream_case("PAM250", (144, 17), 8 * 256 + 77, 1, 17, 2, 256, 34)
    chk.compare("segments of 16 positions, empty lanes", *args)
    # 8 queries, the longest 17 rows, as the pipeline launches them: the
    # profile's ROW_ALIGN padding skipped.
    _, args = stream_case("PAM250", (17, 12, 5, 17, 3, 1, 16, 9), 2000, 1, 150, 5, 256, 35)
    chk.compare("8 queries of up to 17 rows, their rows", *args, rows=17)
    phase_kernel_solo(chk)


def phase_kernel_solo(chk: Checker):
    """K3's solo kernel (one thread a lane, Q queries a thread) against its
    plain version at every (R, Q) built."""
    from seqalign_tpu_torch.ops.swa_cuda import STREAM_SOLO_QUERIES, stream_team

    # Every (R, Q) at nq = 1, Q - 1, Q + 1 and 9 (the last z slice partial
    # where Q does not divide nq), the queries' lengths unequal, up to R
    # rows, the second one empty.
    for r, qs in STREAM_SOLO_QUERIES.items():
        for q in qs:
            for nq in sorted({1, q - 1, q + 1, 9} - {0}):
                rng = np.random.default_rng(100 * r + 10 * q + nq)
                lqs = [r] + [int(x) for x in rng.integers(1, r + 1, size=nq - 1)]
                lqs[1:2] = [0] * min(1, nq - 1)
                _, args = stream_case("PAM250", tuple(lqs), 600, 1, 60, 2, 256,
                                      1000 * r + 10 * q + nq)
                chk.compare(f"solo R={r} Q={q} lq={'/'.join(map(str, lqs))}", *args,
                            team=(1, r), rows=r, queries=q)

    # At lq <= 17 (R = 18), every Q built, the chooser's Q too: 16-position
    # segments, several in flight across a warp, with empty lanes; windows
    # with no segment; go == ge; a BLOSUM62 query holding '*', whose '*'
    # row scores +1 against the streams' '*' padding.
    rng = np.random.default_rng(36)
    star = "".join(random_protein(rng, 5) + "*" for _ in range(2)) + random_protein(rng, 5)
    seg16 = stream_case("BLOSUM62", (17, 9, 0, 13, 17), 8 * 256 + 77, 1, 17, 2, 256, 37)
    if seg16[0].streams.shape[1] != 16 * (seg16[0].fs[:, :, 0] > 0).sum(axis=0).max() + 16:
        fail("the solo 16-position case has a segment longer than one block")
    empty = stream_case("PAM250", (17, 4, 11), 300, 1, 60, 5, 256, 38)
    if np.count_nonzero(empty[0].fs.any(axis=(0, 2))) != 2:
        fail("solo empty-window case does not leave windows empty")
    cases = [
        ("segments of 16 positions, empty lanes", seg16),
        ("empty windows", empty),
        ("go==ge", stream_case("go==ge", (17, 3, 12, 0, 8), 1000, 1, 80, 2, 256, 39)),
        ("BLOSUM62, a query holding '*'",
         stream_case("BLOSUM62", (star, 17, 6), 1500, 1, 120, 3, 256, 40)),
    ]
    team = stream_team(17)
    for label, (_, args) in cases:
        for q in (None, *STREAM_SOLO_QUERIES[team[1]]):
            chk.compare(f"solo {label}", *args, rows=17, queries=q)


def phase_kernel_striped(chk: Checker):
    from seqalign_tpu_torch.host import encode
    from seqalign_tpu_torch.ops.swa_cuda import (
        STRIPE_ROWS, STRIPE_ROWS_PER_THREAD_BUILT, STRIPE_TEAM, stripe_rows_per_thread,
    )

    sr = STRIPE_ROWS
    cases = [
        # name, lq, n, lo, hi, nw, win, seed, stripe rows
        ("BLOSUM45", 1537, 1500, 1, 200, 4, 256, 41, sr),
        ("BLOSUM62", 2000, 1200, 1, 300, 3, 256, 42, sr),  # a partial last pass
        ("PAM250", 4096, 800, 1, 150, 3, 256, 43, sr),
        ("match/mismatch", 3072, 1000, 1, 100, 2, 256, 44, sr),
        ("random", 2000, 800, 1, 120, 2, 256, 45, sr),
        ("go==ge", 1600, 600, 1, 80, 2, 256, 46, sr),
        ("BLOSUM62", 2000, 2048, 1, 64, 2, 1024, 47, sr),
        ("PAM250", 35_000, 300, 1, 60, 2, 256, 48, sr),
        # 32 R + 1 rows: a last pass of 4 rows, one thread with rows.
        ("BLOSUM62", sr + 1, 900, 1, 120, 2, 256, 51, sr),
        # A last pass of 100 rows: 13 threads with rows, 19 without.
        ("PAM250", sr + 100, 900, 1, 120, 2, 256, 52, sr),
        # Passes of 300 rows, not a multiple of R = 16: the boundary row
        # sits inside the last thread (the kPartial instances).
        ("BLOSUM45", 700, 900, 1, 120, 2, 256, 53, 300),
    ]
    # Every R built, a full pass each (two passes: a boundary out, then in).
    cases += [("PAM250", 2 * STRIPE_TEAM * r, 900, 1, 150, 2, 256, 54 + r, STRIPE_TEAM * r)
              for r in STRIPE_ROWS_PER_THREAD_BUILT]
    for name, lq, n, lo, hi, nw, win, seed, rows in cases:
        _, args = stream_case(name, lq, n, lo, hi, nw, win, seed, striped=rows)
        stripes = args[0]
        r = [stripe_rows_per_thread(st.shape[0]) for st in stripes]
        chk.compare_striped(f"{name} lq={lq} R={'/'.join(map(str, sorted(set(r))))}", *args)

    # Segments of 16 positions (records of 1..16 residues), shorter than the
    # warp's 32-position skew; 8 x 256 + 77 records leave 179 lanes of the
    # last lane group empty, and most records end in '*' padding.
    pack, args = stream_case("BLOSUM62", sr + 37, 8 * 256 + 77, 1, 17, 2, 256, 90,
                             striped=True)
    if pack.streams.shape[1] != 16 * (pack.fs[:, :, 0] > 0).sum(axis=0).max() + 16:
        fail("the 16-position case has a segment longer than one block")
    chk.compare_striped("segments of 16 positions, empty lanes", *args)

    rng = np.random.default_rng(49)
    enc = [encode(random_protein(rng, 40)) for _ in range(256)]
    enc += [encode(random_protein(rng, 3)) for _ in range(256)]
    pack, args = stream_case("BLOSUM62", 1600, 0, 0, 0, 1, 256, 49,
                             encoded=enc, order=np.arange(len(enc)), striped=True)
    starts = np.nonzero(pack.fs[:, 0, 0])[0]
    if not (len(starts) == 1 and starts[0] == pack.fs.shape[0] - 1):
        fail("striped tail-segment case does not start on the final block")
    chk.compare_striped("tail segment on the final block", *args)

    pack, args = stream_case("PAM250", 1700, 300, 1, 60, 5, 256, 50, striped=True)
    if np.count_nonzero(pack.fs.any(axis=(0, 2))) != 2:
        fail("striped empty-window case does not leave windows empty")
    chk.compare_striped("empty windows", *args)
    phase_kernel_block(chk)


# K2's block instance (sw_longpair): name, rows, rows_per_thread (None: the
# chooser's), nw, L, win, blocks, a boundary in, a boundary row out, a left
# column before the first block, seed, lanes sorted longest first (as
# sw_longpair scores them). Covers j0 = 0 and j0 > 0, chained left columns,
# every R built, kPartial passes, no boundary in, lanes that are not a
# multiple of a CTA's warps, threads without rows, and (with the lanes'
# ends) CTAs whose lanes have all ended before a block.
BLOCK_CASES = [
    ("BLOSUM62", 200, None, 1, 160, 77, [(0, 48), (48, 112), (112, 160)], True, True, False, 61,
     False),
    ("PAM250", 500, None, 2, 256, 256, [(0, 128), (128, 256)], False, True, False, 62, False),
    ("BLOSUM45", 700, None, 1, 96, 1000, [(0, 32), (32, 96)], True, False, False, 63, False),
    ("PAM250", 1024, None, 1, 128, 100, [(0, 64), (64, 128)], True, True, False, 64, False),
    ("random", 300, None, 2, 96, 77, [(0, 16), (16, 32), (32, 64), (64, 96)], True, True,
     False, 65, False),
    ("match/mismatch", 1000, None, 2, 64, 64, [(0, 32), (32, 64)], False, True, False, 66,
     False),
    ("go==ge", 40, 32, 1, 80, 33, [(32, 48), (48, 80)], True, True, True, 67, False),
    ("BLOSUM62", 96, 8, 3, 48, 20, [(16, 48)], False, False, True, 68, False),
    ("BLOSUM62", 800, None, 2, 256, 200, [(0, 64), (64, 128), (128, 256)], True, True, False,
     69, True),
    ("PAM250", 150, None, 1, 128, 100, [(32, 64), (64, 128)], True, True, True, 70, True),
]


def lane_kinds(ends, rows_per_thread: int, blocks) -> dict:
    """Over ``blocks`` ([(j0, j1)]) and the lanes' ``ends`` ``(nw, win)``:
    the CTAs none of whose lanes reaches j0 (they return before the profile
    copy), the lanes that end before j0 in a CTA that runs (dead warps),
    and the lanes that stop inside the block."""
    cl = cta_lanes(rows_per_thread)
    e = ends.cpu().numpy()
    pad = -e.shape[1] % cl
    e = np.pad(e, ((0, 0), (0, pad)))  # lanes past win: end 0
    real = np.arange(e.shape[1]) < e.shape[1] - pad
    out = {"dead_ctas": 0, "dead_warps": 0, "stops": 0}
    for j0, j1 in blocks:
        dead = e <= j0
        cta_dead = dead.reshape(e.shape[0], -1, cl).all(axis=2)
        out["dead_ctas"] += int(cta_dead.sum())
        out["dead_warps"] += int((dead & real & ~np.repeat(cta_dead, cl, axis=1)).sum())
        out["stops"] += int(((e > j0) & (e < j1 - 1)).sum())  # n < j1 - j0
    return out


def phase_kernel_block(chk: Checker):
    """K2's block instance against its plain version (BLOCK_CASES), on
    random '*'-padded windows and a random boundary row above; each case
    twice, running every cell and stopping each lane at its end. Fails
    unless the cases with ends hold dead CTAs, dead warps in CTAs that run
    and lanes that stop inside a block (counted from the ends)."""
    import torch

    from seqalign_tpu_torch.convert import batch_windows, profile_to_torch
    from seqalign_tpu_torch.ops.swa_cuda import STREAM_JB, lane_ends, stripe_rows_per_thread
    from seqalign_tpu_torch.ops.swa_torch import make_profile

    kinds = {"dead_ctas": 0, "dead_warps": 0, "stops": 0}
    for (name, rows, rpt, nw, length, win, blocks, b_in, b_out, left, seed,
         by_length) in BLOCK_CASES:
        sc = scoring(name)
        rng = np.random.default_rng(seed)
        go, ge = sc.gap_open_total, sc.gap_extend
        stripe = profile_to_torch(
            make_profile(sc.table, sc.query_indices(random_protein(rng, rows))), go, "cuda")
        lens = rng.integers(1, length + 1, nw * win)
        if by_length:
            lens = np.sort(lens.reshape(nw, win), axis=1)[:, ::-1].reshape(-1)
        db = rng.integers(0, 20, (length, nw * win)).astype(np.int8)
        db[np.arange(length)[:, None] >= lens[None, :]] = 31
        windows = batch_windows(db, win, STREAM_JB, "cuda")
        bnd_in = (torch.from_numpy(rng.integers(-4, 60, (2, *windows.shape), dtype=np.int32))
                  .to("cuda") if b_in else None)
        ends = lane_ends(windows).to(torch.int32)
        for k, v in lane_kinds(ends, rpt or stripe_rows_per_thread(rows), blocks).items():
            kinds[k] += v
        for e in (None, ends):
            chk.compare_block(f"{name} rows={rows}", stripe, windows, go, ge, blocks, bnd_in,
                              b_out, left_first=left, rows_per_thread=rpt, ends=e)
    print(f"[kernel] sw_stream_striped_block with ends, over BLOCK_CASES' blocks: {kinds}",
          flush=True)
    if not all(kinds.values()):
        fail(f"the block cases with ends lack a kind of lane: {kinds}")


def windows_case(name, lq, nw, win, hi, seed, lb=None, sort=False, stars=False):
    """One fixed batch of ``nw * win`` random records (lengths in [1, hi),
    one of length ``lb`` if given) as pipeline.lane_batches makes it but
    unpadded, and the kernel's arguments for it on the card. A tuple ``lq``
    gives one query of each length and a 3-D profile. ``sort`` orders the
    records longest first, as lane_batches does; ``stars`` puts '*' inside
    some records and at the end of others, and makes some lanes all '*'."""
    from seqalign_tpu_torch.convert import batch_windows, profile_to_torch
    from seqalign_tpu_torch.host import PAD_INDEX, encode, pack_batch
    from seqalign_tpu_torch.ops.swa_cuda import STREAM_JB
    from seqalign_tpu_torch.ops.swa_torch import make_profile
    from seqalign_tpu_torch.pipeline import _db_from_encoded, multi_profile

    sc = scoring(name)
    rng = np.random.default_rng(seed)
    if isinstance(lq, tuple):
        profile = multi_profile(sc.table, [sc.query_indices(random_protein(rng, k))
                                           for k in lq])
    else:
        profile = make_profile(sc.table, sc.query_indices(random_protein(rng, lq)))
    lengths = rng.integers(1, hi, size=nw * win)
    if lb is not None:
        lengths[int(rng.integers(nw * win))] = lb
    if sort:
        lengths = np.sort(lengths)[::-1]
    recs = [encode(random_protein(rng, int(k))) for k in lengths]
    if stars:
        for k, rec in enumerate(recs):
            if k % 3 == 0 and len(rec) > 2:
                rec[rng.integers(0, len(rec) - 1)] = PAD_INDEX
            if k % 5 == 1:
                rec[-1] = PAD_INDEX
            if k % 97 == 5:
                rec[:] = PAD_INDEX
    db = _db_from_encoded(recs)
    batch = pack_batch(db, np.arange(db.n), nw * win, int(lengths.max()))
    go, ge = sc.gap_open_total, sc.gap_extend
    args = (profile_to_torch(profile, go, "cuda"),
            batch_windows(batch, win, STREAM_JB, "cuda"), go, ge)
    return profile, batch, args


def warp_end_windows(torch, rng, lb, win, per_warp):
    """One window of ``win`` random lanes, each shorter than ``lb - 32``
    but one a warp (of ``per_warp`` lanes), at a random place in it, of
    ``lb - (w % 32)`` residues for warp ``w``: the warps' ends cover every
    residue of a step and of a 16-position block."""
    from seqalign_tpu_torch.host import PAD_INDEX

    lengths = rng.integers(1, lb - 32, size=win)
    longest = np.arange(0, win, per_warp) + rng.integers(0, per_warp, size=-(-win // per_warp))
    longest = np.minimum(longest, win - 1)
    lengths[longest] = lb - np.arange(len(longest)) % 32
    db = np.full((1, lb, win), PAD_INDEX, np.int8)
    for lane, n in enumerate(lengths):
        db[0, :n, lane] = rng.integers(0, 20, size=n)
    return torch.from_numpy(db).cuda()


def phase_kernel_windows(chk: Checker):
    from seqalign_tpu_torch.convert import profile_to_torch
    from seqalign_tpu_torch.host import PAD_INDEX
    from seqalign_tpu_torch.ops import swa_cuda
    from seqalign_tpu_torch.ops.swa_cuda import (
        CONST_S, MAX_QUERY_ROWS, STREAM_TEAMS, WINDOWS_ROWS_PER_THREAD_BUILT,
    )
    from seqalign_tpu_torch.ops.oracle import sw_score_batch
    from seqalign_tpu_torch.ops.swa_torch import make_profile
    from seqalign_tpu_torch.pipeline import multi_profile

    torch = chk.torch

    rng = np.random.default_rng(70)
    lq64 = tuple(int(k) for k in rng.integers(1, 40, size=64))
    cases = [
        # name, lq (a tuple: a 3-D profile), nw, win, hi, seed[, options]
        ("BLOSUM45", 144, 4, 256, 200, 61),
        ("BLOSUM62", 17, 1, 1024, 300, 62),
        ("PAM250", 512, 3, 256, 150, 63),
        ("match/mismatch", 1, 8, 1024, 100, 64),
        ("random", 144, 2, 1024, 120, 65),
        ("go==ge", 17, 5, 256, 80, 66),
        ("BLOSUM62", MAX_QUERY_ROWS, 2, 1024, 64, 67),
        ("BLOSUM62", (17, 9, 0), 3, 256, 300, 71),
        ("PAM250", lq64, 2, 1024, 100, 72),
        ("BLOSUM62", (MAX_QUERY_ROWS, 700), 1, 1024, 64, 73),
        # Ragged batches sorted as lane_batches sorts them, and with '*'
        # inside records, at their ends and in whole lanes.
        ("PAM250", 144, 4, 1024, 300, 77, dict(sort=True)),
        ("BLOSUM62", 40, 2, 1024, 200, 78, dict(sort=True, stars=True)),
        ("BLOSUM45", 17, 3, 256, 150, 79, dict(stars=True)),
        # 4,096-lane batches (wide teams: windows_team fills the card).
        ("PAM250", 144, 4, 1024, 400, 80, dict(sort=True)),
        ("PAM250", 17, 4, 1024, 400, 81, dict(sort=True, stars=True)),
    ]
    for name, lq, nw, win, hi, seed, *opt in cases:
        _, _, args = windows_case(name, lq, nw, win, hi, seed, **(opt[0] if opt else {}))
        label = f"{name} lq={'/'.join(map(str, lq)) if isinstance(lq, tuple) else lq}"[:80]
        if opt:
            label += " " + " ".join(k for k in opt[0])
        chk.compare_windows(label, *args)
        chk.compare_windows(label, *args, const_s=True)

    # Every (T, R) windows_team can pick, the solo instances included: each
    # team at the largest of these row counts it holds, against one plain
    # run a row count, over a ragged window with '*' in it.
    sc = scoring("BLOSUM62")
    go, ge = sc.gap_open_total, sc.gap_extend
    _, _, (_, dbw, _, _) = windows_case("BLOSUM62", 8, 1, 512, 64, 82, stars=True)
    plains, profs = {}, {}
    for t in STREAM_TEAMS:
        for r in WINDOWS_ROWS_PER_THREAD_BUILT:
            rows = max(n for n in (8, 20, 40, 144, 500, 1000, MAX_QUERY_ROWS) if n <= t * r)
            if rows not in profs:
                profs[rows] = profile_to_torch(make_profile(
                    sc.table, sc.query_indices(random_protein(rng, rows))), go, "cuda")
            for const_s in (False, True):
                key = (rows, const_s)
                _, ms = chk.compare_windows(f"team ({t}, {r})", profs[rows], dbw, go, ge,
                                            const_s=const_s, team=(t, r),
                                            plain=plains.get(key))
                if key not in plains:
                    plains[key] = (swa_cuda.sw_windows_reference(
                        profs[rows], dbw, go, ge, const_s=const_s), ms)

    # Warps that end at every residue of a step (and of a 16-position
    # block), at teams of 32, 8 and 1 lanes a warp.
    for team in ((1, 20), (4, 10), (32, 10)):
        dbw = warp_end_windows(torch, rng, 96, 1024, 32 // team[0])
        ends = swa_cuda.warp_ends(dbw, team)[0].reshape(-1, 32 // team[0])[:, 0]
        if set((ends % 32).tolist()) != set(range(0, 32, 2)):
            fail(f"warp-end case at {team}: warp ends {sorted(set(ends.tolist()))}")
        chk.compare_windows(f"warps ending at every residue, team {team}", profs[20], dbw,
                            go, ge, team=team)

    # A BLOSUM62 query holding '*': ('*', '*') scores +1, so the kernel
    # runs every warp to the batch's length, and the padding raises a best
    # above the record's scored alone at its own length.
    # The batch's last lane (in its shortest warp) holds the query's first
    # 28 residues: the cell of the query's '*' row at the lane's first pad
    # position, 28, adds +1 to the best, and a warp ending at 28 stops
    # before it.
    q = np.concatenate([sc.query_indices(random_protein(rng, 28)), [PAD_INDEX]])
    prof = profile_to_torch(make_profile(sc.table, q), go, "cuda")
    _, batch, (_, dbw, _, _) = windows_case("BLOSUM62", 8, 2, 1024, 60, 83, sort=True)
    dbw[-1, :28, -1] = torch.from_numpy(q[:28].astype(np.int8)).cuda()
    dbw[-1, 28:, -1] = PAD_INDEX
    full, _ = chk.compare_windows("query with '*' (the skip is off)", prof, dbw, go, ge)
    alone = int(sw_score_batch(q, [q[:28]], sc.table, sc.gap_open, sc.gap_extend)[0])
    if int(full[-1]) != alone + 1:
        fail(f"query with '*': the last lane's best {int(full[-1])} != its record's "
             f"alone ({alone}) + 1; the case shows nothing")
    print(f"[kernel] sw_windows query with '*': its '*' row scores +1, so the skip is "
          f"off and every warp runs to Lb={dbw.shape[1]}; the last lane's best "
          f"{int(full[-1])} is its record's alone ({alone}, the NumPy oracle) + 1, "
          "which a warp stopping at its end would miss", flush=True)
    # A 3-D profile with '*' in its second query only: that query's CTAs
    # run to the batch's length, the others stop at their warps' ends.
    qs = [sc.query_indices(random_protein(rng, n)) for n in (17, 40, 6)]
    qs[1][11] = PAD_INDEX
    prof3 = profile_to_torch(multi_profile(sc.table, qs), go, "cuda")
    chk.compare_windows("3-D profile, '*' in one query", prof3, dbw, go, ge)
    chk.compare_windows("3-D profile, '*' in one query", prof3, dbw, go, ge, const_s=True)

    # The engine interface pads a batch of Lb = 37 with '*' to 48.
    profile, batch, (prof, dbw, go, ge) = windows_case("PAM250", 144, 3, 1024, 30, 74, lb=37)
    if batch.shape[0] != 37 or dbw.shape[1] != 48:
        fail(f"engine padding case: Lb {batch.shape[0]} -> {dbw.shape[1]}")
    out = swa_cuda.sw_windows_engine(profile, batch, go, ge)
    chk.compare_windows("engine interface, Lb=37 padded to 48", prof, dbw, go, ge, kernel=out)
    # One window, Lb = 50.
    profile, batch, (prof, dbw, go, ge) = windows_case("BLOSUM62", 30, 1, 1024, 40, 75, lb=50)
    out = swa_cuda.sw_window(profile, batch, go, ge)
    chk.compare_windows("sw_window, one window, Lb=50", prof, dbw, go, ge, kernel=out)
    # K5 is K4 on a biased profile of 7s where no row is padding.
    _, _, (prof, dbw, go, ge) = windows_case("BLOSUM62", 144, 2, 1024, 200, 76)
    k5 = swa_cuda.sw_windows(prof, dbw, go, ge, const_s=True)
    k4 = swa_cuda.sw_windows(torch.full_like(prof, CONST_S), dbw, go, ge)
    if not torch.equal(k4, k5):
        fail("K5 != K4 on a biased profile of 7s")
    print("[kernel] K5 == K4 on a biased profile of 7s (lq=144, 2 windows of "
          f"1024 lanes, Lb={dbw.shape[1]})", flush=True)


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
    from seqalign_tpu_torch.ops import pack_cuda
    from seqalign_tpu_torch.utils import packing

    pack_cuda.pack_streams_device.launches = 0
    pack_cuda.pack_streams_reference.calls = 0
    packing.pack_streams.calls = 0
    for fn in (swa_cuda.sw_stream, swa_cuda.sw_stream_multi,
               swa_cuda.sw_stream_striped_pass, swa_cuda.sw_stream_striped_step,
               swa_cuda.sw_windows):
        fn.launches = 0
    swa_cuda.sw_windows.launches_const_s = 0
    for fn in (swa_cuda.sw_stream_striped, swa_cuda.sw_stream_reference,
               swa_cuda.sw_stream_multi_reference,
               swa_cuda.sw_stream_striped_reference,
               swa_cuda.sw_stream_striped_pass_reference,
               swa_cuda.sw_stream_striped_block_reference,
               swa_cuda.sw_stream_striped_step_reference,
               swa_cuda.sw_windows_reference):
        fn.calls = 0


def read_counts(swa_cuda):
    return {
        "sw_stream": swa_cuda.sw_stream.launches,
        "sw_stream_multi": swa_cuda.sw_stream_multi.launches,
        "sw_stream_striped_pass": swa_cuda.sw_stream_striped_pass.launches,
        "sw_stream_striped calls": swa_cuda.sw_stream_striped.calls,
        "sw_stream_striped_step": swa_cuda.sw_stream_striped_step.launches,
        "sw_windows": swa_cuda.sw_windows.launches,
        "sw_windows_const_s": swa_cuda.sw_windows.launches_const_s,
        "plain": swa_cuda.sw_stream_reference.calls
        + swa_cuda.sw_stream_multi_reference.calls
        + swa_cuda.sw_stream_striped_reference.calls
        + swa_cuda.sw_stream_striped_pass_reference.calls
        + swa_cuda.sw_stream_striped_block_reference.calls
        + swa_cuda.sw_stream_striped_step_reference.calls
        + swa_cuda.sw_windows_reference.calls,
    }


def read_pack_counts():
    """The stream pack's counts: kernel launches, plain-version calls and
    host-packer calls (kept out of ``read_counts``, whose sums are the
    Smith-Waterman launches)."""
    from seqalign_tpu_torch.ops import pack_cuda
    from seqalign_tpu_torch.utils import packing

    return {"stream_pack": pack_cuda.pack_streams_device.launches,
            "stream_pack plain": pack_cuda.pack_streams_reference.calls,
            "host pack_streams": packing.pack_streams.calls}


# Small pack cases on the card, against the host packer and the plain
# version: (label, records or a tuple of their lengths, lengths lo..hi, nw,
# win, empty records, records with '*' inside, extra target length). The
# last four are the kernel's edges: records starting at every byte offset
# mod 16, lengths around its 16-byte words and 64-position tiles, a slot
# longer than a CTA's run (ops/pack_cuda.PACK_RUN), 100 lanes (byte
# stores).
PACK_EDGE_LENGTHS = (0, 1, 15, 16, 17, 63, 64, 65, 255, 256, 257)
PACK_CASES = (
    ("one window", 700, 1, 60, 1, 256, 0, 0, None),
    ("a window a slot", 1024, 1, 40, 4, 256, 0, 0, None),
    ("empty records, 100 lanes", 600, 0, 30, 2, 100, 80, 0, None),
    ("'*' inside records", 900, 3, 70, 4, 256, 0, 120, None),
    ("target length, 64 lanes", 800, 1, 50, 3, 64, 0, 0, 96),
    ("records of 1-500 (tiles of several slots)", 3000, 1, 500, 5, 256, 0, 0, None),
    ("every byte offset mod 16", (17,) * 600 + (33,) * 200 + (5,) * 100, None, None, 2, 256,
     0, 30, None),
    ("lengths 0-257", PACK_EDGE_LENGTHS * 100, None, None, 3, 256, 0, 40, None),
    ("a slot longer than a run", (1100,) * 256 + (700, 641, 300) * 200, None, None, 3, 256,
     0, 50, None),
    ("100 lanes", 2000, 0, 300, 3, 100, 60, 40, None),
)


def pack_cases(torch, chk: Checker):
    from seqalign_tpu_torch.convert import database_to_torch, stream_pack_to_torch
    from seqalign_tpu_torch.host import encode, pack_streams, plan_streams
    from seqalign_tpu_torch.ops.pack_cuda import pack_streams_device, pack_streams_reference
    from seqalign_tpu_torch.pipeline import PLANS, STREAM_GRAIN, STREAM_JB, _db_from_encoded

    for k, (label, n, lo, hi, nw, win, zeros, stars, extra) in enumerate(PACK_CASES):
        rng = np.random.default_rng(400 + k)
        if isinstance(n, tuple):
            recs = [encode(random_protein(rng, m)) for m in n]
            n = len(recs)
        else:
            recs = [encode(random_protein(rng, int(rng.integers(lo, hi)))) for _ in range(n)]
        for r in rng.choice(n, zeros, replace=False):
            recs[r] = recs[r][:0]
        for r in rng.choice(n, stars, replace=False):
            if len(recs[r]) > 2:
                recs[r] = recs[r].copy()
                recs[r][rng.integers(1, len(recs[r]) - 1)] = 31
        db = _db_from_encoded(recs)
        order = PLANS.find(db, True).order
        kw = dict(win=win, jb=STREAM_JB, grain=STREAM_GRAIN)
        if extra is not None:
            kw["target_len"] = plan_streams(db.lengths, order, nw, **kw).L + extra
        plan = plan_streams(db.lengths, order, nw, **kw)
        want = stream_pack_to_torch(pack_streams(db, order, nw, **kw), "cuda")
        dev_db = database_to_torch(db, "cuda")
        got = pack_streams_device(*dev_db, plan)
        plain = pack_streams_reference(*dev_db, plan)
        torch.cuda.synchronize()
        chk.compare_pack(f"{label}: nw={nw} L={plan.L} win={win}", got, plain, want)
    # The last case's database searched in chunks of one lane group, with
    # one copy of it on the card and, under a memory budget it does not
    # fit, each chunk copying its own records: the same scores.
    from seqalign_tpu_torch import pipeline

    sc = scoring("PAM250")
    query = sc.query_indices(random_protein(np.random.default_rng(410), 144))
    slots, free = pipeline.MAX_STREAM_SLOTS, pipeline.device_free_bytes
    pipeline.MAX_STREAM_SLOTS = 1
    try:
        chunks = len(pipeline.chunk_bounds(db, pipeline.PLANS.find(db, True).order))
        whole, _ = pipeline.search_database(query, db, sc, device="cuda")
        pipeline.device_free_bytes = lambda device: 0
        per_chunk, _ = pipeline.search_database(query, db, sc, device="cuda")
    finally:
        pipeline.MAX_STREAM_SLOTS, pipeline.device_free_bytes = slots, free
    if not np.array_equal(whole, per_chunk):
        fail("the per-chunk copy's scores != the whole database's")
    print(f"[pack] {db.n} records in {chunks} chunks: each chunk's own records copied "
          "(no room for the database) == one copy of the database", flush=True)


def phase_main_path(torch, chk: Checker, smi: str, query, db, loops, usage):
    from seqalign_tpu_torch import pipeline, sass
    from seqalign_tpu_torch.convert import (
        PinnedPieces, host_to_device, profile_to_torch, stream_pack_to_torch,
    )
    from seqalign_tpu_torch.host import pack_streams
    from seqalign_tpu_torch.ops import _build, swa_cuda
    from seqalign_tpu_torch.ops.pack_cuda import (
        PACK_RUN, PACK_TILE, gather_index, pack_launch, pack_runs, pack_streams_device,
        pack_streams_reference, stage_inputs, staged_views,
    )
    from seqalign_tpu_torch.ops.swa_torch import make_profile, sw_wavefront
    from seqalign_tpu_torch.swissprot import QUERY_LEN, copy_database, device_busy

    pack_cases(torch, chk)
    sc = scoring("PAM250")
    residues = int(db.offsets[-1])
    order = pipeline.PLANS.find(db, True).order
    chunks = len(pipeline.chunk_bounds(db, order))

    reset_counts(swa_cuda)
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        scores, kernel_s = pipeline.search_database(query, db, sc, device="cuda")
        runs.append((kernel_s, time.perf_counter() - t0))
    counts = read_counts(swa_cuda)
    packs = read_pack_counts()
    launches = counts["sw_stream"]
    print(f"[main] launches: {counts}; the pack: {packs} ({chunks} chunk(s) a search)",
          flush=True)
    if launches < 1 or sum(counts.values()) != launches:
        fail("the main path did not run through K1 alone")
    if packs != {"stream_pack": 2 * chunks, "stream_pack plain": 0, "host pack_streams": 0}:
        fail("the main path did not pack its streams with the pack kernel alone, once a chunk")
    if scores.shape != (db.n,) or scores.dtype != np.int32 or scores.min() < 0:
        fail("main-path scores have the wrong shape, type or sign")
    cells = QUERY_LEN * residues
    for k, (kernel_s, wall_s) in enumerate(runs):
        print(f"[main] run {k}: kernel {kernel_s} s = {cells / kernel_s / 1e9} "
              f"GCUPS over real residues, {db.n} entries, {db.n / kernel_s} entries/s; "
              f"search wall {wall_s} s (sort, plan, copy, pack, kernel, reorder, fetch) "
              f"| {smi}", flush=True)
    wall, busy_ms, top = device_busy(
        lambda: pipeline.search_database(query, db, sc, device="cuda"))
    print(f"[main] under torch.profiler: device busy {busy_ms} ms in a {wall} s search "
          f"wall, busy share {busy_ms / 1e3 / wall}; {top} | {smi}", flush=True)

    # The whole database as the pipeline packs it (one launch at this
    # size): the kernel and its plain version on the same card tensors,
    # every record checked, both timed with CUDA events.
    win, jb = pipeline.WINDOW_LANES, pipeline.STREAM_JB
    if db.n > pipeline.MAX_STREAM_SLOTS * win:
        fail("the database no longer fits one launch")
    plan = pipeline.plan_chunk(db.lengths, order, None,
                               pipeline.resident_lanes(torch.device("cuda")))
    nw = plan.nw
    t0 = time.perf_counter()
    pack = pack_streams(db, order, nw, win=win, jb=jb, grain=pipeline.STREAM_GRAIN)
    host_pack_s = time.perf_counter() - t0
    h2d = {}
    for how in ("pageable", "pinned", "registered", "pageable", "pinned", "registered"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev_db = copy_database(db, torch.device("cuda"), how)
        torch.cuda.synchronize()
        h2d.setdefault(how, []).append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams, fs = stream_pack_to_torch(pack, "cuda")
    torch.cuda.synchronize()
    h2d_streams = time.perf_counter() - t0
    db_bytes = nbytes(*dev_db)
    print(f"[main] copy of the database ({db_bytes} B) to the card, twice each way: "
          + ", ".join(f"{how} {t} s" for how, t in h2d.items())
          + f"; the host packer's streams ({nbytes(streams, fs)} B) pageable "
          f"{h2d_streams} s, packed on the host in {host_pack_s} s | {smi}", flush=True)
    got = pack_streams_device(*dev_db, plan)
    plain = pack_streams_reference(*dev_db, plan)
    torch.cuda.synchronize()
    chk.compare_pack(f"main path ({db.n} records, nw={nw} L={plan.L})", got, plain,
                     (streams, fs))
    del got, plain
    records = db.n
    staged, parts = stage_inputs(plan, records)
    ids, run_table, _ = staged_views(host_to_device(staged, "cuda"), parts, plan)
    # The wrapper as a search's DevicePacker calls it: through one pair of
    # page-locked buffers, each made at its first call (two calls here,
    # before the clock) and kept.
    pieces = PinnedPieces()
    for _ in range(2):
        pack_streams_device(*dev_db, plan, pieces)
    pack_ms = cuda_ms(torch, lambda: pack_launch(*dev_db, ids, run_table, plan), 10)
    wrapper_ms = cuda_ms(torch, lambda: pack_streams_device(*dev_db, plan, pieces), 5)
    pack_plain_ms = cuda_ms(torch, lambda: pack_streams_reference(*dev_db, plan), 1)
    # The wrapper's steps on the host clock, ten rounds in turn: the run
    # table; the staging array built, then copied through the pieces (as
    # the wrapper does); the same array built straight into a page-locked
    # buffer made before the clock and copied from there; the whole wrapper.
    pinned = torch.empty(staged.size + 64, dtype=torch.int32, pin_memory=True)

    def stage_in_place():
        built, _ = stage_inputs(plan, records, out=pinned.numpy())
        out = torch.empty(built.size, dtype=torch.int32, device="cuda")
        return out.copy_(pinned[: built.size], non_blocking=True)

    steps = (("run table", lambda: pack_runs(plan)),
             ("stage, then copy", lambda: host_to_device(
                 stage_inputs(plan, records)[0], "cuda", pieces)),
             ("stage into a page-locked buffer, copy", stage_in_place),
             ("wrapper", lambda: pack_streams_device(*dev_db, plan, pieces)))
    if not torch.equal(steps[1][1](), stage_in_place()):
        fail("the staging array built in place != built, then copied")
    step_times = {step: [] for step, _ in steps}
    for _ in range(10):
        for step, fn in steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            step_times[step].append(time.perf_counter() - t0)
    del pinned
    wrapper_steps_s = {step: {"min": min(t), "median": float(np.median(t))}
                       for step, t in step_times.items()}
    print(f"[main] the pack wrapper's steps (s, host clock, 10 rounds in turn): "
          f"{wrapper_steps_s} | {smi}", flush=True)
    # The library's yardstick: one torch.take of the residues with one
    # PAD_INDEX byte in front, over an index built before the clock (8 B,
    # int64, for every output byte).
    idx, live = gather_index(dev_db[1], plan)
    idx = torch.where(live, idx + 1, 0)
    del live
    padded_seq = torch.cat([torch.full((1,), 31, dtype=torch.int8, device="cuda"), dev_db[0]])
    if not torch.equal(torch.take(padded_seq, idx), streams):
        fail("torch.take over the pack's index != the host packer's streams")
    library_ms = cuda_ms(torch, lambda: torch.take(padded_seq, idx), 5)
    index_bytes = nbytes(idx)
    del idx, padded_seq
    # The bytes the kernel must move: each input read once (the records'
    # residues, offsets, the int32 ids, the run table), its output written
    # once (the streams; fs is a view of the inputs' copy, not written).
    # The count made for the kernel's first design, printed beside it so
    # that the two designs' shares compare, read the ids as int64 and a
    # table of 20 B a 64-position tile, and wrote fs.
    nruns = run_table.shape[0]
    pack_bytes = (residues + nbytes(dev_db[1]) + 4 * len(plan.order) + 20 * nruns
                  + plan.nw * plan.L * plan.win)
    ntiles = int(np.sum(-(-run_table[:, 4].cpu().numpy() // PACK_TILE)))
    tile_bytes = (pack_bytes + 4 * len(plan.order) + 20 * (ntiles - nruns)
                  + plan.fs.nbytes)
    pack_bound_ms, pack_bound_by = bound(pack_bytes, 0, 0.0)
    tile_bound_ms, _ = bound(tile_bytes, 0, 0.0)
    pack_usage = {m: u for m, u in sass.resource_usage(_build.build()).items()
                  if "stream_pack_kernel" in m}
    if len(pack_usage) != 2:
        fail(f"the pack kernel's two instances are not in the library: {list(pack_usage)}")
    for m, u in pack_usage.items():
        print(f"[main] {m}: {u.get('REG')} registers, {u.get('SHARED')} B shared, "
              f"{u.get('LOCAL')} B local, {u.get('STACK')} B stack", flush=True)
        if u.get("LOCAL", 0) or u.get("STACK", 0):
            fail(f"{m} spills")
    print(f"[main] pack kernel: {pack_ms} ms a launch ({pack_bytes} B moved, "
          f"{pack_bytes / pack_ms / 1e9} TB/s; {nruns} runs of up to {PACK_RUN} "
          f"positions), the wrapper with its one copy of ids, runs and fs "
          f"({staged.nbytes} B) {wrapper_ms} ms, its plain version {pack_plain_ms} ms, "
          f"torch.take over a {index_bytes} B index {library_ms} ms; bound "
          f"{pack_bound_ms} ms by {pack_bound_by} ({pack_bound_ms / pack_ms} of it); "
          f"by the first design's count ({tile_bytes} B, {ntiles} tiles) "
          f"{tile_bound_ms} ms ({tile_bound_ms / pack_ms} of it) | {smi}", flush=True)
    del dev_db, ids, run_table

    go, ge = sc.gap_open_total, sc.gap_extend
    prof = profile_to_torch(make_profile(sc.table, query), go, "cuda")
    # The launch as the pipeline makes it: the query's own rows scored.
    kw = dict(nslots=len(pack.slot_ids), jb=jb, rows=len(query))
    out = chk.compare(f"main path ({db.n} records)", prof, streams, fs, go, ge,
                      kw["nslots"], jb, rows=len(query))
    full = np.zeros(db.n, np.int32)
    full[order] = out.cpu().numpy().reshape(-1)[: db.n]
    if not np.array_equal(full, scores):
        fail("main-path scores != plain version")
    print(f"[main] all {db.n} records: main-path scores == plain version",
          flush=True)
    ms = cuda_ms(torch, lambda: swa_cuda.sw_stream(prof, streams, fs, go, ge, **kw), 5)
    plain_ms = cuda_ms(torch, lambda: swa_cuda.sw_stream_reference(
        prof, streams, fs, go, ge, nslots=kw["nslots"], jb=jb), 1)
    team = swa_cuda.stream_team(len(query))
    key = swa_cuda.stream_kernel_instance(len(query))
    shape = (f"nw={nw} L={streams.shape[1]} win={win} jb={jb} "
             f"rows={prof.shape[0]} slots={kw['nslots']} (T, R)={team}")
    out_bytes = kw["nslots"] * win * 4
    bound_ms, bound_by = bound(nbytes(prof, streams, fs) + out_bytes, cells,
                               loops[key]["pipe_per_cell"])
    print(f"[main] main-path shape {shape}: kernel {ms} ms "
          f"({cells / ms / 1e6} GCUPS), plain version {plain_ms} ms "
          f"({cells / plain_ms / 1e6} GCUPS), bound {bound_ms} ms by {bound_by} "
          f"({loops[key]['pipe_per_cell']} per cell, {key}, "
          f"{usage.get(key, {}).get('REG')} registers) | {smi}", flush=True)

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
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "instance": key,
        "registers": usage.get(key, {}).get("REG"),
        "shape": f"main path, {db.n} records, lq={QUERY_LEN}, {shape}",
        "main_path_kernel_s": runs[-1][0],
        "main_path_gcups": cells / runs[-1][0] / 1e9,
        "search_wall_s": [w for _, w in runs],
        "busy_share": busy_ms / 1e3 / wall,
        "pack": {
            "launches": packs["stream_pack"], "ms": pack_ms, "wrapper_ms": wrapper_ms,
            "plain_ms": pack_plain_ms, "bound_ms": pack_bound_ms,
            "bound_by": pack_bound_by, "bytes": pack_bytes,
            "tile_count_bytes": tile_bytes, "tile_count_bound_ms": tile_bound_ms,
            "library_ms": library_ms, "library_index_bytes": index_bytes,
            "wrapper_steps_s": wrapper_steps_s,
            "staged_bytes": staged.nbytes, "host_pack_s": host_pack_s,
            "database_copy_s": h2d, "host_streams_copy_s": h2d_streams,
            "shape": f"{db.n} records, {residues} residues -> nw={nw} L={plan.L} "
                     f"win={win}, {nruns} runs of up to {PACK_RUN} positions",
        },
    }, (order, streams, fs, kw["nslots"]), scores


def k1_per_query(torch, queries, sc, db, k1_pack):
    """Every query through K1 on the single-query pack of the whole
    database: (NQ, N) scores, and the CUDA-event time of one pass of the NQ
    launches with the launches that pass counted (NQ of K1, nothing else)."""
    from seqalign_tpu_torch.convert import profile_to_torch
    from seqalign_tpu_torch.ops import swa_cuda
    from seqalign_tpu_torch.ops.swa_torch import make_profile

    order, streams, fs, nslots = k1_pack
    go, ge = sc.gap_open_total, sc.gap_extend
    profs = [profile_to_torch(make_profile(sc.table, q), go, "cuda") for q in queries]
    # As the pipeline launches K1: each query's own rows scored.
    kws = [dict(nslots=nslots, jb=swa_cuda.STREAM_JB, rows=len(q)) for q in queries]
    scores = np.zeros((len(queries), db.n), np.int32)
    for k, (p, kw) in enumerate(zip(profs, kws)):
        out = swa_cuda.sw_stream(p, streams, fs, go, ge, **kw)
        scores[k, order] = out.cpu().numpy().reshape(-1)[: db.n]
    reset_counts(swa_cuda)
    ms = cuda_ms(torch, lambda: [swa_cuda.sw_stream(p, streams, fs, go, ge, **kw)
                                 for p, kw in zip(profs, kws)], 1)
    counts = read_counts(swa_cuda)
    if counts["sw_stream"] != len(queries) or sum(counts.values()) != len(queries):
        fail(f"K1 looped over {len(queries)} queries launched {counts}")
    return scores, ms, counts["sw_stream"]


def phase_multi_path(torch, chk: Checker, smi: str, db, k1_pack, nq, lq,
                     seed, check_plain, loops, usage):
    """One multi-query batch through pipeline.search_database_multi on the
    card, checked against K1 per query (and K3's plain version)."""
    from seqalign_tpu_torch import pipeline
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
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scores, kernel_s = pipeline.search_database_multi(queries, db, sc, device="cuda")
        runs.append((kernel_s, time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated() - base
    counts = read_counts(swa_cuda)
    print(f"{tag} launches: {counts}", flush=True)
    if counts["sw_stream_multi"] < 1 or sum(counts.values()) != counts["sw_stream_multi"]:
        fail(f"{tag} the multi-query path did not run through K3 alone")
    print(f"{tag} device memory: peak {peak} B above the {base} B held before "
          "the search (streams, fs, bests; K3 allocates no rolling-row scratch)",
          flush=True)
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
    k1, k1_loop_ms, k1_launches = k1_per_query(torch, queries, sc, db, k1_pack)
    if not np.array_equal(k1, scores):
        fail(f"{tag} K3 scores != K1 per query")
    print(f"{tag} all {nq} x {db.n} scores == K1 per query", flush=True)

    # The launches as the pipeline makes them, on card tensors made once.
    blocks = pipeline.query_blocks(
        pipeline.multi_profile(sc.table, queries), go, db.n, torch.device("cuda"))
    chunks = [(chunk, *packed) for chunk, packed in
              pipeline.stream_chunks(db, None, torch.device("cuda"))]
    jb = swa_cuda.STREAM_JB

    def k3_all():
        return [swa_cuda.sw_stream_multi(b, s, f, go, ge, nslots=ns, jb=jb, rows=lq)
                for _, s, f, ns in chunks for b in blocks]

    # One launch per chunk and block in each of the two searches: at 64 x
    # 144 the 8 GiB budget holds the batch in one block.
    if counts["sw_stream_multi"] != 2 * len(chunks) * len(blocks) or (
            nq == 64 and len(blocks) != 1):
        fail(f"{tag} {counts['sw_stream_multi']} K3 launches for {len(chunks)} chunk(s) "
             f"and {len(blocks)} block(s) per search")
    k3_ms = cuda_ms(torch, k3_all, 3 if check_plain else 2)
    # The reorder and fetch inside the pipeline's timer after K3: the bests
    # put in database order on the card, then one copy to page-locked
    # memory; beside them the host scatter they replaced (a pageable fetch
    # of the slots, then numpy).
    outs = [(chunk, torch.cat([swa_cuda.sw_stream_multi(b, s, f, go, ge, nslots=ns, jb=jb,
                                                         rows=lq) for b in blocks], dim=1))
            for chunk, s, f, ns in chunks]
    fetched = pipeline._host_scores((nq, db.n), torch.device("cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = torch.zeros((nq, db.n), dtype=torch.int32, device="cuda")
    for chunk, out in outs:
        pipeline.scatter_slots(on_card, chunk, out)
    fetched.copy_(on_card)
    reorder_fetch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_host = np.zeros((nq, db.n), np.int32)
    for chunk, out in outs:
        pipeline.scatter_slots(on_host, chunk, out.cpu())
    host_scatter_s = time.perf_counter() - t0
    if not (np.array_equal(fetched.numpy(), scores) and np.array_equal(on_host, scores)):
        fail(f"{tag} the bests reordered on the card or on the host != the search's scores")
    print(f"{tag} reorder on the card + fetch to page-locked memory {reorder_fetch_s} s; "
          f"the host scatter it replaced (fetch + numpy) {host_scatter_s} s; both == the "
          f"search's scores | {smi}", flush=True)
    del outs, on_card
    team = swa_cuda.stream_team(lq)
    block_nq = blocks[0].shape[0]
    key = swa_cuda.stream_kernel_instance(lq, nq=block_nq)
    solo = key.startswith("sw_stream_solo_kernel<")
    per_thread = swa_cuda.stream_solo_queries(lq, block_nq) if solo else None
    shape = (f"{len(blocks)} block(s) of {block_nq} queries x "
             f"{blocks[0].shape[1]} rows, {len(chunks)} chunk(s), nw="
             f"{'/'.join(str(s.shape[0]) for _, s, _, _ in chunks)}, (T, R)={team}"
             + (f", Q={per_thread} queries a thread" if solo else ""))
    # Each chunk's streams read once for all blocks; real query rows only.
    io_bytes = sum(nbytes(s, f) + ns * nq * s.shape[2] * 4 for _, s, f, ns in chunks)
    bound_ms, bound_by = bound(io_bytes + nbytes(*blocks), cells,
                               loops[key]["pipe_per_cell"])
    # K1 looped over the queries (the short-query point at lq=17): each
    # launch reads the single-query pack once and writes its slots.
    _, k1_streams, k1_fs, k1_slots = k1_pack
    k1_key = swa_cuda.stream_kernel_instance(lq)
    k1_bound_ms, _ = bound(nq * (nbytes(k1_streams, k1_fs) + k1_slots * k1_streams.shape[2] * 4),
                           cells, loops[k1_key]["pipe_per_cell"])
    result = {
        "launches": counts["sw_stream_multi"], "ms": k3_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "instance": key,
        "queries_per_thread": per_thread, "pipe_per_cell": loops[key]["pipe_per_cell"],
        "registers": usage.get(key, {}).get("REG"), "memory_peak_bytes": peak,
        "k1_loop_ms": k1_loop_ms, "k1_launches": k1_launches, "k1_bound_ms": k1_bound_ms,
        "k1_instance": k1_key,
        "k1_registers": usage.get(k1_key, {}).get("REG"),
        "reorder_fetch_s": reorder_fetch_s, "host_scatter_s": host_scatter_s,
        "search_wall_s": [w for _, w in runs],
        "shape": f"{nq}x{lq} on {db.n} records: {shape}",
        "main_path_kernel_s": runs[-1][0],
        "main_path_gcups": cells / runs[-1][0] / 1e9,
    }
    if check_plain:
        full = np.zeros((nq, db.n), np.int32)
        for chunk, streams, fs, nslots in chunks:
            outs = [chk.compare(f"multi path {nq}x{lq} chunk of {len(chunk)}",
                                b, streams, fs, go, ge, nslots, jb, rows=lq) for b in blocks]
            out = torch.cat(outs, dim=1).cpu().numpy()
            full[:, chunk] = out.transpose(1, 0, 2).reshape(out.shape[1], -1)[:nq, : len(chunk)]
        if not np.array_equal(full, scores):
            fail(f"{tag} scores != K3's plain version")
        print(f"{tag} all {nq} x {db.n} scores == K3's plain version", flush=True)
        result["plain_ms"] = cuda_ms(torch, lambda: [
            swa_cuda.sw_stream_multi_reference(b, s, f, go, ge, nslots=ns, jb=jb)
            for _, s, f, ns in chunks for b in blocks], 1)
        result["scores"] = scores
    print(f"{tag} {shape}: K3 {k3_ms} ms ({cells / k3_ms / 1e6} GCUPS), bound "
          f"{bound_ms} ms by {bound_by} ({bound_ms / k3_ms} of it; "
          f"{loops[key]['pipe_per_cell']} per cell, {key}, Q={per_thread}, "
          f"{result['registers']} registers), K1 looped "
          f"over the {nq} queries {k1_loop_ms} ms ({cells / k1_loop_ms / 1e6} GCUPS; "
          f"bound {k1_bound_ms} ms, {k1_bound_ms / k1_loop_ms} of it, "
          f"{loops[k1_key]['pipe_per_cell']} per cell, {k1_key}, "
          f"{result['k1_registers']} registers)"
          + (f", K3's plain version {result['plain_ms']} ms" if check_plain else "")
          + f" | {smi}", flush=True)
    return result


def wavefront_sample(torch, sc, query, db, groups):
    """Scores of the records of each group (one lane batch each) by the
    plain wavefront engine on the card, concatenated."""
    from seqalign_tpu_torch.ops.swa_torch import make_profile, sw_wavefront

    prof = torch.from_numpy(make_profile(sc.table, query)).cuda()
    outs = []
    for ids in groups:
        lb = int(db.lengths[ids].max())
        block = np.full((lb, len(ids)), 31, dtype=np.int8)
        for lane, r in enumerate(ids):
            rec = db.record(int(r))
            block[: len(rec), lane] = rec
        outs.append(sw_wavefront(
            prof, torch.from_numpy(block).cuda(), sc.gap_open_total, sc.gap_extend
        ).cpu().numpy())
    return np.concatenate(outs)


def phase_striped_path(torch, chk: Checker, smi: str, db, loops, usage, factor,
                       lq=2000):
    """A long query through pipeline.search_database on the card: K2 alone,
    every score held against K2's plain version and a sample against the
    wavefront engine; the search's device-memory peak; K2 timed per pass
    and whole, with its rows per thread and the registers of the instances
    its passes launch, whose SASS loops, weighed by their passes' rows, give
    its bound; K1 and K2 side by side at lq=512 and 1536."""
    from seqalign_tpu_torch import pipeline
    from seqalign_tpu_torch.convert import (
        profile_stripes, profile_to_torch,
    )
    from seqalign_tpu_torch.ops import swa_cuda
    from seqalign_tpu_torch.ops.swa_torch import make_profile
    from seqalign_tpu_torch.swissprot import random_query, striped_pass_ms

    tag = f"[long lq={lq}]"
    sc = scoring("PAM250")
    go, ge = sc.gap_open_total, sc.gap_extend
    residues = int(db.offsets[-1])
    query = random_query(lq, 2000)
    dev = torch.device("cuda")

    reset_counts(swa_cuda)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        scores, kernel_s = pipeline.search_database(query, db, sc, device="cuda")
        runs.append((kernel_s, time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated() - base
    counts = read_counts(swa_cuda)
    print(f"{tag} launches: {counts}", flush=True)
    print(f"{tag} device memory: peak {peak} B above the {base} B held before "
          "the search (streams, fs, boundaries, bests; K2 allocates no "
          "rolling-row scratch)", flush=True)
    order = pipeline.PLANS.find(db, True).order
    chunks = [(c, *packed) for c, packed in
              pipeline.stream_chunks(db, None, dev, pipeline.striped_chunk_residues())]
    stripes = profile_stripes(make_profile(sc.table, query), go, swa_cuda.STRIPE_ROWS, "cuda")
    passes = len(stripes) * len(chunks)
    if (counts["sw_stream_striped_pass"] != 2 * passes
            or counts["sw_stream_striped calls"] != 2 * len(chunks)
            or sum(counts.values()) != 2 * (passes + len(chunks))):
        fail(f"{tag} the long-query path did not run through K2 alone "
             f"({len(stripes)} stripes x {len(chunks)} chunks per search)")
    if scores.shape != (db.n,) or scores.dtype != np.int32 or scores.min() < 0:
        fail(f"{tag} scores have the wrong shape, type or sign")
    cells = lq * residues
    for k, (kernel_s, wall_s) in enumerate(runs):
        print(f"{tag} run {k}: kernel timer {kernel_s} s = {cells / kernel_s / 1e9} "
              f"GCUPS over real residues; search wall {wall_s} s incl. host packing "
              f"| {smi}", flush=True)

    # Every score against the plain version, pass by pass, on the card.
    full = np.zeros(db.n, np.int32)
    plain_ms = 0.0
    jb = swa_cuda.STREAM_JB
    for chunk, streams, fs, nslots in chunks:
        out, ms = chk.compare_striped(
            f"long-query path ({len(chunk)} records)", stripes, streams, fs, go, ge,
            nslots, jb, plain_driver=False)
        plain_ms += ms
        full[chunk] = out.cpu().numpy().reshape(-1)[: len(chunk)]
    if not np.array_equal(full, scores):
        fail(f"{tag} scores != K2's plain version")
    print(f"{tag} all {db.n} records: scores == K2's plain version", flush=True)

    # An independent route: the wavefront engine on the 256 longest records
    # and 3840 others.
    rng = np.random.default_rng(8)
    groups = [order[:256], rng.choice(order[256:], 3840, replace=False)]
    pick = np.concatenate(groups)
    t0 = time.perf_counter()
    wf = wavefront_sample(torch, sc, query, db, groups)
    if not np.array_equal(wf, scores[pick]):
        fail(f"{tag} scores != wavefront engine on {len(pick)} records")
    print(f"{tag} {len(pick)} records (the 256 longest among them): scores == "
          f"wavefront engine ({time.perf_counter() - t0} s)", flush=True)

    # K2 timed per pass and whole, on the pipeline's chunk(s).
    kw = [dict(nslots=ns, jb=jb) for _, _, _, ns in chunks]
    whole_ms = cuda_ms(torch, lambda: [
        swa_cuda.sw_stream_striped(stripes, s, f, go, ge, **k)
        for (_, s, f, _), k in zip(chunks, kw)], 3)
    _, streams, fs, nslots = chunks[0]
    pass_ms = striped_pass_ms(stripes, streams, fs, go, ge, nslots, 2)
    io_bytes = sum(nbytes(s, f) + ns * s.shape[2] * 4 for _, s, f, ns in chunks)
    # Each pass's instance (launch_rows' choice); K2's instructions per cell
    # are its instances' loops, each weighed by its pass's rows.
    keys = [swa_cuda.stripe_kernel_instance(st.shape[0], p > 0, p < len(stripes) - 1)
            for p, st in enumerate(stripes)]
    if not set(keys) <= set(loops):
        fail(f"{tag} no SASS loop for the instances the passes launch: {keys}")
    rows = [st.shape[0] for st in stripes]
    ops = [n * loops[key]["pipe_per_cell"] for n, key in zip(rows, keys)]
    bound_ms, bound_by = bound(io_bytes + nbytes(*stripes), cells, sum(ops) / sum(rows))
    k2_factor = sum(o * factor[key] for o, key in zip(ops, keys)) / sum(ops)
    r_pass = [swa_cuda.stripe_rows_per_thread(n) for n in rows]
    regs = {key: usage.get(key, {}).get("REG") for key in keys}
    shape = (f"{len(stripes)} stripes of {stripes[0].shape[0]} rows "
             f"(last {stripes[-1].shape[0]}), R={'/'.join(map(str, r_pass))} rows per "
             f"thread, {len(chunks)} chunk(s), nw="
             f"{'/'.join(str(s.shape[0]) for _, s, _, _ in chunks)} L="
             f"{'/'.join(str(s.shape[1]) for _, s, _, _ in chunks)} win={streams.shape[2]}")
    print(f"{tag} {shape}: K2 {whole_ms} ms ({cells / whole_ms / 1e6} GCUPS) per "
          f"search, per pass {pass_ms} ms, plain version {plain_ms} ms, bound "
          f"{bound_ms} ms by {bound_by} (busier pipe per cell "
          f"{[loops[key]['pipe_per_cell'] for key in keys]} over the passes); rows "
          f"per thread {r_pass}, registers of the passes' instances {regs} | {smi}",
          flush=True)

    # K1 and K2 side by side at lq=512 and at K1's row limit (1536), in
    # turns, on the same streams: a query of one stripe runs as one K2 pass
    # that writes its boundary.
    side = {}
    for lq_k in (512, swa_cuda.MAX_QUERY_ROWS):
        q_k = make_profile(sc.table, random_query(lq_k, lq_k))
        p1 = profile_to_torch(q_k, go, dev)
        s1 = profile_stripes(q_k, go, swa_cuda.STRIPE_ROWS, dev)
        scratch = (torch.empty((2, *streams.shape), dtype=torch.int32, device=dev)
                   if len(s1) == 1 else None)

        def k2():
            if scratch is None:
                return swa_cuda.sw_stream_striped(s1, streams, fs, go, ge, **kw[0])
            return swa_cuda.sw_stream_striped_pass(
                s1[0], streams, fs, go, ge, bnd_out=scratch, **kw[0])[0]

        row = {"lq": lq_k, "k2_passes": len(s1), "k1_ms": [], "k2_ms": []}
        for _ in range(2):
            row["k1_ms"].append(cuda_ms(torch, lambda: swa_cuda.sw_stream(
                p1, streams, fs, go, ge, **kw[0]), 2))
            row["k2_ms"].append(cuda_ms(torch, k2, 2))
        if not torch.equal(swa_cuda.sw_stream(p1, streams, fs, go, ge, **kw[0]), k2()):
            fail(f"{tag} K1 and K2 disagree at lq={lq_k}")
        print(f"{tag} lq={lq_k} on the same streams, in turns: K1 {row['k1_ms']} ms, "
              f"K2 ({len(s1)} passes) {row['k2_ms']} ms; scores equal | {smi}",
              flush=True)
        side[lq_k] = row
    return {
        "launches": counts["sw_stream_striped_pass"],
        "ms": whole_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "factor": k2_factor,
        "pass_ms": pass_ms,
        "rows_per_thread": r_pass,
        "registers": regs,
        "memory_peak_bytes": peak,
        "k1_beside_k2": side,
        "shape": f"long-query path, {db.n} records, lq={lq}, {shape}",
        "main_path_kernel_s": runs[-1][0],
        "main_path_gcups": cells / runs[-1][0] / 1e9,
        "scores": scores,
    }


# One step of K2's block instance at the long pair's shape (phase 6): a
# stripe's rows, block start and end, whether it reads a boundary in, writes
# one out and carries a left column in. Three full sub-passes (the first
# without a boundary in, as entry 0's first), a partial one of 92 rows at
# R = 8 (an entry's last at 2 entries), a last one of 184 rows at R = 8
# without a boundary out (the last entry's at one entry): three instances.
STEP_TASKS = [(1024, 0, 128, False, True, False), (1024, 128, 256, True, True, True),
              (1024, 256, 384, True, True, True), (92, 384, 512, True, True, True),
              (184, 0, 128, True, False, True)]
STEP_LANES, STEP_LENGTH = 1024, 512


def phase_step(torch, chk: Checker, smi: str):
    """K2's block instance, one step (STEP_TASKS, in one launch per
    instance) on random windows of STEP_LANES lanes and random boundaries
    and left columns, against the step's plain version on copies of the
    same card tensors: the merged bests, every boundary row and left
    column, word for word; each timed. Twice: running every cell, and
    with the lanes' ends (each lane stopping at its end)."""
    from seqalign_tpu_torch.convert import batch_windows, profile_stripes
    from seqalign_tpu_torch.ops import swa_cuda
    from seqalign_tpu_torch.ops.swa_torch import make_profile

    tag = "[step]"
    sc = scoring("PAM250")
    go, ge = sc.gap_open_total, sc.gap_extend
    rng = np.random.default_rng(90)
    dev = torch.device("cuda")
    lens = rng.integers(1, STEP_LENGTH + 1, STEP_LANES)
    db = rng.integers(0, 20, (STEP_LENGTH, STEP_LANES)).astype(np.int8)
    db[np.arange(STEP_LENGTH)[:, None] >= lens[None, :]] = 31
    windows = batch_windows(db, STEP_LANES, swa_cuda.STREAM_JB, dev)
    bnd = (2, *windows.shape)
    stripes = [profile_stripes(
        make_profile(sc.table, sc.query_indices(random_protein(rng, rows))), go, rows,
        dev)[0] for rows, *_ in STEP_TASKS]

    def rand(shape):
        return torch.from_numpy(rng.integers(-4, 60, shape, dtype=np.int32)).to(dev)

    result = {}
    for ends in (None, swa_cuda.lane_ends(windows).to(torch.int32)):
        tasks, plain = [], []
        for stripe, (rows, j0, j1, b_in, b_out, carried) in zip(stripes, STEP_TASKS):
            left = rand(swa_cuda.left_column(rows, windows).shape)
            out = torch.full(bnd, -9, dtype=torch.int32, device=dev) if b_out else None
            task = swa_cuda.BlockTask(stripe, j0, j1, rand(bnd) if b_in else None, out,
                                      left if carried else None, left)
            tasks.append(task)
            p_left = left.clone()  # in place, as the kernel's
            plain.append(task._replace(bnd_out=None if out is None else out.clone(),
                                       left_in=p_left if carried else None, left_out=p_left))
        table = swa_cuda.BlockTable(windows, tasks, go, ge, ends)
        keys = [swa_cuda.block_kernel_instance(t.stripe.shape[0], t.bnd_out is not None)
                for t in tasks]
        runs = sum(i == 0 or keys[i] != keys[i - 1] for i in range(len(keys)))
        best = torch.full((1, STEP_LANES), -5, dtype=torch.int32, device=dev)
        reset_counts(swa_cuda)
        swa_cuda.sw_stream_striped_step(table, 0, len(tasks), best)
        torch.cuda.synchronize()
        if swa_cuda.sw_stream_striped_step.launches != runs:
            fail(f"{tag} {swa_cuda.sw_stream_striped_step.launches} launches, not {runs}")
        p_best = torch.full_like(best, -5)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        swa_cuda.sw_stream_striped_step_reference(
            swa_cuda.BlockTable(windows, plain, go, ge, ends), 0, len(plain), p_best)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        pairs = [(best, p_best)] + [(getattr(a, f), getattr(b, f))
                                    for a, b in zip(tasks, plain)
                                    for f in ("bnd_out", "left_out") if getattr(a, f) is not None]
        err = max(int((a.long() - b.long()).abs().max()) for a, b in pairs)
        chk.max_abs_err["sw_stream_striped_block"] = max(
            chk.max_abs_err["sw_stream_striped_block"], err)
        what = "every cell" if ends is None else (
            f"lanes stopping at their ends ({int((ends <= STEP_TASKS[3][1]).sum())} of "
            f"{STEP_LANES} dead at the {STEP_TASKS[3][1]}-position block)")
        if not all(torch.equal(a, b) for a, b in pairs):
            fail(f"{tag} K2's block instance != the step's plain version, {what}")
        # Timed again on the kernel's own tensors (the columns change in
        # place); then the first task alone, one block, and its plain version.
        step_ms = cuda_ms(torch, lambda: swa_cuda.sw_stream_striped_step(
            table, 0, len(tasks), best), 3)
        block_ms = cuda_ms(torch, lambda: swa_cuda.sw_stream_striped_step(table, 0, 1, best), 3)
        t = plain[0]
        start.record()
        swa_cuda.sw_stream_striped_block_reference(
            t.stripe, windows, go, ge, j0=t.j0, j1=t.j1, bnd_in=t.bnd_in, bnd_out=t.bnd_out,
            left_in=t.left_in, left_out=t.left_out, ends=ends)
        end.record()
        torch.cuda.synchronize()
        block_plain_ms = start.elapsed_time(end)
        shape = (f"{len(tasks)} tasks ({'/'.join(str(t[0]) for t in STEP_TASKS)} rows) x 128 "
                 f"positions x {STEP_LANES} lanes, L={windows.shape[1]}")
        block = f"{STEP_TASKS[0][0]} rows x 128 positions x {STEP_LANES} lanes"
        print(f"{tag} one step of {shape}, {what}: {runs} launches ({sorted(set(keys))}); "
              f"bests, boundary rows and left columns == the plain version word for word, "
              f"max_abs_err={err}; kernel {step_ms} ms, plain version {plain_ms} ms; its "
              f"first task alone (one block, {block}): kernel {block_ms} ms, plain version "
              f"{block_plain_ms} ms | {smi}", flush=True)
        row = {"step_ms": step_ms, "plain_ms": plain_ms, "launches": runs, "shape": shape,
               "instances": keys, "block_ms": block_ms, "block_plain_ms": block_plain_ms,
               "block": block}
        if ends is None:
            result = row
        else:
            result["with_ends"] = row
    return result


def phase_fixed_path(torch, chk: Checker, smi: str, query, db, loops, usage, factor, k1,
                     multi8):
    """The fixed-batch engine over the whole database at each lane-batch
    width of swissprot.FIXED_LANES, through pipeline.get_engine("windows"):
    K4 alone, once per batch, every score equal to K1's (``k1``: phase 4's
    scores and its kernel ms). The times, the (T, R) of each width and the
    cells K4 runs come from swissprot.fixed_breakdown at lq=144 (K4 and K5
    in turns at each width); each width's bound reads its instance's SASS
    loop (``loops``). At the widest: K4 and K5 against their plain versions
    on every batch, and the 8 x 17 batch through K4's 3-D form against K3's
    scores (``multi8``)."""
    from seqalign_tpu_torch import pipeline
    from seqalign_tpu_torch.convert import batch_windows, profile_to_torch
    from seqalign_tpu_torch.ops import swa_cuda
    from seqalign_tpu_torch.ops.swa_cuda import FIXED_WINDOW_LANES, STREAM_JB
    from seqalign_tpu_torch.ops.swa_torch import make_profile
    from seqalign_tpu_torch.swissprot import FIXED_LANES, QUERY_LEN, fixed_breakdown

    k1_scores, k1_ms = k1
    sc = scoring("PAM250")
    go, ge = sc.gap_open_total, sc.gap_extend
    residues = int(db.offsets[-1])
    profile = make_profile(sc.table, query)
    prof = profile_to_torch(profile, go, "cuda")
    order = pipeline.PLANS.find(db, True).order
    engine = pipeline.get_engine("windows")
    launches = {}
    for lanes in FIXED_LANES:
        tag = f"[fixed B={lanes}]"
        batches = list(pipeline.lane_batches(db, order, lanes))
        reset_counts(swa_cuda)
        scores = np.zeros(db.n, np.int32)
        t0 = time.perf_counter()
        for ids, batch in batches:
            scores[ids] = engine(profile, batch, go, ge).cpu().numpy()[: len(ids)]
        wall = time.perf_counter() - t0
        counts = read_counts(swa_cuda)
        print(f"{tag} launches: {counts}", flush=True)
        if counts["sw_windows"] != len(batches) or sum(counts.values()) != len(batches):
            fail(f"{tag} the fixed-batch path did not launch K4 alone, once per "
                 f"batch ({len(batches)} batches)")
        if not np.array_equal(scores, k1_scores):
            bad = int(np.count_nonzero(scores != k1_scores))
            fail(f"{tag} {bad} scores != phase 4's K1 scores")
        launches[lanes] = counts["sw_windows"]
        print(f"{tag} all {db.n} scores == K1's (main path) in {len(batches)} "
              f"batches; engine wall {wall} s incl. H2D", flush=True)

    rows = fixed_breakdown(db, {QUERY_LEN: prof}, {QUERY_LEN: k1_ms},
                           lambda msg: print(f"{msg} | {smi}", flush=True))
    per_b = {r["lanes"]: {"launches": launches[r["lanes"]], "ms": min(r["k4_ms"]),
                          **{k: v for k, v in r.items() if k not in ("lanes", "lq")}}
             for r in rows}
    widest = FIXED_LANES[-1]
    tag = f"[fixed B={widest}]"
    res = per_b[widest]
    k4_ms, k5_ms = res["ms"], min(res["k5_ms"])
    # ``batches`` are the widest width's, the last of FIXED_LANES.
    wins = [batch_windows(b, FIXED_WINDOW_LANES, STREAM_JB, "cuda") for _, b in batches]

    # K4 and K5 against their plain versions on every batch, on the card.
    plain = {False: 0.0, True: 0.0}
    for k, w in enumerate(wins):
        for const_s in (False, True):
            _, plain_ms = chk.compare_windows(f"fixed path batch {k}", prof, w, go, ge,
                                              const_s=const_s)
            plain[const_s] += plain_ms
    print(f"{tag} K4 and K5 == their plain versions on all {len(wins)} batches "
          f"(plain {plain[False]} ms, {plain[True]} ms)", flush=True)

    # K5's launches, counted on one pass over the batches it was timed on.
    reset_counts(swa_cuda)
    for w in wins:
        swa_cuda.sw_windows(prof, w, go, ge, const_s=True)
    k5_launches = read_counts(swa_cuda)["sw_windows_const_s"]

    # The 8 x 17 batch through K4's 3-D form against K3's scores.
    scores8, queries8 = multi8
    prof8 = profile_to_torch(pipeline.multi_profile(sc.table, queries8), go, "cuda")
    got = np.zeros((len(queries8), db.n), np.int32)
    for (ids, _), w in zip(batches, wins):
        got[:, ids] = swa_cuda.sw_windows(prof8, w, go, ge).cpu().numpy()[:, : len(ids)]
    if not np.array_equal(got, scores8):
        fail(f"{tag} K4 with a 3-D profile (8 x 17) != K3's scores")
    print(f"{tag} 8 x 17 through K4's 3-D form: all {len(queries8)} x {db.n} "
          "scores == K3's", flush=True)

    # Bounds: K4 over the real cells (query rows x real residues: the skip
    # runs what the data needs), the primary share; over the batches' cells
    # beside it. K5 runs every batch cell by its contract. Each width's
    # instance is the (T, R) windows_team gave it.
    out_bytes = 4 * db.n
    real = QUERY_LEN * residues
    for b, r in per_b.items():
        key = swa_cuda.windows_kernel_instance(prof.shape[0], b, team=tuple(r["team"]))
        k5_key = swa_cuda.windows_kernel_instance(prof.shape[0], b, True, tuple(r["team"]))
        r.update(instance=key, registers=usage.get(key, {}).get("REG"),
                 pipe_per_cell=loops[key]["pipe_per_cell"],
                 k5_instance=k5_key, k5_registers=usage.get(k5_key, {}).get("REG"),
                 k5_pipe_per_cell=loops[k5_key]["pipe_per_cell"])
        r["bound_real_ms"], r["bound_by"] = bound(
            residues + out_bytes + nbytes(prof), real, r["pipe_per_cell"])
        r["bound_batch_ms"] = bound(residues + out_bytes + nbytes(prof), r["cells_batch"],
                                    r["pipe_per_cell"])[0]
        r["k5_bound_ms"] = bound(out_bytes, r["cells_batch"], r["k5_pipe_per_cell"])[0]
        print(f"[fixed B={b}] (T, R) {tuple(r['team'])} ({key}, {r['registers']} registers, "
              f"{r['pipe_per_cell']} per cell): K4 {r['ms']} ms; cells run (a model, "
              f"counted from the batch: windows_cells) {r['model_cells_run']}, "
              f"{r['model_run_over_real']} of the real {r['cells_real']}, the batches' "
              f"{r['cells_batch']}; bound over the real cells {r['bound_real_ms']} ms "
              f"({r['bound_real_ms'] / r['ms']} of K4's time), over the batches' cells "
              f"{r['bound_batch_ms']} ms ({r['bound_batch_ms'] / r['ms']}); K5 "
              f"{min(r['k5_ms'])} ms ({k5_key}, {r['k5_pipe_per_cell']} per cell), bound "
              f"over every batch cell {r['k5_bound_ms']} ms "
              f"({r['k5_bound_ms'] / min(r['k5_ms'])}) | {smi}", flush=True)
    # The skip, measured: K5 runs every batch cell (2.03x the real ones) at
    # about K4's rate a cell, so K4 is well below it only where its warps
    # stop at their ends.
    if k4_ms >= 0.75 * k5_ms:
        fail(f"{tag} K4 {k4_ms} ms is not below 0.75 x K5's {k5_ms} ms: the warps did "
             "not stop at their ends")
    print(f"{tag} K4/K5 {k4_ms / k5_ms} (measured; below 0.75: the warps stop at "
          "their ends)", flush=True)
    shape = (f"{len(wins)} batches of {widest} lanes ({widest // FIXED_WINDOW_LANES} "
             f"windows of {FIXED_WINDOW_LANES}), Lb={'/'.join(str(w.shape[1]) for w in wins)}, "
             f"rows={prof.shape[0]}, (T, R)={tuple(res['team'])}")
    common = {"shape": f"fixed-batch path, {db.n} records, lq={QUERY_LEN}, {shape}",
              "card": smi}
    return {
        "sw_windows": {
            "launches": res["launches"], "ms": k4_ms, "plain_ms": plain[False],
            "bound_ms": res["bound_real_ms"], "bound_by": res["bound_by"],
            "bound_is": "over the real cells (query rows x real residues), at the "
                        "widest B's instance; bound_batch_ms beside it over the batches' cells",
            "bound_batch_ms": res["bound_batch_ms"],
            "instance": res["instance"], "registers": res["registers"],
            "factor": factor[res["instance"]],
            "cells_real": res["cells_real"], "cells_batch": res["cells_batch"],
            "k4_over_k5": k4_ms / k5_ms,
            "gcups_real": res["gcups_real"], "gcups_batch_cells": res["gcups_batch_cells"],
            "padded_over_real": res["padded_over_real"],
            "per_lanes": {str(b): {k: v for k, v in r.items() if not k.startswith("model_")}
                          for b, r in per_b.items()},
            **common,
        },
        "sw_windows_const_s": {
            "launches": k5_launches, "ms": k5_ms, "plain_ms": plain[True],
            "bound_ms": res["k5_bound_ms"], "bound_by": "operations",
            "bound_is": "over every batch cell, which K5 runs",
            "bound_real_cells_ms": bound(out_bytes, real, res["k5_pipe_per_cell"])[0],
            "instance": res["k5_instance"], "registers": res["k5_registers"],
            "factor": factor[res["k5_instance"]],
            "k4_ms_in_turns": res["k4_ms"], "k5_ms_in_turns": res["k5_ms"],
            **common,
        },
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
    (out_dir / "q8.fa").write_text("".join(
        f">q{k} query {k}\n{random_protein(rng, int(rng.integers(5, 150)))}\n"
        for k in range(8)
    ))
    (out_dir / "q2000.fa").write_text(">long\n" + random_protein(rng, 2000) + "\n")
    (out_dir / "qmix.fa").write_text(
        f">s1\n{random_protein(rng, 60)}\n>long\n{random_protein(rng, 2000)}\n"
        f">s2\n{random_protein(rng, 17)}\n")
    env = dict(os.environ, SEQALIGN_PLATFORM="cuda")
    for qfile, blocks in (("q.fa", 0), ("q8.fa", 8), ("q2000.fa", 0), ("qmix.fa", 3)):
        outs = []
        for extra in ([], ["--engine", "wavefront"]):
            cmd = [sys.executable, "-m", "seqalign_tpu_torch.cli",
                   "--substitution_matrix", "BLOSUM62",
                   "--files", str(out_dir / qfile), str(out_dir / "db.fa"), *extra]
            proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                                  text=True, timeout=600)
            # Only a batch holding a long query says so, and only under the
            # stream kernels.
            note = qfile == "qmix.fa" and not extra
            if proc.returncode != 0 or ("Note:" in proc.stderr) != note:
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
    phase_cli_engines(out_dir, rng, env)


def phase_cli_engines(out_dir, rng, env):
    """The JAX CLI's engine names: pallas (the stream kernels, no Note:) and
    oracle (the NumPy oracle), against wavefront on a smaller FASTA."""
    (out_dir / "db300.fa").write_text("".join(
        f">s{i}\n{random_protein(rng, int(rng.integers(2, 100)))}\n" for i in range(300)))
    (out_dir / "q60.fa").write_text(">q60\n" + random_protein(rng, 60) + "\n")
    (out_dir / "q3.fa").write_text("".join(
        f">t{k}\n{random_protein(rng, 20 + 30 * k)}\n" for k in range(3)))
    for qfile in ("q60.fa", "q3.fa"):
        outs = {}
        for engine in ("wavefront", "pallas", "oracle"):
            cmd = [sys.executable, "-m", "seqalign_tpu_torch.cli", "--files",
                   str(out_dir / qfile), str(out_dir / "db300.fa"), "--engine", engine]
            proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                                  text=True, timeout=600)
            if proc.returncode != 0 or "Note:" in proc.stderr:
                fail(f"CLI {qfile} --engine {engine}: rc={proc.returncode} "
                     f"{proc.stderr[-2000:]}")
            outs[engine] = [ln for ln in proc.stdout.splitlines()
                            if not ln.startswith("Total Time:")]
        if not outs["wavefront"] == outs["pallas"] == outs["oracle"]:
            fail(f"CLI {qfile}: --engine pallas / oracle output != wavefront")
        print(f"[cli] {qfile}: --engine pallas == oracle == wavefront on 300 "
              "records (Total Time dropped)", flush=True)


def cli_run(args):
    """The port's CLI in this process (its launch counters readable here):
    (exit code, stdout, stderr)."""
    import contextlib
    import io

    from seqalign_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = cli.main(["smith_waterman", *map(str, args)])
    return code, out.getvalue(), err.getvalue()


def phase_ingest(smi: str, db):
    """The native host libraries built from native/ (seconds each, in a
    fresh directory), then the whole Swiss-Prot-scale database written as
    FASTA and read back: the native parse equal to the pure-Python one,
    the chunked reader (131,072 records a part) and iter_cache_chunks over
    a fresh .sqc concatenating back to it, and parse and pack timed native
    against Python (swissprot.ingest_breakdown)."""
    import tempfile

    from seqalign_tpu_torch import native
    from seqalign_tpu_torch.swissprot import ingest_breakdown, write_fasta
    from seqalign_tpu_torch.utils import native_io

    tag = "[ingest]"
    native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=native.BUILD_DIR) as tmp:
        for name in native.LIBRARIES:
            t0 = time.perf_counter()
            try:
                native.build(name, Path(tmp))
            except RuntimeError as e:
                fail(f"{tag} native/{native.LIBRARIES[name][0]} does not build: {e}")
            print(f"{tag} native {name} built in {time.perf_counter() - t0} s "
                  f"({native.compiler()})", flush=True)
    if not native_io.available():
        fail(f"{tag} the native fastio library is not available")
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    fasta = out_dir / "swissprot.fa"
    t0 = time.perf_counter()
    write_fasta(db, fasta)
    print(f"{tag} {fasta.relative_to(ROOT)}: {fasta.stat().st_size} B written in "
          f"{time.perf_counter() - t0} s", flush=True)
    timing = ingest_breakdown(db, fasta, lambda msg: print(f"{msg} | {smi}", flush=True))
    whole = native_io.parse_file(str(fasta))

    def same(chunks, what):
        seqs, offs, names, base, n = [], [np.zeros(1, np.int64)], [], 0, 0
        for c in chunks:
            if c.n > STREAM_PART:
                fail(f"{tag} {what}: a part of {c.n} records")
            seqs.append(np.asarray(c.seq))
            offs.append(c.offsets[1:] + base)
            base += len(c.seq)
            names.extend(c.names)
            n += 1
        if not (np.array_equal(np.concatenate(seqs), whole.seq)
                and np.array_equal(np.concatenate(offs), whole.offsets)
                and names == whole.names):
            fail(f"{tag} {what} does not concatenate back to the whole parse")
        print(f"{tag} {what}: {n} parts concatenate back to the whole parse", flush=True)

    t0 = time.perf_counter()
    same(native_io.stream_chunks(str(fasta), STREAM_PART), "stream_chunks")
    timing["stream_chunks_s"] = time.perf_counter() - t0
    sqc = out_dir / "swissprot.fa.sqc"
    native_io.save_cache(whole, str(sqc), src_path=str(fasta))
    cached = native_io.load_cache(str(sqc), src_path=str(fasta))
    if cached is None:
        fail(f"{tag} a fresh .sqc cache did not load")
    same(native_io.iter_cache_chunks(cached, STREAM_PART), "iter_cache_chunks over a fresh .sqc")
    sqc.unlink()
    return fasta, timing


def phase_streaming(torch, smi: str, db, fasta, query, k1_scores, long_query, long_scores):
    """The bounded-memory search and the resumable scan at Swiss-Prot scale
    on the card: search_files_streaming in parts of 131,072 records (K1
    once per part, nothing else; scores equal phase 4's), its wall against
    search_files' and its device busy share (swissprot.streaming_breakdown);
    --checkpoint's first run writes every part, a rerun launches nothing,
    and a chunk dropped from one part's manifest is the one launch of the
    next rerun; then the 2000-residue query the same way through K2, one
    part."""
    import shutil

    from seqalign_tpu_torch import pipeline
    from seqalign_tpu_torch.models import decode
    from seqalign_tpu_torch.ops import swa_cuda
    from seqalign_tpu_torch.swissprot import streaming_breakdown

    sc = scoring("PAM250")
    out_dir = fasta.parent
    results = {}
    for lq, q, want, part, kernel in (
            (len(query), query, k1_scores, STREAM_PART, "sw_stream"),
            (len(long_query), long_query, long_scores, db.n, "sw_stream_striped_pass")):
        tag = f"[streaming lq={lq}]"
        qfa = out_dir / f"q{lq}.fa"
        qfa.write_text(f">q{lq}\n{decode(q)}\n")
        parts = -(-db.n // part)
        per_chunk = passes(kernel, lq)
        ck = out_dir / f"ckpt{lq}"
        shutil.rmtree(ck, ignore_errors=True)

        def run(checkpoint):
            reset_counts(swa_cuda)
            t0 = time.perf_counter()
            res = pipeline.search_files_streaming(
                str(qfa), str(fasta), sc, chunk_records=part,
                checkpoint_dir=str(ck) if checkpoint else None)
            wall = time.perf_counter() - t0
            counts = read_counts(swa_cuda)
            if not np.array_equal(res.scores, want):
                fail(f"{tag} streaming scores != the search's on the whole database")
            return res, counts, wall

        res, counts, wall = run(False)
        print(f"{tag} {parts} parts of <= {part} records: launches {counts}; wall "
              f"{wall} s, kernel timer {res.kernel_time} s | {smi}", flush=True)
        if counts[kernel] != parts * per_chunk or sum(counts.values()) != counts[kernel] + (
                counts["sw_stream_striped calls"]):
            fail(f"{tag} the streaming search did not run through {kernel} alone, "
                 f"{per_chunk} per part")
        res, counts, wall = run(True)
        written = sorted(p.name for p in ck.iterdir())
        if written != sorted(f"part{k}" for k in range(parts)) or counts[kernel] != parts * per_chunk:
            fail(f"{tag} --checkpoint's first run wrote {written}, launches {counts}")
        res, counts, wall = run(True)
        print(f"{tag} checkpoint rerun: launches {counts}, kernel timer "
              f"{res.kernel_time} s, wall {wall} s | {smi}", flush=True)
        if sum(counts.values()) != 0 or res.kernel_time != 0.0:
            fail(f"{tag} a finished checkpointed scan launched a kernel")
        victim = ck / f"part{parts - 1}" / "manifest.json"
        state = json.loads(victim.read_text())
        state["chunks"] = state["chunks"][:-1]
        victim.write_text(json.dumps(state))
        res, counts, wall = run(True)
        print(f"{tag} one chunk dropped from part{parts - 1}'s manifest: launches "
              f"{counts}, wall {wall} s | {smi}", flush=True)
        if counts[kernel] != per_chunk:
            fail(f"{tag} the rerun launched {counts[kernel]} {kernel}, not one chunk's")
        shutil.rmtree(ck)
        results[lq] = {"parts": parts, "launches_first": parts * per_chunk}
    results["breakdown"] = streaming_breakdown(
        out_dir / f"q{len(query)}.fa", fasta, sc, STREAM_PART,
        lambda msg: print(f"{msg} | {smi}", flush=True))
    return results


def passes(kernel: str, lq: int) -> int:
    """Launches of ``kernel`` per chunk for a query of ``lq`` rows: one,
    or one per row stripe for K2."""
    from seqalign_tpu_torch.ops import swa_cuda

    return -(-lq // swa_cuda.STRIPE_ROWS) if kernel == "sw_stream_striped_pass" else 1


# Records a part of phase 10's streaming search (and of phase 9's chunked
# reads): 565,247 records in 5 parts.
STREAM_PART = 131072
# The small FASTA of phase 11's comparison with the wavefront engine:
# records of 2-400 residues, and long ones of 2,500-9,000 (above the direct
# traceback's 4 Mi cells for the 2000-residue query).
ALIGN_SMALL = (3000, 12)


def star_negative_pam250(path: Path) -> None:
    """PAM250 as a matrix file whose '*' row and column score -8: the
    builtin's ('*', '*') = +1 would leave --align's end finding to the host
    (a '*' that could outscore real residues), and no query or database here
    holds a '*', so every score is PAM250's."""
    from seqalign_tpu_torch.models import write_matrix_file

    write_matrix_file(str(path), "PAM250")
    lines = path.read_text().splitlines()
    star = lines[1].split().index("*")
    rows = lines[:2]
    for ln in lines[2:]:
        cells = ln.split()
        rows.append(cells[0] + " " + " ".join(
            "-8" if k == star or cells[0] == "*" else v for k, v in enumerate(cells[1:])))
    path.write_text("\n".join(rows) + "\n")


def cli_scoring(matrix: Path, gap_open: int, gap_extend: int):
    """The scoring the CLI builds from ``--substitution_matrix matrix
    --gapopen gap_open --gapextend gap_extend``."""
    from seqalign_tpu_torch.host import load_substitution_matrix, sw_default_scoring

    sc = sw_default_scoring()
    sc.gap_open, sc.gap_extend = gap_open, gap_extend
    load_substitution_matrix(str(matrix), sc)
    sc.use_match_mismatch = False
    sc.finalize()
    return sc


def phase_align_trace(smi: str, db, fasta, query, k1_scores, long_query, long_scores):
    """--align 10 and --trace through the CLI on the card. At Swiss-Prot
    scale, the 144- and 2000-residue queries: K1 (K2) once, the hits'
    passes in tb_fill_kernel (one launch where every hit is direct, else
    three: the forward ends of the hits above the direct-fill threshold,
    their reverse ends, every fill), each hit's score equal to its K1 (K2)
    score, the hits the 10 best, every alignment equal to the host
    route's. On a 3,012-record FASTA with 12 long records, the same
    queries' alignments equal --engine wavefront's, but for Total Time.
    --trace, in a CLI process of its own, writes a trace that names K1's
    kernel and holds its one launch. Returns each query's run, its hits'
    records under ``records``."""
    import dataclasses
    import shutil

    from seqalign_tpu_torch.ops import swa_cuda
    from seqalign_tpu_torch.ops import traceback as tb
    from seqalign_tpu_torch.ops import traceback_cuda as tbc

    out_dir = fasta.parent
    matrix = out_dir / "pam250_star.txt"
    star_negative_pam250(matrix)
    base = ["--substitution_matrix", matrix, "--gapopen", "-2", "--gapextend", "-1"]
    table = cli_scoring(matrix, -2, -1).table
    results = {}
    for lq, want, kernel in ((len(query), k1_scores, "sw_stream"),
                             (len(long_query), long_scores, "sw_stream_striped_pass")):
        tag = f"[align lq={lq}]"
        reset_counts(swa_cuda)
        tbc.run.launches = 0
        t0 = time.perf_counter()
        code, out, err = cli_run(["--files", out_dir / f"q{lq}.fa", fasta, *base,
                                  "--align", "10", "--json"])
        wall = time.perf_counter() - t0
        counts = read_counts(swa_cuda)
        launches = tbc.run.launches
        if code != 0:
            fail(f"{tag} CLI rc={code}: {err[-2000:]}")
        hits = json.loads(out.splitlines()[-1])["alignments"]
        top = np.argsort(-want, kind="stable")[:10]
        big = [h["entry"] for h in hits
               if (db.lengths[h["entry"]] + 1) * (lq + 1) > tb._DIRECT_CELLS]
        print(f"{tag} --align 10 over {db.n} records: launches {counts}, "
              f"tb_fill_kernel launches {launches} for {len(big)} hits above "
              f"{tb._DIRECT_CELLS} cells; wall {wall} s | {smi}", flush=True)
        per = passes(kernel, lq)
        long = kernel == "sw_stream_striped_pass"
        if counts[kernel] != per or sum(counts.values()) != per + counts["sw_stream_striped calls"]:
            fail(f"{tag} the --align scan did not run through {kernel} alone")
        if launches != (3 if big else 1) or (long and not big):
            fail(f"{tag} {launches} launches of tb_fill_kernel for {len(big)} long hits")
        if [h["entry"] for h in hits] != [int(r) for r in top]:
            fail(f"{tag} the hits are not the 10 best of the scan")
        if [h["score"] for h in hits] != [int(want[r]) for r in top]:
            fail(f"{tag} a hit's traceback score != its kernel score")
        q = query if lq == len(query) else long_query
        t0 = time.perf_counter()
        host = tb.topk_alignments(q, db, want, 10, table, -2, -1, engine_ends=False)
        host_s = time.perf_counter() - t0
        for h, (rec, aln) in zip(hits, host):
            if h["entry"] != rec or any(h[f] != v for f, v in dataclasses.asdict(aln).items()):
                fail(f"{tag} record {rec}'s alignment on the card != the host route's")
        print(f"{tag} 10 hits (records {[h['entry'] for h in hits]}, lengths "
              f"{[int(db.lengths[h['entry']]) for h in hits]}): traceback scores == "
              f"kernel scores; every alignment == the host route's (every pass on the "
              f"host, {host_s} s)", flush=True)
        results[lq] = {"wall_s": wall, "tb_launches": launches, "long_hits": len(big),
                       "host_route_s": host_s, "records": [h["entry"] for h in hits]}

    # The same queries on a small FASTA, against the wavefront engine.
    rng = np.random.default_rng(98)
    small = out_dir / "db_align.fa"
    n_short, n_long = ALIGN_SMALL
    small.write_text("".join(
        f">s{i}\n{random_protein(rng, int(rng.integers(2, 400)))}\n" for i in range(n_short)
    ) + "".join(f">long{i}\n{random_protein(rng, int(rng.integers(2500, 9000)))}\n"
                for i in range(n_long)))
    for lq in (len(query), len(long_query)):
        outs = []
        for extra in ([], ["--engine", "wavefront"]):
            tbc.run.launches = 0
            code, out, err = cli_run(["--files", out_dir / f"q{lq}.fa", small, *base,
                                      "--align", "10", *extra])
            if code != 0 or out.count("CIGAR") != 10:
                fail(f"[align lq={lq}] small FASTA {extra}: rc={code} {err[-2000:]}")
            outs.append([ln for ln in out.splitlines() if not ln.startswith("Total Time:")])
            # Only the 2000-residue query's hits pass the direct-fill
            # threshold (the long records): three launches, else one.
            if tbc.run.launches != (3 if lq == len(long_query) else 1):
                fail(f"[align lq={lq}] small FASTA {extra}: {tbc.run.launches} launches "
                     "of tb_fill_kernel")
        if outs[0] != outs[1]:
            fail(f"[align lq={lq}] --align 10 output != --engine wavefront's")
        print(f"[align lq={lq}] --align 10 on {n_short + n_long} records: stream == "
              "--engine wavefront (Total Time dropped)", flush=True)

    # The traced search runs as a user runs it, in a process of its own:
    # torch.profiler, a later session of it in a long process (after this
    # script's other sessions), now and then keeps the CPU events and drops
    # the device records (seen on the parent commit too, PERF.md). Its K1
    # launches are counted in the trace, since the counters live there.
    trace = out_dir / "trace"
    shutil.rmtree(trace, ignore_errors=True)
    proc = subprocess.run(
        [sys.executable, "-m", "seqalign_tpu_torch.cli", "--files",
         str(out_dir / f"q{len(query)}.fa"), str(fasta), *base, "--topk", "5",
         "--trace", str(trace)],
        cwd=ROOT, env=dict(os.environ, SEQALIGN_PLATFORM="cuda"), capture_output=True,
        text=True, timeout=600)
    files = list(trace.glob("seqalign_trace_*.json"))
    if proc.returncode != 0 or "Note:" in proc.stderr or len(files) != 1:
        fail(f"[trace] rc={proc.returncode} files={files} {proc.stderr[-2000:]}")
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {str(e.get("name", "")) for e in events}
    kernels = sorted(n for n in names if "sw_stream_kernel" in n)
    dp = [e for e in events if e.get("cat") == "kernel" and "sw_" in str(e.get("name"))]
    if not kernels or len(dp) != 1:
        fail(f"[trace] the trace names no sw_stream_kernel, or holds {len(dp)} "
             "Smith-Waterman launches, not one K1")
    print(f"[trace] {files[0].relative_to(ROOT)}: {files[0].stat().st_size} B, "
          f"{len(names)} event names, one launch of K1's {kernels}", flush=True)
    results["trace_kernels"] = kernels
    return results


def native_pass(p, table, go: int, ge: int):
    """The native host function a pass of the alignment step replaces on
    the card (``sw_tb_ends``, or ``sw_tb_fill`` for states), on one host
    thread: ``(best, (j, i))``, with states ``(states, best, (j, i))``."""
    import ctypes

    from seqalign_tpu_torch.ops import traceback as tb

    lib = tb._load_native()
    if lib is None:
        fail("[tb_fill] the native traceback library did not load")
    t = np.ascontiguousarray(table.T if p.flip else table, dtype=np.int8)
    q = np.ascontiguousarray(p.q, dtype=np.int8)
    d = np.ascontiguousarray(p.d, dtype=np.int8)
    bj, bi = ctypes.c_int64(), ctypes.c_int64()
    if p.states:
        st = np.zeros((len(d) + 1, len(q) + 1), np.uint8)
        best = lib.sw_tb_fill(q.ctypes.data, len(q), d.ctypes.data, len(d), t.ctypes.data,
                              go, ge, st.ctypes.data, ctypes.byref(bj), ctypes.byref(bi))
        return st, int(best), (int(bj.value), int(bi.value))
    best = lib.sw_tb_ends(q.ctypes.data, len(q), d.ctypes.data, len(d), t.ctypes.data,
                          go, ge, ctypes.byref(bj), ctypes.byref(bi))
    return int(best), (int(bj.value), int(bi.value))


def tb_drive(tag: str, smi: str, steps: list, table, gap_open: int, gap_extend: int,
             device) -> list:
    """Drive the traceback ``steps`` of several pairs as topk_alignments
    does on the card (``traceback._run_on_card``): every pending ends pass
    in one launch of tb_fill_kernel, then every fill; each launch's result
    held against the native pass on the same pair, the best, its end cell
    and the state bytes [1:, 1:] (row and column 0 are never written, nor
    read by the walk). Returns each launch's kind, pairs, cells, host wall
    of ``traceback_cuda.run`` (upload, kernel, download) and the native
    passes' host time."""
    from seqalign_tpu_torch.ops import traceback_cuda as tbc

    go, ge = gap_open + gap_extend, gap_extend
    waiting, rounds = {}, []

    def advance(k, result):
        try:
            waiting[k] = steps[k].send(result)
        except StopIteration:
            pass

    for k in range(len(steps)):
        advance(k, None)
    while waiting:
        states = all(p.states for p in waiting.values())
        keys = sorted(k for k, p in waiting.items() if p.states == states)
        group = [waiting.pop(k) for k in keys]
        if not all(tbc.fits(p, table, go, ge) for p in group):
            fail(f"{tag} a pass the kernel cannot take")
        if len(tbc.batches(group, states)) != 1:
            fail(f"{tag} the passes need more than one launch")
        launch = tbc.plan(group, table, states)
        prepared = tbc.prepare(launch, device)
        t0 = time.perf_counter()
        found = tbc.run(launch, prepared, go, ge)
        card_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = [native_pass(p, table, go, ge) for p in group]
        native_ms = (time.perf_counter() - t0) * 1e3
        err = 0
        for p, g, w in zip(group, found, want):
            err = max(err, abs(g[-2] - w[-2]))
            if g[-2:] != w[-2:] or (states and not np.array_equal(g[0][1:, 1:], w[0][1:, 1:])):
                fail(f"{tag} {'fill' if states else 'ends'} of a {len(p.q)} x {len(p.d)} "
                     f"pair (flip {p.flip}): the card's {g[-2:]} != native {w[-2:]}, or "
                     "its state bytes differ")
        kind = "fill" if states else ("ends" if not rounds else "reverse ends")
        cells = sum(len(p.q) * len(p.d) for p in group)
        rounds.append({"pass": kind, "pairs": len(group), "cells": cells,
                       "longest": max(len(p.q) * len(p.d) for p in group),
                       "card_wall_ms": card_ms, "native_ms": native_ms, "max_abs_err": err})
        print(f"{tag} {kind}: {len(group)} pairs, {cells} cells (largest "
              f"{rounds[-1]['longest']}) == native sw_tb_{'fill' if states else 'ends'}"
              f" (best, end cell{', state bytes' if states else ''}); card {card_ms} ms "
              f"(host wall of the upload, launch and download), native {native_ms} ms | {smi}",
              flush=True)
        for k, g in zip(keys, found):  # walks the states before the next launch
            advance(k, g)
    return rounds


# The lq=5,478 self-hit of phase 11's kernel check: the longest query of
# the CUDASW++ set, as the kernel timer (ops.traceback_cuda) draws it.
TB_SELF = 5478


def phase_tb_fill(torch, smi: str, db, out_dir: Path, query, long_query, align, loops,
                  usage, factor):
    """tb_fill_kernel (csrc/tb_fill.cu) against the native passes it
    replaces, at the alignment step's shapes: the lq=5,478 self-hit under
    BLOSUM62 11/1 (its forward ends, reverse ends and fill, 30.0 M cells
    each), and phase 11's two searches' 10 hits (``align``'s records) under
    the CLI's PAM250 2/1 and under BLOSUM62 11/1, whose '*' scores +1;
    each launch as topk_alignments takes it (``tb_drive``). Then the
    kernel timer in a process of its own (torch.profiler, as phase 11's
    trace): each instance's device time on the self-hit, alone and with
    nine records beside it; the bound of that work at the card's rate and
    at one SM's (a CTA a pair)."""
    from seqalign_tpu_torch.host import ScoringModel, load_builtin
    from seqalign_tpu_torch.ops import traceback as tb
    from seqalign_tpu_torch.probe import INT32_PER_S
    from seqalign_tpu_torch.swissprot import random_query

    dev = torch.device("cuda")
    pam = cli_scoring(out_dir / "pam250_star.txt", -2, -1)
    blosum = load_builtin("BLOSUM62", ScoringModel(gap_open=-11, gap_extend=-1,
                                                   use_match_mismatch=False))
    cases = [("self-hit BLOSUM62 11/1", blosum, [(random_query(TB_SELF, TB_SELF),) * 2])]
    for q in (query, long_query):
        recs = align[len(q)]["records"]
        for name, sc in (("PAM250 2/1", pam), ("BLOSUM62 11/1", blosum)):
            cases.append((f"lq={len(q)} hits {name}", sc,
                          [(q, db.record(r)) for r in recs]))
    rounds, err = {}, 0
    for label, sc, pairs in cases:
        steps = [tb._traceback_steps(np.asarray(a), np.asarray(b), sc.table, sc.gap_open,
                                     sc.gap_extend) for a, b in pairs]
        rounds[label] = tb_drive(f"[tb_fill {label}]", smi, steps, sc.table, sc.gap_open,
                                 sc.gap_extend, dev)
        err = max([err] + [r["max_abs_err"] for r in rounds[label]])
    self_hit = {r["pass"]: r for r in rounds[cases[0][0]]}
    if list(self_hit) != ["ends", "reverse ends", "fill"]:
        fail(f"[tb_fill] the self-hit took {list(self_hit)}, not ends, reverse ends, fill")

    timer = out_dir / "tb_time.json"
    proc = subprocess.run(
        [sys.executable, "-m", "seqalign_tpu_torch.ops.traceback_cuda", "--out", str(timer)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"[tb_fill] the kernel timer: rc={proc.returncode} {proc.stderr[-2000:]}")
    timed = json.loads(timer.read_text())
    kernel_ms = {k: v["device_ms"].get("kernel") for k, v in timed.items()
                 if isinstance(v, dict) and "device_ms" in v}
    if any(v is None for v in kernel_ms.values()):
        fail(f"[tb_fill] the kernel timer's profile holds no kernel time: {kernel_ms}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cells = TB_SELF * TB_SELF
    out = {"self_cells": cells, "kernel_ms": kernel_ms, "timer": timed, "rounds": rounds,
           "max_abs_err": err, "sms": sms}
    for kind, states in (("ends", False), ("fill", True)):
        key = f"tb_fill_kernel<{'true' if states else 'false'}>"
        per_cell = loops[key]["pipe_per_cell"]
        written = (TB_SELF + 1) * (16 + -(-TB_SELF // 16) * 16) if states else 0
        ms, by = bound(written, cells, per_cell)
        out[kind] = {"instance": key, "registers": usage.get(key, {}).get("REG"),
                     "ms": kernel_ms[f"self.{kind}"], "bound_ms": ms, "bound_by": by,
                     "bound_ms_one_sm": cells * per_cell / (INT32_PER_S / sms) * 1e3,
                     "pipe_per_cell": per_cell, "factor": factor[key],
                     "plain_ms": self_hit[kind]["native_ms"],
                     "card_wall_ms": self_hit[kind]["card_wall_ms"]}
        o = out[kind]
        print(f"[tb_fill] {key} ({o['registers']} registers, {per_cell} instructions a "
              f"cell on the busier pipe), the {TB_SELF}-residue self-hit's {kind}: "
              f"{o['ms']} ms on the card (profiler, the timer's process); bound "
              f"{ms} ms by {by} at the card's rate ({100 * ms / o['ms']}%), "
              f"{o['bound_ms_one_sm']} ms at one SM's of {sms} "
              f"({100 * o['bound_ms_one_sm'] / o['ms']}%); native sw_tb_"
              f"{'fill' if states else 'ends'} {o['plain_ms']} ms | {smi}", flush=True)
    return out


# Phase 12: the stand-in meshes (entries of the one card), the lane batch
# of the sharded K4 (the records from 4 x 65,536 on of the length-sorted
# database: 4 shards of 16,384 lanes, 16 windows of FIXED_WINDOW_LANES
# each), and how long a host of the two-host CLI may take.
MESH_ENTRIES = (2, 4)
SHARDED_LANES = 65536
SHARDED_START = 4 * SHARDED_LANES
HOST_TIMEOUT_S = 300
KERNEL_TIMER = "multi_device_search's kernel timer: first launch to last fetch"


def phase_parallel(torch, smi: str, db, query, k1_scores, k1_kernel_s, multi8, fasta):
    """Phase 12: the multi-device search (K1 per device entry, K3 per entry
    and block), the sharded fixed-batch engine and its top-k (K4 per
    shard), and the two-host CLI, all on the one card; every check against
    an earlier phase's scores (``k1_scores``, ``multi8``)."""
    from seqalign_tpu_torch import pipeline
    from seqalign_tpu_torch.device import local_devices
    from seqalign_tpu_torch.host import lattice_round_up, pack_batch
    from seqalign_tpu_torch.ops import swa_cuda
    from seqalign_tpu_torch.ops.swa_torch import make_profile
    from seqalign_tpu_torch.parallel import (
        deal_chunks, make_mesh, multi_device_search, shard_db, sharded_engine,
        sharded_topk,
    )
    from seqalign_tpu_torch.swissprot import random_query

    sc = scoring("PAM250")
    go, ge = sc.gap_open_total, sc.gap_extend
    profile = make_profile(sc.table, query)
    cuda0 = torch.device("cuda", 0)
    win = pipeline.WINDOW_LANES
    order = pipeline.PLANS.find(db, True).order
    result = {"sw_stream": {}, "sw_stream_multi": {}, "sw_windows": {}}

    # (a) multi_device_search: K1 once per entry, every score phase 4's.
    for devices in [local_devices()] + [[cuda0] * d for d in MESH_ENTRIES]:
        tag = f"[parallel K1 x{len(devices)}]"
        reset_counts(swa_cuda)
        t0 = time.perf_counter()
        scores, kernel_s = multi_device_search(profile, db, go, ge, devices=devices)
        wall = time.perf_counter() - t0
        counts = read_counts(swa_cuda)
        if counts["sw_stream"] != len(devices) or sum(counts.values()) != len(devices):
            fail(f"{tag} launches {counts}, not one K1 per device entry")
        if not np.array_equal(scores, k1_scores):
            fail(f"{tag} {int(np.count_nonzero(scores != k1_scores))} scores != phase 4's")
        packs = []
        for chunk in deal_chunks(order, db.lengths, len(devices), win=win):
            p = pipeline.plan_chunk(db.lengths, chunk, None, pipeline.resident_lanes(cuda0))
            packs.append((len(chunk), p.real_residues, p.nw, p.L,
                          p.padded_cells_per_query_row))
        key = f"x{len(devices)}" + (" (local_devices)" if devices == local_devices() else "")
        result["sw_stream"][key] = {
            "launches": counts["sw_stream"], "ms": kernel_s * 1e3, "ms_is": KERNEL_TIMER,
            "search_wall_s": wall,
            "shape": "; ".join(f"{n} records, {r} residues, nw={nw} L={length}, "
                               f"{cells} packed cells a row" for n, r, nw, length, cells in packs),
        }
        print(f"{tag} all {db.n} scores == phase 4's K1; launches {counts}; kernel "
              f"timer {kernel_s} s (phase 4: {k1_kernel_s} s), search wall {wall} s; per "
              f"entry (records, real residues, nw, L, packed cells a row): {packs} | {smi}",
              flush=True)

    # K3 on two entries: the 8 x 17 batch, every score phase 5's.
    scores8, queries8 = multi8
    tag = "[parallel K3 x2]"
    reset_counts(swa_cuda)
    t0 = time.perf_counter()
    got8, kernel_s = multi_device_search(pipeline.multi_profile(sc.table, queries8), db,
                                         go, ge, devices=[cuda0] * 2)
    wall = time.perf_counter() - t0
    counts = read_counts(swa_cuda)
    if counts["sw_stream_multi"] != 2 or sum(counts.values()) != 2:
        fail(f"{tag} launches {counts}, not one K3 per entry (one block each)")
    if not np.array_equal(got8, scores8):
        fail(f"{tag} scores != phase 5's K3 scores")
    result["sw_stream_multi"]["x2"] = {
        "launches": 2, "ms": kernel_s * 1e3, "ms_is": KERNEL_TIMER, "search_wall_s": wall,
        "shape": f"{len(queries8)}x17 on 2 entries of cuda:0, one block each"}
    print(f"{tag} all {len(queries8)} x {db.n} scores == phase 5's K3; launches {counts}; "
          f"kernel timer {kernel_s} s, search wall {wall} s | {smi}", flush=True)

    # A query K1 cannot hold in one pass: refused before any launch.
    reset_counts(swa_cuda)
    try:
        multi_device_search(make_profile(sc.table, random_query(2000, 2000)), db, go, ge,
                            devices=[cuda0] * 2)
        fail("[parallel] a 2000-residue query did not raise")
    except ValueError as e:
        if sum(read_counts(swa_cuda).values()):
            fail("[parallel] the 2000-residue query launched a kernel")
        print(f"[parallel] 2000-residue query: ValueError({e}), nothing launched", flush=True)

    # (b) the fixed-batch engine (K4) sharded over 4 entries, and its top-k.
    tag = f"[parallel K4 x4]"
    ids = order[SHARDED_START:SHARDED_START + SHARDED_LANES]
    lb = lattice_round_up(int(db.lengths[ids].max()))
    batch = pack_batch(db, ids, SHARDED_LANES, lb)
    engine = pipeline.get_engine("windows")
    mesh = make_mesh([cuda0] * 4)
    shards = shard_db(batch, mesh)
    run, topk = sharded_engine(engine, mesh, go, ge), sharded_topk(engine, mesh, go, ge, k=10)
    whole_dev = torch.from_numpy(batch).to(cuda0)
    for _ in range(2):  # the second round is timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole = engine(profile, whole_dev, go, ge).cpu().numpy()
        whole_ms = (time.perf_counter() - t0) * 1e3
        reset_counts(swa_cuda)
        t0 = time.perf_counter()
        got = run(profile, shards).cpu().numpy()
        sharded_ms = (time.perf_counter() - t0) * 1e3
        engine_counts = read_counts(swa_cuda)
        reset_counts(swa_cuda)
        t0 = time.perf_counter()
        vals, idx = (t.cpu().numpy() for t in topk(profile, shards))
        topk_ms = (time.perf_counter() - t0) * 1e3
        topk_counts = read_counts(swa_cuda)
    for what, counts in (("sharded_engine", engine_counts), ("sharded_topk", topk_counts)):
        if counts["sw_windows"] != 4 or sum(counts.values()) != 4:
            fail(f"{tag} {what} launches {counts}, not one K4 per shard")
    if not np.array_equal(got, whole):
        fail(f"{tag} sharded scores != one K4 call on the whole batch")
    best = np.argsort(-whole, kind="stable")[:10]
    if not (np.array_equal(idx, best) and np.array_equal(vals, whole[best])):
        fail(f"{tag} sharded top-10 != a stable descending sort of the scores")
    shape = (f"records {SHARDED_START}..{SHARDED_START + SHARDED_LANES - 1} of the sorted "
             f"database, Lb={lb}, 4 shards of {SHARDED_LANES // 4} lanes "
             f"({SHARDED_LANES // 4 // swa_cuda.FIXED_WINDOW_LANES} windows each)")
    result["sw_windows"]["x4"] = {
        "launches": 4, "ms": sharded_ms, "ms_is": "host clock around sharded_engine's "
        "call and the fetch of its scores", "sharded_topk_ms": topk_ms,
        "one_call_ms": whole_ms, "shape": shape}
    print(f"{tag} {shape}: scores == one K4 call; top-10 {best.tolist()} == stable sort; "
          f"launches 4 + 4; sharded_engine {sharded_ms} ms, sharded_topk {topk_ms} ms, "
          f"one call {whole_ms} ms (host clock, H2D of the profile included) | {smi}",
          flush=True)

    # (c) the two-host CLI on the one card against the one-process CLI.
    from seqalign_tpu_torch.utils import native_io

    sqc = fasta.parent / "swissprot.fa.sqc"
    native_io.parse_file_cached(str(fasta), str(sqc))  # built once, before the hosts
    qfa = fasta.parent / f"q{len(query)}.fa"
    base = ["--substitution_matrix", "PAM250", "--gapopen", "-2", "--gapextend", "-1",
            "--db-cache", str(sqc), "--files", str(qfa), str(fasta)]
    code, single, err = cli_run(base)
    lines = [ln for ln in single.splitlines() if not ln.startswith("Total Time:")]
    got = np.array([int(ln.split()[1]) for ln in lines if ln.startswith("score:")])
    if code != 0 or not np.array_equal(got, k1_scores):
        fail(f"[parallel cli] one-process CLI rc={code}, scores != phase 4's: {err[-2000:]}")
    walls = {}
    for extra in ([], ["--topk", "10", "--json"]):
        tag = f"[parallel cli --hosts 2 {' '.join(extra)}]".replace(" ]", "]")
        (out0, out1), walls[" ".join(extra) or "plain"] = two_hosts(base + extra)
        if "score:" in out1 or '"entries"' in out1:
            fail(f"{tag} host 1 printed results")
        if extra:
            d = json.loads(out0.splitlines()[-1])
            best = np.argsort(-k1_scores, kind="stable")[:10]
            want = [{"entry": int(k), "score": int(k1_scores[k])} for k in best]
            if d["entries"] != want or d["hosts"] != 2 or d["total_entries"] != db.n:
                fail(f"{tag} host 0's JSON != the stable top 10 of phase 4's scores")
        elif [ln for ln in out0.splitlines() if not ln.startswith("Total Time:")] != lines:
            fail(f"{tag} host 0's stdout != the one-process CLI's")
        elif f"Total Entries: {db.n}" not in out0:
            fail(f"{tag} host 0 printed no 'Total Entries: {db.n}'")
        what = ("host 0's JSON == the stable top 10 of phase 4's scores" if extra
                else f"host 0 == the one-process CLI ({db.n} entries)")
        print(f"{tag} {what}; host 1 printed no result; each host's wall "
              f"{walls[' '.join(extra) or 'plain']} s | {smi}", flush=True)
    result["cli_two_hosts_wall_s"] = walls
    sqc.unlink()
    return result


def two_hosts(args):
    """``python -m seqalign_tpu_torch.cli ARGS --hosts 2 --host-id {0,1}``
    on the card, both at once, coordinated on a free local port (a port
    taken before it was bound is retried once); both killed on a timeout
    or a failure. Returns (the hosts' stdouts, each host's wall seconds)."""
    import socket

    env = dict(os.environ, SEQALIGN_PLATFORM="cuda")
    for attempt in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "seqalign_tpu_torch.cli", *args, "--hosts", "2",
             "--host-id", str(pid), "--coordinator", f"127.0.0.1:{port}"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for pid in range(2)]
        results, walls = [], []
        try:
            for p in procs:
                out, err = p.communicate(timeout=HOST_TIMEOUT_S)
                results.append((p.returncode, out, err))
                walls.append(time.perf_counter() - t0)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        errs = "\n".join(err[-2000:] for _, _, err in results)
        if all(rc == 0 for rc, _, _ in results):
            return [out for _, out, _ in results], walls
        if attempt == 0 and "address already in use" in errs.lower():
            continue
        fail(f"[parallel cli] a host failed: {errs}")


def longpair_layout(mesh, lq, length, jb, stripe_rows):
    """As sw_longpair lays the run out: per data slice, each entry's
    sub-passes as (rows, whether it writes a boundary out); the blocks;
    the steps (stages + blocks - 1); and the launches of K2's block
    instance, per entry and step one for each run of its sub-passes at work
    that share an instance. For the launch count and the bound."""
    from seqalign_tpu_torch.convert import ROW_ALIGN
    from seqalign_tpu_torch.ops.swa_cuda import STREAM_JB, block_kernel_instance

    def rows_of(n):
        return -(-n // ROW_ALIGN) * ROW_ALIGN

    grid = mesh if isinstance(mesh[0], list) else [mesh]
    rows = rows_of(-(-lq // len(grid[0])))
    entries = [min(rows, lq - s) for s in range(0, lq, rows)]
    subs = []
    for k, n in enumerate(entries):
        cuts = [rows_of(min(stripe_rows, n - s)) for s in range(0, n, stripe_rows)]
        subs.append([(r, k < len(entries) - 1 or p < len(cuts) - 1)
                     for p, r in enumerate(cuts)])
    blk = -(-jb // STREAM_JB) * STREAM_JB
    n_blocks = -(-length // blk)
    n_steps = sum(map(len, subs)) + n_blocks - 1
    launches, first = 0, 0
    for entry in subs:
        for t in range(n_steps):
            keys = [block_kernel_instance(r, out) for p, (r, out) in enumerate(entry)
                    if 0 <= t - first - p < n_blocks]
            launches += sum(i == 0 or keys[i] != keys[i - 1] for i in range(len(keys)))
        first += len(entry)
    return [subs] * len(grid), n_blocks, n_steps, launches * len(grid)


def cta_lanes(rows_per_thread: int) -> int:
    """Lanes (warps) of a CTA of K2's instances at R = ``rows_per_thread``
    (``team_warps<R>`` in csrc/sw_striped.cu)."""
    return 16 if rows_per_thread >= 24 else 8


def longpair_live_cells(subs, lengths, win, length, jb) -> int:
    """The padded cells of sw_longpair's tasks that lie in (CTA, block)
    pairs where some lane of the CTA still has a residue at or after the
    block's start (lanes sorted by length, data slices contiguous): what
    the block kernel would run if it skipped a CTA whose lanes' records
    ended before the block."""
    from seqalign_tpu_torch.ops.swa_cuda import STREAM_JB, stripe_rows_per_thread

    blk = -(-jb // STREAM_JB) * STREAM_JB
    starts = np.arange(0, length, blk)
    widths = np.minimum(starts + blk, length) - starts
    live = 0
    for d, sl in enumerate(subs):
        lens = np.zeros(win, dtype=np.int64)
        part = lengths[d * win:(d + 1) * win]
        lens[:part.size] = part
        for r, _ in (sp for entry in sl for sp in entry):
            warps = cta_lanes(stripe_rows_per_thread(r))
            cta_max = np.pad(lens, (0, -win % warps)).reshape(-1, warps).max(axis=1)
            live += r * warps * int(((cta_max[None, :] > starts[:, None]).sum(axis=1)
                                     * widths).sum())
    return live


# Phase 13's gate on the lanes' ends: the x1, jb=128 run with them must
# take at most this share of the same run through tables without them.
SKIP_SHARE_MAX = 0.8


def phase_longpair(torch, smi: str, db, loops, factor):
    """Phase 13: sw_longpair on the one card (swissprot.LONGPAIR_RUNS)
    against the long-query search (K2) of the same records; K2's block
    instance alone, its launches (by steps), a CUDA-event timer, the
    device-memory peak, the bound over the records' real cells (and over
    the padded batch's), and the cells a CTA-level skip would leave, a
    model from the lengths. Then the first run (x1, jb=128) again through
    tables without the lanes' ends (every cell, as a query with a positive
    '*' score runs): the same scores, and the run with ends at most
    SKIP_SHARE_MAX of its time, measured in turns; the same records
    shuffled, as sw_longpair sorts them and in the order given (timed, not
    gated); and the device's busy share of the run with ends under
    torch.profiler."""
    from seqalign_tpu_torch import pipeline
    from seqalign_tpu_torch.ops import swa_cuda
    from seqalign_tpu_torch.parallel import longpair, sw_longpair
    from seqalign_tpu_torch.swissprot import (
        LONGPAIR_LQ, LONGPAIR_RUNS, device_busy, longpair_case, longpair_mesh,
    )

    tag = f"[longpair lq={LONGPAIR_LQ}]"
    query, profile, sc, sub, batch = longpair_case(db)
    go, ge = sc.gap_open_total, sc.gap_extend
    lengths = sub.lengths
    residues = int(lengths.sum())
    print(f"{tag} {sub.n} records of {int(lengths.min())}-{int(lengths.max())} residues, "
          f"{residues} residues, one ({batch.shape[0]}, {batch.shape[1]}) lane batch", flush=True)

    # The reference: the long-query search (K2 passes) of the same records.
    reset_counts(swa_cuda)
    t0 = time.perf_counter()
    want, k2_s = pipeline.search_database(query, sub, sc, device="cuda")
    k2_wall = time.perf_counter() - t0
    k2_counts = read_counts(swa_cuda)
    if not k2_counts["sw_stream_striped_pass"] or k2_counts["sw_stream_striped_step"]:
        fail(f"{tag} the K2 search launched {k2_counts}")
    print(f"{tag} K2 search: {k2_counts['sw_stream_striped_pass']} passes, kernel timer "
          f"{k2_s} s, wall {k2_wall} s | {smi}", flush=True)

    cuda0 = torch.device("cuda", 0)
    length = windows_length(batch)
    if not longpair.skips(profile):
        fail(f"{tag} the query has a positive '*' score: its lanes would not stop")

    def timed(mesh, axes, name, jb, expect, n=2, lanes=batch, want=want):
        """n runs of sw_longpair on ``lanes``, each checked (launches, the
        scores ``want``): the kernel timers, and the last run's wall and
        device-memory peak."""
        timers = []
        for _ in range(n):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(swa_cuda)
            events = []
            t0 = time.perf_counter()
            got = sw_longpair(profile, lanes, go, ge, mesh, jb=jb, events=events, **axes)
            got = got.cpu().numpy()
            wall = time.perf_counter() - t0
            counts = read_counts(swa_cuda)
            start, end = events[0]
            timers.append(start.elapsed_time(end))
            peak = torch.cuda.max_memory_allocated() - base
            if counts["sw_stream_striped_step"] != expect or sum(counts.values()) != expect:
                fail(f"{tag} {name}: launches {counts}, not {expect} of K2's block "
                     "instance alone")
            if got.shape != (sub.n,) or got.dtype != np.int32 or not np.array_equal(got, want):
                fail(f"{tag} {name}: {int(np.count_nonzero(got != want))} scores != the K2 "
                     "search's")
        return timers, wall, peak, counts

    runs = []
    for entries, data, jb in LONGPAIR_RUNS:
        mesh, axes, name = longpair_mesh(cuda0, entries, data)
        name += f" jb={jb}"
        subs, n_blocks, n_steps, expect = longpair_layout(mesh, LONGPAIR_LQ, length, jb,
                                                          swa_cuda.STRIPE_ROWS)
        # The second run is the one kept.
        timers, wall, peak, counts = timed(mesh, axes, name, jb, expect)
        win = batch.shape[1] // len(subs)  # lanes of a data slice
        flat = [sp for sl in subs for entry in sl for sp in entry]
        # The cells the answer needs: every query row against each record's
        # real residues; the kernel also runs the padded batch's.
        cells = LONGPAIR_LQ * residues
        padded_cells = sum(r for r, _ in flat) * win * length
        model_live = longpair_live_cells(subs, lengths, win, length, jb)
        keys = [swa_cuda.block_kernel_instance(r, out) for r, out in flat]
        if not set(keys) <= set(loops):
            fail(f"{tag} no SASS loop for the block instances {sorted(set(keys))}")
        rows = [r for r, _ in flat]
        ops = [n * loops[key]["pipe_per_cell"] for n, key in zip(rows, keys)]
        # The batch and profile read once, the scores written once.
        io_bytes = batch.size + profile.size * 4 + batch.shape[1] * 4
        bound_ms, bound_by = bound(io_bytes, cells, sum(ops) / sum(rows))
        padded_ms, _ = bound(io_bytes, padded_cells, sum(ops) / sum(rows))
        row = {"mesh": name, "launches": counts["sw_stream_striped_step"],
               "ms": timers[-1], "ms_first_run": timers[0], "search_wall_s": wall,
               "memory_peak_bytes": peak, "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_ms_padded": padded_ms, "model_live_cells": model_live,
               "factor": sum(o * factor[key] for o, key in zip(ops, keys)) / sum(ops),
               "cells": cells, "padded_cells": padded_cells, "blocks": n_blocks,
               "steps": n_steps,
               "sub_passes": [sum(map(len, sl)) for sl in subs],
               "instances": sorted(set(keys))}
        runs.append(row)
        print(f"{tag} {name}: all {sub.n} scores == the K2 search's; {row['launches']} "
              f"launches of the block instance ({n_steps} steps of {n_blocks} blocks x "
              f"{row['sub_passes']} sub-passes, instances {row['instances']}), nothing else; "
              f"kernel timer (CUDA events, first launch to merged result) {timers} ms, call "
              f"+ fetch wall {wall} s; K2 search's kernel timer {k2_s * 1e3} ms; "
              f"device-memory peak {peak} B; bound {bound_ms} ms by {bound_by} over the "
              f"{cells} real cells ({bound_ms / timers[-1]:.0%}), {padded_ms} ms over the "
              f"{padded_cells} padded cells of the batch; modelled from the lengths (the "
              f"kernel counts none), {model_live} of those lie in CTA-blocks where a lane's "
              f"record reaches the block ({model_live / padded_cells:.1%}) | {smi}",
              flush=True)

    # The first run (x1, jb=128) through tables without ends, in turns with
    # the run with them: with, without, without, with.
    entries, data, jb = LONGPAIR_RUNS[0]
    mesh, axes, name = longpair_mesh(cuda0, entries, data)
    name += f" jb={jb}"
    expect = runs[0]["launches"]
    skips = longpair.skips
    longpair.skips = lambda prof: False
    try:
        every_cell, _, _, _ = timed(mesh, axes, name + " without ends", jb, expect)
    finally:
        longpair.skips = skips
    again, _, _, _ = timed(mesh, axes, name, jb, expect, n=1)
    with_ends = [runs[0]["ms"], again[0]]
    share = max(with_ends) / min(every_cell)
    print(f"{tag} {name} in turns, kernel timer with the lanes' ends {with_ends} ms, through "
          f"tables without ends (every cell) {every_cell} ms: {share:.3f} of it, the slower "
          f"with ends over the faster without (at most {SKIP_SHARE_MAX}) | {smi}", flush=True)
    if share > SKIP_SHARE_MAX:
        fail(f"{tag} {name}: with the lanes' ends {with_ends} ms, over {SKIP_SHARE_MAX} of "
             f"the {every_cell} ms through tables without them")
    runs[0].update(ms_with_ends_in_turns=with_ends, ms_every_cell=every_cell,
                   skip_share=share)
    # The same records in a shuffled order: as sw_longpair scores them (each
    # shard longest first), and in the order given, as without that sort.
    perm = np.random.default_rng(13).permutation(sub.n)
    shuffled = {}
    order = longpair.lane_order
    for how in ("sorted by sw_longpair", "scored as given"):
        if how == "scored as given":
            longpair.lane_order = lambda ends, data_count: np.arange(ends.size)
        try:
            shuffled[how], _, _, _ = timed(mesh, axes, f"{name} shuffled, {how}", jb, expect,
                                           lanes=batch[:, perm], want=want[perm])
        finally:
            longpair.lane_order = order
    print(f"{tag} {name} on the records shuffled, kernel timer {shuffled['sorted by sw_longpair']}"
          f" ms as sw_longpair sorts them, {shuffled['scored as given']} ms scored in the "
          f"shuffled order; the batch given longest first {runs[0]['ms']} ms; scores == the "
          f"K2 search's | {smi}", flush=True)
    runs[0].update(ms_shuffled=shuffled["sorted by sw_longpair"],
                   ms_shuffled_unsorted=shuffled["scored as given"])
    wall, busy_ms, top = device_busy(
        lambda: sw_longpair(profile, batch, go, ge, mesh, jb=jb, **axes).cpu())
    runs[0]["profile"] = {"wall_s": wall, "device_ms": busy_ms,
                          "busy_share": busy_ms / 1e3 / wall, "top_ms": top}
    print(f"{tag} {name} under torch.profiler: device busy {busy_ms} ms in a {wall} s call "
          f"(plan, windows, H2D, launches, fetch), busy share {busy_ms / 1e3 / wall}; {top} "
          f"| {smi}", flush=True)
    return {"runs": runs, "k2_search_kernel_s": k2_s, "k2_search_wall_s": k2_wall,
            "k2_passes": k2_counts["sw_stream_striped_pass"], "lq": LONGPAIR_LQ,
            "records": sub.n,
            "residues": residues, "batch": list(batch.shape)}


def windows_length(batch) -> int:
    """The batch's length padded with '*' to STREAM_JB (convert.batch_windows)."""
    from seqalign_tpu_torch.ops.swa_cuda import STREAM_JB

    return -(-batch.shape[0] // STREAM_JB) * STREAM_JB


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None,
                    help="another checkout whose K1, K2 and K3 to time in turns")
    ap.add_argument("--phases", default=None,
                    help="run phases 1-2 and only these of 3, 4, 6 and 13 (comma-separated)")
    args = ap.parse_args(argv)
    only = None if args.phases is None else {int(x) for x in args.phases.split(",")}
    if only is not None and (not only or not only <= {3, 4, 6, 13} or args.against):
        ap.error("--phases takes some of 3, 4, 6 and 13, without --against")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on a GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    name, smi = phase_device(torch)
    loops, usage, factor = phase_build()
    chk = Checker(torch)
    if only is None or 3 in only:
        phase_kernel(chk)
        phase_kernel_multi(chk)
        phase_kernel_striped(chk)
        phase_kernel_windows(chk)

    from seqalign_tpu_torch.swissprot import swissprot_db

    t0 = time.perf_counter()
    query, db = swissprot_db()
    print(f"[main] database: {db.n} records, {int(db.offsets[-1])} residues, "
          f"generated in {time.perf_counter() - t0} s", flush=True)
    if only is not None:
        ran = {"max_abs_err": chk.max_abs_err}
        if 4 in only:
            ran["main_path"] = phase_main_path(torch, chk, smi, query, db, loops, usage)[0]
        if 6 in only:
            ran["long_path"] = phase_striped_path(torch, chk, smi, db, loops, usage, factor)
            ran["long_path"].pop("scores")
            ran["step"] = phase_step(torch, chk, smi)
        if 13 in only:
            ran["longpair"] = phase_longpair(torch, smi, db, loops, factor)
        print(f"[main] phases 1, 2 and {sorted(only)} in {time.perf_counter() - t_start} s",
              flush=True)
        print(json.dumps(ran, default=str))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
        }}))
        return 0
    main_path, k1_pack, k1_scores = phase_main_path(torch, chk, smi, query, db, loops,
                                                    usage)
    multi8 = phase_multi_path(torch, chk, smi, db, k1_pack, 8, 17, 100, True, loops, usage)
    multi64 = phase_multi_path(torch, chk, smi, db, k1_pack, 64, 144, 200, False, loops,
                               usage)
    long_path = phase_striped_path(torch, chk, smi, db, loops, usage, factor)
    step = phase_step(torch, chk, smi)
    del k1_pack
    from seqalign_tpu_torch.swissprot import random_query

    batch8 = (multi8.pop("scores"), [random_query(17, 100 + k) for k in range(8)])
    fixed = phase_fixed_path(
        torch, chk, smi, query, db, loops, usage, factor, (k1_scores, main_path["ms"]),
        batch8)
    phase_cli()
    fasta, ingest = phase_ingest(smi, db)
    long_query, long_scores = random_query(2000, 2000), long_path.pop("scores")
    streaming = phase_streaming(torch, smi, db, fasta, query, k1_scores,
                                long_query, long_scores)
    align = phase_align_trace(smi, db, fasta, query, k1_scores, long_query, long_scores)
    t0 = time.perf_counter()
    tb_fill = phase_tb_fill(torch, smi, db, fasta.parent, query, long_query, align, loops,
                            usage, factor)
    print(f"[tb_fill] in {time.perf_counter() - t0} s", flush=True)
    t0 = time.perf_counter()
    parallel = phase_parallel(torch, smi, db, query, k1_scores,
                              main_path["main_path_kernel_s"], batch8, fasta)
    print(f"[parallel] phase 12 in {time.perf_counter() - t0} s", flush=True)
    t0 = time.perf_counter()
    longpair = phase_longpair(torch, smi, db, loops, factor)
    print(f"[longpair] phase 13 in {time.perf_counter() - t0} s", flush=True)
    print(f"[main] every phase in {time.perf_counter() - t_start} s", flush=True)
    turns = None
    if args.against:
        from seqalign_tpu_torch import turns as turns_mod

        turns = turns_mod.run(Path(args.against).resolve(), 3,
                              lambda msg: print(msg, flush=True))["cells"]
    kernels = [{
        "name": "sw_stream",
        "route": "cuda",
        "source": "seqalign_tpu_torch/csrc/sw_stream.cuh",
        "replaces": "seqalign_tpu/ops/swa_pallas.py:559",
        "launches": main_path["launches"],
        "max_abs_err": chk.max_abs_err["sw_stream"],
        "ms": main_path["ms"],
        "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"],
        "library_ms": None,
        "instance": main_path["instance"],
        "registers": main_path["registers"],
        "shape": main_path["shape"],
        "main_path_kernel_s": main_path["main_path_kernel_s"],
        "main_path_gcups": main_path["main_path_gcups"],
        "search_wall_s": main_path["search_wall_s"],
        "busy_share": main_path["busy_share"],
        # The short-query point: K1 at lq=17, once for each of phase 5's 8
        # queries, the launches counted in the timed pass.
        "short_query": {"lq": 17, "launches": multi8["k1_launches"],
                        "ms": multi8["k1_loop_ms"],
                        "bound_ms": multi8["k1_bound_ms"], "instance": multi8["k1_instance"],
                        "registers": multi8["k1_registers"]},
        "card": smi,
    }, {
        "name": "sw_stream_multi",
        "route": "cuda",
        "source": "seqalign_tpu_torch/csrc/sw_stream.cuh",
        "replaces": "seqalign_tpu/ops/swa_pallas.py:934",
        "launches": multi8["launches"],
        "max_abs_err": chk.max_abs_err["sw_stream_multi"],
        "ms": multi8["ms"],
        "plain_ms": multi8["plain_ms"],
        "bound_ms": multi8["bound_ms"],
        "bound_by": multi8["bound_by"],
        "library_ms": None,
        "k1_loop_ms": multi8["k1_loop_ms"],
        "instance": multi8["instance"],
        "queries_per_thread": multi8["queries_per_thread"],
        "pipe_per_cell": multi8["pipe_per_cell"],
        "registers": multi8["registers"],
        "memory_peak_bytes": multi8["memory_peak_bytes"],
        "shape": multi8["shape"],
        "main_path_kernel_s": multi8["main_path_kernel_s"],
        "main_path_gcups": multi8["main_path_gcups"],
        "north_star": {k: multi64[k] for k in
                       ("launches", "ms", "bound_ms", "bound_by", "k1_loop_ms",
                        "instance", "queries_per_thread", "registers",
                        "memory_peak_bytes", "shape", "reorder_fetch_s",
                        "host_scatter_s", "search_wall_s",
                        "main_path_kernel_s", "main_path_gcups")},
        "card": smi,
    }, {
        "name": "sw_stream_striped",
        "route": "cuda",
        "source": "seqalign_tpu_torch/csrc/sw_striped.cu",
        "replaces": "seqalign_tpu/ops/swa_pallas.py:1067",
        "launches": long_path["launches"],
        "max_abs_err": chk.max_abs_err["sw_stream_striped"],
        "ms": long_path["ms"],
        "plain_ms": long_path["plain_ms"],
        "bound_ms": long_path["bound_ms"],
        "bound_by": long_path["bound_by"],
        "library_ms": None,
        **{k: long_path[k] for k in ("pass_ms", "rows_per_thread", "registers",
                                      "memory_peak_bytes", "k1_beside_k2")},
        "shape": long_path["shape"],
        "main_path_kernel_s": long_path["main_path_kernel_s"],
        "main_path_gcups": long_path["main_path_gcups"],
        "card": smi,
    }, {
        "name": "sw_stream_striped_block",
        "wrapper": "sw_stream_striped_step (a step of tasks a launch)",
        "route": "cuda",
        "source": "seqalign_tpu_torch/csrc/sw_striped.cu",
        "replaces": "seqalign_tpu/parallel/longpair.py:139",
        "launches": longpair["runs"][0]["launches"],
        "max_abs_err": chk.max_abs_err["sw_stream_striped_block"],
        "ms": longpair["runs"][0]["ms"],
        "plain_ms": step["block_plain_ms"],
        "plain_ms_is": f"the plain version on one block ({step['block']}), beside block_ms; "
                       "the whole run's plain version is not run",
        "block_ms": step["block_ms"],
        "step_ms": step["step_ms"],
        "step_plain_ms": step["plain_ms"],
        "step": step,
        "bound_ms": longpair["runs"][0]["bound_ms"],
        "bound_by": longpair["runs"][0]["bound_by"],
        "bound_is": "over the records' real cells (lq x residues); bound_ms_padded in "
                    "longpair's runs is over the padded batch the kernel runs",
        "library_ms": None,
        "ms_is": "sw_longpair's kernel timer over [cuda:0] x 1, jb=128 (CUDA events, "
                 "first launch to merged result), each lane stopping at its end",
        # The model's cells stay in phase 13's print: the kernel counts none.
        "longpair": {**longpair, "runs": [{k: v for k, v in r.items()
                                            if not k.startswith("model_")}
                                           for r in longpair["runs"]]},
        "shape": f"sw_longpair, lq={longpair['lq']}, the {longpair['records']} longest "
                 f"records ({longpair['residues']} residues) as one {longpair['batch']} "
                 "lane batch",
        "card": smi,
    }, {
        "name": "stream_pack",
        "wrapper": "ops/pack_cuda.pack_streams_device",
        "route": "cuda",
        "source": "seqalign_tpu_torch/csrc/stream_pack.cu",
        "replaces": "seqalign_tpu/utils/packing.py:106 (host code, no pallas_call; its "
                    "fill native/fastio.cc:529)",
        "launches": main_path["pack"]["launches"],
        "max_abs_err": chk.max_abs_err["stream_pack"],
        **{k: v for k, v in main_path["pack"].items() if k != "launches"},
        "ms_is": "the launch alone, CUDA events; wrapper_ms adds its one copy of the "
                 "plan's ids, runs and fs",
        "library_is": "torch.take of the residues with one PAD_INDEX byte in front, over "
                      "an int64 index built before the clock (8 B a stream byte)",
        "card": smi,
    }, {
        "name": "tb_fill",
        "wrapper": "ops/traceback_cuda.run (topk_alignments on a CUDA device)",
        "route": "cuda",
        "source": "seqalign_tpu_torch/csrc/tb_fill.cu",
        "replaces": "none: host code, native/traceback.cc sw_tb_ends and sw_tb_fill "
                    "(seqalign_tpu/ops/traceback.py _score_ends, _direct_traceback)",
        # Phase 11's --align run of the 2000-residue query, the counter
        # zeroed just before it.
        "launches": align[len(long_query)]["tb_launches"],
        "launches_lq144": align[len(query)]["tb_launches"],
        "max_abs_err": tb_fill["max_abs_err"],
        "ms": tb_fill["fill"]["ms"],
        "plain_ms": tb_fill["fill"]["plain_ms"],
        "bound_ms": tb_fill["fill"]["bound_ms"],
        "bound_by": tb_fill["fill"]["bound_by"],
        "bound_ms_one_sm": tb_fill["fill"]["bound_ms_one_sm"],
        "library_ms": None,
        "ms_is": "the state-writing instance on the lq=5,478 self-hit, torch.profiler in "
                 "the kernel timer's process; ends is the ends-only instance",
        "plain_is": "native sw_tb_fill (sw_tb_ends) on one host thread, the same pass",
        "bound_is": "bound_ms at the whole card's int32 rate; bound_ms_one_sm at one "
                    "SM's, the design's (a CTA a pair)",
        "instance": tb_fill["fill"]["instance"],
        "registers": tb_fill["fill"]["registers"],
        "ends": tb_fill["ends"],
        "timer": tb_fill["timer"],
        "search": tb_fill["rounds"],
        "shape": f"the lq={TB_SELF} self-hit, {tb_fill['self_cells']} cells, BLOSUM62 11/1",
        "card": smi,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "seqalign_tpu_torch/csrc/sw_windows.cuh",
        "replaces": replaces,
        "max_abs_err": chk.max_abs_err[name],
        "library_ms": None,
        **fixed[name],
    } for name, replaces in (
        ("sw_windows", "seqalign_tpu/ops/swa_pallas.py:526"),
        ("sw_windows_const_s", "seqalign_tpu/ops/swa_pallas.py:360"),
    )]
    # The bound at the issue rates measured on this card, beside the data
    # sheet's (bound_ms, which the ranking of kernels keeps).
    kfactor = {n: fixed[n]["factor"] for n in ("sw_windows", "sw_windows_const_s")}
    kfactor["sw_stream"] = factor[main_path["instance"]]
    kfactor["sw_stream_multi"] = factor[multi8["instance"]]
    kfactor["sw_stream_striped"] = long_path["factor"]
    kfactor["sw_stream_striped_block"] = longpair["runs"][0]["factor"]
    kfactor["stream_pack"] = 1.0
    kfactor["tb_fill"] = tb_fill["fill"]["factor"]
    for k in kernels:
        k["bound_ms_measured_rates"] = k["bound_ms"] * (
            kfactor[k["name"]] if k["bound_by"] == "operations" else 1.0)
    # Phase 12's launches, shapes and times on the parallel paths.
    for k in kernels:
        if k["name"] in parallel:
            k["parallel"] = parallel[k["name"]]
    if turns is not None:
        kernels[0]["in_turns"] = {c: v for c, v in turns.items() if c.startswith("K1")}
        kernels[1]["in_turns"] = {c: v for c, v in turns.items() if c.startswith("K3")}
        kernels[2]["in_turns"] = {c: v for c, v in turns.items() if c.startswith("K2")}
        pack_kernel = next(k for k in kernels if k["name"] == "stream_pack")
        pack_kernel["in_turns"] = {c: v for c, v in turns.items() if c.startswith("P ")}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
