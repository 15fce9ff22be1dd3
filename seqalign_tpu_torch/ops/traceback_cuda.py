"""The alignment step's dynamic-programming passes on the card: the
forward and windowed reverse ends passes and the traceback-state fill of
``ops.traceback``'s top-k hits, a pass of every pair in one launch of
``csrc/tb_fill.cu`` (``tb_fill_kernel``, a CTA a pair).

A pass is what the native library's ``sw_tb_ends`` or ``sw_tb_fill`` takes:
``q`` along i, ``d`` along j, the table or (``flip``) its transpose; the
kernel gives the same best score and end cell, and the same state bytes.
:func:`plan` lays one launch's inputs and outputs out in one workspace
(host code, so the CPU tests reach it); :func:`run` allocates the
workspace on the card, uploads the inputs, launches, and downloads the
bests and the states in one copy into page-locked memory. The states come
back as views of that memory, row ``j`` of a pair at ``j * pitch`` (16 + lq
rounded up to 16, so that each thread's 16 bytes of a row lie on 16
bytes), column ``i`` at byte ``15 + i``; the native fill's rows are ``lq +
1`` apart, its bytes at ``[j, i]`` the same.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np

# csrc/tb_fill.cu: rows a thread (kRows), warps a CTA at most (kMaxWarps).
ROWS = 16
MAX_WARPS = 16
STRIPE = 32 * ROWS  # rows of q a warp takes at once
# The kernel's TbPair: nine int64.
PAIR_FIELDS = ("q", "d", "states", "bnd", "flags", "lq", "lb", "pitch", "flip")
# A launch's states at most; a pass over more splits into more launches
# (a single pair above it takes one of its own).
MAX_STATES_BYTES = 1 << 30
# The page-locked buffers kept between calls, at most.
PINNED_CAP = 256 << 20
# The keys hold 32 x H + 31 in int32: a pair whose best could reach
# 2^26 stays on the host.
SCORE_LIMIT = 1 << 26


@dataclass
class Pass:
    """One pass of a pair as ``sw_tb_ends`` / ``sw_tb_fill`` take it."""

    states: bool  # sw_tb_fill (True) or sw_tb_ends
    q: np.ndarray  # along i, lq
    d: np.ndarray  # along j, lb
    flip: bool  # scored by the table's transpose


def _up(n: int, a: int = 16) -> int:
    return -(-n // a) * a


def fits(p: Pass, table: np.ndarray, go: int, ge: int) -> bool:
    """True if the kernel computes ``p`` exactly: the table in int8, gaps
    that cost (ge <= 0, go <= 0: F as a key equals the native prefix carry),
    both sequences non-empty, and no score the keys cannot hold."""
    lq, lb = len(p.q), len(p.d)
    t = np.asarray(table)
    return (
        min(lq, lb) > 0
        and int(np.abs(t).max(initial=0)) <= 127
        and -(1 << 24) < go <= 0
        and -(1 << 24) < ge <= 0
        and min(lq, lb) * max(int(t.max(initial=0)), 0) < SCORE_LIMIT
    )


@dataclass
class Launch:
    """One launch's workspace: ``head`` (the pairs, the two tables, the
    sequences) is uploaded to ``[0, len(head))``; the flags ``[flags_off,
    +flags_bytes)`` are zeroed; the download is ``[out_off, total)``: the
    int32 bests ``(n, 3)``, then the states at ``states_off``."""

    passes: list
    states: bool
    head: np.ndarray  # uint8
    tables_off: int
    flags_off: int
    flags_bytes: int
    out_off: int
    total: int
    warps: int
    states_off: list  # per pair, from out_off (states only)
    pitch: list

    def views(self, down: np.ndarray):
        """``(best, (j, i))``, with states ``(states, best, (j, i))``, of each
        pair from the downloaded ``down`` (``total - out_off`` bytes)."""
        n = len(self.passes)
        bests = down[: 12 * n].view(np.int32).reshape(n, 3)
        out = []
        for k, p in enumerate(self.passes):
            found = (int(bests[k, 0]), (int(bests[k, 1]), int(bests[k, 2])))
            if not self.states:
                out.append(found)
                continue
            lq, lb = len(p.q), len(p.d)
            st = np.lib.stride_tricks.as_strided(
                down[self.states_off[k] + 15:], shape=(lb + 1, lq + 1),
                strides=(self.pitch[k], 1), writeable=False)
            out.append((st, *found))
        return out


def plan(passes: list, table: np.ndarray, states: bool) -> Launch:
    """The workspace of one launch over ``passes`` (each ``fits``)."""
    n = len(passes)
    off = _up(8 * len(PAIR_FIELDS) * n)
    tables_off = off
    off += 2 * 32 * 32
    rows = np.zeros((n, len(PAIR_FIELDS)), np.int64)
    seq_at = []
    for k, p in enumerate(passes):
        lq, lb = len(p.q), len(p.d)
        seq_at.append((off, _up(off + lq)))
        rows[k, 0], rows[k, 1], rows[k, 5], rows[k, 6] = off, _up(off + lq), lq, lb
        rows[k, 8] = int(p.flip)
        off = _up(_up(off + lq) + lb)
    head_bytes = off
    flags_off = off
    for k, p in enumerate(passes):
        rows[k, 4] = off
        off += 4 * -(-len(p.q) // STRIPE)
    flags_bytes = off - flags_off
    off = _up(off)
    for k, p in enumerate(passes):
        rows[k, 3] = off
        off = _up(off + 12 * len(p.d) * (-(-len(p.q) // STRIPE) - 1))
    out_off = off
    off = _up(off + 12 * n)
    states_off, pitch = [], []
    if states:
        for k, p in enumerate(passes):
            lq, lb = len(p.q), len(p.d)
            rows[k, 2], rows[k, 7] = off, 16 + _up(lq)
            states_off.append(off - out_off)
            pitch.append(16 + _up(lq))
            off += (lb + 1) * (16 + _up(lq))
    head = np.zeros(head_bytes, np.uint8)
    head[: rows.nbytes] = rows.view(np.uint8).ravel()
    t = np.asarray(table, np.int8)
    head[tables_off: tables_off + 2048] = np.concatenate(
        [t.ravel(), np.ascontiguousarray(t.T).ravel()]).view(np.uint8)
    for p, (qa, da) in zip(passes, seq_at):
        head[qa: qa + len(p.q)] = np.asarray(p.q).astype(np.uint8)
        head[da: da + len(p.d)] = np.asarray(p.d).astype(np.uint8)
    warps = min(MAX_WARPS, max(-(-len(p.q) // STRIPE) for p in passes))
    return Launch(passes, states, head, tables_off, flags_off, flags_bytes, out_off, off,
                  warps, states_off, pitch)


def batches(passes: list, states: bool) -> list:
    """``passes`` in groups of at most ``MAX_STATES_BYTES`` of states each
    (one group for ends), in their order."""
    if not states:
        return [passes] if passes else []
    out, size = [], 0
    for p in passes:
        b = (len(p.d) + 1) * (16 + _up(len(p.q)))
        if not out or size + b > MAX_STATES_BYTES:
            out.append([])
            size = 0
        out[-1].append(p)
        size += b
    return out


_pinned: dict = {}


def _pinned_buffer(which: str, nbytes: int):
    """A page-locked uint8 tensor of at least ``nbytes``, kept for the next
    call up to ``PINNED_CAP``."""
    import torch

    buf = _pinned.get(which)
    if buf is not None and buf.numel() >= nbytes:
        return buf
    buf = torch.empty(max(nbytes, 1 << 20), dtype=torch.uint8, pin_memory=True)
    if buf.numel() <= PINNED_CAP:
        _pinned[which] = buf
    return buf


def prepare(launch: Launch, device):
    """What :func:`run` needs of torch, made before it (so that the step's
    span holds no torch op): the workspace on ``device`` and the
    page-locked upload and download buffers, the upload filled."""
    import torch

    ws = torch.empty(launch.total, dtype=torch.uint8, device=device)
    up = _pinned_buffer("up", len(launch.head))
    up.numpy()[: len(launch.head)] = launch.head
    down = _pinned_buffer("down", launch.total - launch.out_off)
    return ws, up, down


def run(launch: Launch, prepared, go: int, ge: int):
    """Upload, launch, download and wait, on the workspace's device and its
    current stream; each pair's result as :meth:`Launch.views` gives it,
    over the download buffer (valid until the next call)."""
    import torch

    from . import _build

    ws, up, down = prepared
    dev = ws.device
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.tb_fill_launch(
            ws.data_ptr(), up.data_ptr(), len(launch.head), launch.tables_off,
            launch.flags_off, launch.flags_bytes, launch.out_off, down.data_ptr(),
            launch.total - launch.out_off, len(launch.passes), launch.warps,
            int(launch.states), int(go), int(ge), stream)
        if not err:
            err = lib.tb_fill_sync(stream)
    if err:
        raise RuntimeError(
            f"tb_fill launch failed: CUDA error {err} ({_build.error_string(err)})")
    run.launches += 1
    return launch.views(down.numpy()[: launch.total - launch.out_off])


run.launches = 0


def main(argv=None) -> int:
    """Time the passes on the card under BLOSUM62 11/1: the longest query of
    the CUDASW++ set (5,478 residues) against itself, and with nine random
    records of Swiss-Prot's length distribution beside it in the launch; each
    pass (ends, then fill) five times after a warm-up, under
    ``torch.profiler``: the kernel's and the copies' device times and the
    host's wall of :func:`run`. Prints one JSON line.

        python -m seqalign_tpu_torch.ops.traceback_cuda [--out FILE]
    """
    import argparse
    import json
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..host import ScoringModel, load_builtin
    from ..swissprot import random_query

    ap = argparse.ArgumentParser(description=main.__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sc = load_builtin("BLOSUM62", ScoringModel(gap_open=-11, gap_extend=-1,
                                                use_match_mismatch=False))
    go, ge = sc.gap_open + sc.gap_extend, sc.gap_extend
    dev = torch.device("cuda")
    q = random_query(5478, 5478)
    rng = np.random.default_rng(5478)
    others = [random_query(int(n), 9000 + k) for k, n in
              enumerate(np.clip(rng.gamma(1.8, 202, 9), 2, 35000))]
    out = {"device": torch.cuda.get_device_name(0), "lq": len(q),
           "others": [len(o) for o in others]}
    for name, group in (("self", [(q, q)]), ("self+9", [(q, q)] + [(q, o) for o in others])):
        for states in (False, True):
            passes = [Pass(states, a, b, False) for a, b in group]
            launch = plan(passes, sc.table, states)
            run(launch, prepare(launch, dev), go, ge)  # warm-up
            walls = []
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    prepared = prepare(launch, dev)
                    t0 = time.perf_counter()
                    run(launch, prepared, go, ge)
                    walls.append(1e3 * (time.perf_counter() - t0))
            dev_ms: dict = {}
            for ev in prof.profiler.kineto_results.events():
                if (ev.device_type() == torch.autograd.DeviceType.CUDA
                        and not ev.is_user_annotation()):
                    key = "kernel" if "tb_fill_kernel" in ev.name() else ev.name()
                    ms = (ev.end_ns() - ev.start_ns()) / 1e6 / 5
                    dev_ms[key] = dev_ms.get(key, 0.0) + ms
            cells = sum(len(a) * len(b) for a, b in group)
            out[f"{name}.{'fill' if states else 'ends'}"] = {
                "cells": cells, "warps": launch.warps, "device_ms": dev_ms,
                "wall_ms": sorted(walls),
                "download_bytes": launch.total - launch.out_off,
                "gcups": cells / dev_ms.get("kernel", float("nan")) / 1e6}
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
