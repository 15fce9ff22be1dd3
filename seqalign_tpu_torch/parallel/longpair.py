"""Sequence-parallel alignment of ONE long query across several devices.

The port of ``seqalign_tpu.parallel.longpair``. The query's DP rows are cut
into one stripe per mesh entry, and the only coupling, each stripe's last
row ``(Gg, F)`` at every database position, flows from entry ``k`` to entry
``k + 1``. The entries march database blocks as a wavefront pipeline, so
after the fill all entries compute at once on successive blocks. Entry 0
reads the local-alignment boundary (Gg = go, F = 0) above its stripe.

The rows of a stripe run as sub-passes of at most ``STRIPE_ROWS`` rows,
and every sub-pass of every entry of a data slice is a pipeline stage
sigma, numbered in row order (the sub-passes of the entries before, plus
its own index p). At step ``t`` stage sigma scores block ``t - sigma``, so
an entry's tasks of a step, one (sub-pass, block) pair each, lie on an
anti-diagonal of its grid and are independent: task (p, b) reads the
boundary row that (p - 1, b) wrote and the left column, ``(Gg, E)`` of its
rows at the block's last position, that (p, b - 1) wrote, both a step
before, and its corner (the row above at the block's first position - 1)
two steps before. One launch of K2's block instance (``ops.swa_cuda.
sw_stream_striped_step``, or two where the entry's last sub-pass needs
another instance) runs an entry's tasks of a step from a task table built
once a call and put on the device once; each task max-merges its lanes'
bests into the entry's best. Every entry runs on its own CUDA stream. At
each step entry ``k`` waits on the event entry ``k - 1`` recorded a step
before, and copies the block its first stage scores of the edge boundary
to its own device on its own stream: a copy within one card, or a peer
copy between cards. JAX's ``lax.ppermute`` is such a hand-off inside one
program, so no collective library is involved (NCCL also refuses two ranks
on one card). Each stripe edge has a full-length boundary array on each
side, and each edge between two sub-passes one of its own, written one
block at a time and never reused: no write races a read, and a block's
first sub-pass finds its corner as the block before left it. On CPU
entries the same steps run their plain version, task by task, in the same
order.

Each lane stops at its end (1 + its last position holding a char other
than '*'; ``swa_cuda.lane_ends``): a task skips the lanes whose records
ended before its block, and a lane's last block stops after its last
residue. That is exact only where no skipped cell can raise a best: every
'*' score of the query at most 0 (the profile's '*' column), and ``ge <=
0``, which ``supported_scoring`` enforces. A query with a positive '*'
score runs every cell, as a whole call: a sub-pass below a '*'-positive
one would read boundary words that a skipped task never wrote. Within each
data slice's shard the lanes are scored longest first, so that a CTA's
lanes end close together, and the bests go back in the caller's order.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..convert import ROW_ALIGN, batch_windows, profile_stripes
from ..host import PAD_INDEX
from ..ops import swa_cuda
from ..ops.swa_cuda import (
    ALPHA, STREAM_JB, BlockTable, BlockTask, left_column, supported_scoring,
    sw_stream_striped_step,
)


def _grid(mesh, data_axis) -> list[list[torch.device]]:
    """The mesh as data slices of sequence entries, ``grid[d][s]``."""
    entries = list(mesh)
    nested = [isinstance(e, (list, tuple)) for e in entries]
    if entries and all(nested):
        if data_axis is None:
            raise ValueError(
                "a 2-D mesh mesh[d][s] shards lanes on its first axis: name it "
                "with data_axis, or the query axis does not cover all devices"
            )
        grid = [[torch.device(x) for x in row] for row in entries]
        if not grid[0] or len({len(row) for row in grid}) != 1:
            raise ValueError("a 2-D mesh needs rows of one nonzero length")
    elif entries and not any(nested):
        if data_axis is not None:
            raise ValueError(f"data_axis={data_axis!r} names an axis a 1-D mesh lacks")
        grid = [[torch.device(e) for e in entries]]
    else:
        raise ValueError("the mesh must be a nonempty list of devices or of device lists")
    types = {dev.type for row in grid for dev in row}
    if len(types) != 1 or not types <= {"cpu", "cuda"}:
        raise ValueError(f"the mesh mixes or names unsupported devices: {sorted(types)}")
    if types == {"cuda"} and not torch.cuda.is_available():
        raise RuntimeError("the mesh names CUDA devices, and no CUDA device is available")
    return grid


class _Entry:
    """One mesh entry's stripe: its sub-passes, left columns, boundaries,
    running best, stream, task table and the events it records after each
    step. ``ends``: the lanes' ends its tasks stop at, or None (every cell
    runs)."""

    def __init__(self, subs, windows, ends, edge_in: bool, edge_out: bool):
        dev = windows.device
        _, length, win = windows.shape
        self.subs, self.windows, self.ends = subs, windows, ends
        self.left = [left_column(s.shape[0], windows) for s in subs]
        bnd = (2, 1, length, win)
        # One boundary array per edge between sub-passes: sub-pass p + 1
        # reads its corner at j0 - 1, which sub-pass p wrote with the block
        # before.
        self.inner = [torch.empty(bnd, dtype=torch.int32, device=dev)
                      for _ in range(len(subs) - 1)]
        self.edge_in = torch.empty(bnd, dtype=torch.int32, device=dev) if edge_in else None
        self.edge_out = torch.empty(bnd, dtype=torch.int32, device=dev) if edge_out else None
        self.best = torch.zeros((1, win), dtype=torch.int32, device=dev)
        self.stream = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
        self.events = {}

    def plan(self, first_stage: int, n_steps: int, n_blocks: int, blk: int, go: int, ge: int):
        """Build the entry's task table: its sub-pass ``p`` is stage
        ``first_stage + p`` and scores block ``t - first_stage - p`` at step
        ``t``. ``steps[t]`` is ``(lo, hi, edge)``: the step's tasks
        ``[lo, hi)`` of the table, in row order (all sub-passes but the
        last share an instance, so one or two launches), and the positions
        ``(j0, j1)`` of the edge boundary to take from the entry before
        first, or None."""
        length = self.windows.shape[1]
        last = len(self.subs) - 1
        tasks, self.steps = [], []
        for t in range(n_steps):
            lo = len(tasks)
            for p, sub in enumerate(self.subs):
                b = t - first_stage - p
                if 0 <= b < n_blocks:
                    j0 = b * blk
                    tasks.append(BlockTask(
                        sub, j0, min(j0 + blk, length),
                        bnd_in=self.edge_in if p == 0 else self.inner[p - 1],
                        bnd_out=self.edge_out if p == last else self.inner[p],
                        left_in=None if b == 0 else self.left[p],
                        left_out=None if b == n_blocks - 1 else self.left[p]))
            b = t - first_stage
            edge = None
            if self.edge_in is not None and 0 <= b < n_blocks:
                edge = (b * blk, min((b + 1) * blk, length))
            self.steps.append((lo, len(tasks), edge))
        self.table = BlockTable(self.windows, tasks, go, ge, self.ends)

    def on_stream(self):
        return torch.cuda.stream(self.stream) if self.stream else contextlib.nullcontext()

    def run_step(self, t: int, prev):
        """Step ``t``: take the edge block from ``prev`` (the entry before,
        which recorded its event a step before), launch the step's tasks
        and record the step's event."""
        lo, hi, edge = self.steps[t]
        if lo == hi:
            return
        with self.on_stream():
            if edge is not None:
                if self.stream:
                    self.stream.wait_event(prev.events[t - 1])
                j0, j1 = edge
                self.edge_in[:, :, j0:j1].copy_(prev.edge_out[:, :, j0:j1], non_blocking=True)
            sw_stream_striped_step(self.table, lo, hi, self.best)
            if self.stream:
                ev = torch.cuda.Event()
                ev.record(self.stream)
                self.events[t] = ev


def skips(profile: np.ndarray) -> bool:
    """True if the lanes may stop at their ends for this query: every '*'
    score of its profile ``(Lq, 32)`` at most 0 (the penalties' part,
    ``ge <= 0``, is ``supported_scoring``'s)."""
    return profile.size == 0 or int(profile[:, PAD_INDEX].max()) <= 0


def lane_order(ends: np.ndarray, data_count: int) -> np.ndarray:
    """The order in which the lanes are scored: each of ``data_count``
    equal shards of ``ends`` (the lanes' ends) by end, longest first
    (stable), each lane staying in its shard."""
    shard = ends.size // data_count
    return np.concatenate([
        d * shard + np.argsort(-ends[d * shard:(d + 1) * shard], kind="stable")
        for d in range(data_count)])


def _pipeline(prof: np.ndarray, db: np.ndarray, go: int, ge: int, grid, jb: int):
    """``sw_longpair``'s entries of each data slice, their arrays and task
    tables planned (nothing launched); the number of steps: stages + blocks
    - 1, the stages every sub-pass of a data slice; and ``order``, the
    caller's lane at each scored lane (each shard's lanes longest first)."""
    lq = prof.shape[0]
    lb, b = db.shape
    seq_count, data_count = len(grid[0]), len(grid)
    rows = -(-(-(-lq // seq_count)) // ROW_ALIGN) * ROW_ALIGN
    shard = -(-b // data_count)
    dbp = np.full((lb, shard * data_count), PAD_INDEX, dtype=np.int8)
    dbp[:, :b] = db
    blk = -(-jb // STREAM_JB) * STREAM_JB
    ends = swa_cuda.lane_ends(torch.from_numpy(dbp)[None])[0].numpy()
    order = lane_order(ends, data_count)
    skip = skips(prof)

    slices = []
    for d, row in enumerate(grid):
        lanes = order[d * shard:(d + 1) * shard]
        windows = {dev: batch_windows(dbp[:, lanes], shard, STREAM_JB, dev)
                   for dev in set(row)}
        lane_ends = {dev: torch.from_numpy(ends[lanes].astype(np.int32))[None].to(dev)
                     if skip else None for dev in windows}
        starts = range(0, lq, rows)
        slices.append([
            _Entry(profile_stripes(prof[s:s + rows], go, swa_cuda.STRIPE_ROWS, dev),
                   windows[dev], lane_ends[dev], edge_in=k > 0, edge_out=k < len(starts) - 1)
            for k, (s, dev) in enumerate(zip(starts, row))
        ])
    length = slices[0][0].windows.shape[1]
    n_blocks = -(-length // blk)
    n_steps = sum(len(ent.subs) for ent in slices[0]) + n_blocks - 1
    for sl in slices:
        first = 0
        for ent in sl:
            ent.plan(first, n_steps, n_blocks, blk, go, ge)
            first += len(ent.subs)
    return slices, n_steps, order


def sw_longpair(
    profile: np.ndarray,
    db: np.ndarray,
    go: int,
    ge: int,
    mesh,
    jb: int = 128,
    axis: str | None = None,
    data_axis: str | None = None,
    *,
    events: list | None = None,
) -> torch.Tensor:
    """Score one (long) query against ``db`` lanes, query rows sharded.

    Args:
      profile: ``(Lq, 32)`` int query profile (``make_profile``).
      db: ``(Lb, B)`` int database lanes, '*'-padded.
      go, ge: total gap-open and gap-extend penalties; the scoring must lie
        inside ``swa_cuda.supported_scoring`` (else ``ValueError`` before
        any device work: outside it JAX's scores depend on its padding).
      mesh: a 1-D mesh, a list of devices (``make_mesh``; entries may
        repeat, so one card can stand for several), whose entries take the
        query's row stripes in order; or a 2-D mesh, a list of equal-length
        lists ``mesh[d][s]``: ``d`` over ``data_axis`` shards the lanes
        (JAX's ``("data", "seq")`` mesh), ``s`` over ``axis`` the query
        rows, and each data slice runs its own pipeline over its lane shard.
        All entries are CUDA devices, or all CPU.
      jb: database positions per pipeline block, any ``jb >= 1``; rounded
        up to a multiple of ``STREAM_JB`` (16), the kernel's block grain.
        Scores do not depend on it.
      axis, data_axis: the mesh's axis names, as JAX takes them; a 2-D mesh
        needs ``data_axis``, a 1-D mesh must not have one.
      events: a list to which a CUDA run appends its (start, end) CUDA
        events, recorded on ``mesh[0]``'s current stream right before the
        first launch and after the result is merged (a kernel timer).

    Each entry holds ``ceil(Lq / entries)`` rows rounded up to
    ``ROW_ALIGN`` (the kernel's row unroll; every stripe edge is a real
    row), so trailing entries may hold fewer rows or none, and an entry
    with none launches nothing. Returns the ``(B,)`` int32 best
    local-alignment scores on ``mesh[0]``, identical to the single-device
    engines.
    """
    grid = _grid(mesh, data_axis)
    prof = np.asarray(profile)
    if prof.ndim != 2 or prof.shape[1] != ALPHA:
        raise ValueError(f"profile shape {prof.shape} != (Lq, {ALPHA})")
    if not supported_scoring(prof, go, ge):
        raise ValueError(
            f"scoring system outside the kernel's int32 G-form envelope (it "
            f"needs ge >= go, ge <= 0, no int32 overflow; got {go=}, {ge=})"
        )
    if jb < 1:
        raise ValueError(f"jb={jb} is not positive")
    db = np.asarray(db)
    if db.ndim != 2:
        raise ValueError(f"db shape {db.shape} is not (Lb, B)")
    lq = prof.shape[0]
    lb, b = db.shape
    dev0 = grid[0][0]
    if lq == 0 or lb == 0 or b == 0:
        return torch.zeros(b, dtype=torch.int32, device=dev0)
    slices, n_steps, order = _pipeline(prof, db, go, ge, grid, jb)
    order = torch.from_numpy(order).to(dev0)

    cuda = dev0.type == "cuda"
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev0))
        for ent in (e for sl in slices for e in sl):
            ent.stream.wait_stream(torch.cuda.current_stream(ent.windows.device))
    for t in range(n_steps):
        for sl in slices:
            for k, ent in enumerate(sl):
                ent.run_step(t, sl[k - 1] if k else None)
    if cuda:
        for ent in (e for sl in slices for e in sl):
            torch.cuda.current_stream(ent.windows.device).wait_stream(ent.stream)
    scored = torch.cat([
        torch.stack([ent.best[0].to(dev0) for ent in sl]).amax(dim=0) for sl in slices
    ])
    best = torch.empty_like(scored)
    best[order] = scored
    best = best[:b]
    if cuda and events is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(dev0))
        events.append((start, end))
    return best
