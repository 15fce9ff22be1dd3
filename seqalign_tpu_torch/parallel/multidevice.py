"""Multi-device (single-host) database search: data parallelism over records.

The port of ``seqalign_tpu.parallel.multidevice``. A database scan has no
cross-record dependency, so the records are dealt to the devices, each
device packs its share's window streams from its one copy of the encoded
database and scores them in one launch of the segmented stream kernel (K1,
or K3 per block of a stacked-query profile), and the scores are scattered
on the host: no collective in the scoring path. Collectives appear only in
the top-k merge (``sharding.sharded_topk``) and across hosts
(``multihost``).

The TPU package pads every device's pack to one stream length so that one
compiled executable serves all, and retries without packed production when
a compile fails; the port compiles nothing per shape and keeps neither.
"""

from __future__ import annotations

import functools
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..convert import profile_to_torch
from ..device import local_devices
from ..host import EncodedDatabase
from ..ops import swa_cuda
from ..ops.swa_cuda import STREAM_JB, TEAM_MAX_SLOTS, sw_stream, sw_stream_multi
from ..pipeline import (
    PLANS, WINDOW_LANES, DevicePacker, _sync, chunk_device_bytes, plan_chunk, query_blocks,
    resident_lanes, scatter_slots,
)


def deal_chunks(order: np.ndarray, lengths: np.ndarray, n_devices: int, win: int = 1024):
    """Deal lane-groups of sorted records to devices, balancing residues.

    ``order`` must be length-sorted descending. Groups of ``win`` records go
    to the device with the least residues so far (greedy — groups arrive in
    descending size, the classic LPT schedule).
    """
    totals = [0] * n_devices
    chunks: list[list[np.ndarray]] = [[] for _ in range(n_devices)]
    for start in range(0, len(order), win):
        ids = order[start : start + win]
        d = min(range(n_devices), key=totals.__getitem__)
        chunks[d].append(ids)
        totals[d] += int(lengths[ids].sum())
    return [
        np.concatenate(c) if c else np.zeros(0, dtype=order.dtype)
        for c in chunks
    ]


def multi_device_search(
    profile: np.ndarray,
    db: EncodedDatabase,
    go: int,
    ge: int,
    devices: Sequence[torch.device | str] | None = None,
    engine_fn: Callable | None = None,
    win: int = WINDOW_LANES,
) -> tuple[np.ndarray, float]:
    """Score a query (or stacked queries) across the given devices.

    Args:
      profile: ``(Lq, 32)`` or ``(NQ, Lq, 32)`` int query profile(s), at
        most ``swa_cuda.MAX_QUERY_ROWS`` rows (no striped path here, as in
        the JAX package).
      db: EncodedDatabase.
      go, ge: total gap-open and gap-extend penalties, ``ge >= go``.
      devices: default :func:`..device.local_devices` (which raises with no
        GPU unless ``SEQALIGN_PLATFORM=cpu``). Entries may repeat: each is
        one share of the records and one launch.
      engine_fn: ``fn(profile_dev, streams_dev, fs_dev, go, ge, nslots=,
        jb=)`` per device and query block (a test hook); default
        ``sw_stream`` (2-D) or ``sw_stream_multi`` (3-D) over the query's
        own rows, their plain versions on a CPU device.
      win: records per dealt lane group and per window lane; the port's
        ``WINDOW_LANES`` (256, not the TPU's 1024), so that each dealt
        group is one of the packer's windows.

    Returns (scores in stream order — ``(N,)`` or ``(NQ, N)`` int32 — and
    kernel seconds). Every device's launches are enqueued before any result
    is fetched; the timer runs from the first launch to the last fetch,
    after every device is synchronised (planning, the database's copy to
    each device, the packing and the other host-to-device copies stay
    outside it, the reference's own boundary). Entries of one device share
    one copy of the database (:class:`..pipeline.DevicePacker`, one a
    device).
    """
    multi = profile.ndim == 3
    nq = profile.shape[0] if multi else 1
    rows = int(profile.shape[-2])
    n = db.n
    scores = np.zeros((nq, n) if multi else n, dtype=np.int32)
    if n == 0:
        return scores, 0.0
    if rows > swa_cuda.MAX_QUERY_ROWS:
        raise ValueError(
            f"query of {rows} rows exceeds MAX_QUERY_ROWS="
            f"{swa_cuda.MAX_QUERY_ROWS} of the one-pass stream kernel"
        )
    if ge < go:
        raise ValueError(f"G-form kernel requires ge >= go (got {go=}, {ge=})")
    devices = local_devices() if devices is None else [torch.device(d) for d in devices]
    if engine_fn is None:
        engine_fn = functools.partial(sw_stream_multi if multi else sw_stream, rows=rows)

    chunks = deal_chunks(PLANS.find(db, True).order, db.lengths, len(devices), win=win)
    plans = []
    for dev, chunk in zip(devices, chunks):
        if not len(chunk):
            continue
        plan = plan_chunk(db.lengths, chunk, None, resident_lanes(dev), win=win)
        nslots = len(plan.slot_lb)
        if nslots >= TEAM_MAX_SLOTS:
            raise ValueError(
                f"{nslots} slots on {dev}: the stream kernel holds slots below "
                f"{TEAM_MAX_SLOTS}"
            )
        plans.append((dev, chunk, plan))
    held: dict[torch.device, int] = {}
    for dev, _, plan in plans:
        held[dev] = held.get(dev, 0) + chunk_device_bytes(plan, nq)
    packers = {dev: DevicePacker(db, dev, b) for dev, b in held.items()}
    work = []
    for dev, chunk, plan in plans:
        streams, fs = packers[dev](plan)
        profs = (query_blocks(profile, go, len(chunk), dev) if multi
                 else [profile_to_torch(profile, go, dev)])
        work.append((chunk, streams, fs, len(plan.slot_lb), profs))

    for dev in set(devices):
        _sync(dev)
    t0 = time.perf_counter()
    outs = [
        [engine_fn(p, streams, fs, go, ge, nslots=nslots, jb=STREAM_JB) for p in profs]
        for _, streams, fs, nslots, profs in work
    ]
    outs = [torch.cat(o, dim=1).cpu() if multi else o[0].cpu() for o in outs]
    kernel_time = time.perf_counter() - t0

    for (chunk, *_), out in zip(work, outs):
        scatter_slots(scores, chunk, out)
    return scores, kernel_time
