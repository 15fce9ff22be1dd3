"""The stream pack on the card: the window streams of the stream kernels
(K1, K3, K2) written from the device's copy of the encoded database.

:func:`pack_streams_device` returns exactly what
``convert.stream_pack_to_torch(pack_streams(db, ...))`` gives for the
plan ``utils.packing.plan_streams`` made of the same arguments: ``(streams
(nw, L, win) int8, fs (L//jb, nw, 2) int32)``. The plan stays on the host;
the fill, the host packer's ``pack_batch`` per slot, becomes one launch of
``csrc/stream_pack.cu`` over a table of runs (:func:`pack_runs`: up to
``PACK_RUN`` positions of one slot, or of a stream's '*' tail, for 256
lanes a CTA) that covers every stream position once. The kernel's inputs
from the plan (the record ids, the run table and ``fs``) go to the card
as one int32 array (:func:`stage_inputs`), copied once through the
search's page-locked buffers (``convert.host_to_device``). On a CPU tensor
it runs its plain version, :func:`pack_streams_reference`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..convert import PinnedPieces, host_to_device
from ..host import PAD_INDEX
from ..utils.packing import StreamPlan

# Positions of one tile of the kernel (csrc/stream_pack.cu's kTile).
PACK_TILE = 64
# Positions a CTA walks at most: a run of one slot (or tail). Of 64-1,024
# timed on an H100 (PERF.md), 64 and 128 were 12% and 1.6% slower than
# 256, 512 and 1,024 within 1.1% of it.
PACK_RUN = 256
# The pieces of stage_inputs' array start at multiples of this many words.
STAGE_ALIGN = 64


def pack_runs(plan: StreamPlan) -> np.ndarray:
    """``(nruns, 5)`` int32 rows ``(w, p, q, s, npos)``: stream ``w``'s
    positions ``[p, p + npos)`` hold positions ``[q, q + npos)`` of slot
    ``s`` (``s = -1``: the stream's '*' tail, which the kernel writes with
    no read), in runs of at most ``PACK_RUN`` positions, the longest first;
    together they cover every position of every stream once."""
    end = np.zeros(plan.nw, np.int64)
    np.maximum.at(end, plan.slot_w, plan.slot_start + plan.slot_lb)
    tail = np.flatnonzero(end < plan.L)
    w = np.concatenate([plan.slot_w, tail])
    start = np.concatenate([plan.slot_start, end[tail]])
    lb = np.concatenate([plan.slot_lb, plan.L - end[tail]])
    s = np.concatenate([np.arange(len(plan.slot_lb)), np.full(len(tail), -1)])
    per = -(-lb // PACK_RUN)
    seg = np.repeat(np.arange(len(lb)), per)
    q = (np.arange(len(seg)) - np.repeat(np.cumsum(per) - per, per)) * PACK_RUN
    runs = np.stack(
        [w[seg], start[seg] + q, q, s[seg], np.minimum(PACK_RUN, lb[seg] - q)], axis=1
    ).astype(np.int32)
    return runs[np.argsort(-runs[:, 4], kind="stable")]


def stage_inputs(
    plan: StreamPlan, records: int | None = None, out: np.ndarray | None = None
) -> tuple[np.ndarray, tuple[slice, ...]]:
    """The kernel's inputs from the plan in one int32 array: the record ids
    (``plan.order``), :func:`pack_runs`' table and ``plan.fs``, each
    starting at a multiple of ``STAGE_ALIGN`` words, zeros between; and
    the three slices of the array that hold them. The array is the start
    of ``out`` where one is given, else a new one. Raises ``ValueError``
    for an id that int32 does not hold or, given the database's
    ``records``, that names none of them."""
    top = _max_id(plan.order)
    if records is not None and top >= records:
        raise ValueError("the plan names a record past the database's offsets")
    if top > np.iinfo(np.int32).max:
        raise ValueError("a record id of the plan does not fit in int32")
    runs = pack_runs(plan)
    pieces = (plan.order, runs.reshape(-1), plan.fs.reshape(-1))
    parts, n = [], 0
    for piece in pieces:
        parts.append(slice(n, n + piece.size))
        n += -(-piece.size // STAGE_ALIGN) * STAGE_ALIGN
    staged = np.empty(n, np.int32) if out is None else out[:n]
    if len(staged) < n:
        raise ValueError(f"out holds {len(staged)} words, the inputs {n}")
    stop = 0
    for piece, part in zip(pieces, parts):
        staged[stop : part.start] = 0
        staged[part] = piece
        stop = part.stop
    staged[stop:] = 0
    return staged, tuple(parts)


def _max_id(order: np.ndarray) -> int:
    """The largest record id of ``order`` in one pass, a negative one
    counting as past every other (-1 for none)."""
    if not len(order):
        return -1
    return int(np.asarray(order, np.int64).view(np.uint64).max())


def staged_views(
    staged: torch.Tensor, parts: tuple[slice, ...], plan: StreamPlan
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(ids, runs, fs)``: views of :func:`stage_inputs`' array, as a
    tensor on any device, in the shapes the kernel reads."""
    ids, runs, fs = (staged[part] for part in parts)
    return ids, runs.view(-1, 5), fs.view(plan.fs.shape)


def _check(seq: torch.Tensor, offsets: torch.Tensor) -> None:
    """Refuse tensors the pack cannot take."""
    if seq.dtype != torch.int8 or seq.ndim != 1:
        raise ValueError(f"seq must be 1-D int8, got {seq.dtype} {tuple(seq.shape)}")
    if offsets.dtype != torch.int64 or offsets.ndim != 1:
        raise ValueError(
            f"offsets must be 1-D int64, got {offsets.dtype} {tuple(offsets.shape)}")
    if offsets.device != seq.device:
        raise ValueError(f"seq on {seq.device}, offsets on {offsets.device}")


def pack_streams_device(
    seq: torch.Tensor, offsets: torch.Tensor, plan: StreamPlan,
    pieces: PinnedPieces | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(streams, fs)`` of ``plan`` on ``seq``'s device.

    Args:
      seq: the database's residues, ``EncodedDatabase.seq`` as 1-D int8.
      offsets: its ``(N + 1,)`` int64 record offsets, on ``seq``'s device.
      plan: ``utils.packing.plan_streams`` of records of this database.
      pieces: the page-locked buffers the plan's inputs go to the card
        through (``convert.host_to_device``; the search's, from
        ``pipeline.DevicePacker``).

    On a CUDA tensor it copies :func:`stage_inputs`' array to the card
    once, launches the pack kernel (``csrc/stream_pack.cu``) and counts the
    launch in ``pack_streams_device.launches``; ``fs`` is a view of that
    copy. On a CPU tensor it runs :func:`pack_streams_reference`.
    """
    _check(seq, offsets)
    with trace.span("pack"):
        if seq.device.type == "cpu":
            return pack_streams_reference(seq, offsets, plan)
        if seq.device.type != "cuda":
            raise ValueError(f"no pack kernel for device {seq.device}")
        with trace.span("stage"):
            staged, parts = stage_inputs(plan, offsets.shape[0] - 1)
        ids, runs, fs = staged_views(host_to_device(staged, seq.device, pieces), parts, plan)
        streams = pack_launch(seq, offsets, ids, runs, plan)
        pack_streams_device.launches += 1
        return streams, fs


pack_streams_device.launches = 0


def pack_launch(seq, offsets, ids, runs, plan: StreamPlan) -> torch.Tensor:
    """One launch of the pack kernel on card tensors (``ids`` int32, ``runs``
    :func:`pack_runs`' table): the ``(nw, L, win)`` streams, every byte
    written (``torch.empty`` is never read)."""
    from . import _build
    from .swa_cuda import _call

    _build.load()
    streams = torch.empty((plan.nw, plan.L, plan.win), dtype=torch.int8, device=seq.device)
    _call("stream_pack", seq.device, seq.data_ptr(), offsets.data_ptr(), ids.data_ptr(),
          runs.data_ptr(), streams.data_ptr(), runs.shape[0], PACK_TILE, plan.L,
          plan.win, len(plan.order))
    return streams


def pack_streams_reference(
    seq: torch.Tensor, offsets: torch.Tensor, plan: StreamPlan
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`pack_streams_device`, same contract:
    a gather of ``seq`` over an index tensor (:func:`gather_index`),
    ``where`` for the padding. ``pack_streams_reference.calls`` counts the
    calls."""
    _check(seq, offsets)
    if _max_id(plan.order) >= offsets.shape[0] - 1:
        raise ValueError("the plan names a record past the database's offsets")
    pack_streams_reference.calls += 1
    dev = seq.device
    idx, live = gather_index(offsets, plan)
    chars = seq[idx] if seq.numel() else torch.zeros_like(idx, dtype=torch.int8)
    streams = torch.where(live, chars, torch.tensor(PAD_INDEX, dtype=torch.int8, device=dev))
    return streams, torch.from_numpy(plan.fs).to(dev)


pack_streams_reference.calls = 0


def gather_index(offsets: torch.Tensor, plan: StreamPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """``(idx, live)``, both ``(nw, L, win)`` on ``offsets``' device: the
    index into ``seq`` of every stream byte that holds a residue (``live``)
    and 0 elsewhere."""
    dev = offsets.device
    nslots = len(plan.slot_lb)
    lb = torch.from_numpy(plan.slot_lb).to(dev)
    # Every stream position a slot holds: its slot and its position there.
    slot = torch.repeat_interleave(torch.arange(nslots, device=dev), lb)
    q = torch.arange(slot.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(lb, 0) - lb, lb)
    w = torch.from_numpy(plan.slot_w).to(dev)[slot]
    p = torch.from_numpy(plan.slot_start).to(dev)[slot] + q
    at = torch.full((plan.nw, plan.L), -1, dtype=torch.int64, device=dev)
    at[w, p] = slot
    pos = torch.zeros((plan.nw, plan.L), dtype=torch.int64, device=dev)
    pos[w, p] = q
    ids = torch.from_numpy(np.ascontiguousarray(plan.order, np.int64)).to(dev)
    rank = at[..., None] * plan.win + torch.arange(plan.win, device=dev)
    live = (at[..., None] >= 0) & (rank < len(ids))
    rec = ids[torch.where(live, rank, 0)] if len(ids) else torch.zeros_like(rank)
    start = offsets[rec]
    live &= pos[..., None] < offsets[rec + 1] - start
    return torch.where(live, start + pos[..., None], 0), live
