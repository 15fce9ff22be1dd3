"""The stream pack on the card: the window streams of the stream kernels
(K1, K3, K2) written from the device's copy of the encoded database.

:func:`pack_streams_device` returns exactly what
``convert.stream_pack_to_torch(pack_streams(db, ...))`` gives for the
plan ``utils.packing.plan_streams`` made of the same arguments: ``(streams
(nw, L, win) int8, fs (L//jb, nw, 2) int32)``. The plan stays on the host;
the fill, the host packer's ``pack_batch`` per slot, becomes one launch of
``csrc/stream_pack.cu`` over a table of tiles (``PACK_TILE`` positions of
256 lanes each) that covers every slot and every stream's tail. On a CPU
tensor it runs its plain version, :func:`pack_streams_reference`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..host import PAD_INDEX
from ..utils.packing import StreamPlan

# Positions of one tile of the kernel (csrc/stream_pack.cu's kTile).
PACK_TILE = 64


def pack_tiles(plan: StreamPlan, tile: int = PACK_TILE) -> np.ndarray:
    """``(ntiles, 5)`` int32 rows ``(w, p, q, s, npos)``: stream ``w``'s
    positions ``[p, p + npos)`` hold positions ``[q, q + npos)`` of slot
    ``s`` (``s = -1``: the stream's '*' tail), in tiles of at most ``tile``
    positions; together they cover every position of every stream once."""
    end = np.zeros(plan.nw, np.int64)
    np.maximum.at(end, plan.slot_w, plan.slot_start + plan.slot_lb)
    tail = np.flatnonzero(end < plan.L)
    w = np.concatenate([plan.slot_w, tail])
    start = np.concatenate([plan.slot_start, end[tail]])
    lb = np.concatenate([plan.slot_lb, plan.L - end[tail]])
    s = np.concatenate([np.arange(len(plan.slot_lb)), np.full(len(tail), -1)])
    per = -(-lb // tile)
    seg = np.repeat(np.arange(len(lb)), per)
    q = (np.arange(len(seg)) - np.repeat(np.cumsum(per) - per, per)) * tile
    return np.stack(
        [w[seg], start[seg] + q, q, s[seg], np.minimum(tile, lb[seg] - q)], axis=1
    ).astype(np.int32)


def _check(seq: torch.Tensor, offsets: torch.Tensor, plan: StreamPlan) -> None:
    if seq.dtype != torch.int8 or seq.ndim != 1:
        raise ValueError(f"seq must be 1-D int8, got {seq.dtype} {tuple(seq.shape)}")
    if offsets.dtype != torch.int64 or offsets.ndim != 1:
        raise ValueError(
            f"offsets must be 1-D int64, got {offsets.dtype} {tuple(offsets.shape)}")
    if offsets.device != seq.device:
        raise ValueError(f"seq on {seq.device}, offsets on {offsets.device}")
    if len(plan.order) and int(plan.order.max()) >= offsets.shape[0] - 1:
        raise ValueError("the plan names a record past the database's offsets")


def pack_streams_device(
    seq: torch.Tensor, offsets: torch.Tensor, plan: StreamPlan
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(streams, fs)`` of ``plan`` on ``seq``'s device.

    Args:
      seq: the database's residues, ``EncodedDatabase.seq`` as 1-D int8.
      offsets: its ``(N + 1,)`` int64 record offsets, on ``seq``'s device.
      plan: ``utils.packing.plan_streams`` of records of this database.

    On a CUDA tensor it launches the pack kernel (``csrc/stream_pack.cu``)
    and counts the launch in ``pack_streams_device.launches``; on a CPU
    tensor it runs :func:`pack_streams_reference`.
    """
    _check(seq, offsets, plan)
    if seq.device.type == "cpu":
        return pack_streams_reference(seq, offsets, plan)
    if seq.device.type != "cuda":
        raise ValueError(f"no pack kernel for device {seq.device}")
    dev = seq.device
    ids = torch.from_numpy(np.ascontiguousarray(plan.order, np.int64)).to(dev)
    tiles = torch.from_numpy(pack_tiles(plan)).to(dev)
    fs = torch.from_numpy(plan.fs).to(dev)
    streams = pack_launch(seq, offsets, ids, tiles, plan)
    pack_streams_device.launches += 1
    return streams, fs


pack_streams_device.launches = 0


def pack_launch(seq, offsets, ids, tiles, plan: StreamPlan) -> torch.Tensor:
    """One launch of the pack kernel on card tensors: the ``(nw, L, win)``
    streams, every byte written (``torch.empty`` is never read)."""
    from . import _build
    from .swa_cuda import _call

    _build.load()
    streams = torch.empty((plan.nw, plan.L, plan.win), dtype=torch.int8, device=seq.device)
    _call("stream_pack", seq.device, seq.data_ptr(), offsets.data_ptr(), ids.data_ptr(),
          tiles.data_ptr(), streams.data_ptr(), tiles.shape[0], PACK_TILE, plan.L,
          plan.win, len(plan.order))
    return streams


def pack_streams_reference(
    seq: torch.Tensor, offsets: torch.Tensor, plan: StreamPlan
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`pack_streams_device`, same contract:
    a gather of ``seq`` over an index tensor, ``where`` for the padding.
    ``pack_streams_reference.calls`` counts the calls."""
    _check(seq, offsets, plan)
    pack_streams_reference.calls += 1
    dev = seq.device
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
    idx = torch.where(live, start + pos[..., None], 0)
    chars = seq[idx] if seq.numel() else torch.zeros_like(idx, dtype=torch.int8)
    streams = torch.where(live, chars, torch.tensor(PAD_INDEX, dtype=torch.int8, device=dev))
    return streams, torch.from_numpy(plan.fs).to(dev)


pack_streams_reference.calls = 0
