"""Carry the host code's numpy inputs across to the port's tensors.

The host side of the search (encoding, profiles, ``pack_streams``) is numpy
code; the port keeps its own copy of the JAX package's (``models``,
``utils``). These functions turn its outputs into the tensors the port's
engines take, on an explicit device, so that tests can feed the same numpy
objects to both packages.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .host import PAD_INDEX, EncodedDatabase, StreamPack

# The biased profile's row count is padded to a multiple of this, as
# ``sw_pallas_stream`` pads to its row unroll; the CUDA kernel unrolls its
# row loop by the same factor. Zero rows of P' never change a score
# (H' = Gg_diag <= G_diag <= best there).
ROW_ALIGN = 4


def profile_to_torch(
    profile: np.ndarray, go: int, device: torch.device | str
) -> torch.Tensor:
    """The stream kernels' biased profile ``P' = P - go`` as int32.

    ``profile`` is the ``(Lq, 32)`` query profile of ``make_profile``, or an
    ``(NQ, Lq, 32)`` stack of them (``search_database_multi`` pads each
    query to Lq with ``P = 0`` rows). The result is ``(lqp, 32)`` or
    ``(NQ, lqp, 32)`` with ``lqp`` = Lq rounded up to ``ROW_ALIGN`` and each
    query's extra rows zero. Exact in int32: no bf16 rounding as on the TPU.
    """
    prof = np.asarray(profile, dtype=np.int64)
    if prof.ndim not in (2, 3):
        raise ValueError(f"profile shape {prof.shape} is not (Lq, 32) or (NQ, Lq, 32)")
    lq = prof.shape[-2]
    lqp = -(-lq // ROW_ALIGN) * ROW_ALIGN
    out = np.zeros((*prof.shape[:-2], lqp, prof.shape[-1]), dtype=np.int32)
    out[..., :lq, :] = prof - int(go)
    return torch.from_numpy(out).to(device)


def stream_pack_to_torch(
    pack: StreamPack, device: torch.device | str
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(streams, fs)`` of a ``StreamPack`` as device tensors.

    streams: ``(NW, L, win)`` int8; fs: ``(L//jb, NW, 2)`` int32.
    """
    streams = torch.from_numpy(np.ascontiguousarray(pack.streams, np.int8))
    fs = torch.from_numpy(np.ascontiguousarray(pack.fs, np.int32))
    return streams.to(device), fs.to(device)


# host_to_device copies to a card through two page-locked buffers of this
# many bytes in turn: 210 MB took 8-15 ms so, against 26-40 ms as one
# pageable copy and 33-73 ms registered in place (H100, PERF.md; swissprot
# times the three).
PIECE_BYTES = 32 << 20


class PinnedPieces:
    """Two page-locked host buffers of up to ``nbytes`` that copies to a
    card go through in turn, each with the event of its last copy, so that
    the host fills one while the other's copy runs. Each is made at its
    first copy, as large as that copy, and made anew only for a larger
    one; the owner keeps them for its next copies: ``pipeline.DevicePacker``
    holds one pair for a search, its database's copy and every pack's
    inputs."""

    def __init__(self, nbytes: int = PIECE_BYTES):
        self.nbytes = nbytes
        self._bufs: list[torch.Tensor | None] = [None, None]
        self._sent: list[torch.cuda.Event | None] = [None, None]
        self._next = 0

    def send(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """Copy the host tensor ``src`` (at most ``nbytes``) into the card
        tensor ``dst`` through the next buffer, enqueued on the current
        stream."""
        nbytes = src.numel() * src.element_size()
        k, self._next = self._next, self._next ^ 1
        if self._sent[k] is not None:
            self._sent[k].synchronize()  # the buffer's last copy has left it
        if self._bufs[k] is None or self._bufs[k].numel() < nbytes:
            self._bufs[k] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        buf = self._bufs[k][:nbytes].view(src.dtype)
        buf.copy_(src.reshape(-1))
        dst.view(-1).copy_(buf, non_blocking=True)
        self._sent[k] = torch.cuda.Event()
        self._sent[k].record(torch.cuda.current_stream(dst.device))


def database_to_torch(
    db: EncodedDatabase, device: torch.device | str, pieces: PinnedPieces | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(seq, offsets)`` of an EncodedDatabase on ``device``: its residues
    as 1-D int8 and its ``(N + 1,)`` int64 record offsets, the inputs of
    ``ops.pack_cuda.pack_streams_device`` (:func:`host_to_device`)."""
    return (host_to_device(db.seq, device, pieces),
            host_to_device(np.asarray(db.offsets, np.int64), device, pieces))


def host_to_device(
    array: np.ndarray, device: torch.device | str, pieces: PinnedPieces | None = None
) -> torch.Tensor:
    """``array`` as a tensor on ``device``: on the CPU a view; on a card a
    copy through ``pieces`` (a pair made for this copy where none is
    given), enqueued on the current stream, so that what is launched after
    it there reads it whole."""
    with warnings.catch_warnings():
        # A cache's memory map is read-only; the tensor is only read.
        warnings.simplefilter("ignore", UserWarning)
        src = torch.from_numpy(np.ascontiguousarray(array))
    dev = torch.device(device)
    if dev.type != "cuda" or not src.numel():
        return src.to(dev)
    pieces = PinnedPieces() if pieces is None else pieces
    size = src.element_size()
    out = torch.empty(src.shape, dtype=src.dtype, device=dev)
    flat, dst = src.view(-1), out.view(-1)
    step = max(1, pieces.nbytes // size)
    for a in range(0, flat.numel(), step):
        b = min(a + step, flat.numel())
        pieces.send(flat[a:b], dst[a:b])
    return out


def batch_windows(
    batch, win: int, jb: int, device: torch.device | str
) -> torch.Tensor:
    """A lane batch as the fixed-batch kernel's ``(NW, Lb', win)`` int8
    windows on ``device``, ``Lb'`` the batch length padded with '*' to a
    positive multiple of ``jb``.

    ``batch`` is ``(Lb, B)`` (``pack_batch``; ``B`` a multiple of ``win``),
    window ``w`` holding lanes ``[w*win, (w+1)*win)``, or already stacked as
    ``(NW, Lb, win)``. A numpy batch is split on the host and copied once; a
    tensor is split where it lies (``device`` is then its own).
    """
    is_tensor = isinstance(batch, torch.Tensor)
    if batch.ndim == 2:
        lb, b = batch.shape
        if b % win:
            raise ValueError(f"lane count {b} not a multiple of the window {win}")
        nw = b // win
        split = batch.reshape(lb, nw, win)
        batch = split.permute(1, 0, 2) if is_tensor else split.transpose(1, 0, 2)
    elif batch.ndim != 3:
        raise ValueError(f"batch shape {tuple(batch.shape)} is not (Lb, B) or (NW, Lb, win)")
    nw, lb, w = batch.shape
    lbp = max(-(-lb // jb) * jb, jb)
    if is_tensor:
        out = torch.full((nw, lbp, w), PAD_INDEX, dtype=torch.int8, device=batch.device)
        out[:, :lb] = batch
        return out
    out = np.full((nw, lbp, w), PAD_INDEX, dtype=np.int8)
    out[:, :lb] = batch
    return torch.from_numpy(out).to(device)


def profile_stripes(
    profile: np.ndarray, go: int, stripe_rows: int, device: torch.device | str
) -> list[torch.Tensor]:
    """The ``(Lq, 32)`` profile cut into row stripes for the striped kernel
    (K2), each biased as :func:`profile_to_torch` biases a profile.

    Every stripe but the last is exactly ``stripe_rows`` real rows: its last
    row is the boundary the next pass reads, so it must be a real row, and
    ``stripe_rows`` must be a multiple of ``ROW_ALIGN``. Only the last
    stripe is padded (to ``ROW_ALIGN``, with ``P' = 0`` rows).
    """
    prof = np.asarray(profile)
    if prof.ndim != 2:
        raise ValueError(f"profile shape {prof.shape} is not (Lq, 32)")
    if stripe_rows <= 0 or stripe_rows % ROW_ALIGN:
        raise ValueError(
            f"stripe_rows={stripe_rows} is not a positive multiple of {ROW_ALIGN}"
        )
    return [
        profile_to_torch(prof[s : s + stripe_rows], go, device)
        for s in range(0, prof.shape[0], stripe_rows)
    ]
