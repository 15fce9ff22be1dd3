"""Carry the JAX package's numpy inputs across to the port's tensors.

The host side of the search (encoding, profiles, ``pack_streams``) is the
JAX package's numpy code, shared by both packages. These functions turn its
outputs into the tensors the port's engines take, on an explicit device, so
that tests can feed the same numpy objects to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .host import StreamPack

# The biased profile's row count is padded to a multiple of this, as
# ``sw_pallas_stream`` pads to its row unroll; the CUDA kernel unrolls its
# row loop by the same factor. Zero rows of P' never change a score
# (H' = Gg_diag <= G_diag <= best there).
ROW_ALIGN = 4


def profile_to_torch(
    profile: np.ndarray, go: int, device: torch.device | str
) -> torch.Tensor:
    """The stream kernel's biased profile ``P' = P - go`` as int32.

    ``profile`` is the ``(Lq, 32)`` query profile of ``make_profile``; the
    result is ``(lqp, 32)`` with ``lqp`` = Lq rounded up to ``ROW_ALIGN``,
    the extra rows zero. Exact in int32: no bf16 rounding as on the TPU.
    """
    prof = np.asarray(profile, dtype=np.int64)
    if prof.ndim != 2:
        raise NotImplementedError(
            "a 3-D (multi-query) profile needs the K3 row-stacked kernel, "
            "which is not yet ported"
        )
    lq = prof.shape[0]
    lqp = -(-lq // ROW_ALIGN) * ROW_ALIGN
    out = np.zeros((lqp, prof.shape[1]), dtype=np.int32)
    out[:lq] = prof - int(go)
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
