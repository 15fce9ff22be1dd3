"""The device a search runs on, shared by the pipeline and the kernel
wrappers that take host arrays, and the devices a multi-device search
spreads over (``local_devices``).

The device comes from ``SEQALIGN_PLATFORM`` (``cuda``, the default, or
``cpu``). With no GPU, ``cuda`` is an error, never a silent run on the CPU.
"""

from __future__ import annotations

import os

import torch


def resolve_device(platform: str | None = None) -> torch.device:
    """The device named by ``platform`` or ``SEQALIGN_PLATFORM``."""
    plat = platform or os.environ.get("SEQALIGN_PLATFORM") or "cuda"
    if plat == "cpu":
        return torch.device("cpu")
    if plat != "cuda":
        raise ValueError(
            f"SEQALIGN_PLATFORM={plat!r}: expected 'cpu' or 'cuda'"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (SEQALIGN_PLATFORM=cuda is the "
            "default); set SEQALIGN_PLATFORM=cpu to run on the CPU"
        )
    return torch.device("cuda")


def local_devices(platform: str | None = None) -> list[torch.device]:
    """Every device of this process's platform (``jax.local_devices()``):
    each visible card, ``cuda:0 .. cuda:{n-1}``, or ``[cpu]`` under
    ``cpu``. Raises as :func:`resolve_device` does."""
    dev = resolve_device(platform)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
