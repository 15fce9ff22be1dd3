"""Lane sharding of a lane-batch engine over several devices.

The port of ``seqalign_tpu.parallel.sharding``. A database scan has no
cross-sequence dependency, so a lane batch ``(Lb, B_total)`` is cut into
equal lane shards, one per device, the query profile is replicated, and
every shard is scored with no communication; only the top-k merge gathers
candidates. A "mesh" is a list of ``torch.device`` (entries may repeat);
``axis`` is kept for the JAX package's signatures and unused.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..device import local_devices


def make_mesh(devices: Sequence[torch.device | str] | None = None,
              axis: str = "db") -> list[torch.device]:
    """All local devices (:func:`..device.local_devices`), or the given
    ones, as a 1-D mesh."""
    return local_devices() if devices is None else [torch.device(d) for d in devices]


def shard_db(db, mesh: list[torch.device], axis: str = "db") -> list[torch.Tensor]:
    """A ``(Lb, B_total)`` batch (numpy or tensor) cut into ``len(mesh)``
    equal lane shards, shard ``k`` on ``mesh[k]``."""
    db = torch.as_tensor(db)
    b_total = db.shape[1]
    if b_total % len(mesh):
        raise ValueError(f"{b_total} lanes do not split into {len(mesh)} equal shards")
    return [s.contiguous().to(dev) for s, dev in zip(db.chunk(len(mesh), dim=1), mesh)]


def _score_shards(engine_fn, mesh, go, ge, profile, db) -> list[torch.Tensor]:
    """Every shard's scores, each shard's launch enqueued before any
    result is gathered."""
    shards = db if isinstance(db, (list, tuple)) else shard_db(db, mesh)
    if len(shards) != len(mesh):
        raise ValueError(f"{len(shards)} shards for a mesh of {len(mesh)}")
    prof = torch.as_tensor(profile)
    return [engine_fn(prof.to(s.device), s, go, ge) for s in shards]


def sharded_engine(
    engine_fn: Callable, mesh: list[torch.device], go: int, ge: int, axis: str = "db"
) -> Callable:
    """Wrap a lane-batch engine ``fn(profile, db, go, ge) -> (B,)`` to run
    sharded over the mesh's lanes.

    The returned ``fn(profile (Lq, 32), db)`` takes a ``(Lb, B_total)``
    batch (``B_total`` a multiple of ``len(mesh)`` times the engine's lane
    width) or :func:`shard_db`'s shards, and returns the ``(B_total,)``
    int32 scores on ``mesh[0]``.
    """

    def run(profile, db) -> torch.Tensor:
        outs = _score_shards(engine_fn, mesh, go, ge, profile, db)
        return torch.cat([o.to(mesh[0]) for o in outs])

    return run


def sharded_topk(
    engine_fn: Callable, mesh: list[torch.device], go: int, ge: int, k: int,
    axis: str = "db",
) -> Callable:
    """Sharded scoring and a global top-k merge.

    Each shard keeps its local top ``min(k, width)`` with lane indices
    offset by ``shard * width``; the candidates are gathered onto
    ``mesh[0]`` and the global top-k is taken there. Both selections are
    stable descending sorts, so ties keep the lower lane first, as
    ``jax.lax.top_k`` does. Returns ``fn(profile, db) -> (values (k,),
    global lane indices (k,))`` on ``mesh[0]``.
    """

    def run(profile, db) -> tuple[torch.Tensor, torch.Tensor]:
        outs = _score_shards(engine_fn, mesh, go, ge, profile, db)
        vals, idx = [], []
        for shard, scores in enumerate(outs):
            v, i = torch.sort(scores, descending=True, stable=True)
            local_k = min(k, scores.shape[0])
            vals.append(v[:local_k].to(mesh[0]))
            idx.append((i[:local_k] + shard * scores.shape[0]).to(mesh[0]))
        all_vals, all_idx = torch.cat(vals), torch.cat(idx)
        top, pos = torch.sort(all_vals, descending=True, stable=True)
        return top[:k], all_idx[pos[:k]]

    return run
