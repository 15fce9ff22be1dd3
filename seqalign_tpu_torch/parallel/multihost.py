"""Multi-host database search over ``torch.distributed``.

The port of ``seqalign_tpu.parallel.multihost``. The FASTA database is
striped across hosts (host ``p`` of ``P`` holds records ``i`` with ``i % P
== p``), every host scores its stripe on its local devices
(:func:`.multidevice.multi_device_search`, one launch per device), and the
global result is merged with an all-gather: the full score vector (4 B a
record) or each host's top-k candidates.

The merge moves host arrays that are already fetched, as the JAX package's
``process_allgather`` gathers host arrays over the data-centre network, so
it runs on the ``gloo`` backend over CPU tensors. NCCL carries device
tensors and refuses two ranks on one GPU; it has no part in this merge.
"""

from __future__ import annotations

import datetime
from typing import Callable, Iterable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from ..device import local_devices
from ..host import encode, parse_file_cached, read_fasta
from ..ops.swa_torch import make_profile
from ..pipeline import _db_from_encoded
from .multidevice import multi_device_search

# How long a collective, and the rendezvous, may wait for the other hosts
# before it raises: a host that died must fail its peers, not hang them.
DIST_TIMEOUT = datetime.timedelta(minutes=5)


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join the ``gloo`` process group whose rank 0 listens at
    ``coordinator_address`` (``host:port``); a no-op for a single process.
    Returns True if this call created the group (the caller destroys it)."""
    if num_processes is None or num_processes <= 1:
        return False
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=DIST_TIMEOUT,
    )
    return True


def host_stripe(records: Iterable, process_id: int, num_processes: int) -> Iterator:
    """Round-robin stripe of a record stream for this host.

    Striping by position (record i belongs to host i % P) keeps every host's
    stripe statistically identical in length distribution, which balances
    padded work without a global sort.
    """
    for i, rec in enumerate(records):
        if i % num_processes == process_id:
            yield rec


def merge_topk_candidates(
    local_scores: np.ndarray,
    local_ids: np.ndarray,
    k: int,
    gathered: list[tuple[np.ndarray, np.ndarray]] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Merge per-host (scores, global record ids) candidate sets to top-k.

    ``gathered`` holds other hosts' candidate pairs (from an all-gather);
    ``None`` means single host.
    """
    scores = [np.asarray(local_scores)]
    ids = [np.asarray(local_ids)]
    for s, i in gathered or []:
        scores.append(np.asarray(s))
        ids.append(np.asarray(i))
    all_s = np.concatenate(scores)
    all_i = np.concatenate(ids)
    order = np.argsort(-all_s, kind="stable")[:k]
    return all_s[order], all_i[order]


def _allgather(arr: np.ndarray) -> np.ndarray:
    """``(nproc, *arr.shape)``: every host's ``arr`` (equal shapes and
    dtypes on every host), in rank order."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def multihost_search(
    query_idx: np.ndarray,
    db_path: str,
    scoring,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    k: int | None = None,
    engine_fn: Callable | None = None,
    db_cache: str | None = None,
) -> tuple[np.ndarray, float] | tuple[np.ndarray, np.ndarray, float]:
    """Search one query against a FASTA database striped across hosts.

    Every participating process calls this with the same arguments (plus its
    own ``process_id``). Each host reads only its round-robin stripe of the
    database (with ``db_cache``, views of the mmapped .sqc), scores it on
    its local devices (:func:`..device.local_devices`, which raises with no
    GPU unless ``SEQALIGN_PLATFORM=cpu``), and the results merge:

    - ``k is None``: all-gather every stripe's scores and return the FULL
      global score vector, identical on every host, in database stream
      order. Returns ``(scores, kernel_s)``.
    - ``k`` set: all-gather only per-host top-k candidates and return
      ``(values, record_ids, kernel_s)``.

    ``engine_fn`` is forwarded to :func:`.multidevice.multi_device_search`.
    A process group this call creates is destroyed before it returns.
    """
    created = init_distributed(coordinator_address, num_processes, process_id)
    try:
        pid, nproc = (
            (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
        )
        encoded: list[np.ndarray] = []
        gids: list[int] = []
        n_total = 0
        if db_cache is not None:
            full = parse_file_cached(db_path, db_cache)
            n_total = full.n
            for i in range(pid, n_total, nproc):
                encoded.append(full.record(i))
                gids.append(i)
        else:
            for i, rec in enumerate(read_fasta(db_path)):
                n_total = i + 1
                if i % nproc == pid:
                    encoded.append(encode(rec.seq))
                    gids.append(i)

        db = _db_from_encoded(encoded)
        profile = make_profile(scoring.table, query_idx)
        go, ge = scoring.gap_open_total, scoring.gap_extend
        local_scores, kernel_s = multi_device_search(
            profile, db, go, ge, devices=local_devices(), engine_fn=engine_fn,
        )
        gid_arr = np.asarray(gids, dtype=np.int64)

        if nproc == 1:
            if k is None:
                return local_scores.astype(np.int32), kernel_s
            vals, ids = merge_topk_candidates(local_scores, gid_arr, k)
            return vals, ids, kernel_s

        if k is None:
            # Stripes differ by <= 1 record: pad to the common width, gather
            # (scores, global ids) from every host, scatter into stream order.
            m = -(-n_total // nproc)
            sc = np.full(m, np.iinfo(np.int32).min, dtype=np.int32)
            ids = np.full(m, -1, dtype=np.int64)
            sc[: db.n] = local_scores
            ids[: db.n] = gid_arr
            all_sc = _allgather(sc)
            all_ids = _allgather(ids)
            out = np.zeros(n_total, dtype=np.int32)
            valid = all_ids >= 0
            out[all_ids[valid]] = all_sc[valid]
            return out, kernel_s

        kk = min(k, max(db.n, 1))
        order = np.argsort(-local_scores, kind="stable")[:kk]
        cand_s = np.full(k, np.iinfo(np.int32).min, dtype=np.int32)
        cand_i = np.full(k, -1, dtype=np.int64)
        cand_s[: len(order)] = local_scores[order]
        cand_i[: len(order)] = gid_arr[order]
        all_s = _allgather(cand_s).reshape(-1)
        all_i = _allgather(cand_i).reshape(-1)
        keep = all_i >= 0
        vals, ids = merge_topk_candidates(all_s[keep], all_i[keep], k)
        return vals, ids, kernel_s
    finally:
        if created:
            dist.destroy_process_group()
