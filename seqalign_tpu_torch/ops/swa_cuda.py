"""The Smith-Waterman kernels for Hopper: the segmented-stream kernels for
one query (K1), a batch of queries (K3) and the row stripes of a long query
(K2); the fixed-batch kernel (K4) and its constant-S timing mode (K5); and
their plain PyTorch versions.

:func:`sw_stream` keeps the contract of ``seqalign_tpu.ops.swa_pallas.
sw_pallas_stream``: NW window streams, each a back-to-back concatenation of
'*'-padded lane-group segments (``seqalign_tpu.utils.packing.
pack_streams``), are scored against one query in a single launch, and every
segment's per-lane best lands in its output slot. A nonzero ``fs[j, w, 0]``
means a new segment starts at block ``j`` of window ``w``: the finished
segment's best goes to slot ``fs[j, w, 0] - 1`` and the window's DP state
resets. ``fs[L//jb - 1, w, 1]`` is 1 + the slot of the window's final
segment. Slots that no ``fs`` entry names stay zero.

The DP is the G-form recurrence of ``swa_pallas.py`` (valid for ge >= go),
in int32 throughout, on the biased profile ``P' = P - go``::

    H' = Gg_diag + P'[i, c]       E = max(Gg_up, E_up + ge)
    F  = max(Gg_left, F_left + ge) G = max(H', E, F, 0)      Gg = G + go

with the running best taken over G, and boundary Gg = go, E = F = 0.

:func:`sw_stream_multi` is the same search for ``nq`` queries at once
(``sw_pallas_stream`` with a 3-D profile): each query's DP is independent
and keeps its own best, so slot ``s`` of query ``q`` lands in
``out[s, q]``.

:func:`sw_stream_striped` scores a query of any length (the contract of
``sw_pallas_stream_striped``, K2): the query's rows are cut into stripes
(``convert.profile_stripes``) and each stripe is one launch over the same
streams (:func:`sw_stream_striped_pass`). A pass reads the previous
stripe's last row, ``(Gg, F)`` at every stream position, as its row -1 in
place of the boundary (Gg = go, F = 0), and writes its own last row for
the next pass; the passes' bests are max-merged. The boundary is a ``(2,
NW, L, win)`` int32 tensor: Gg in ``[0]``, F in ``[1]``, laid out like the
streams. A segment start resets a stripe's own rows and its diagonal seed
(Gg = go), not its row -1: the boundary there already belongs to the new
sequence.

:func:`sw_stream_striped_step` runs K2's block instance for
``parallel.sw_longpair``: tasks of a :class:`BlockTable`, each one block of
positions of one sub-pass over fixed windows with the sub-pass's left
column carried from block to block (one task's contract is its plain
version's, :func:`sw_stream_striped_block_reference`), in one launch per
instance, the lanes' bests max-merged.

The fixed-batch kernel keeps the contract of ``sw_pallas_windows``:
:func:`sw_windows` scores one query, or ``nq`` queries with a 3-D profile,
against NW equal-length '*'-padded windows, one database sequence per
lane; the DP state starts fresh at position 0 only, and each lane's best
comes out once, window-major (lane ``w * win + l``). With ``const_s`` (K5)
every substitution score is the biased constant 7, on every row the kernel
runs (the ``lqp`` rows of the profile, padded rows included): the DP loop
alone, for timing; its scores mean nothing. :func:`sw_windows_engine` is
the lane-batch engine interface over it (``sw_pallas_multi``: an unbiased
profile and an ``(Lb, B)`` batch), :func:`sw_window` its one-window form
(``sw_pallas``).

On a CUDA tensor each wrapper launches its kernel or raises: K1 and K3 the
one-pass kernel of ``csrc/sw_stream.cuh`` (a team of T threads per lane, the
query's rows in registers, no rolling-row scratch; :func:`stream_team`
picks T and R), or at one thread a lane its solo kernel
``csrc/sw_stream_solo.cu`` (Q queries a thread; :func:`stream_solo_queries`
picks Q), K2 ``csrc/sw_striped.cu`` (the same team step, a warp per
lane, over row stripes, and its block instance), K4 and K5
``csrc/sw_windows.cuh`` (K1's team design over fixed windows, each warp
stopping after its own lanes' last residue where that is exact;
:func:`windows_team` picks T and R for the batch's width). On a CPU
tensor it runs its plain version (:func:`sw_stream_reference`,
:func:`sw_stream_multi_reference`, :func:`sw_stream_striped_pass_reference`,
:func:`sw_stream_striped_step_reference`, :func:`sw_windows_reference`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..convert import ROW_ALIGN, batch_windows, profile_to_torch
from ..device import resolve_device
from ..host import PAD_INDEX

# The port's query-row limit for one launch: a team of 32 threads holds 32 x
# 48 rows, and its profile (4 KiB x R) 192 KiB of the 227 KiB a Hopper block
# may hold. Longer queries go to the row-striped kernel (K2,
# sw_stream_striped), whose launches take STRIPE_ROWS rows each.
MAX_QUERY_ROWS = 1536

# The one-pass kernel of K1 and K3 (csrc/sw_stream.cuh) scores a lane with
# a team of T threads, T one of STREAM_TEAMS, thread k holding R rows of the
# query in registers; it is built for each R of STREAM_ROWS_PER_THREAD_BUILT
# (T is a launch argument), and a launch runs stream_team's (T, R). Teams of
# one thread at the R of STREAM_SOLO_ROWS run the solo kernel instead
# (csrc/sw_stream_solo.cu, sw_stream_solo_kernel<R, Q>): one thread a lane
# scores Q queries of the launch, Q one of STREAM_SOLO_QUERIES[R]
# (stream_solo_queries picks it).
STREAM_TEAMS = (1, 2, 4, 8, 16, 32)
STREAM_ROWS_PER_THREAD_BUILT = (10, 12, 16, 18, 20, 24, 28, 32, 36, 40, 44, 48)
STREAM_SOLO_ROWS = (10, 12, 16, 18, 20, 24)
# The Q that ran K3 fastest at each solo R, over 8 and 64 queries of R rows
# (the R of lq 10, 12, 16, 17, 20 and 24) at Swiss-Prot scale on an H100
# (PERF.md; `swissprot --nq 8|64 --lq 10,12,16,17,20,24`, which timed Q =
# 1, 2 and 4 at every R): the instances' registers set how many warps an SM
# holds, so it is not monotonic in Q. Built are that Q and the smaller ones
# (for fewer queries); a new sweep needs the others added back here and in
# sw_stream_solo.cu's SW_SOLO_INSTANCES.
STREAM_SOLO_BEST_QUERIES = {10: 4, 12: 2, 16: 1, 18: 4, 20: 4, 24: 1}
STREAM_SOLO_QUERIES = {r: tuple(q for q in (1, 2, 4) if q <= best)
                       for r, best in STREAM_SOLO_BEST_QUERIES.items()}

# The striped kernel (K2, csrc/sw_striped.cu) scores a lane with one warp
# of STRIPE_TEAM threads, thread k holding R rows of the pass in registers;
# it is built for each R of STRIPE_ROWS_PER_THREAD_BUILT, and a pass runs
# the smallest that holds its rows (stripe_rows_per_thread).
STRIPE_TEAM = 32
STRIPE_ROWS_PER_THREAD_BUILT = (8, 16, 24, 32)
# R of a full pass, and its rows (a multiple of convert.ROW_ALIGN). On an
# H100 at lq=2000, R = 32 ran 1.07x faster than 24, 1.20x than 16 and 1.48x
# than 8 (PERF.md).
STRIPE_ROWS_PER_THREAD = 32
STRIPE_ROWS = STRIPE_TEAM * STRIPE_ROWS_PER_THREAD
# The team kernels (K1, K3 and K2) pack a step's fs slot from bit 11 of a
# signed int32 segment word (kSlotShift, csrc/sw_team.cuh), so a slot must
# stay below 2^20.
TEAM_MAX_SLOTS = 1 << 20

# Positions per kernel block, chained through registers per sweep over the
# query rows; the one block size the CUDA kernel is built for (the plain
# version takes any). On an H100 16 ran 1.35-1.9x faster than 8 at lq=144
# (PERF.md).
STREAM_JB = 16

ALPHA = 32

# Lanes of one window of the fixed-batch engine (sw_windows_engine): the
# JAX package's 1024-lane window.
FIXED_WINDOW_LANES = 1024

# The fixed-batch kernel of K4 and K5 (csrc/sw_windows.cuh) is K1's team
# design, built for the same R, with solo instances at the same R; a launch
# runs windows_team's (T, R), which fits the team to the batch's width.
WINDOWS_ROWS_PER_THREAD_BUILT = STREAM_ROWS_PER_THREAD_BUILT
WINDOWS_SOLO_ROWS = STREAM_SOLO_ROWS
# The SMs of an H100 SXM, the card windows_team fills unless told another,
# and the share of them a grid's full CTAs must reach to fill it: 4,096
# lanes in teams of 16 make 128 CTAs of 512 threads (97%), which ran
# fastest there on an H100 (PERF.md).
H100_SMS = 132
FILL_SHARE = 0.9

# K5's biased substitution score, on every row and position
# (swa_pallas.py:363).
CONST_S = 7


def supported_scoring(profile, go: int, ge: int) -> bool:
    """True if the stream kernel scores this (profile, gaps) pair exactly.

    The G-form needs ge >= go. Every attainable value must fit int32: G lies
    in [0, Lq * max(P, 0)] as long as ge <= 0 (a positive extend grows E
    with the database length, which no bound on the query covers), and the
    intermediate sums add at most |go|, |ge| and max|P - go| to that.
    Systems outside this envelope go to the wavefront engine.
    """
    if ge < go or ge > 0:
        return False
    prof = np.asarray(profile, dtype=np.int64)
    if prof.size == 0:
        return True
    lq = prof.shape[-2]
    bound = (
        lq * max(int(prof.max()), 0)
        + abs(int(go)) + abs(int(ge))
        + int(np.abs(prof - int(go)).max())
    )
    return bound < 2**31


def _check(profile_biased, streams, fs, go, ge, nslots, jb, *, multi=False):
    want = "(nq, rows, 32)" if multi else "(rows, 32)"
    if profile_biased.ndim != (3 if multi else 2) or profile_biased.shape[-1] != ALPHA:
        hint = (
            "; a 3-D (multi-query) profile goes to sw_stream_multi (K3)"
            if not multi and profile_biased.ndim == 3 else ""
        )
        raise ValueError(
            f"profile shape {tuple(profile_biased.shape)} != {want}{hint}"
        )
    if multi and profile_biased.shape[0] < 1:
        raise ValueError("a multi-query profile needs at least one query")
    if jb < 1:
        raise ValueError(f"jb={jb} is not positive")
    if streams.ndim != 3:
        raise ValueError(f"streams must be (NW, L, win), got {streams.shape}")
    nw, length, _ = streams.shape
    if length == 0 or length % jb:
        raise ValueError(f"stream length {length} not a positive multiple of {jb=}")
    if tuple(fs.shape) != (length // jb, nw, 2):
        raise ValueError(f"fs shape {tuple(fs.shape)} != {(length // jb, nw, 2)}")
    _check_rows_and_tensors(
        profile_biased, ("streams", streams), ("fs", fs, torch.int32), go=go, ge=ge
    )
    if fs.numel():
        lo, hi = torch.aminmax(fs)
        if int(lo) < 0 or int(hi) > nslots:
            raise ValueError(f"fs names slots outside [0, {nslots}]")


def _check_slots(nslots, kernel):
    if nslots >= TEAM_MAX_SLOTS:
        raise ValueError(
            f"nslots={nslots}: the {kernel} kernel's segment word holds slots "
            f"below {TEAM_MAX_SLOTS}"
        )


def stream_team(rows: int) -> tuple[int, int]:
    """``(T, R)`` of the one-pass launch (K1, K3) for ``rows`` query rows:
    the team of ``STREAM_TEAMS`` and the rows per thread of
    ``STREAM_ROWS_PER_THREAD_BUILT`` that hold them with the fewest padded
    rows ``T R``, and of those the smallest team (fewer shuffles and steps
    of fill and drain per cell)."""
    fits = [(t * r, t, r) for t in STREAM_TEAMS
            for r in STREAM_ROWS_PER_THREAD_BUILT if t * r >= rows]
    if not fits:
        raise ValueError(
            f"a query of {rows} rows exceeds the {STREAM_TEAMS[-1]} x "
            f"{STREAM_ROWS_PER_THREAD_BUILT[-1]} rows the K1/K3 kernel holds"
        )
    _, t, r = min(fits)
    return t, r


def stream_rows_stepped(rows: int, nq: int = 1) -> int:
    """The query rows a K1 or K3 launch of ``nq`` queries over ``rows`` rows
    steps on a card: :func:`stream_team`'s ``T R`` a query (the rows past
    ``rows`` as padding), a solo launch's queries filled up to a multiple
    of its Q."""
    t, r = stream_team(rows)
    if _solo((t, r)):
        q = stream_solo_queries(rows, nq)
        nq = -(-nq // q) * q
    return nq * t * r


def team_threads(rows_per_thread: int) -> int:
    """Threads of a full CTA of the one-pass team kernels (K1, K3, K4, K5)
    at R rows a thread: ``team_threads<R>()`` of ``csrc/sw_stream.cuh``, one
    CTA an SM."""
    return 384 if rows_per_thread >= 40 else 512


def windows_team(rows: int, lanes: int, sms: int = H100_SMS) -> tuple[int, int]:
    """``(T, R)`` of a K4 or K5 launch over ``rows`` query rows and
    ``lanes`` lanes (queries x windows x lanes a window).

    Among the built ``(T, R)`` that hold the rows, the fewest padded rows
    ``T R`` (then the smallest team) whose grid fills the card: ``lanes x
    T`` threads reach ``FILL_SHARE`` of ``sms`` CTAs of
    :func:`team_threads`. Where none does, every SM the grid reaches runs
    one CTA, and a lane's steps take R rows a thread: the fewest rows a
    thread (the R of the largest team), then the fewest padded rows. A
    wide batch takes K1's team (:func:`stream_team`); a narrow one wider
    teams of fewer rows a thread, so that its lanes still reach every SM.
    On an H100 this took the fastest team measured at each of 4,096,
    16,384 and 67,584 lanes and lq = 17, 144, 512 and 1536 (PERF.md).
    """
    fits = [(t, r) for t in STREAM_TEAMS for r in WINDOWS_ROWS_PER_THREAD_BUILT
            if t * r >= rows]
    if not fits:
        raise ValueError(
            f"a query of {rows} rows exceeds the {STREAM_TEAMS[-1]} x "
            f"{WINDOWS_ROWS_PER_THREAD_BUILT[-1]} rows the K4/K5 kernel holds"
        )
    full = [(t * r, t, r) for t, r in fits
            if lanes * t >= FILL_SHARE * sms * team_threads(r)]
    if full:
        _, t, r = min(full)
    else:
        _, _, t, r = min((r, t * r, t, r) for t, r in fits)
    return t, r


def windows_launch_team(profile_biased: torch.Tensor,
                        db_windows: torch.Tensor) -> tuple[int, int]:
    """:func:`windows_team`'s ``(T, R)`` for a :func:`sw_windows` launch on
    these tensors: all the profile's rows, every lane of every window and
    query, the SMs of the windows' card."""
    nq = profile_biased.shape[0] if profile_biased.ndim == 3 else 1
    nw, _, win = db_windows.shape
    sms = (torch.cuda.get_device_properties(db_windows.device).multi_processor_count
           if db_windows.device.type == "cuda" else H100_SMS)
    return windows_team(profile_biased.shape[-2], nq * nw * win, sms)


def windows_kernel_instance(rows: int, lanes: int, const_s: bool = False,
                            team: tuple[int, int] | None = None) -> str:
    """The template instance of ``csrc/sw_windows.cuh`` that a K4 (K5 with
    ``const_s``) launch over ``rows`` query rows and ``lanes`` lanes runs
    (``team`` or :func:`windows_team`'s choice), keyed as ``sass.kernel_key``
    keys it: ``sw_windows_kernel<R, kSolo, kConstS>``."""
    t, r = team or windows_team(rows, lanes)
    solo = t == 1 and r in WINDOWS_SOLO_ROWS
    flag = {False: "false", True: "true"}
    return f"sw_windows_kernel<{r}, {flag[solo]}, {flag[bool(const_s)]}>"


def stream_solo_queries(rows: int, nq: int) -> int:
    """Q, the queries a thread scores, of a K1 or K3 launch of ``nq``
    queries over ``rows`` rows where :func:`stream_team` picks a solo
    ``(1, R)`` (``R`` in ``STREAM_SOLO_ROWS``): the Q that ran fastest at
    that R (``STREAM_SOLO_BEST_QUERIES``, from the sweep of Q in {1, 2, 4}
    over every solo R at 8 and 64 queries, PERF.md call 6), but no more than
    ``nq``: the largest Q built at most ``nq`` (1 for one query)."""
    team = stream_team(rows)
    if not _solo(team):
        raise ValueError(f"{rows} rows run {team}, not a team of one thread")
    return max(q for q in STREAM_SOLO_QUERIES[team[1]] if q <= max(nq, 1))


def _solo(team: tuple[int, int]) -> bool:
    return team[0] == 1 and team[1] in STREAM_SOLO_ROWS


def stream_kernel_instance(rows: int, team: tuple[int, int] | None = None,
                           nq: int = 1, queries: int | None = None) -> str:
    """The kernel instance a K1 or K3 launch of ``nq`` queries over ``rows``
    query rows runs (``team`` or :func:`stream_team`'s (T, R); ``queries``
    or :func:`stream_solo_queries`'s Q), keyed as ``sass.kernel_key`` keys
    it: ``sw_stream_solo_kernel<R, Q>`` for a team of one thread at an R of
    ``STREAM_SOLO_ROWS``, else ``sw_stream_kernel<R, false>``."""
    t, r = team or stream_team(rows)
    if _solo((t, r)):
        q = queries or stream_solo_queries(t * r, nq)
        return f"sw_stream_solo_kernel<{r}, {q}>"
    return f"sw_stream_kernel<{r}, false>"


def _stream_rows(profile_biased, rows, team, queries=None) -> int:
    """The rows a K1 or K3 launch scores (``rows``, or all ``lqp``),
    checked with the forced ``team`` and ``queries``."""
    lqp = profile_biased.shape[-2]
    rows = lqp if rows is None else rows
    if not 0 <= rows <= lqp:
        raise ValueError(f"rows={rows} outside the profile's [0, {lqp}] rows")
    if team is not None:
        t, r = team
        if t not in STREAM_TEAMS or r not in STREAM_ROWS_PER_THREAD_BUILT or t * r < rows:
            raise ValueError(
                f"team={team}: K1/K3 run teams of {STREAM_TEAMS} threads of "
                f"{STREAM_ROWS_PER_THREAD_BUILT} rows, and a team must hold {rows} rows"
            )
    if queries is not None:
        t, r = team or stream_team(rows)
        if not _solo((t, r)) or queries not in STREAM_SOLO_QUERIES[r]:
            raise ValueError(
                f"queries={queries}: a thread scores several queries only in a "
                f"team of one thread at R in {STREAM_SOLO_ROWS} (here (T, R) = "
                f"{(t, r)}), Q one of STREAM_SOLO_QUERIES[R]"
            )
    return rows


def _check_rows_and_tensors(profile_biased, data, *others, go, ge):
    """The checks every kernel's inputs share: the profile's rows (a
    multiple of ``ROW_ALIGN``, at most ``MAX_QUERY_ROWS``), the database
    tensor ``data = (name, int8 tensor)`` and each ``(name, tensor, dtype)``
    of ``others`` of their type, on the database's device and contiguous,
    and ``ge >= go``."""
    lqp = profile_biased.shape[-2]
    if lqp % ROW_ALIGN:
        raise ValueError(f"profile rows {lqp} not a multiple of {ROW_ALIGN}")
    if lqp > MAX_QUERY_ROWS:
        raise NotImplementedError(
            f"query of {lqp} rows exceeds MAX_QUERY_ROWS={MAX_QUERY_ROWS} of "
            "one launch; longer queries go to sw_stream_striped (K2, row "
            "stripes) or the wavefront engine"
        )
    name, db = data
    for tname, t, dt in (
        ("profile", profile_biased, torch.int32), (name, db, torch.int8), *others
    ):
        if t.dtype != dt:
            raise ValueError(f"{tname} dtype {t.dtype} != {dt}")
        if t.device != db.device:
            raise ValueError(f"{tname} on {t.device}, {name} on {db.device}")
        if not t.is_contiguous():
            raise ValueError(f"{tname} is not contiguous")
    if ge < go:
        raise ValueError(f"G-form kernel requires ge >= go (got {go=}, {ge=})")


def sw_stream(
    profile_biased: torch.Tensor,
    streams: torch.Tensor,
    fs: torch.Tensor,
    go: int,
    ge: int,
    *,
    nslots: int,
    jb: int,
    team: tuple[int, int] | None = None,
    rows: int | None = None,
) -> torch.Tensor:
    """Score one query against segmented window streams in one launch.

    Args:
      profile_biased: ``(lqp, 32)`` int32 ``P - go`` (``convert.
        profile_to_torch``), ``lqp`` a multiple of ``ROW_ALIGN`` and at most
        ``MAX_QUERY_ROWS``.
      streams: ``(NW, L, win)`` int8 database streams, chars in 0..31.
      fs: ``(L//jb, NW, 2)`` int32 segment table (see module docstring).
      go, ge: total gap-open and gap-extend penalties, ``ge >= go``.
      nslots: number of output slots, below ``TEAM_MAX_SLOTS``.
      jb: positions per block; segment starts fall on block starts. The
        CUDA kernel takes only ``STREAM_JB``.
      team: ``(T, R)`` of the kernel launch, one of ``STREAM_TEAMS`` and one
        of ``STREAM_ROWS_PER_THREAD_BUILT`` whose team holds the rows; None
        for :func:`stream_team`'s. The plain version has no team.
      rows: the query rows to score, at most ``lqp`` (None: ``lqp``). The
        profile's rows from ``rows`` on must be padding that never raises a
        score (``P' <= -go``, as ``profile_to_torch`` and the pipeline's
        ``multi_profile`` pad), which the kernel skips; the plain version
        scores every row.

    Returns:
      ``(nslots, win)`` int32 per-segment best scores.
    """
    _check(profile_biased, streams, fs, go, ge, nslots, jb)
    _check_slots(nslots, "K1")
    rows = _stream_rows(profile_biased, rows, team)
    if streams.device.type == "cpu":
        return sw_stream_reference(
            profile_biased, streams, fs, go, ge, nslots=nslots, jb=jb
        )
    out = _launch_stream(profile_biased, streams, fs, go, ge, nslots, jb, team, rows)
    sw_stream.launches += 1
    return out


sw_stream.launches = 0


def sw_stream_multi(
    profile_biased: torch.Tensor,
    streams: torch.Tensor,
    fs: torch.Tensor,
    go: int,
    ge: int,
    *,
    nslots: int,
    jb: int,
    team: tuple[int, int] | None = None,
    rows: int | None = None,
    queries: int | None = None,
) -> torch.Tensor:
    """Score ``nq`` queries against the same segmented window streams in one
    launch (K3).

    Args:
      profile_biased: ``(nq, lqe, 32)`` int32 ``P - go`` (``convert.
        profile_to_torch`` of a 3-D profile), ``lqe`` a multiple of
        ``ROW_ALIGN`` and at most ``MAX_QUERY_ROWS``.
      streams, fs, go, ge, nslots, jb, team: as :func:`sw_stream`.
      rows: as :func:`sw_stream`, for every query.
      queries: Q, the queries one thread scores, where the launch's (T, R)
        is solo (a team of one thread at an R of ``STREAM_SOLO_ROWS``), one
        of ``STREAM_SOLO_QUERIES[R]``; None for
        :func:`stream_solo_queries`'s. For checks and timing, as ``team``;
        refused elsewhere. The plain version has no Q.

    Returns:
      ``(nslots, nq, win)`` int32 per-segment best scores of each query.
    """
    _check(profile_biased, streams, fs, go, ge, nslots, jb, multi=True)
    _check_slots(nslots, "K3")
    rows = _stream_rows(profile_biased, rows, team, queries)
    if streams.device.type == "cpu":
        return sw_stream_multi_reference(
            profile_biased, streams, fs, go, ge, nslots=nslots, jb=jb
        )
    out = _launch_stream(profile_biased, streams, fs, go, ge, nslots, jb, team, rows,
                         queries)
    sw_stream_multi.launches += 1
    return out


sw_stream_multi.launches = 0


def _check_bnd(name, bnd, streams):
    if bnd is None:
        return
    want = (2, *streams.shape)
    if tuple(bnd.shape) != want:
        raise ValueError(f"{name} shape {tuple(bnd.shape)} != {want}")
    if bnd.dtype != torch.int32 or bnd.device != streams.device:
        raise ValueError(f"{name} must be int32 on {streams.device}")
    if not bnd.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def stripe_rows_per_thread(rows: int) -> int:
    """R of the K2 instance a pass of ``rows`` rows launches: the smallest
    of ``STRIPE_ROWS_PER_THREAD_BUILT`` whose team holds them."""
    for r in STRIPE_ROWS_PER_THREAD_BUILT:
        if STRIPE_TEAM * r >= rows:
            return r
    raise ValueError(
        f"a K2 pass of {rows} rows exceeds the {STRIPE_TEAM} x "
        f"{STRIPE_ROWS_PER_THREAD_BUILT[-1]} rows its kernel holds"
    )


def stripe_rows_stepped(rows: int) -> int:
    """The rows a K2 pass over ``rows`` rows steps on a card: its warp's
    ``STRIPE_TEAM`` x :func:`stripe_rows_per_thread` rows."""
    return STRIPE_TEAM * stripe_rows_per_thread(rows)


def stripe_kernel_instance(rows: int, bnd_in: bool, bnd_out: bool,
                           rows_per_thread: int | None = None) -> str:
    """The template instance of ``csrc/sw_striped.cu`` that a pass of
    ``rows`` rows launches (``launch_rows``' choice), keyed as ``sass.
    kernel_key`` keys it: ``sw_stream_striped_kernel<R, kIn, kOut,
    kPartial>``, kPartial where the pass writes a last row that sits inside
    a thread."""
    r = rows_per_thread or stripe_rows_per_thread(rows)
    flags = (bnd_in, bnd_out, bnd_out and rows % r != 0)
    return (f"sw_stream_striped_kernel<{r}, "
            + ", ".join("true" if f else "false" for f in flags) + ">")


def sw_stream_striped_pass(
    profile_biased: torch.Tensor,
    streams: torch.Tensor,
    fs: torch.Tensor,
    go: int,
    ge: int,
    *,
    nslots: int,
    jb: int,
    bnd_in: torch.Tensor | None = None,
    bnd_out: torch.Tensor | None = None,
    rows_per_thread: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One row stripe of a long query against the streams, in one launch
    (one pass of K2).

    Args:
      profile_biased: ``(rows, 32)`` int32 biased stripe
        (``convert.profile_stripes``), as :func:`sw_stream` takes it; the
        CUDA kernel takes at most ``STRIPE_TEAM`` x the largest of
        ``STRIPE_ROWS_PER_THREAD_BUILT`` rows (1024) in a pass.
      streams, fs, go, ge, jb: as :func:`sw_stream`.
      nslots: as :func:`sw_stream`.
      bnd_in: ``(2, NW, L, win)`` int32 ``(Gg, F)`` of the previous
        stripe's last row, or None for the first stripe (row -1 is then the
        boundary Gg = go, F = 0).
      bnd_out: ``(2, NW, L, win)`` int32 tensor this pass overwrites with
        its own last row's ``(Gg, F)``, or None for the last stripe. At
        least one of ``bnd_in`` and ``bnd_out`` is given: a pass with
        neither is a one-stripe query, :func:`sw_stream`'s work.
      rows_per_thread: R of the kernel instance to launch, one of
        ``STRIPE_ROWS_PER_THREAD_BUILT`` whose team holds the rows; None
        for :func:`stripe_rows_per_thread`'s. The plain version has no R.

    Returns:
      ``((nslots, win)`` int32 per-segment bests over this stripe's rows,
      ``bnd_out)``.
    """
    _check(profile_biased, streams, fs, go, ge, nslots, jb)
    _check_bnd("bnd_in", bnd_in, streams)
    _check_bnd("bnd_out", bnd_out, streams)
    if bnd_in is None and bnd_out is None:
        raise ValueError(
            "a pass with no boundary in or out is a one-stripe query: "
            "use sw_stream (K1)"
        )
    _check_slots(nslots, "K2")
    rows = profile_biased.shape[0]
    if rows_per_thread is not None:
        _stripe_r(rows, rows_per_thread)
    if streams.device.type == "cpu":
        return sw_stream_striped_pass_reference(
            profile_biased, streams, fs, go, ge, nslots=nslots, jb=jb,
            bnd_in=bnd_in, bnd_out=bnd_out,
        )
    if rows == 0:
        raise ValueError("a K2 pass needs at least one row")
    out, dims = _cuda_out(profile_biased, streams, nslots, jb)
    _call(
        "sw_stream_striped", streams.device, profile_biased.data_ptr(),
        streams.data_ptr(), fs.data_ptr(), out.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (bnd_in, bnd_out)),
        *dims, jb, int(go), int(ge),
        rows_per_thread or stripe_rows_per_thread(rows),
    )
    sw_stream_striped_pass.launches += 1
    return out, bnd_out


sw_stream_striped_pass.launches = 0


def sw_stream_striped(
    stripes: list[torch.Tensor],
    streams: torch.Tensor,
    fs: torch.Tensor,
    go: int,
    ge: int,
    *,
    nslots: int,
    jb: int,
) -> torch.Tensor:
    """Score a query of any length, one launch of K2 per row stripe.

    Args:
      stripes: the query's biased row stripes in order
        (``convert.profile_stripes``); every stripe but the last is all
        real rows, since its last row is the next pass's boundary.
      streams, fs, go, ge, nslots, jb: as :func:`sw_stream`.

    Returns:
      ``(nslots, win)`` int32 per-segment best scores: the max over the
      passes (G's running max over disjoint row sets). One stripe is one
      launch of :func:`sw_stream`. ``sw_stream_striped.calls`` counts the
      calls; the launches are counted by the pass.
    """
    sw_stream_striped.calls += 1
    if len(stripes) == 1:
        return sw_stream(stripes[0], streams, fs, go, ge, nslots=nslots, jb=jb)
    return _striped(sw_stream_striped_pass, stripes, streams, fs, go, ge, nslots, jb)


sw_stream_striped.calls = 0


def _striped(pass_fn, stripes, streams, fs, go, ge, nslots, jb) -> torch.Tensor:
    """Run ``pass_fn`` over the stripes, the boundary ping-ponging between
    two arrays allocated once, and max-merge the passes' bests."""
    if not stripes:
        raise ValueError("a striped search needs at least one stripe")
    bnd = None
    if len(stripes) > 1:
        bnd = torch.empty((2, 2, *streams.shape), dtype=torch.int32,
                          device=streams.device)
    best = None
    for p, stripe in enumerate(stripes):
        out, _ = pass_fn(
            stripe, streams, fs, go, ge, nslots=nslots, jb=jb,
            bnd_in=bnd[(p - 1) % 2] if p > 0 else None,
            bnd_out=bnd[p % 2] if p < len(stripes) - 1 else None,
        )
        best = out if best is None else torch.maximum(best, out)
    return best


def _cuda_out(prof, streams, nslots, jb) -> tuple[torch.Tensor, tuple]:
    """The zeroed ``(nslots, [nq,] win)`` output of a stream kernel launch on
    checked tensors and the launch's ``(lqp, L, win, nw)``; raise on another
    device or block size."""
    if streams.device.type != "cuda":
        raise ValueError(f"no stream kernel for device {streams.device}")
    if jb != STREAM_JB:
        raise ValueError(f"the CUDA kernel is built for jb={STREAM_JB}, got {jb=}")
    nw, length, win = streams.shape
    out = torch.zeros((nslots, *prof.shape[:-2], win), dtype=torch.int32,
                      device=streams.device)
    return out, (prof.shape[-2], length, win, nw)


def _launch_stream(prof, streams, fs, go, ge, nslots, jb, team, rows,
                   queries=None) -> torch.Tensor:
    """Launch the one-pass kernel (K1 for a 2-D profile, K3 for a 3-D one)
    over ``rows`` rows at ``team`` or :func:`stream_team`'s (T, R): the solo
    kernel at ``queries`` or :func:`stream_solo_queries`'s Q where (T, R)
    is solo, else the team kernel; no scratch."""
    out, (lqp, *dims) = _cuda_out(prof, streams, nslots, jb)
    t, r = team or stream_team(rows)
    nq = prof.shape[0] if prof.ndim == 3 else 1
    args = (prof.data_ptr(), streams.data_ptr(), fs.data_ptr(), out.data_ptr(), lqp,
            rows, *dims, nq, jb, int(go), int(ge))
    if _solo((t, r)):
        _call("sw_stream_solo", streams.device, *args, r,
              queries or stream_solo_queries(t * r, nq))
    else:
        _call("sw_stream", streams.device, *args, t, r)
    return out


def _call(name, dev, *args) -> None:
    """Call ``{name}_launch`` of the kernel library on ``dev``'s current
    stream; raise on a refused launch."""
    from . import _build

    lib = _build.load()
    with torch.cuda.device(dev):
        err = getattr(lib, f"{name}_launch")(
            *args, torch.cuda.current_stream(dev).cuda_stream
        )
    if err:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({_build.error_string(err)})"
        )


def sw_stream_reference(
    profile_biased: torch.Tensor,
    streams: torch.Tensor,
    fs: torch.Tensor,
    go: int,
    ge: int,
    *,
    nslots: int,
    jb: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`sw_stream`, same contract."""
    _check(profile_biased, streams, fs, go, ge, nslots, jb)
    sw_stream_reference.calls += 1
    return _wavefront(profile_biased[None], streams, fs, go, ge, nslots, jb)[:, 0]


sw_stream_reference.calls = 0


def sw_stream_multi_reference(
    profile_biased: torch.Tensor,
    streams: torch.Tensor,
    fs: torch.Tensor,
    go: int,
    ge: int,
    *,
    nslots: int,
    jb: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`sw_stream_multi`, same contract."""
    _check(profile_biased, streams, fs, go, ge, nslots, jb, multi=True)
    sw_stream_multi_reference.calls += 1
    return _wavefront(profile_biased, streams, fs, go, ge, nslots, jb)


sw_stream_multi_reference.calls = 0


def sw_stream_striped_pass_reference(
    profile_biased: torch.Tensor,
    streams: torch.Tensor,
    fs: torch.Tensor,
    go: int,
    ge: int,
    *,
    nslots: int,
    jb: int,
    bnd_in: torch.Tensor | None = None,
    bnd_out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version of :func:`sw_stream_striped_pass`, same
    contract."""
    _check(profile_biased, streams, fs, go, ge, nslots, jb)
    _check_bnd("bnd_in", bnd_in, streams)
    _check_bnd("bnd_out", bnd_out, streams)
    sw_stream_striped_pass_reference.calls += 1
    out = _wavefront(
        profile_biased[None], streams, fs, go, ge, nslots, jb, bnd_in, bnd_out
    )
    return out[:, 0], bnd_out


sw_stream_striped_pass_reference.calls = 0


def sw_stream_striped_reference(
    stripes: list[torch.Tensor],
    streams: torch.Tensor,
    fs: torch.Tensor,
    go: int,
    ge: int,
    *,
    nslots: int,
    jb: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`sw_stream_striped`, same contract:
    the plain pass over every stripe."""
    sw_stream_striped_reference.calls += 1
    return _striped(
        sw_stream_striped_pass_reference, stripes, streams, fs, go, ge,
        nslots, jb,
    )


sw_stream_striped_reference.calls = 0


def _stripe_r(rows: int, rows_per_thread: int | None) -> int:
    """R of the K2 instance for ``rows`` rows: ``rows_per_thread``,
    checked, or :func:`stripe_rows_per_thread`'s."""
    if rows_per_thread is None:
        return stripe_rows_per_thread(rows)
    if rows_per_thread not in STRIPE_ROWS_PER_THREAD_BUILT or STRIPE_TEAM * rows_per_thread < rows:
        raise ValueError(
            f"rows_per_thread={rows_per_thread}: K2 is built for "
            f"{STRIPE_ROWS_PER_THREAD_BUILT}, and a team must hold {rows} rows"
        )
    return rows_per_thread


def block_kernel_instance(rows: int, bnd_out: bool,
                          rows_per_thread: int | None = None) -> str:
    """The template instance of ``csrc/sw_striped.cu`` that a block task of
    a sub-pass of ``rows`` rows launches (``launch_block_rows``' choice),
    keyed as ``sass.kernel_key`` keys it: ``sw_striped_block_kernel<R,
    kOut, kPartial>``, kPartial where the task writes a last row that sits
    inside a thread. Row -1 is chosen at run time (no kIn)."""
    r, out, partial = _block_key(rows, bnd_out, rows_per_thread)
    return f"sw_striped_block_kernel<{r}, {str(out).lower()}, {str(partial).lower()}>"


def _block_key(rows, bnd_out, rows_per_thread=None) -> tuple[int, bool, bool]:
    r = _stripe_r(rows, rows_per_thread)
    return r, bool(bnd_out), bool(bnd_out) and rows % r != 0


def left_column(rows: int, windows: torch.Tensor,
                rows_per_thread: int | None = None) -> torch.Tensor:
    """An uninitialised left column for a sub-pass of ``rows`` rows over
    ``windows``: ``(2, R, NW, win, 32)`` int32, row ``k R + r`` of window
    ``w``, lane ``l`` at ``[:, r, w, l, k]`` (``(Gg, E)``), so the 32
    threads of a warp touch 32 consecutive words. Words of rows past
    ``rows`` are never read or written."""
    nw, _, win = windows.shape
    r = _stripe_r(rows, rows_per_thread)
    return torch.empty((2, r, nw, win, STRIPE_TEAM), dtype=torch.int32, device=windows.device)


def team_profile(stripe: torch.Tensor, rows_per_thread: int) -> torch.Tensor:
    """``stripe`` ``(rows, 32)`` as a CTA of K2's block instance holds it in
    shared memory: ``(32, R, 32)`` int32, ``[c, r, k] = stripe[k R + r,
    c]``, 0 past the stripe's rows, so the CTA loads it with one coalesced
    copy."""
    r = rows_per_thread
    padded = torch.zeros((STRIPE_TEAM * r, ALPHA), dtype=torch.int32, device=stripe.device)
    padded[:stripe.shape[0]] = stripe
    return padded.view(STRIPE_TEAM, r, ALPHA).permute(2, 1, 0).contiguous()


def _check_block(stripe, windows, go, ge, j0, j1, bnd_in, bnd_out, left_in, left_out,
                 rows_per_thread=None):
    if stripe.ndim != 2 or stripe.shape[1] != ALPHA:
        raise ValueError(f"stripe shape {tuple(stripe.shape)} != (rows, 32)")
    if stripe.shape[0] == 0:
        raise ValueError("a block needs at least one row")
    if windows.ndim != 3:
        raise ValueError(f"windows must be (NW, L, win), got {tuple(windows.shape)}")
    nw, length, win = windows.shape
    if length == 0 or length % STREAM_JB:
        raise ValueError(f"window length {length} not a positive multiple of {STREAM_JB}")
    if not 0 <= j0 < j1 <= length or j0 % STREAM_JB or j1 % STREAM_JB:
        raise ValueError(
            f"block [{j0}, {j1}) is not a nonempty range of multiples of "
            f"{STREAM_JB} inside [0, {length}]"
        )
    _check_rows_and_tensors(stripe, ("windows", windows), go=go, ge=ge)
    _check_bnd("bnd_in", bnd_in, windows)
    _check_bnd("bnd_out", bnd_out, windows)
    want = (2, _stripe_r(stripe.shape[0], rows_per_thread), nw, win, STRIPE_TEAM)
    for name, t in (("left_in", left_in), ("left_out", left_out)):
        if t is None:
            continue
        if tuple(t.shape) != want:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {want}")
        if t.dtype != torch.int32 or t.device != windows.device:
            raise ValueError(f"{name} must be int32 on {windows.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


class BlockTask(NamedTuple):
    """One task of K2's block instance: block ``[j0, j1)`` of one sub-pass,
    the arguments of :func:`sw_stream_striped_block_reference` but the
    windows and penalties, which a :class:`BlockTable` holds."""

    stripe: torch.Tensor
    j0: int
    j1: int
    bnd_in: torch.Tensor | None = None
    bnd_out: torch.Tensor | None = None
    left_in: torch.Tensor | None = None
    left_out: torch.Tensor | None = None
    rows_per_thread: int | None = None


# Words of 64 bits a task takes in the table on the device (BlockTask of
# csrc/sw_striped.cu): five pointers, (lqp, j0), (j1, 0), padding.
BLOCK_TASK_WORDS = 8


class BlockTable:
    """Tasks of K2's block instance over one set of windows, checked once;
    on a card also packed into one int64 tensor on the device
    (``BLOCK_TASK_WORDS`` a task), which the kernel reads, with each
    stripe's :func:`team_profile` (one per stripe and R, however many
    blocks share it). ``keys[i]`` is task ``i``'s instance ``(R, kOut,
    kPartial)``: one launch runs a run of tasks of one key.

    ``ends`` ``(NW, win)`` int32 (:func:`lane_ends`), or None: with ends,
    every task stops each lane at its end, as
    :func:`sw_stream_striped_block_reference` says. That is exact only
    where every '*' score of the stripes is at most 0 (and ``ge <= 0``,
    which ``_check_rows_and_tensors`` enforces); the caller decides."""

    def __init__(self, windows: torch.Tensor, tasks: list[BlockTask], go: int, ge: int,
                 ends: torch.Tensor | None = None):
        for t in tasks:
            _check_block(t.stripe, windows, go, ge, t.j0, t.j1, t.bnd_in, t.bnd_out,
                         t.left_in, t.left_out, t.rows_per_thread)
        _check_ends(ends, windows)
        self.windows, self.tasks, self.go, self.ge = windows, list(tasks), int(go), int(ge)
        self.ends = ends
        self.keys = [_block_key(t.stripe.shape[0], t.bnd_out is not None, t.rows_per_thread)
                     for t in tasks]
        self.words, self.profiles = None, {}
        if windows.device.type == "cuda" and tasks:
            words = np.zeros((len(tasks), BLOCK_TASK_WORDS), dtype=np.int64)
            for i, (t, (r, _, _)) in enumerate(zip(tasks, self.keys)):
                key = (t.stripe.data_ptr(), t.stripe.shape[0], r)
                if key not in self.profiles:
                    self.profiles[key] = team_profile(t.stripe, r)
                words[i, :5] = [0 if a is None else a.data_ptr() for a in (
                    self.profiles[key], t.bnd_in, t.bnd_out, t.left_in, t.left_out)]
            ints = words.view(np.int32)
            ints[:, 10] = [t.stripe.shape[0] for t in tasks]
            ints[:, 11] = [t.j0 for t in tasks]
            ints[:, 12] = [t.j1 for t in tasks]
            self.words = torch.from_numpy(words).to(windows.device)


def _check_ends(ends, windows):
    if ends is None:
        return
    nw, length, win = windows.shape
    if tuple(ends.shape) != (nw, win) or ends.dtype != torch.int32 \
            or ends.device != windows.device or not ends.is_contiguous():
        raise ValueError(f"ends must be a contiguous ({nw}, {win}) int32 tensor on "
                         f"{windows.device}")
    if ends.numel():
        lo, hi = torch.aminmax(ends)
        if int(lo) < 0 or int(hi) > length:
            raise ValueError(f"ends outside [0, {length}]")


def _check_step(table, lo, hi, best):
    if not 0 <= lo <= hi <= len(table.tasks):
        raise ValueError(f"tasks [{lo}, {hi}) outside the table's {len(table.tasks)}")
    nw, _, win = table.windows.shape
    if tuple(best.shape) != (nw, win) or best.dtype != torch.int32 \
            or best.device != table.windows.device or not best.is_contiguous():
        raise ValueError(f"best must be a contiguous ({nw}, {win}) int32 tensor on "
                         f"{table.windows.device}")


def sw_stream_striped_step(table: BlockTable, lo: int, hi: int,
                           best: torch.Tensor) -> torch.Tensor:
    """Tasks ``lo .. hi - 1`` of ``table``, one step of ``sw_longpair``'s
    pipeline: each task's block as :func:`sw_stream_striped_block_reference`
    computes it, its lanes' bests max-merged into ``best`` ``(NW, win)`` int32 (in
    place, returned). The tasks must not touch each other's words: no task
    writes what another reads or writes (the bests aside), so the kernel
    runs them at once and the plain version in table order, with one
    result.

    On a card, one launch of K2's block instance (``sw_striped_block_
    kernel``) per run of tasks of one instance (``table.keys``), each task a
    z slice of the grid; ``sw_stream_striped_step.launches`` counts them. On
    the CPU, the plain version (:func:`sw_stream_striped_step_reference`).
    """
    _check_step(table, lo, hi, best)
    dev = table.windows.device
    if dev.type == "cpu":
        return sw_stream_striped_step_reference(table, lo, hi, best)
    if dev.type != "cuda":
        raise ValueError(f"no block kernel for device {dev}")
    nw, length, win = table.windows.shape
    first = lo
    while first < hi:
        end = first + 1
        while end < hi and table.keys[end] == table.keys[first]:
            end += 1
        r, out, partial = table.keys[first]
        _call(
            "sw_striped_block", dev,
            table.words.data_ptr() + first * BLOCK_TASK_WORDS * 8, end - first,
            table.windows.data_ptr(), 0 if table.ends is None else table.ends.data_ptr(),
            best.data_ptr(), length, win, nw, table.go, table.ge, r, int(out), int(partial),
        )
        sw_stream_striped_step.launches += 1
        first = end
    return best


sw_stream_striped_step.launches = 0


def sw_stream_striped_step_reference(table: BlockTable, lo: int, hi: int,
                                     best: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`sw_stream_striped_step`, same
    contract: :func:`sw_stream_striped_block_reference` over the tasks in
    table order (with the table's ends), each block's bests max-merged into
    ``best`` where the lane reaches the block (the kernel's dead lanes
    merge nothing)."""
    _check_step(table, lo, hi, best)
    sw_stream_striped_step_reference.calls += 1
    for t in table.tasks[lo:hi]:
        out, _, _ = sw_stream_striped_block_reference(
            t.stripe, table.windows, table.go, table.ge, j0=t.j0, j1=t.j1,
            bnd_in=t.bnd_in, bnd_out=t.bnd_out, left_in=t.left_in, left_out=t.left_out,
            rows_per_thread=t.rows_per_thread, ends=table.ends)
        merged = torch.maximum(best, out)
        best.copy_(merged if table.ends is None else torch.where(table.ends > t.j0, merged, best))
    return best


sw_stream_striped_step_reference.calls = 0


def sw_stream_striped_block_reference(
    stripe: torch.Tensor,
    windows: torch.Tensor,
    go: int,
    ge: int,
    *,
    j0: int,
    j1: int,
    bnd_in: torch.Tensor | None = None,
    bnd_out: torch.Tensor | None = None,
    left_in: torch.Tensor | None = None,
    left_out: torch.Tensor | None = None,
    rows_per_thread: int | None = None,
    ends: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """One block of positions ``[j0, j1)`` of one row stripe against fixed
    windows: the plain PyTorch version of one task of K2's block instance
    (``sw_striped_block_kernel``, launched by :func:`sw_stream_striped_step`
    for a :class:`BlockTable` of tasks).

    Each lane of a window is one database sequence from position 0, as
    ``convert.batch_windows`` lays them out; there is no segment table. The
    block continues the DP of the blocks before it through the stripe's
    left column and reads the stripe above it through ``bnd_in``; chained
    over the blocks of a stripe, it computes what one pass of
    :func:`sw_stream_striped_pass` over one segment per lane computes.

    Args:
      stripe: ``(rows, 32)`` int32 biased stripe (``convert.
        profile_stripes``); the kernel takes at most ``STRIPE_TEAM`` x the
        largest of ``STRIPE_ROWS_PER_THREAD_BUILT`` rows (1024).
      windows: ``(NW, L, win)`` int8 windows, chars in 0..31, ``L`` a
        multiple of ``STREAM_JB``.
      go, ge: total gap-open and gap-extend penalties, ``ge >= go``.
      j0, j1: the block, multiples of ``STREAM_JB``, ``0 <= j0 < j1 <= L``.
      bnd_in: ``(2, NW, L, win)`` int32 ``(Gg, F)`` of the stripe above's
        last row; read inside ``[j0, j1)`` and, as the corner of row 0's
        diagonal, at ``j0 - 1``. None: row -1 is the boundary (Gg = go,
        F = 0).
      bnd_out: ``(2, NW, L, win)`` int32, written with the last row's ``(Gg,
        F)`` inside ``[j0, j1)`` only; None writes nothing.
      left_in: the left column (:func:`left_column`: ``(2, R, NW, win,
        32)`` int32, coalesced) holding every row's ``(Gg, E)`` at position
        ``j0 - 1`` (the previous block's ``left_out``); None: the boundary
        Gg = go, E = 0, as at position 0.
      left_out: a left column of the same shape, written with every row's
        ``(Gg, E)`` at ``j1 - 1``; it may be ``left_in`` itself. None
        writes nothing.
      rows_per_thread: R of the instance, as :func:`sw_stream_striped_pass`
        takes it; it also sets the left column's shape.
      ends: ``(NW, win)`` int32, each lane's end (:func:`lane_ends`), or
        None to run every position. With ends, lane ``l`` runs only its
        ``n_l = min(j1 - j0, round_up_2(end_l - j0))`` first positions of
        the block (none where ``end_l <= j0``): its bests are over those,
        ``bnd_out`` is written only inside ``[j0, j0 + n_l)``, and
        ``left_out`` only where ``n_l = j1 - j0``. Every other word is left
        as it was, as the kernel leaves it.

    Returns:
      ``((NW, win)`` int32 best G of each lane over the block's cells,
      ``bnd_out``, ``left_out)``.

    An anti-diagonal wavefront over the block: step ``d`` computes the cells
    ``(i, j0 + d - i)`` of every window and lane. A row keeps its state
    until its first position in the block, so there it reads the left
    column, and after its last, so that it ends holding ``j1 - 1``'s.
    State is laid out ``(row, window, lane)``.
    """
    _check_block(stripe, windows, go, ge, j0, j1, bnd_in, bnd_out, left_in, left_out,
                 rows_per_thread)
    _check_ends(ends, windows)
    sw_stream_striped_block_reference.calls += 1
    dev = windows.device
    rows = stripe.shape[0]
    nw, length, win = windows.shape
    n = j1 - j0
    # Each lane's positions of the block (nw, win): a step's two at a time.
    n_lane = (torch.full((nw, win), n, dtype=torch.int64, device=dev) if ends is None
              else ((ends.long() - j0 + 1) // 2 * 2).clamp(0, n))
    shape = (rows, nw, win)
    # Row i of the left column at [:, i % R, :, :, i // R].
    r_per = _stripe_r(rows, rows_per_thread)
    iota = torch.arange(rows, device=dev)
    at = (iota % r_per, slice(None), slice(None), iota // r_per)
    if left_in is None:
        gg1 = torch.full(shape, go, dtype=torch.int32, device=dev)
        e1 = torch.zeros(shape, dtype=torch.int32, device=dev)
    else:  # (Gg, E) at j0 - 1, as (row, window, lane)
        gg1, e1 = left_in[0][at].clone(), left_in[1][at].clone()
    f1 = torch.zeros(shape, dtype=torch.int32, device=dev)
    gg2 = gg1  # the state one diagonal earlier
    best = torch.zeros((nw, win), dtype=torch.int32, device=dev)
    go_row = torch.full((1, nw, win), go, dtype=torch.int32, device=dev)
    zero_row = torch.zeros((1, nw, win), dtype=torch.int32, device=dev)
    w_idx = torch.arange(nw, device=dev)[None, :]
    row_base = (iota * ALPHA)[:, None, None]
    prof_flat = stripe.reshape(-1)

    def top(k, j):  # bnd_in[k] at position j as a (1, nw, win) row
        return bnd_in[k][:, j][None]

    for d in range(n + rows - 1):
        j = d - iota  # each row's position in the block
        v = (j >= 0)[:, None, None] & (j[:, None, None] < n_lane)
        jc = (j0 + j.clamp(0, n - 1))[:, None]  # (rows, 1)
        chars = windows[w_idx, jc].long() & (ALPHA - 1)  # (rows, nw, win)
        s = prof_flat[row_base + chars]
        # Row 0 at position j0 + d: row -1 is the boundary, or the stripe
        # above; its diagonal at j0 is the corner.
        if bnd_in is None or d >= n:
            top_gg, top_f, top_diag = go_row, zero_row, go_row
        else:
            top_gg, top_f = top(0, j0 + d), top(1, j0 + d)
            top_diag = top(0, j0 + d - 1) if j0 + d > 0 else go_row
        gg_diag = torch.cat([top_diag, gg2[:-1]], dim=0)
        hp = gg_diag + s
        e = torch.maximum(gg1, e1 + ge)
        f = torch.maximum(torch.cat([top_gg, gg1[:-1]], dim=0),
                          torch.cat([top_f, f1[:-1]], dim=0) + ge)
        g = torch.maximum(torch.maximum(hp, e), torch.clamp_min(f, 0))
        jl = d - rows + 1  # the last row's position
        if bnd_out is not None and 0 <= jl < n:
            on = jl < n_lane
            bnd_out[0][:, j0 + jl] = torch.where(on, g[-1] + go, bnd_out[0][:, j0 + jl])
            bnd_out[1][:, j0 + jl] = torch.where(on, f[-1], bnd_out[1][:, j0 + jl])
        best = torch.maximum(best, torch.where(v, g, 0).amax(dim=0))
        gg2 = gg1
        gg1 = torch.where(v, g + go, gg1)
        e1 = torch.where(v, e, e1)
        f1 = torch.where(v, f, f1)
    if left_out is not None:
        full = n_lane == n
        left_out[0][at] = torch.where(full, gg1, left_out[0][at])
        left_out[1][at] = torch.where(full, e1, left_out[1][at])
    return best, bnd_out, left_out


sw_stream_striped_block_reference.calls = 0


def _check_windows(profile_biased, db_windows, go, ge):
    if profile_biased.ndim not in (2, 3) or profile_biased.shape[-1] != ALPHA:
        raise ValueError(
            f"profile shape {tuple(profile_biased.shape)} is not (rows, 32) "
            "or (nq, rows, 32)"
        )
    if profile_biased.ndim == 3 and profile_biased.shape[0] < 1:
        raise ValueError("a multi-query profile needs at least one query")
    if db_windows.ndim != 3:
        raise ValueError(
            f"db_windows must be (NW, Lb, win), got {tuple(db_windows.shape)}"
        )
    nw, length, win = db_windows.shape
    if nw < 1 or win < 1:
        raise ValueError(f"db_windows shape {tuple(db_windows.shape)} is empty")
    if length == 0 or length % STREAM_JB:
        raise ValueError(
            f"db length {length} not a positive multiple of {STREAM_JB} "
            "(pad with '*', as convert.batch_windows does)"
        )
    _check_rows_and_tensors(profile_biased, ("db_windows", db_windows), go=go, ge=ge)


def sw_windows(
    profile_biased: torch.Tensor,
    db_windows: torch.Tensor,
    go: int,
    ge: int,
    *,
    const_s: bool = False,
    team: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Score one query, or a batch, against fixed windows in one launch (K4;
    K5 with ``const_s``).

    Args:
      profile_biased: ``(lqp, 32)`` or ``(nq, lqp, 32)`` int32 ``P - go``
        (``convert.profile_to_torch``), ``lqp`` a multiple of ``ROW_ALIGN``
        and at most ``MAX_QUERY_ROWS``. K5 reads only its shape.
      db_windows: ``(NW, Lb, win)`` int8 windows, chars in 0..31,
        '*'-padded, ``Lb`` a positive multiple of ``STREAM_JB``
        (``convert.batch_windows``).
      go, ge: total gap-open and gap-extend penalties, ``ge >= go``; the
        kernel also needs ``ge <= 0`` (each of a team's rows past ``lqp``
        would add ``ge`` to K4's best).
      const_s: K5: every substitution score is the biased ``CONST_S`` = 7
        on all ``lqp`` rows and every position.
      team: ``(T, R)`` of the kernel launch, one of ``STREAM_TEAMS`` and one
        of ``WINDOWS_ROWS_PER_THREAD_BUILT`` whose team holds the rows; None
        for :func:`windows_team`'s. The plain version has no team.

    Returns:
      ``(NW * win,)`` int32 best scores in window-major lane order, or
      ``(nq, NW * win)`` for a 3-D profile. ``sw_windows.launches`` counts
      K4's launches, ``sw_windows.launches_const_s`` K5's.

    The kernel stops each warp after the last residue of its own lanes
    where that is exact (every row's '*' score at most 0; never for K5),
    and keeps no DP state in device memory.
    """
    _check_windows(profile_biased, db_windows, go, ge)
    lqp = profile_biased.shape[-2]
    if team is not None:
        t, r = team
        if t not in STREAM_TEAMS or r not in WINDOWS_ROWS_PER_THREAD_BUILT or t * r < lqp:
            raise ValueError(
                f"team={team}: K4/K5 run teams of {STREAM_TEAMS} threads of "
                f"{WINDOWS_ROWS_PER_THREAD_BUILT} rows, and a team must hold {lqp} rows"
            )
    if db_windows.device.type == "cpu":
        return sw_windows_reference(
            profile_biased, db_windows, go, ge, const_s=const_s
        )
    if ge > 0:
        raise ValueError(
            f"the fixed-batch kernel needs ge <= 0 (got {ge=}): each of a team's "
            "rows past the query's would add ge to the best"
        )
    dev = db_windows.device
    if dev.type != "cuda":
        raise ValueError(f"no fixed-batch kernel for device {dev}")
    nq = profile_biased.shape[0] if profile_biased.ndim == 3 else 1
    nw, length, win = db_windows.shape
    t, r = team or windows_launch_team(profile_biased, db_windows)
    out = torch.empty(
        (*profile_biased.shape[:-2], nw * win), dtype=torch.int32, device=dev
    )
    _call(
        "sw_windows", dev, profile_biased.data_ptr(), db_windows.data_ptr(),
        out.data_ptr(), lqp, length, win, nw, nq, int(const_s), STREAM_JB,
        int(go), int(ge), t, r,
    )
    if const_s:
        sw_windows.launches_const_s += 1
    else:
        sw_windows.launches += 1
    return out


sw_windows.launches = 0
sw_windows.launches_const_s = 0


def lane_ends(db_windows: torch.Tensor) -> torch.Tensor:
    """``(NW, win)`` int64: 1 + each lane's last position holding a char
    other than '*' (0 for an all-'*' lane)."""
    live = db_windows != PAD_INDEX
    last = db_windows.shape[1] - live.flip(1).to(torch.uint8).argmax(dim=1).long()
    return torch.where(live.any(dim=1), last, 0)


def warp_ends(db_windows: torch.Tensor, team: tuple[int, int]) -> torch.Tensor:
    """``(NW, win)`` int64: the end at which the kernel stops each lane, as
    modelled from the batch (the kernel reports none), its warp's end: the
    largest :func:`lane_ends` of the ``32 / T`` lanes of its
    warp (lanes past the window's last add nothing), rounded up to a step's
    2 positions."""
    ends = lane_ends(db_windows)
    nw, win = ends.shape
    per_warp = max(1, 32 // team[0])
    pad = -win % per_warp
    warp = torch.nn.functional.pad(ends, (0, pad)).reshape(nw, -1, per_warp)
    warp = (warp.amax(dim=2, keepdim=True) + 1) // 2 * 2
    return warp.expand(-1, -1, per_warp).reshape(nw, -1)[:, :win]


def windows_cells(db_windows: torch.Tensor, rows: int, team: tuple[int, int],
                  skip: bool = True) -> dict[str, int]:
    """The DP cells of a K4 or K5 launch over ``db_windows`` at ``rows``
    query rows (one query) and ``team`` ``(T, R)``, a model counted from
    the batch (the kernel counts none; its time shows whether it skips):
    ``real``, rows x each lane's end (:func:`lane_ends`); ``run``, rows x
    each lane's warp end (:func:`warp_ends`), or the batch's length where
    the kernel does not ``skip`` (K5, or a '*' score above 0); and
    ``batch``, rows x every batch cell. The team's fill and drain steps,
    ``T - 1`` a lane, are not counted."""
    nw, length, win = db_windows.shape
    run = int(warp_ends(db_windows, team).sum()) if skip else nw * length * win
    return {"real": rows * int(lane_ends(db_windows).sum()), "run": rows * run,
            "batch": rows * nw * length * win}


def sw_windows_reference(
    profile_biased: torch.Tensor,
    db_windows: torch.Tensor,
    go: int,
    ge: int,
    *,
    const_s: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`sw_windows`, same contract: the
    stream version's body with one segment per window."""
    _check_windows(profile_biased, db_windows, go, ge)
    sw_windows_reference.calls += 1
    prof = profile_biased if profile_biased.ndim == 3 else profile_biased[None]
    if const_s:
        prof = torch.full_like(prof, CONST_S)
    nw, length, win = db_windows.shape
    fs = torch.zeros(
        (length // STREAM_JB, nw, 2), dtype=torch.int32, device=db_windows.device
    )
    fs[-1, :, 1] = torch.arange(1, nw + 1, dtype=torch.int32)
    out = _wavefront(prof, db_windows, fs, go, ge, nw, STREAM_JB)
    out = out.permute(1, 0, 2).reshape(prof.shape[0], nw * win)
    return out if profile_biased.ndim == 3 else out[0]


sw_windows_reference.calls = 0


def sw_windows_engine(profile, db, go: int, ge: int) -> torch.Tensor:
    """The fixed-batch kernel behind the lane-batch engine interface
    (``sw_pallas_multi``): ``fn(profile, db, go, ge) -> (B,)`` scores.

    Args:
      profile: ``(Lq, 32)`` unbiased query profile (numpy or tensor).
      db: ``(Lb, B)`` lane batch, ``B`` a multiple of
        ``FIXED_WINDOW_LANES``, split into windows on the host for numpy and
        on its device for a tensor; or window-stacked ``(NW, Lb, win)``.
        ``Lb`` is padded with '*' to ``STREAM_JB``. A numpy batch runs on
        ``device.resolve_device()``'s device.
      go, ge: total gap-open and gap-extend penalties.

    Returns:
      ``(NW * win,)`` int32 scores, lane order. Raises on a 3-D profile
      (:func:`sw_windows` takes it), a query over ``MAX_QUERY_ROWS`` rows
      and a scoring system outside :func:`supported_scoring`: such inputs
      go to the wavefront engine, never silently.
    """
    prof = np.asarray(profile.cpu() if isinstance(profile, torch.Tensor) else profile)
    if prof.ndim != 2:
        raise ValueError(
            "sw_windows_engine is the single-query adapter; call sw_windows "
            "directly for a 3-D (multi-query) profile"
        )
    if prof.shape[0] > MAX_QUERY_ROWS:
        raise NotImplementedError(
            f"query of {prof.shape[0]} rows exceeds MAX_QUERY_ROWS="
            f"{MAX_QUERY_ROWS} of the fixed-batch kernel; use the wavefront "
            "engine"
        )
    if not supported_scoring(prof, go, ge):
        raise ValueError(
            f"scoring system outside the kernel's int32 G-form envelope (it "
            f"needs ge >= go, ge <= 0, no int32 overflow; got {go=}, {ge=}); "
            "use the wavefront engine"
        )
    device = db.device if isinstance(db, torch.Tensor) else resolve_device()
    windows = batch_windows(db, FIXED_WINDOW_LANES, STREAM_JB, device)
    return sw_windows(profile_to_torch(prof, go, device), windows, go, ge)


def sw_window(profile, db, go: int, ge: int) -> torch.Tensor:
    """One ``(Lb, win)`` window through :func:`sw_windows_engine`
    (``sw_pallas``); ``Lb`` of any length, padded with '*'."""
    if db.ndim != 2:
        raise ValueError(f"db must be one (Lb, win) window, got {tuple(db.shape)}")
    return sw_windows_engine(profile, db[None], go, ge)


def _wavefront(
    prof, streams, fs, go, ge, nslots, jb, bnd_in=None, bnd_out=None
) -> torch.Tensor:
    """The plain versions' body: ``(nq, lqp, 32)`` profile -> ``(nslots, nq,
    win)``.

    An anti-diagonal wavefront over every query and every window's whole
    stream at once: step ``d`` computes the cells ``(i, j = d - i)`` of all
    queries, windows and lanes. Row 0 of each query sees the row -1
    boundary (Gg = go, F = 0) on its left and diagonal sides; a position
    that starts a segment sees it (Gg = go, E = 0) on its up and diagonal
    sides; each cell's G is max-reduced into its segment's best. State is
    laid out ``(row, window, query, lane)``.

    For one query (``nq == 1``), ``bnd_in`` replaces row -1 with a stripe
    boundary: row 0 at position ``j`` reads ``(Gg, F) = bnd_in[:, w, j]`` on
    its left side and ``bnd_in[0, w, j - 1]`` on its diagonal (still ``go``
    where ``j`` starts a segment); ``bnd_out`` receives the last row's
    ``(Gg, F)`` at every position.
    """
    dev = streams.device
    nq, lqp, _ = prof.shape
    nw, length, win = streams.shape
    nj = length // jb
    out = torch.zeros((nslots, nq, win), dtype=torch.int32, device=dev)
    if lqp == 0 or nw == 0 or nq == 0:
        return out

    # Segment of every block and position; a flagged block starts one.
    starts = fs[:, :, 0] > 0  # (nj, nw)
    seg_blk = torch.cumsum(starts.long(), dim=0)  # (nj, nw)
    seg = seg_blk.repeat_interleave(jb, dim=0).T.contiguous()  # (nw, L)
    fresh = torch.zeros((nw, length), dtype=torch.bool, device=dev)
    fresh[:, ::jb] = starts.T
    fresh[:, 0] = True
    nseg = int(seg_blk[-1].max()) + 1
    # Slot of every (segment, window): a start flag names the slot of the
    # segment before it; fs[last, w, 1] names the final segment's.
    slot_of = torch.full((nseg, nw), -1, dtype=torch.long, device=dev)
    jj, ww = torch.nonzero(starts, as_tuple=True)
    slot_of[seg_blk[jj, ww] - 1, ww] = fs[jj, ww, 0].long() - 1
    wall = torch.arange(nw, device=dev)
    last = fs[nj - 1, :, 1]
    ends = last > 0
    slot_of[seg_blk[-1, ends], wall[ends]] = last[ends].long() - 1

    prof_flat = prof.reshape(-1)
    iota = torch.arange(lqp, device=dev)
    qs = torch.arange(nq, device=dev)
    # Flat index of P'[q, i, 0], laid out (row, 1, query, 1).
    row_base = ((qs[None, :] * lqp + iota[:, None]) * ALPHA)[:, None, :, None]
    w_idx = wall[None, :]
    best = torch.zeros((nseg, nw, nq, win), dtype=torch.int32, device=dev)
    go_row = torch.full((1, nw, nq, win), go, dtype=torch.int32, device=dev)
    zero_row = torch.zeros((1, nw, nq, win), dtype=torch.int32, device=dev)

    def down(x, fill):  # out[i] = x[i-1], out[0] = the row -1 boundary
        return torch.cat([fill, x[:-1]], dim=0)

    def bnd_row(k, j):  # bnd_in[k] at position j as a (1, nw, 1, win) row
        return bnd_in[k][:, min(max(j, 0), length - 1)][None, :, None, :]

    shape = (lqp, nw, nq, win)
    gg1 = torch.full(shape, go, dtype=torch.int32, device=dev)  # diagonal d-1
    e1 = torch.zeros(shape, dtype=torch.int32, device=dev)
    f1 = torch.zeros(shape, dtype=torch.int32, device=dev)
    gg2 = gg1  # Gg on diagonal d-2
    for d in range(length + lqp - 1):
        j = d - iota
        jc = j.clamp(0, length - 1)[:, None]  # (lqp, 1)
        chars = streams[w_idx, jc].long() & (ALPHA - 1)  # (lqp, nw, win)
        s = prof_flat[row_base + chars[:, :, None, :]]
        new = fresh[w_idx, jc][:, :, None, None]  # (lqp, nw, 1, 1)
        gg_up = torch.where(new, go, gg1)
        e_up = torch.where(new, 0, e1)
        # Row 0 at position d: row -1 is the boundary, or the stripe above.
        if bnd_in is None:
            top_gg, top_f, top_diag = go_row, zero_row, go_row
        else:
            top_gg, top_f, top_diag = bnd_row(0, d), bnd_row(1, d), bnd_row(0, d - 1)
        gg_diag = torch.where(new, go, down(gg2, top_diag))
        hp = gg_diag + s
        e = torch.maximum(gg_up, e_up + ge)
        f = torch.maximum(down(gg1, top_gg), down(f1, top_f) + ge)
        g = torch.maximum(torch.maximum(hp, e), torch.clamp_min(f, 0))
        jl = d - lqp + 1  # the last row's position
        if bnd_out is not None and 0 <= jl < length:
            bnd_out[0][:, jl] = g[-1, :, 0] + go
            bnd_out[1][:, jl] = f[-1, :, 0]
        valid = ((j >= 0) & (j < length))[:, None, None, None]
        best.scatter_reduce_(
            0,
            seg[w_idx, jc][:, :, None, None].expand(shape),
            torch.where(valid, g, 0),
            reduce="amax",
        )
        gg2, gg1, e1, f1 = gg1, g + go, e, f

    flushed = slot_of >= 0
    out[slot_of[flushed]] = best[flushed]
    return out
