"""The port's sequence-parallel long pair (``seqalign_tpu_torch.parallel.
sw_longpair``) and K2's block instance (``swa_cuda.sw_stream_striped_step``,
one task's plain version ``sw_stream_striped_block_reference``) against the JAX package on the CPU: the port runs on ``[cpu] * D`` (the
block's plain version), the JAX package on the 8 CPU devices ``conftest.py``
forces. Every comparison is exact (int32, tolerance 0). The tests marked
``cuda`` run the kernel and skip without a card."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from seqalign_tpu import parallel as jax_parallel
from seqalign_tpu.models import ScoringModel, load_builtin
from seqalign_tpu.ops.swa_xla import make_profile, sw_wavefront
from seqalign_tpu.parallel.longpair import sw_longpair as jax_sw_longpair
from seqalign_tpu.parallel.sharding import make_mesh as jax_make_mesh
from seqalign_tpu_torch import parallel
from seqalign_tpu_torch.convert import batch_windows, profile_stripes
from seqalign_tpu_torch.ops import swa_cuda
from seqalign_tpu_torch.parallel import longpair, make_mesh, sw_longpair

from _torch_cases import SCORINGS, make_scoring
from conftest import random_protein

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SEQALIGN_PLATFORM", "cpu")


def _case(sc, rng, lq, lb, b):
    """A profile and a '*'-padded (lb, b) lane batch, as TestLongPair
    makes them."""
    prof = make_profile(sc.table, sc.query_indices(random_protein(rng, lq)))
    db = np.full((lb, b), 31, dtype=np.int32)
    for lane in range(b):
        s = sc.query_indices(random_protein(rng, int(rng.integers(1, lb))))
        db[: len(s), lane] = s
    return prof, db


def _port(prof, db, sc, mesh, **kw):
    return sw_longpair(prof, db, sc.gap_open_total, sc.gap_extend, mesh, **kw).cpu().numpy()


def test_all_equals_the_jax_package():
    assert parallel.__all__ == jax_parallel.__all__


@pytest.mark.parametrize("lq,lb,b,jb", [(100, 333, 16, 32), (7, 500, 8, 64)])
def test_matches_jax_on_eight_entries(lq, lb, b, jb):
    """TestLongPair.test_matches_wavefront's shapes: 8 entries (at lq=7 one
    row each and the last entry none)."""
    sc = make_scoring("BLOSUM62")
    prof, db = _case(sc, np.random.default_rng(lq), lq, lb, b)
    go, ge = sc.gap_open_total, sc.gap_extend
    got = _port(prof, db, sc, [CPU] * 8, jb=jb)
    np.testing.assert_array_equal(
        got, np.asarray(jax_sw_longpair(prof, db, go, ge, jax_make_mesh(jax.devices()[:8]), jb=jb)))
    np.testing.assert_array_equal(got, np.asarray(sw_wavefront(prof, db, go, ge)))


@pytest.mark.parametrize("lq,lb,b,jb", [(100, 333, 16, 32), (50, 200, 13, 64)])
def test_2d_mesh_data_by_seq(lq, lb, b, jb):
    """The 2 x 4 data x seq mesh; 13 lanes do not split evenly over 2."""
    sc = make_scoring("BLOSUM62")
    prof, db = _case(sc, np.random.default_rng(lq + b), lq, lb, b)
    go, ge = sc.gap_open_total, sc.gap_extend
    mesh = [[CPU] * 4 for _ in range(2)]
    got = _port(prof, db, sc, mesh, jb=jb, axis="seq", data_axis="data")
    jmesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "seq"))
    want = jax_sw_longpair(prof, db, go, ge, jmesh, jb=jb, axis="seq", data_axis="data")
    assert got.shape == (b,)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, np.asarray(sw_wavefront(prof, db, go, ge)))


def test_single_entry_mesh():
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(23)
    prof = make_profile(sc.table, sc.query_indices(random_protein(rng, 23)))
    db = np.full((100, 8), 31, dtype=np.int32)
    for lane in range(8):
        s = sc.query_indices(random_protein(rng, 60))
        db[: len(s), lane] = s
    go, ge = sc.gap_open_total, sc.gap_extend
    got = _port(prof, db, sc, make_mesh([CPU], axis="q"))
    np.testing.assert_array_equal(
        got, np.asarray(jax_sw_longpair(prof, db, go, ge, jax_make_mesh(jax.devices()[:1]))))
    np.testing.assert_array_equal(got, np.asarray(sw_wavefront(prof, db, go, ge)))


@pytest.mark.parametrize("n,two_d", [(2, False), (3, False), (2, True), (4, True)])
def test_dry_run_block(n, two_d):
    """The JAX package's multichip dry run: a random table, lq=16, lb=24,
    8 lanes an entry, gaps -3 / -1, jb=8 (one 16-position block here); its
    2-D mesh on an even count."""
    rng = np.random.default_rng(0)
    table = rng.integers(-8, 12, (32, 32)).astype(np.int32)
    table[31, :] = -4
    table[:, 31] = -4
    profile = make_profile(table, rng.integers(1, 27, 16))
    db = rng.integers(1, 27, (24, 8 * n)).astype(np.int32)
    if two_d:
        got = sw_longpair(profile, db, -3, -1, [[CPU] * (n // 2)] * 2, jb=8,
                          axis="seq", data_axis="data").numpy()
        jmesh = Mesh(np.array(jax.devices()[:n]).reshape(2, n // 2), ("data", "seq"))
        want = jax_sw_longpair(profile, db, -3, -1, jmesh, jb=8, axis="seq", data_axis="data")
    else:
        got = sw_longpair(profile, db, -3, -1, [CPU] * n, jb=8, axis="db").numpy()
        want = jax_sw_longpair(profile, db, -3, -1, jax_make_mesh(jax.devices()[:n]),
                               jb=8, axis="db")
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, np.asarray(sw_wavefront(profile, db, -3, -1)))


@pytest.mark.parametrize("jb", [1, 8, 16, 17, 48, 1000])
def test_scores_do_not_depend_on_jb(jb):
    sc = make_scoring("PAM250")
    prof, db = _case(sc, np.random.default_rng(5), 30, 70, 6)
    want = np.asarray(sw_wavefront(prof, db, sc.gap_open_total, sc.gap_extend))
    np.testing.assert_array_equal(_port(prof, db, sc, [CPU] * 3, jb=jb), want)


@pytest.mark.parametrize("stripe_rows,subs", [(8, (3, 3)), (4, (6, 5))])
def test_stripes_run_as_sub_passes(monkeypatch, stripe_rows, subs):
    """A query of more than 2 x STRIPE_ROWS rows on 2 entries: the
    entries' 24 and 19 rows run as sub-passes of STRIPE_ROWS rows (the
    last 3 rows padded to 4). Four or more sub-passes read, at each
    block's first position, a boundary row written a block earlier."""
    monkeypatch.setattr(swa_cuda, "STRIPE_ROWS", stripe_rows)
    sc = make_scoring("BLOSUM62")
    prof, db = _case(sc, np.random.default_rng(44), 43, 90, 7)
    go, ge = sc.gap_open_total, sc.gap_extend
    calls = swa_cuda.sw_stream_striped_block_reference.calls
    steps = swa_cuda.sw_stream_striped_step_reference.calls
    got = _port(prof, db, sc, [CPU] * 2, jb=32)
    # 3 blocks (L = 96) x the entries' sub-passes, in one plain step call
    # per entry and step it has tasks in: sub-passes + blocks - 1 an entry.
    assert swa_cuda.sw_stream_striped_block_reference.calls - calls == 3 * sum(subs)
    assert swa_cuda.sw_stream_striped_step_reference.calls - steps == sum(n + 2 for n in subs)
    np.testing.assert_array_equal(got, np.asarray(sw_wavefront(prof, db, go, ge)))
    np.testing.assert_array_equal(
        got, np.asarray(jax_sw_longpair(prof, db, go, ge, jax_make_mesh(jax.devices()[:2]),
                                        jb=32)))


# Query rows per STRIPE_ROWS and seq entries: 5-6 sub-passes an entry
# (at 4 rows: 22 rows on one entry, 24 + 21 on two, 24 x 3 + 18 on four).
_STAGED_LQ = {1: 22, 2: 45, 4: 90}


def _mesh(shape):
    """[cpu] x s for (s,), a d x s data x seq mesh for (d, s)."""
    if len(shape) == 1:
        return [CPU] * shape[0], {}, jax_make_mesh(jax.devices()[:shape[0]])
    d, s = shape
    return ([[CPU] * s for _ in range(d)], dict(axis="seq", data_axis="data"),
            Mesh(np.array(jax.devices()[:d * s]).reshape(d, s), ("data", "seq")))


@pytest.mark.parametrize("stripe_rows", [4, 8])
@pytest.mark.parametrize("shape", [(1,), (2,), (4,), (2, 2)])
def test_staged_schedule_matches_jax(monkeypatch, stripe_rows, shape):
    """The staged schedule with 5-6 sub-passes an entry, on 1-, 2- and
    4-entry meshes and the 2 x 2 data x seq mesh: every score equals JAX's
    sw_longpair on the same mesh and sw_wavefront; every task runs once,
    in one plain step call per entry and step it has tasks in."""
    monkeypatch.setattr(swa_cuda, "STRIPE_ROWS", stripe_rows)
    sc = make_scoring("BLOSUM62")
    lq = _STAGED_LQ[shape[-1]] * stripe_rows // 4
    prof, db = _case(sc, np.random.default_rng(lq + len(shape)), lq, 90, 13)
    go, ge = sc.gap_open_total, sc.gap_extend
    mesh, kw, jmesh = _mesh(shape)
    grid = mesh if len(shape) == 2 else [mesh]
    slices, _, _ = longpair._pipeline(prof, db, go, ge, grid, 32)
    subs = [len(ent.subs) for sl in slices for ent in sl]
    assert all(5 <= n <= 6 for n in subs)
    calls = swa_cuda.sw_stream_striped_block_reference.calls
    steps = swa_cuda.sw_stream_striped_step_reference.calls
    got = _port(prof, db, sc, mesh, jb=32, **kw)
    assert swa_cuda.sw_stream_striped_block_reference.calls - calls == 3 * sum(subs)
    assert swa_cuda.sw_stream_striped_step_reference.calls - steps == sum(n + 2 for n in subs)
    np.testing.assert_array_equal(got, np.asarray(sw_wavefront(prof, db, go, ge)))
    np.testing.assert_array_equal(
        got, np.asarray(jax_sw_longpair(prof, db, go, ge, jmesh, jb=32, **kw)))


@pytest.mark.parametrize("shape,stripe_rows,jb", [
    ((1,), 8, 32), ((2,), 4, 32), ((4,), 4, 16), ((2, 2), 8, 48), ((3,), 1024, 16),
])
def test_task_table_schedule(monkeypatch, shape, stripe_rows, jb):
    """sw_longpair's plan, host only (nothing launched): steps = stages +
    blocks - 1 for each data slice; at each step no two tasks or edge
    copies write the same words, and none reads what another writes;
    every word a task or copy reads was written at an earlier step (a
    task's edge block by its entry's copy of the same step, which runs
    before the step's launch on the entry's stream); each boundary word is
    written once, all of them by the end; an entry's tasks of a step form
    at most two runs of one instance (launches)."""
    monkeypatch.setattr(swa_cuda, "STRIPE_ROWS", stripe_rows)
    sc = make_scoring("PAM250")
    lq = _STAGED_LQ.get(shape[-1], 50)
    prof, db = _case(sc, np.random.default_rng(7), lq, 90, 6)
    mesh, _, _ = _mesh(shape)
    grid = mesh if len(shape) == 2 else [mesh]
    slices, n_steps, _ = longpair._pipeline(prof, db, sc.gap_open_total, sc.gap_extend, grid, jb)
    length = 96
    n_blocks = -(-length // (-(-jb // 16) * 16))
    for sl in slices:
        assert n_steps == sum(len(ent.subs) for ent in sl) + n_blocks - 1

    def span(arr, j0, j1):
        return {(arr.data_ptr(), j) for j in range(j0, j1)}

    def left(arr):
        return set() if arr is None else {(arr.data_ptr(), "left")}

    written = set()
    for t in range(n_steps):
        ops = []  # (reads, writes, the words the op's entry copied first)
        for sl in slices:
            for k, ent in enumerate(sl):
                lo, hi, edge = ent.steps[t]
                copied = set()
                if edge is not None:
                    copied = span(ent.edge_in, *edge)
                    ops.append((span(sl[k - 1].edge_out, *edge), copied, set()))
                keys = ent.table.keys[lo:hi]
                assert sum(i == 0 or keys[i] != keys[i - 1] for i in range(len(keys))) <= 2
                for task in ent.table.tasks[lo:hi]:
                    reads = left(task.left_in)
                    if task.bnd_in is not None:
                        reads |= span(task.bnd_in, max(task.j0 - 1, 0), task.j1)
                    writes = left(task.left_out)
                    if task.bnd_out is not None:
                        writes |= span(task.bnd_out, task.j0, task.j1)
                    ops.append((reads, writes, copied))
        for i, (reads, writes, copied) in enumerate(ops):
            assert reads <= written | copied
            bnd = {w for w in writes if w[1] != "left"}
            assert not bnd & written
            for j, (reads2, writes2, copied2) in enumerate(ops):
                if i != j:
                    assert not writes & writes2
                    assert not (writes - copied2) & reads2
        written |= set().union(*(w for _, w, _ in ops))
    for sl in slices:
        for ent in sl:
            for arr in ent.inner + [a for a in (ent.edge_in, ent.edge_out) if a is not None]:
                assert span(arr, 0, length) <= written


def test_left_column_layout():
    """Row k R + r of window w, lane l sits at word ((r NW + w) win + l) 32
    + k of each plane: one block's left column at R = 8 and at R = 16 holds
    the same rows there, and words past the stripe's rows stay as they
    were."""
    sc = make_scoring("BLOSUM62")
    go, ge = sc.gap_open_total, sc.gap_extend
    prof, db = _case(sc, np.random.default_rng(9), 40, 48, 6)
    windows = batch_windows(db.astype(np.int8), 3, swa_cuda.STREAM_JB, CPU)  # 2 x 3 lanes
    nw, _, win = windows.shape
    (stripe,) = profile_stripes(prof, go, 40, CPU)
    flat = {}
    for r in (8, 16):
        col = swa_cuda.left_column(40, windows, rows_per_thread=r)
        assert col.shape == (2, r, nw, win, 32)
        col.fill_(-99)
        swa_cuda.sw_stream_striped_block_reference(stripe, windows, go, ge, j0=0, j1=48,
                                                   left_out=col, rows_per_thread=r)
        i = torch.arange(40)[:, None, None]
        w = torch.arange(nw)[None, :, None]
        lane = torch.arange(win)[None, None, :]
        word = (((i % r) * nw + w) * win + lane) * 32 + i // r
        flat[r] = col.reshape(2, -1)[:, word]
        untouched = torch.ones(col.reshape(2, -1).shape[1], dtype=torch.bool)
        untouched[word.reshape(-1)] = False
        assert (col.reshape(2, -1)[:, untouched] == -99).all()
    assert torch.equal(flat[8], flat[16])
    assert (flat[8] != -99).all()


@pytest.mark.parametrize("rows,r", [(40, 8), (92, 8), (1024, 32), (560, 24)])
def test_team_profile_is_the_shared_layout(rows, r):
    """The profile a block task's CTA copies into shared memory: row k R +
    r of char c at word (c R + r) 32 + k, zero past the stripe's rows."""
    stripe = torch.from_numpy(np.random.default_rng(rows).integers(
        -9, 9, (rows, 32), dtype=np.int32))
    team = swa_cuda.team_profile(stripe, r)
    assert team.shape == (32, r, 32) and team.is_contiguous()
    flat = team.reshape(-1)
    i = torch.arange(32 * r)[:, None]
    c = torch.arange(32)[None, :]
    want = torch.zeros((32 * r, 32), dtype=torch.int32)
    want[:rows] = stripe
    assert torch.equal(flat[(c * r + i % r) * 32 + i // r], want)


def _step_tasks(dev, rng):
    """Four independent tasks over one set of windows, of three instances
    (K2 block tasks at R = 8 with and without a partial last row, one at R
    = 16 without a boundary out), and copies of their outputs: a first
    sub-pass without a boundary in, a block with a carried left column in
    place, a partial sub-pass of 12 rows, a last sub-pass of 40 rows."""
    sc = make_scoring("PAM250")
    go, ge = sc.gap_open_total, sc.gap_extend
    prof, db = _case(sc, rng, 76, 64, 6)
    windows = batch_windows(db.astype(np.int8), 6, swa_cuda.STREAM_JB, dev)
    a, b, c = profile_stripes(prof[:24], go, 24, dev)[0], \
        profile_stripes(prof[24:36], go, 12, dev)[0], profile_stripes(prof[36:], go, 40, dev)[0]

    def rand(shape):
        return torch.from_numpy(rng.integers(-4, 40, shape, dtype=np.int32)).to(dev)

    bnd = (2, *windows.shape)

    def make():
        return [
            swa_cuda.BlockTask(a, 0, 32, None, rand(bnd), None, rand((2, 8, 1, 6, 32))),
            swa_cuda.BlockTask(a, 32, 64, rand(bnd), rand(bnd), *[rand((2, 8, 1, 6, 32))] * 2),
            swa_cuda.BlockTask(b, 16, 48, rand(bnd), rand(bnd), *[rand((2, 8, 1, 6, 32))] * 2),
            swa_cuda.BlockTask(c, 0, 64, rand(bnd), None, None, rand((2, 16, 1, 6, 32)),
                               rows_per_thread=16),
        ]
    return windows, go, ge, make()


def _clone(tasks):
    """The tasks with every tensor they write cloned (in-place columns
    stay in place)."""
    out = []
    for t in tasks:
        left = t.left_out.clone() if t.left_out is not None else None
        out.append(t._replace(
            bnd_out=None if t.bnd_out is None else t.bnd_out.clone(),
            left_in=left if t.left_in is t.left_out else t.left_in, left_out=left))
    return out


def test_step_wrapper_on_cpu_is_the_plain_version():
    """sw_stream_striped_step on CPU tensors is its plain version, no
    launch: one step of four tasks of three instances, each block's bests
    max-merged into one best; the independent tasks give the same result
    in any table order."""
    windows, go, ge, tasks = _step_tasks(CPU, np.random.default_rng(12))
    results = []
    for order in (tasks, _clone(tasks)[::-1], _clone(tasks)):
        table = swa_cuda.BlockTable(windows, order, go, ge)
        best = torch.zeros((1, 6), dtype=torch.int32)
        launches = swa_cuda.sw_stream_striped_step.launches
        calls = swa_cuda.sw_stream_striped_step_reference.calls
        blocks = swa_cuda.sw_stream_striped_block_reference.calls
        fn = (swa_cuda.sw_stream_striped_step if len(results) < 2
              else swa_cuda.sw_stream_striped_step_reference)
        assert fn(table, 0, 4, best) is best
        assert swa_cuda.sw_stream_striped_step.launches == launches
        assert swa_cuda.sw_stream_striped_step_reference.calls - calls == 1
        assert swa_cuda.sw_stream_striped_block_reference.calls - blocks == 4
        by_task = sorted(order, key=lambda t: (t.stripe.shape[0], t.j0))
        results.append([best] + [x for t in by_task for x in (t.bnd_out, t.left_out)
                                 if x is not None])
    assert [k for k in swa_cuda.BlockTable(windows, tasks, go, ge).keys] == [
        (8, True, False), (8, True, False), (8, True, True), (16, False, False)]
    for other in results[1:]:
        assert all(torch.equal(x, y) for x, y in zip(results[0], other))
    # The bests are the blocks' own, max-merged.
    assert results[0][0].max() > 0


def test_step_rejects_malformed_input():
    windows, go, ge, tasks = _step_tasks(CPU, np.random.default_rng(13))
    table = swa_cuda.BlockTable(windows, tasks, go, ge)
    for lo, hi, best in ((0, 5, torch.zeros((1, 6), dtype=torch.int32)),
                         (2, 1, torch.zeros((1, 6), dtype=torch.int32)),
                         (0, 4, torch.zeros((6,), dtype=torch.int32)),
                         (0, 4, torch.zeros((1, 6), dtype=torch.int64))):
        with pytest.raises(ValueError):
            swa_cuda.sw_stream_striped_step(table, lo, hi, best)
    with pytest.raises(ValueError, match="left_out"):
        swa_cuda.BlockTable(windows, [tasks[0]._replace(rows_per_thread=16)], go, ge)


@pytest.mark.parametrize("scoring", SCORINGS)
def test_scoring_systems_match_jax(scoring):
    sc = make_scoring(scoring)
    prof, db = _case(sc, np.random.default_rng(len(scoring)), 41, 120, 9)
    go, ge = sc.gap_open_total, sc.gap_extend
    got = _port(prof, db, sc, [CPU] * 4, jb=32)
    np.testing.assert_array_equal(got, np.asarray(sw_wavefront(prof, db, go, ge)))
    np.testing.assert_array_equal(
        got, np.asarray(jax_sw_longpair(prof, db, go, ge, jax_make_mesh(jax.devices()[:4]),
                                        jb=32)))


def _segment_per_lane_fs(nw, length):
    """A segment table of one segment per window: slot w is window w's."""
    fs = torch.zeros((length // swa_cuda.STREAM_JB, nw, 2), dtype=torch.int32)
    fs[-1, :, 1] = torch.arange(1, nw + 1, dtype=torch.int32)
    return fs


def _one_task(stripe, windows, go, ge, *, j0, j1, bnd_in=None, bnd_out=None,
              left_in=None, left_out=None, rows_per_thread=None):
    """One block as a step of one task (a one-task BlockTable): the
    block's bests."""
    nw, _, win = windows.shape
    table = swa_cuda.BlockTable(windows, [swa_cuda.BlockTask(
        stripe, j0, j1, bnd_in, bnd_out, left_in, left_out, rows_per_thread)], go, ge)
    best = torch.zeros((nw, win), dtype=torch.int32, device=windows.device)
    return swa_cuda.sw_stream_striped_step(table, 0, 1, best)


@pytest.mark.parametrize("scoring", ["BLOSUM45", "PAM250", "random"])
@pytest.mark.parametrize("blk", [16, 48, 112])
def test_blocks_chain_to_one_pass(scoring, blk):
    """Blocks of a stripe, each carrying the left column (in place, in its
    coalesced layout) and reading the stripe above, equal one plain pass
    over the whole length: bests and the boundary row."""
    sc = make_scoring(scoring)
    go, ge = sc.gap_open_total, sc.gap_extend
    prof, db = _case(sc, np.random.default_rng(blk), 50, 100, 12)
    windows = batch_windows(db.astype(np.int8), 4, swa_cuda.STREAM_JB, CPU)  # 3 x 4 lanes
    nw, length, win = windows.shape
    top, stripe = profile_stripes(prof, go, 28, CPU)  # 28 rows, then 22 padded to 24
    fs = _segment_per_lane_fs(nw, length)
    kw = dict(nslots=nw, jb=swa_cuda.STREAM_JB)
    above = torch.empty((2, nw, length, win), dtype=torch.int32)
    want_top, _ = swa_cuda.sw_stream_striped_pass_reference(top, windows, fs, go, ge,
                                                            bnd_out=above, **kw)
    below = torch.empty_like(above)
    want, _ = swa_cuda.sw_stream_striped_pass_reference(stripe, windows, fs, go, ge,
                                                        bnd_in=above, bnd_out=below, **kw)
    for rows_prof, bnd_in, want_best, want_bnd in ((top, None, want_top, above),
                                                   (stripe, above, want, below)):
        left = swa_cuda.left_column(rows_prof.shape[0], windows)
        bnd = torch.full_like(above, -7)
        best = torch.zeros((nw, win), dtype=torch.int32)
        for j0 in range(0, length, blk):
            out = _one_task(
                rows_prof, windows, go, ge, j0=j0, j1=min(j0 + blk, length),
                bnd_in=bnd_in, bnd_out=bnd, left_in=None if j0 == 0 else left,
                left_out=left)
            best = torch.maximum(best, out)
        assert torch.equal(best, want_best)
        assert torch.equal(bnd, want_bnd)


def test_block_left_out_is_the_column_at_j1():
    """left_out holds (Gg, E) at j1 - 1: a second block from it equals the
    first two blocks' second half, and left_in=None is the boundary."""
    sc = make_scoring("BLOSUM62")
    go, ge = sc.gap_open_total, sc.gap_extend
    prof, db = _case(sc, np.random.default_rng(3), 12, 64, 5)
    windows = batch_windows(db.astype(np.int8), 5, swa_cuda.STREAM_JB, CPU)
    (stripe,) = profile_stripes(prof, go, 12, CPU)
    left = swa_cuda.left_column(12, windows)
    one, _, _ = swa_cuda.sw_stream_striped_block_reference(
        stripe, windows, go, ge, j0=0, j1=32, left_out=left)
    two, _, _ = swa_cuda.sw_stream_striped_block_reference(
        stripe, windows, go, ge, j0=32, j1=64, left_in=left)
    whole, _, _ = swa_cuda.sw_stream_striped_block_reference(stripe, windows, go, ge, j0=0, j1=64)
    assert torch.equal(torch.maximum(one, two), whole)
    # The boundary column at j0 = 0 is what left_in=None means.
    boundary = swa_cuda.left_column(12, windows)
    boundary[0], boundary[1] = go, 0
    again, _, _ = swa_cuda.sw_stream_striped_block_reference(
        stripe, windows, go, ge, j0=0, j1=64, left_in=boundary)
    assert torch.equal(again, whole)


def test_block_wrapper_on_cpu_is_the_plain_version():
    """A one-task step on CPU tensors is the block's plain version and
    launches nothing."""
    sc = make_scoring("PAM250")
    go, ge = sc.gap_open_total, sc.gap_extend
    prof, db = _case(sc, np.random.default_rng(8), 20, 40, 3)
    windows = batch_windows(db.astype(np.int8), 3, swa_cuda.STREAM_JB, CPU)
    (stripe,) = profile_stripes(prof, go, 20, CPU)
    launches = swa_cuda.sw_stream_striped_step.launches
    calls = swa_cuda.sw_stream_striped_block_reference.calls
    got = _one_task(stripe, windows, go, ge, j0=16, j1=48)
    want, _, _ = swa_cuda.sw_stream_striped_block_reference(stripe, windows, go, ge, j0=16, j1=48)
    assert torch.equal(got, want)
    assert swa_cuda.sw_stream_striped_step.launches == launches
    assert swa_cuda.sw_stream_striped_block_reference.calls - calls == 2


def _block_args():
    stripe = torch.zeros((8, 32), dtype=torch.int32)
    windows = torch.zeros((2, 32, 4), dtype=torch.int8)
    return stripe, windows


@pytest.mark.parametrize("bad", [
    dict(j0=8), dict(j1=40), dict(j0=16, j1=16), dict(j1=24),
    dict(stripe=torch.zeros((6, 32), dtype=torch.int32)),
    dict(stripe=torch.zeros((0, 32), dtype=torch.int32)),
    dict(windows=torch.zeros((2, 24, 4), dtype=torch.int8)),
    dict(left_in=torch.zeros((2, 2, 8, 4), dtype=torch.int32)),  # rows, not coalesced
    dict(left_out=torch.zeros((2, 8, 2, 4, 32), dtype=torch.int64)),
    dict(left_in=torch.zeros((2, 8, 2, 4, 32), dtype=torch.int32), rows_per_thread=16),
    dict(left_out=torch.zeros((2, 8, 2, 4, 32), dtype=torch.int32)[:, :, :, :, :16]),
    dict(bnd_in=torch.zeros((2, 2, 16, 4), dtype=torch.int32)),
    dict(go=-1, ge=-2),
    dict(rows_per_thread=12),
    dict(windows=torch.zeros((2, 32, 4), dtype=torch.int8, device="meta")),
])
def test_block_rejects_malformed_input(bad):
    """A task is checked when its table is built, and by the plain version."""
    stripe, windows = _block_args()
    kw = dict(stripe=stripe, windows=windows, go=-3, ge=-1, j0=0, j1=32) | bad
    args = kw.pop("stripe"), kw.pop("windows"), kw.pop("go"), kw.pop("ge")
    with pytest.raises(ValueError):
        _one_task(*args, **kw)
    with pytest.raises(ValueError):
        swa_cuda.sw_stream_striped_block_reference(*args, **kw)


@pytest.mark.parametrize("rows,bnd_out,key", [
    (1024, True, "sw_striped_block_kernel<32, true, false>"),
    (560, False, "sw_striped_block_kernel<24, false, false>"),
    (300, True, "sw_striped_block_kernel<16, true, true>"),
    (8, False, "sw_striped_block_kernel<8, false, false>"),
])
def test_block_kernel_instance(rows, bnd_out, key):
    """Row -1 is a run-time choice of the block instance: a task's instance
    is (R, kOut, kPartial) whether or not it reads a boundary in."""
    from seqalign_tpu_torch import sass

    assert swa_cuda.block_kernel_instance(rows, bnd_out) == key
    mangled = ("_ZN12_GLOBAL__N_123sw_striped_block_kernelILi32ELb1ELb0EEEvPKNS_9BlockTaskEPKaPi"
               "iiiiii")
    assert sass.kernel_key(mangled) == "sw_striped_block_kernel<32, true, false>"
    assert sass.expected_cells(key) == 2 * int(key.split("<")[1].split(",")[0])


def test_out_of_envelope_scoring_is_refused():
    """gap_open=+3: the port refuses before any work; JAX's sw_longpair
    scores depend on its padding there (jb=16 against jb=64 on lane 7)."""
    sc = load_builtin("BLOSUM62", ScoringModel(gap_open=3, gap_extend=-1,
                                               use_match_mismatch=False))
    prof, db = _case(sc, np.random.default_rng(0), 60, 90, 8)
    go, ge = sc.gap_open_total, sc.gap_extend
    calls = swa_cuda.sw_stream_striped_block_reference.calls
    with pytest.raises(ValueError, match="envelope"):
        sw_longpair(prof, db, go, ge, [CPU] * 4, jb=16)
    assert swa_cuda.sw_stream_striped_block_reference.calls == calls
    mesh = jax_make_mesh(jax.devices()[:4])
    at16 = np.asarray(jax_sw_longpair(prof, db, go, ge, mesh, jb=16))
    at64 = np.asarray(jax_sw_longpair(prof, db, go, ge, mesh, jb=64))
    assert not np.array_equal(at16, at64)


@pytest.mark.parametrize("mesh,data_axis", [
    ([], None), ([[CPU], [CPU, CPU]], "data"), ([[CPU] * 2] * 2, None),
    ([CPU] * 2, "data"), ([CPU, [CPU]], None), ([torch.device("meta")], None),
])
def test_malformed_meshes_are_refused(mesh, data_axis):
    sc = make_scoring("BLOSUM62")
    prof, db = _case(sc, np.random.default_rng(1), 10, 20, 4)
    with pytest.raises(ValueError):
        sw_longpair(prof, db, sc.gap_open_total, sc.gap_extend, mesh, data_axis=data_axis)


@pytest.mark.parametrize("lq,lb,b", [(0, 20, 4), (10, 0, 4), (10, 20, 0)])
def test_empty_query_or_database_gives_zeros(lq, lb, b):
    sc = make_scoring("BLOSUM62")
    prof = make_profile(sc.table, sc.query_indices(random_protein(np.random.default_rng(2), lq)))
    db = np.full((lb, b), 31, dtype=np.int32)
    got = _port(prof, db, sc, [CPU] * 2)
    assert got.dtype == np.int32 and got.shape == (b,) and not got.any()


def test_no_gpu_is_an_error_under_cuda(monkeypatch):
    monkeypatch.setenv("SEQALIGN_PLATFORM", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = make_scoring("BLOSUM62")
    prof, db = _case(sc, np.random.default_rng(4), 10, 20, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        sw_longpair(prof, db, sc.gap_open_total, sc.gap_extend, make_mesh())
    with pytest.raises(RuntimeError, match="CUDA"):
        sw_longpair(prof, db, sc.gap_open_total, sc.gap_extend, ["cuda"] * 2)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA block kernel)")


@pytest.mark.cuda
@pytest.mark.parametrize("lq", [40, 300, 1024])
def test_block_kernel_matches_plain_version_on_the_card(lq):
    _needs_card()
    sc = make_scoring("PAM250")
    go, ge = sc.gap_open_total, sc.gap_extend
    prof, db = _case(sc, np.random.default_rng(lq), lq, 200, 40)
    dev = torch.device("cuda")
    windows = batch_windows(db.astype(np.int8), 40, swa_cuda.STREAM_JB, dev)
    (stripe,) = profile_stripes(prof, go, 1024, dev)
    bnd_in = torch.randint(-5, 30, (2, *windows.shape), dtype=torch.int32, device=dev)
    left = torch.randint(-5, 30, swa_cuda.left_column(stripe.shape[0], windows).shape,
                         dtype=torch.int32, device=dev)
    outs = []
    for fn in (_one_task, lambda *a, **kw: swa_cuda.sw_stream_striped_block_reference(
            *a, **kw)[0]):
        bnd = torch.zeros_like(bnd_in)
        lo = left.clone()
        outs.append((fn(stripe, windows, go, ge, j0=32, j1=112, bnd_in=bnd_in, bnd_out=bnd,
                        left_in=lo, left_out=lo), bnd, lo))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_step_kernel_matches_plain_version_on_the_card():
    """One launch per instance run of a step of four tasks (three
    instances, a partial sub-pass among them) against the plain version."""
    _needs_card()
    windows, go, ge, tasks = _step_tasks(torch.device("cuda"), np.random.default_rng(14))
    outs = []
    for fn, order in ((swa_cuda.sw_stream_striped_step, tasks),
                      (swa_cuda.sw_stream_striped_step_reference, _clone(tasks))):
        best = torch.zeros((1, 6), dtype=torch.int32, device="cuda")
        launches = swa_cuda.sw_stream_striped_step.launches
        fn(swa_cuda.BlockTable(windows, order, go, ge), 0, 4, best)
        if fn is swa_cuda.sw_stream_striped_step:
            assert swa_cuda.sw_stream_striped_step.launches - launches == 3
        outs.append([best] + [x for t in order for x in (t.bnd_out, t.left_out) if x is not None])
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("entries", [1, 2, 4])
def test_longpair_on_the_card_matches_the_cpu(entries):
    _needs_card()
    sc = make_scoring("BLOSUM62")
    prof, db = _case(sc, np.random.default_rng(entries), 700, 300, 50)
    got = _port(prof, db, sc, [torch.device("cuda")] * entries, jb=64)
    np.testing.assert_array_equal(got, _port(prof, db, sc, [CPU] * entries, jb=64))


# Lane ends: each lane stops at its record's end where every '*' score and
# ge are at most 0 (the skip), and runs every cell otherwise.


def _unsorted_case(sc, rng, lq, lb, b):
    """``_case`` with its lanes shuffled and lane ``b // 2`` all '*'."""
    prof, db = _case(sc, rng, lq, lb, b)
    db = db[:, rng.permutation(b)]
    db[:, b // 2] = 31
    return prof, db


@pytest.mark.parametrize("two_d", [False, True])
@pytest.mark.parametrize("scoring", SCORINGS)
def test_skip_matches_jax_on_every_scoring(scoring, two_d):
    """The skip open (every task table has the lanes' ends), lanes given
    unsorted with an all-'*' lane, on [cpu] x 3 and the 2 x 2 data x seq
    mesh: every score equals JAX's sw_longpair and sw_wavefront."""
    sc = make_scoring(scoring)
    go, ge = sc.gap_open_total, sc.gap_extend
    prof, db = _unsorted_case(sc, np.random.default_rng(len(scoring) + two_d), 37, 110, 11)
    mesh, kw, jmesh = _mesh((2, 2) if two_d else (3,))
    grid = mesh if two_d else [mesh]
    slices, _, _ = longpair._pipeline(prof, db, go, ge, grid, 32)
    assert longpair.skips(prof)
    assert all(ent.table.ends is not None for sl in slices for ent in sl)
    got = _port(prof, db, sc, mesh, jb=32, **kw)
    np.testing.assert_array_equal(got, np.asarray(sw_wavefront(prof, db, go, ge)))
    np.testing.assert_array_equal(
        got, np.asarray(jax_sw_longpair(prof, db, go, ge, jmesh, jb=32, **kw)))
    assert got[db.shape[1] // 2] == 0


@pytest.mark.parametrize("data", [1, 2, 3])
def test_lanes_sorted_by_end_within_each_shard(data):
    """_pipeline scores each data slice's shard longest first (stable), a
    lane never leaving its shard; each table's ends are the scored lanes'
    ends, in that order."""
    sc = make_scoring("PAM250")
    prof, db = _unsorted_case(sc, np.random.default_rng(data), 12, 70, 10)
    ends = swa_cuda.lane_ends(torch.from_numpy(db.astype(np.int8))[None])[0].numpy()
    grid = [[CPU] * 2 for _ in range(data)]
    slices, _, order = longpair._pipeline(prof, db, sc.gap_open_total, sc.gap_extend, grid, 16)
    shard = -(-10 // data)
    padded = np.concatenate([ends, np.zeros(shard * data - 10, dtype=ends.dtype)])
    assert sorted(order) == list(range(shard * data))
    for d, sl in enumerate(slices):
        mine = order[d * shard:(d + 1) * shard]
        assert all(d * shard <= x < (d + 1) * shard for x in mine)
        want = sorted(range(d * shard, (d + 1) * shard), key=lambda x: -padded[x])
        assert list(mine) == want
        for ent in sl:
            assert ent.table.ends.tolist() == [padded[mine].tolist()]


@pytest.mark.parametrize("shape", [(2,), (2, 2)])
def test_scores_do_not_depend_on_the_lane_order(monkeypatch, shape):
    """Scoring the lanes in the order given (lane_order the identity, as
    chip_smoke's phase 13 times it) gives the same scores as the sort by
    end, with the skip open: the sort only groups lanes that end together."""
    sc = make_scoring("PAM250")
    prof, db = _unsorted_case(sc, np.random.default_rng(5), 21, 90, 13)
    mesh, kw, _ = _mesh(shape)
    sorted_scores = _port(prof, db, sc, mesh, jb=16, **kw)
    monkeypatch.setattr(longpair, "lane_order", lambda ends, data_count: np.arange(ends.size))
    assert longpair.skips(prof)
    np.testing.assert_array_equal(_port(prof, db, sc, mesh, jb=16, **kw), sorted_scores)
    np.testing.assert_array_equal(
        sorted_scores, np.asarray(sw_wavefront(prof, db, sc.gap_open_total, sc.gap_extend)))


def _ends_mask(ends, j0, j1):
    """Each lane's positions of block [j0, j1) when it stops at its end."""
    return ((ends.long() - j0 + 1) // 2 * 2).clamp(0, j1 - j0)


@pytest.mark.parametrize("blk", [16, 32, 48])
def test_plain_block_with_ends_leaves_unread_words_untouched(blk):
    """Two sub-passes chained over every block (the second reads the
    first's boundary row) on sentinel-filled boundary rows and left
    columns, with the lanes' ends and without: the bests of the lanes
    with a residue, merged over every task, are equal (an all-'*' lane
    merges nothing); with ends, each boundary word and left
    column is the run without ends' where the lane reaches it, and the
    sentinel exactly where the kernel leaves it untouched (past the
    lane's stop; no left column where it stops inside the block)."""
    sc = make_scoring("BLOSUM62")
    go, ge = sc.gap_open_total, sc.gap_extend
    rng = np.random.default_rng(blk)
    prof, db = _unsorted_case(sc, rng, 20, 90, 12)
    db[:, 3] = 31
    db[:1, 3] = 5  # a lane of one residue
    windows = batch_windows(db.astype(np.int8), 6, swa_cuda.STREAM_JB, CPU)
    ends = swa_cuda.lane_ends(windows).to(torch.int32)
    length = windows.shape[1]
    blocks = [(j, min(j + blk, length)) for j in range(0, length, blk)]
    subs = profile_stripes(prof, go, 12, CPU)
    sentinel = -12345

    def run(with_ends):
        bnd = [torch.full((2, *windows.shape), sentinel, dtype=torch.int32) for _ in subs]
        lefts = [[torch.full(swa_cuda.left_column(s.shape[0], windows).shape, sentinel,
                             dtype=torch.int32) for _ in blocks] for s in subs]
        tasks = [swa_cuda.BlockTask(s, j0, j1, bnd[p - 1] if p else None, bnd[p],
                                    lefts[p][b - 1] if b else None, lefts[p][b])
                 for p, s in enumerate(subs) for b, (j0, j1) in enumerate(blocks)]
        table = swa_cuda.BlockTable(windows, tasks, go, ge, ends if with_ends else None)
        best = torch.full((2, 6), -7, dtype=torch.int32)
        swa_cuda.sw_stream_striped_step_reference(table, 0, len(tasks), best)
        return best, bnd, lefts

    full, skip = run(False), run(True)
    assert torch.equal(skip[0][ends > 0], full[0][ends > 0])
    assert bool((skip[0][ends == 0] == -7).all()) and bool((ends == 0).any())
    pos = torch.arange(length)[:, None, None]
    reach = (pos < ((ends.long() + 1) // 2 * 2)[None]).permute(1, 0, 2)  # (nw, L, win)
    for a, b in zip(skip[1], full[1]):
        assert torch.equal(a[:, reach], b[:, reach])
        assert bool((a[:, ~reach] == sentinel).all())
    for p, s in enumerate(subs):
        r = swa_cuda.left_column(s.shape[0], windows).shape[1]
        rows = torch.arange(s.shape[0])
        at = (slice(None), rows % r, slice(None), slice(None), rows // r)
        for b, (j0, j1) in enumerate(blocks):
            whole = _ends_mask(ends, j0, j1) == j1 - j0  # (nw, win)
            a, c = skip[2][p][b][at], full[2][p][b][at]  # (2, rows, nw, win)
            assert torch.equal(a[:, :, whole], c[:, :, whole])
            assert bool((a[:, :, ~whole] == sentinel).all())


def test_plain_block_with_ends_one_task():
    """One block alone with ends: a dead lane and the words past a lane's
    stop are left as they were, and the block's bests over the positions
    each lane runs equal the run without ends' cut to those positions."""
    sc = make_scoring("PAM250")
    go, ge = sc.gap_open_total, sc.gap_extend
    rng = np.random.default_rng(31)
    prof, db = _case(sc, rng, 24, 64, 5)
    windows = batch_windows(db.astype(np.int8), 5, swa_cuda.STREAM_JB, CPU)
    ends = torch.tensor([[0, 17, 32, 33, 64]], dtype=torch.int32)
    (stripe,) = profile_stripes(prof, go, 24, CPU)
    bnd_in = torch.from_numpy(rng.integers(-4, 40, (2, *windows.shape), dtype=np.int32))
    left_in = torch.from_numpy(rng.integers(
        -4, 40, swa_cuda.left_column(24, windows).shape, dtype=np.int32))
    outs = []
    for e in (ends, None):
        bnd = torch.full((2, *windows.shape), -99, dtype=torch.int32)
        left = torch.full_like(left_in, -99)
        best, _, _ = swa_cuda.sw_stream_striped_block_reference(
            stripe, windows, go, ge, j0=16, j1=48, bnd_in=bnd_in, bnd_out=bnd,
            left_in=left_in, left_out=left, ends=e)
        outs.append((best, bnd, left))
    (best, bnd, left), (_, bnd_all, left_all) = outs
    assert _ends_mask(ends, 16, 48).tolist() == [[0, 2, 16, 18, 32]]
    assert best[0, 0] == 0
    for lane, n in enumerate([0, 2, 16, 18, 32]):
        assert torch.equal(bnd[:, 0, 16:16 + n, lane], bnd_all[:, 0, 16:16 + n, lane])
        assert bool((bnd[:, 0, 16 + n:, lane] == -99).all())
        assert bool((bnd[:, 0, :16, lane] == -99).all())
        want = left_all[:, :, 0, lane] if n == 32 else torch.full_like(left_all[:, :, 0, lane], -99)
        assert torch.equal(left[:, :, 0, lane], want)
    # Lane 4 runs every position: its best is the run without ends'.
    assert best[0, 4] == outs[1][0][0, 4]


def test_block_table_rejects_malformed_ends():
    windows, go, ge, tasks = _step_tasks(CPU, np.random.default_rng(15))
    for bad in (torch.zeros((1, 5), dtype=torch.int32), torch.zeros((1, 6), dtype=torch.int64),
                torch.full((1, 6), windows.shape[1] + 1, dtype=torch.int32),
                torch.full((1, 6), -1, dtype=torch.int32)):
        with pytest.raises(ValueError, match="ends"):
            swa_cuda.BlockTable(windows, tasks, go, ge, bad)


def test_task_table_with_ends_reads_only_written_words(monkeypatch):
    """The plan of a 2 x 2 mesh with 5-6 sub-passes an entry, lane by lane
    with each lane's ends (lanes of lengths 0 to 90 against 96 positions):
    every boundary word or left column a live lane's task reads was
    written by an earlier task, or copied at the step from a written word;
    a dead lane's task reads and writes nothing."""
    monkeypatch.setattr(swa_cuda, "STRIPE_ROWS", 4)
    sc = make_scoring("PAM250")
    prof, db = _unsorted_case(sc, np.random.default_rng(17), 45, 90, 14)
    db[:1, 5] = 3
    db[1:, 5] = 31
    mesh, _, _ = _mesh((2, 2))
    slices, n_steps, _ = longpair._pipeline(prof, db, sc.gap_open_total, sc.gap_extend,
                                            mesh, 32)
    written = set()
    for t in range(n_steps):
        copies, tasks = set(), []
        for sl in slices:
            for k, ent in enumerate(sl):
                lo, hi, edge = ent.steps[t]
                ends = ent.table.ends[0].tolist()
                if edge is not None:
                    src, dst = sl[k - 1].edge_out.data_ptr(), ent.edge_in.data_ptr()
                    copies |= {(dst, j, l) for j in range(*edge) for l in range(len(ends))
                               if (src, j, l) in written}
                for task in ent.table.tasks[lo:hi]:
                    tasks.append((task, _ends_mask(ent.table.ends, task.j0, task.j1)[0]))
        written |= copies
        new = set()
        for task, n_lane in tasks:
            for lane, n in enumerate(n_lane.tolist()):
                reads = set()
                if n and task.left_in is not None:
                    reads.add((task.left_in.data_ptr(), "left", lane))
                if n and task.bnd_in is not None:
                    reads |= {(task.bnd_in.data_ptr(), j, lane)
                              for j in range(max(task.j0 - 1, 0), task.j0 + n)}
                assert reads <= written
                if n == task.j1 - task.j0 and task.left_out is not None:
                    new.add((task.left_out.data_ptr(), "left", lane))
                if task.bnd_out is not None:
                    new |= {(task.bnd_out.data_ptr(), j, lane)
                            for j in range(task.j0, task.j0 + n)}
        written |= new


# JAX's sw_longpair pads Lb to a multiple of jb with '*' and scores that
# padding; a query holding '*' under BLOSUM62 scores ('*', '*') = +1, so its
# scores depend on jb. The port pads to STREAM_JB only, and runs such a
# query's every cell (no lane ends).
_STAR_RESIDUES = "WCNMFMQGNDWAKICIPAAFDSDPTYDVYPIECTSKLAKYLWIHRLIG"


def test_star_query_differs_from_jax_on_purpose():
    sc = make_scoring("BLOSUM62")
    go, ge = sc.gap_open_total, sc.gap_extend
    prof = make_profile(sc.table, sc.query_indices(_STAR_RESIDUES + "****"))
    db = np.full((48, 1), 31, dtype=np.int32)
    db[:, 0] = sc.query_indices(_STAR_RESIDUES)
    assert int(np.asarray(sw_wavefront(prof, db, go, ge))[0]) == 280
    for jb in (16, 32, 64):
        assert _port(prof, db, sc, [CPU], jb=jb).tolist() == [280]
    jmesh = jax_make_mesh(jax.devices()[:1])
    assert int(np.asarray(jax_sw_longpair(prof, db, go, ge, jmesh, jb=16))[0]) == 280
    assert int(np.asarray(jax_sw_longpair(prof, db, go, ge, jmesh, jb=32))[0]) == 284
    assert not longpair.skips(prof)
    slices, _, _ = longpair._pipeline(prof, db, go, ge, [[CPU]], 32)
    assert slices[0][0].table.ends is None


@pytest.mark.cuda
def test_block_kernel_with_ends_matches_plain_version_on_the_card():
    """K2's block instance with ends against its plain version, word for
    word on sentinel-filled boundary rows and left columns: 40 lanes at R
    = 8 (CTAs of 8 lanes) hold a dead CTA, dead warps in live CTAs, stops
    inside the block and lanes that run it whole; two steps (a second
    sub-pass reads the first's boundary)."""
    _needs_card()
    sc = make_scoring("BLOSUM62")
    go, ge = sc.gap_open_total, sc.gap_extend
    rng = np.random.default_rng(41)
    dev = torch.device("cuda")
    prof = make_profile(sc.table, sc.query_indices(random_protein(rng, 200)))
    lens = np.concatenate([np.full(8, 150), rng.integers(1, 150, 8), np.zeros(8, int),
                           rng.choice([0, 20, 47, 48, 49, 90, 111, 112], 16)])
    db = np.full((150, 40), 31, dtype=np.int32)
    for lane, n in enumerate(lens):
        db[:n, lane] = rng.integers(0, 20, n)
    windows = batch_windows(db.astype(np.int8), 40, swa_cuda.STREAM_JB, dev)
    ends = swa_cuda.lane_ends(windows).to(torch.int32)
    a, b = profile_stripes(prof, go, 104, dev)
    bnd_in = torch.randint(-5, 30, (2, *windows.shape), dtype=torch.int32, device=dev)
    left = torch.randint(-5, 30, swa_cuda.left_column(104, windows).shape,
                         dtype=torch.int32, device=dev)
    outs = []
    for fn in (swa_cuda.sw_stream_striped_step, swa_cuda.sw_stream_striped_step_reference):
        mid = torch.full((2, *windows.shape), -777, dtype=torch.int32, device=dev)
        last = torch.full_like(mid, -777)
        la, lb = left.clone(), torch.full_like(left, -777)
        table = swa_cuda.BlockTable(windows, [
            swa_cuda.BlockTask(a, 48, 112, bnd_in, mid, la, la),
            swa_cuda.BlockTask(b, 48, 112, mid, last, None, lb)], go, ge, ends)
        best = torch.full((1, 40), -3, dtype=torch.int32, device=dev)
        fn(table, 0, 1, best)
        fn(table, 1, 2, best)
        torch.cuda.synchronize()
        outs.append((best, mid, last, la, lb))
    for x, y in zip(*outs):
        assert torch.equal(x, y)
