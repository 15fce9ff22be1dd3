"""The port's sequence-parallel long pair (``seqalign_tpu_torch.parallel.
sw_longpair``) and K2's block instance (``swa_cuda.sw_stream_striped_block``)
against the JAX package on the CPU: the port runs on ``[cpu] * D`` (the
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
from seqalign_tpu_torch.parallel import make_mesh, sw_longpair

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
    got = _port(prof, db, sc, [CPU] * 2, jb=32)
    # 3 blocks (L = 96) x the entries' sub-passes.
    assert swa_cuda.sw_stream_striped_block_reference.calls - calls == 3 * sum(subs)
    np.testing.assert_array_equal(got, np.asarray(sw_wavefront(prof, db, go, ge)))
    np.testing.assert_array_equal(
        got, np.asarray(jax_sw_longpair(prof, db, go, ge, jax_make_mesh(jax.devices()[:2]),
                                        jb=32)))


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


@pytest.mark.parametrize("scoring", ["BLOSUM45", "PAM250", "random"])
@pytest.mark.parametrize("blk", [16, 48, 112])
def test_blocks_chain_to_one_pass(scoring, blk):
    """Blocks of a stripe, each carrying the left column (in place) and
    reading the stripe above, equal one plain pass over the whole length:
    bests and the boundary row."""
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
        left = torch.empty((2, nw, rows_prof.shape[0], win), dtype=torch.int32)
        bnd = torch.full_like(above, -7)
        best = torch.zeros((nw, win), dtype=torch.int32)
        for j0 in range(0, length, blk):
            out, _, _ = swa_cuda.sw_stream_striped_block(
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
    left = torch.empty((2, 1, 12, 5), dtype=torch.int32)
    one, _, _ = swa_cuda.sw_stream_striped_block_reference(
        stripe, windows, go, ge, j0=0, j1=32, left_out=left)
    two, _, _ = swa_cuda.sw_stream_striped_block_reference(
        stripe, windows, go, ge, j0=32, j1=64, left_in=left)
    whole, _, _ = swa_cuda.sw_stream_striped_block_reference(stripe, windows, go, ge, j0=0, j1=64)
    assert torch.equal(torch.maximum(one, two), whole)
    # The boundary column at j0 = 0 is what left_in=None means.
    boundary = torch.stack([torch.full((1, 12, 5), go, dtype=torch.int32),
                            torch.zeros((1, 12, 5), dtype=torch.int32)])
    again, _, _ = swa_cuda.sw_stream_striped_block_reference(
        stripe, windows, go, ge, j0=0, j1=64, left_in=boundary)
    assert torch.equal(again, whole)


def test_block_wrapper_on_cpu_is_the_plain_version():
    sc = make_scoring("PAM250")
    go, ge = sc.gap_open_total, sc.gap_extend
    prof, db = _case(sc, np.random.default_rng(8), 20, 40, 3)
    windows = batch_windows(db.astype(np.int8), 3, swa_cuda.STREAM_JB, CPU)
    (stripe,) = profile_stripes(prof, go, 20, CPU)
    launches = swa_cuda.sw_stream_striped_block.launches
    calls = swa_cuda.sw_stream_striped_block_reference.calls
    got, _, _ = swa_cuda.sw_stream_striped_block(stripe, windows, go, ge, j0=16, j1=48)
    want, _, _ = swa_cuda.sw_stream_striped_block_reference(stripe, windows, go, ge, j0=16, j1=48)
    assert torch.equal(got, want)
    assert swa_cuda.sw_stream_striped_block.launches == launches
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
    dict(left_in=torch.zeros((2, 2, 4, 4), dtype=torch.int32)),
    dict(left_out=torch.zeros((2, 2, 8, 4), dtype=torch.int64)),
    dict(bnd_in=torch.zeros((2, 2, 16, 4), dtype=torch.int32)),
    dict(go=-1, ge=-2),
    dict(rows_per_thread=12),
    dict(windows=torch.zeros((2, 32, 4), dtype=torch.int8, device="meta")),
])
def test_block_rejects_malformed_input(bad):
    stripe, windows = _block_args()
    kw = dict(stripe=stripe, windows=windows, go=-3, ge=-1, j0=0, j1=32) | bad
    with pytest.raises(ValueError):
        swa_cuda.sw_stream_striped_block(
            kw.pop("stripe"), kw.pop("windows"), kw.pop("go"), kw.pop("ge"), **kw)


@pytest.mark.parametrize("rows,bnd_in,bnd_out,key", [
    (1024, True, True, "sw_striped_block_kernel<32, true, true, false>"),
    (560, True, False, "sw_striped_block_kernel<24, true, false, false>"),
    (300, False, True, "sw_striped_block_kernel<16, false, true, true>"),
    (8, False, False, "sw_striped_block_kernel<8, false, false, false>"),
])
def test_block_kernel_instance(rows, bnd_in, bnd_out, key):
    from seqalign_tpu_torch import sass

    assert swa_cuda.block_kernel_instance(rows, bnd_in, bnd_out) == key
    mangled = ("_ZN12_GLOBAL__N_123sw_striped_block_kernelILi32ELb1ELb0ELb0EEEvPKiPKaPiS3_S4_"
               "S3_S4_iiiiiiiii")
    assert sass.kernel_key(mangled) == "sw_striped_block_kernel<32, true, false, false>"
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
    left = torch.randint(-5, 30, (2, 1, stripe.shape[0], 40), dtype=torch.int32, device=dev)
    outs = []
    for fn in (swa_cuda.sw_stream_striped_block, swa_cuda.sw_stream_striped_block_reference):
        bnd = torch.zeros_like(bnd_in)
        lo = left.clone()
        outs.append((fn(stripe, windows, go, ge, j0=32, j1=112, bnd_in=bnd_in, bnd_out=bnd,
                        left_in=lo, left_out=lo)[0], bnd, lo))
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
