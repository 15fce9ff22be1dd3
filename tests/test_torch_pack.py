"""The stream pack on the device (``ops.pack_cuda``) and the plan it fills
(``utils.packing.plan_streams``) against the JAX package's host packer, on
the CPU, where ``pack_streams_device`` runs its plain version; the device
form of ``pipeline.scatter_slots`` against its host form; and the
pipeline's use of both: one plain pack a chunk and no host pack, nothing
packed for a resumed chunk, and each chunk's own records copied where the
database does not fit the device."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from seqalign_tpu import pipeline as jax_pipeline
from seqalign_tpu.utils import packing as jax_packing
from seqalign_tpu_torch import pipeline
from seqalign_tpu_torch.convert import database_to_torch, stream_pack_to_torch
from seqalign_tpu_torch.models import PAD_INDEX
from seqalign_tpu_torch.ops import pack_cuda, swa_cuda
from seqalign_tpu_torch.ops.pack_cuda import (
    pack_runs, pack_streams_device, pack_streams_reference, stage_inputs, staged_views,
)
from seqalign_tpu_torch.parallel import multi_device_search
from seqalign_tpu_torch.utils import packing

from _torch_cases import make_scoring, random_records
from conftest import random_protein


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SEQALIGN_PLATFORM", "cpu")


def _records(rng, n, lo, hi, zeros=0, stars=0):
    """n encoded records, ``zeros`` of them empty and ``stars`` holding '*'
    (index 31) inside."""
    recs = random_records(rng, n, lo, hi)
    for k in rng.choice(n, zeros, replace=False):
        recs[k] = recs[k][:0]
    for k in rng.choice(n, stars, replace=False):
        if len(recs[k]) > 2:
            recs[k] = recs[k].copy()
            recs[k][rng.integers(1, len(recs[k]) - 1)] = PAD_INDEX
    return recs


# The pack kernel's edges: record lengths around its 16-byte words and
# 64-position tiles, and one slot longer than a CTA's run.
EDGE_LENGTHS = (0, 1, 15, 16, 17, 63, 64, 65, 255, 256, 257)

# name: (records, lo, hi, nw or "slots", win, empty records, '*' records,
# target_len over the natural length); records may be a tuple of lengths
# (lo and hi None).
CASES = {
    "nw_1": (700, 1, 60, 1, 256, 0, 0, None),
    "nw_equals_slots": (1024, 1, 40, "slots", 256, 0, 0, None),
    "partial_last_slot": (1300, 1, 90, 3, 256, 0, 0, None),
    "zero_length_records": (600, 0, 30, 2, 128, 80, 0, None),
    "star_inside_records": (900, 3, 70, 4, 256, 0, 120, None),
    "target_len": (800, 1, 50, 3, 64, 0, 0, 96),
    # 17-residue records start at every byte offset mod 16.
    "every_offset_mod_16": ((17,) * 48 + (33,) * 16 + (5,) * 16, None, None, 2, 64, 0, 4, None),
    "edge_lengths": (EDGE_LENGTHS * 24, None, None, 2, 128, 0, 20, None),
    "slot_longer_than_a_run": ((2 * pack_cuda.PACK_RUN + 77,) * 3 + (700, 641, 300) * 20,
                               None, None, 2, 64, 0, 10, None),
    "win_100": (700, 0, 80, 3, 100, 30, 20, None),
}


def _case(name, jb, grain):
    n, lo, hi, nw, win, zeros, stars, extra = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)) + jb)
    if isinstance(n, tuple):
        recs = [random_records(rng, 1, k, k + 1)[0] for k in n]
        n = len(recs)
        for k in rng.choice(n, stars, replace=False):
            if len(recs[k]) > 2:
                recs[k] = recs[k].copy()
                recs[k][rng.integers(1, len(recs[k]) - 1)] = PAD_INDEX
    else:
        recs = _records(rng, n, lo, hi, zeros, stars)
    db = pipeline._db_from_encoded(recs)
    order = np.argsort(-db.lengths, kind="stable")
    if nw == "slots":
        nw = -(-n // win)
    kw = dict(win=win, jb=jb, grain=grain)
    if extra is not None:
        natural = jax_packing.pack_streams(db, order, nw, **kw).streams.shape[1]
        kw["target_len"] = natural + extra
    return db, order, nw, kw


@pytest.mark.parametrize("jb,grain", [(16, 16), (4, 32)])
@pytest.mark.parametrize("name", list(CASES))
def test_plan_and_plain_pack_equal_jax_pack_streams(name, jb, grain):
    db, order, nw, kw = _case(name, jb, grain)
    want = jax_packing.pack_streams(db, order, nw, **kw)
    plan = packing.plan_streams(db.lengths, order, nw, **kw)
    np.testing.assert_array_equal(plan.fs, want.fs)
    assert plan.L == want.streams.shape[1]
    assert len(plan.slot_ids) == len(want.slot_ids)
    for a, b in zip(plan.slot_ids, want.slot_ids):
        np.testing.assert_array_equal(a, b)
    assert (plan.real_residues, plan.padded_cells_per_query_row) == (
        want.real_residues, want.padded_cells_per_query_row)
    calls = pack_streams_reference.calls
    streams, fs = pack_streams_device(torch.from_numpy(db.seq),
                                      torch.from_numpy(db.offsets), plan)
    assert pack_streams_reference.calls == calls + 1
    assert streams.dtype == torch.int8 and fs.dtype == torch.int32
    np.testing.assert_array_equal(streams.numpy(), want.streams)
    np.testing.assert_array_equal(fs.numpy(), want.fs)
    # The port's host packer (the plan and its host fill) is the same.
    host = packing.pack_streams(db, order, nw, **kw)
    np.testing.assert_array_equal(host.streams, want.streams)


@pytest.mark.parametrize("name", list(CASES))
def test_tiles_cover_every_stream_position_once(name):
    """The kernel's run table: every position of every stream once, each
    run inside its slot, or (s = -1, written with no read) a stream's tail
    past its last slot, longest first."""
    db, order, nw, kw = _case(name, 16, 16)
    plan = packing.plan_streams(db.lengths, order, nw, **kw)
    runs = pack_runs(plan)
    assert runs.dtype == np.int32 and runs.shape[1] == 5
    assert (np.diff(runs[:, 4]) <= 0).all()
    cover = np.zeros((plan.nw, plan.L), np.int64)
    in_slot = np.zeros((plan.nw, plan.L), bool)
    for w, start, lb in zip(plan.slot_w, plan.slot_start, plan.slot_lb):
        in_slot[w, start : start + lb] = True
    for w, p, q, s, npos in runs:
        assert 1 <= npos <= pack_cuda.PACK_RUN
        cover[w, p : p + npos] += 1
        if s >= 0:  # inside its slot
            assert p - q == plan.slot_start[s] and q + npos <= plan.slot_lb[s]
            assert w == plan.slot_w[s]
        else:  # a tail: no slot there, and no residue written
            assert not in_slot[w, p : p + npos].any()
    assert (cover == 1).all()
    # Every residue lies in a slot's run; the tails are all padding.
    want = jax_packing.pack_streams(db, order, nw, **kw).streams
    assert (want[~in_slot] == PAD_INDEX).all()


@pytest.mark.parametrize("name", list(CASES))
def test_staged_inputs_split_back_into_the_plan(name):
    """The one int32 array the wrapper copies holds the ids, the run table
    and fs, each at a multiple of STAGE_ALIGN words, as views of it."""
    db, order, nw, kw = _case(name, 4, 32)
    plan = packing.plan_streams(db.lengths, order, nw, **kw)
    staged, parts = stage_inputs(plan)
    assert staged.dtype == np.int32
    assert all(part.start % pack_cuda.STAGE_ALIGN == 0 for part in parts)
    tensor = torch.from_numpy(staged)
    ids, runs, fs = staged_views(tensor, parts, plan)
    for view in (ids, runs, fs):
        assert view.dtype == torch.int32 and view.is_contiguous()
        assert view.untyped_storage().data_ptr() == tensor.untyped_storage().data_ptr()
    np.testing.assert_array_equal(ids.numpy(), plan.order)
    np.testing.assert_array_equal(runs.numpy(), pack_runs(plan))
    np.testing.assert_array_equal(fs.numpy(), plan.fs)
    assert fs.shape == plan.fs.shape


@pytest.mark.parametrize("name", ["nw_1", "win_100"])
def test_staged_inputs_build_into_the_start_of_out(name):
    """Given ``out``, the same array is built into its start, as a view of
    it; an ``out`` too short for it raises."""
    db, order, nw, kw = _case(name, 4, 32)
    plan = packing.plan_streams(db.lengths, order, nw, **kw)
    want, parts = stage_inputs(plan)
    out = np.full(len(want) + 100, -7, np.int32)
    got, got_parts = stage_inputs(plan, out=out)
    assert got_parts == parts and np.shares_memory(got, out)
    np.testing.assert_array_equal(got, want)
    assert (out[len(want):] == -7).all()
    with pytest.raises(ValueError, match="words"):
        stage_inputs(plan, out=out[: len(want) - 1])


def test_an_id_past_int32_raises():
    db, order, nw, kw = _case("nw_1", 16, 16)
    plan = packing.plan_streams(db.lengths, order, nw, **kw)
    stage_inputs(plan)
    big = plan.order.astype(np.int64)
    big[3] = np.iinfo(np.int32).max + 1
    with pytest.raises(ValueError, match="int32"):
        stage_inputs(dataclasses.replace(plan, order=big))
    big[3] = -1  # no record id either
    with pytest.raises(ValueError, match="int32"):
        stage_inputs(dataclasses.replace(plan, order=big))
    with pytest.raises(ValueError, match="past the database"):
        stage_inputs(plan, records=int(plan.order.max()))
    with pytest.raises(ValueError, match="past the database"):
        pack_streams_device(torch.from_numpy(db.seq), torch.from_numpy(db.offsets),
                            dataclasses.replace(plan, order=big))


@pytest.mark.parametrize("name", ["partial_last_slot", "zero_length_records"])
@pytest.mark.parametrize("queries", [0, 3])
def test_device_scatter_equals_host_scatter(name, queries):
    """``(nslots, win)`` bests, or ``(nslots, nq_b, win)`` with padding
    queries past the scores' rows, into a chunk of a larger database."""
    db, order, nw, kw = _case(name, 16, 16)
    rng = np.random.default_rng(9)
    plan = packing.plan_streams(db.lengths, order, nw, **kw)
    chunk = plan.order
    nslots, win = len(plan.slot_lb), plan.win
    n = db.n + 50  # records outside the chunk stay as they were
    shape = (queries, n) if queries else (n,)
    out = torch.from_numpy(rng.integers(0, 1000, (nslots, *((queries + 2,) if queries else ()),
                                                   win), dtype=np.int32))
    host = rng.integers(0, 9, shape, dtype=np.int32)
    dev = torch.from_numpy(host.copy())
    pipeline.scatter_slots(host, chunk, out)
    pipeline.scatter_slots(dev, torch.from_numpy(chunk), out)
    np.testing.assert_array_equal(dev.numpy(), host)


def test_stream_chunks_equal_the_host_packer(monkeypatch):
    """Every chunk ``stream_chunks`` packs on the device equals the host
    packer's streams for that chunk's plan, the chunks in the stable length
    order."""
    monkeypatch.setattr(pipeline, "MAX_STREAM_SLOTS", 2)
    rng = np.random.default_rng(5)
    db = pipeline._db_from_encoded(random_records(rng, 1400, 1, 40))
    chunks = list(pipeline.stream_chunks(db, None, torch.device("cpu")))
    assert len(chunks) == 3
    np.testing.assert_array_equal(np.concatenate([c for c, _ in chunks]),
                                  np.argsort(-db.lengths, kind="stable"))
    for chunk, (streams, fs, nslots) in chunks:
        plan = pipeline.plan_chunk(db.lengths, chunk, None, None)
        want = stream_pack_to_torch(
            packing.pack_streams(db, chunk, plan.nw, win=plan.win, jb=plan.jb,
                                 grain=pipeline.STREAM_GRAIN), "cpu")
        assert nslots == len(plan.slot_lb)
        assert torch.equal(streams, want[0]) and torch.equal(fs, want[1])


def test_chunk_database_holds_the_chunk_in_order():
    rng = np.random.default_rng(6)
    db = pipeline._db_from_encoded(_records(rng, 300, 0, 30, zeros=20))
    chunk = rng.permutation(db.n)[:120]
    local = pipeline.chunk_database(db, chunk)
    assert local.n == len(chunk)
    for k, r in enumerate(chunk):
        np.testing.assert_array_equal(local.record(k), db.record(int(r)))


def _pack_counts():
    return (pack_streams_reference.calls, pack_streams_device.launches,
            packing.pack_streams.calls)


@pytest.mark.parametrize("multi", [False, True])
def test_search_packs_each_chunk_once_on_the_device(multi, monkeypatch):
    """A CPU search packs each chunk once through the pack's plain version
    (its launch count on a card) and never through the host packer; the
    database is copied once."""
    monkeypatch.setattr(pipeline, "MAX_STREAM_SLOTS", 1)
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(61)
    qs = [sc.query_indices(random_protein(rng, k)) for k in (12, 7)]
    db = pipeline._db_from_encoded(random_records(rng, 1100, 1, 30))
    copies = []
    real = pipeline.database_to_torch
    monkeypatch.setattr(pipeline, "database_to_torch",
                        lambda d, dev, *rest: copies.append(d.n) or real(d, dev, *rest))
    chunks = len(pipeline.chunk_bounds(db, np.argsort(-db.lengths, kind="stable")))
    before = _pack_counts()
    if multi:
        got, _ = pipeline.search_database_multi(qs, db, sc)
        want, _ = jax_pipeline.search_database_multi(qs, db, sc, engine="wavefront")
    else:
        got, _ = pipeline.search_database(qs[0], db, sc)
        want, _ = jax_pipeline.search_database(qs[0], db, sc, engine="wavefront")
    after = _pack_counts()
    assert chunks == 5
    assert (after[0] - before[0], after[1] - before[1], after[2] - before[2]) == (chunks, 0, 0)
    assert copies == [db.n]
    np.testing.assert_array_equal(got, want)


def test_resumed_checkpoint_chunk_packs_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(pipeline, "MAX_STREAM_SLOTS", 1)
    sc = make_scoring("PAM250")
    rng = np.random.default_rng(62)
    q = sc.query_indices(random_protein(rng, 10))
    db = pipeline._db_from_encoded(random_records(rng, 1000, 1, 25))
    ck = str(tmp_path / "ckpt")
    copies = []
    real = pipeline.database_to_torch
    monkeypatch.setattr(pipeline, "database_to_torch",
                        lambda d, dev, *rest: copies.append(d.n) or real(d, dev, *rest))
    first, _ = pipeline.search_database(q, db, sc, checkpoint_dir=ck)
    assert copies == [db.n]
    n0 = pack_streams_reference.calls
    second, dt = pipeline.search_database(q, db, sc, checkpoint_dir=ck)
    assert pack_streams_reference.calls == n0 and dt == 0.0 and copies == [db.n]
    np.testing.assert_array_equal(second, first)
    manifest = json.loads(Path(ck, "manifest.json").read_text())
    manifest["chunks"].remove(256)
    Path(ck, "manifest.json").write_text(json.dumps(manifest))
    third, _ = pipeline.search_database(q, db, sc, checkpoint_dir=ck)
    assert pack_streams_reference.calls == n0 + 1 and copies == [db.n] * 2
    np.testing.assert_array_equal(third, first)
    want, _ = jax_pipeline.search_database(q, db, sc, engine="wavefront")
    np.testing.assert_array_equal(first, want)


@pytest.mark.parametrize("route", ["single", "multi", "striped"])
def test_per_chunk_copy_where_the_database_does_not_fit(route, monkeypatch):
    """Under a memory budget below the database, each chunk copies only its
    own records (gathered on the host); the scores stay JAX's."""
    monkeypatch.setattr(pipeline, "MAX_STREAM_SLOTS", 2)
    monkeypatch.setattr(pipeline, "device_free_bytes", lambda device: 1000)
    if route == "striped":  # 20 rows in stripes of 8
        monkeypatch.setattr(swa_cuda, "MAX_QUERY_ROWS", 16)
        monkeypatch.setattr(swa_cuda, "STRIPE_ROWS", 8)
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(63)
    qs = [sc.query_indices(random_protein(rng, k)) for k in (20, 9, 14)]
    db = pipeline._db_from_encoded(random_records(rng, 1300, 1, 30))
    copies = []
    real = pipeline.database_to_torch
    monkeypatch.setattr(pipeline, "database_to_torch",
                        lambda d, dev, *rest: copies.append(d.n) or real(d, dev, *rest))
    if route == "multi":
        got, _ = pipeline.search_database_multi(qs[1:], db, sc)
        want, _ = jax_pipeline.search_database_multi(qs[1:], db, sc, engine="wavefront")
    else:
        got, _ = pipeline.search_database(qs[0 if route == "striped" else 1], db, sc)
        want, _ = jax_pipeline.search_database(
            qs[0 if route == "striped" else 1], db, sc, engine="wavefront")
    bounds = pipeline.chunk_bounds(db, np.argsort(-db.lengths, kind="stable"))
    assert len(bounds) == 3 and copies == [b - a for a, b in bounds]
    np.testing.assert_array_equal(got, want)


def test_entries_of_one_device_share_one_copy(monkeypatch):
    sc = make_scoring("PAM250")
    rng = np.random.default_rng(64)
    q = sc.query_indices(random_protein(rng, 15))
    db = pipeline._db_from_encoded(random_records(rng, 1500, 1, 30))
    prof = pipeline.make_profile(sc.table, q)
    copies = []
    real = pipeline.database_to_torch
    monkeypatch.setattr(pipeline, "database_to_torch",
                        lambda d, dev, *rest: copies.append(d.n) or real(d, dev, *rest))
    n0 = pack_streams_reference.calls
    got, _ = multi_device_search(prof, db, sc.gap_open_total, sc.gap_extend, ["cpu"] * 3)
    assert copies == [db.n] and pack_streams_reference.calls == n0 + 3
    want, _ = jax_pipeline.search_database(q, db, sc, engine="wavefront")
    np.testing.assert_array_equal(got, want)


def test_database_to_torch_on_cpu_is_a_view():
    rng = np.random.default_rng(65)
    db = pipeline._db_from_encoded(random_records(rng, 50, 1, 30))
    seq, offsets = database_to_torch(db, "cpu")
    assert seq.dtype == torch.int8 and offsets.dtype == torch.int64
    assert seq.data_ptr() == db.seq.ctypes.data
    np.testing.assert_array_equal(offsets.numpy(), db.offsets)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA pack kernel)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_pack_kernel_matches_host_packer_on_the_card(name):
    _needs_card()
    db, order, nw, kw = _case(name, 16, 16)
    plan = packing.plan_streams(db.lengths, order, nw, **kw)
    want = packing.pack_streams(db, order, nw, **kw)
    seq, offsets = database_to_torch(db, "cuda")
    launches = pack_streams_device.launches
    streams, fs = pack_streams_device(seq, offsets, plan)
    assert pack_streams_device.launches == launches + 1
    plain = pack_streams_reference(seq, offsets, plan)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(streams.cpu().numpy(), want.streams)
    assert torch.equal(streams, plain[0]) and torch.equal(fs, plain[1])
