"""The pipeline's plan memo (``pipeline.PlanMemo``): a database's length
order, chunk bounds and stream plans are made once and kept between
searches of the same records, found by the content of their offsets.

The file imports neither JAX nor the JAX package.
"""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from seqalign_tpu_torch import pipeline
from seqalign_tpu_torch.host import ScoringModel, encode, load_builtin
from seqalign_tpu_torch.ops import swa_cuda

AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def scoring():
    return load_builtin("BLOSUM62", ScoringModel(gap_open=-11, gap_extend=-1,
                                                 use_match_mismatch=False))


@pytest.fixture
def memo(monkeypatch):
    """A memo of the test's own that holds nothing yet; ``planned`` counts
    the chunks planned (``pipeline.plan_chunk``) since it was made."""
    memo = pipeline.PlanMemo()
    monkeypatch.setattr(pipeline, "PLANS", memo)
    memo.planned = 0
    plan_chunk = pipeline.plan_chunk

    def spy(*args, **kwargs):
        memo.planned += 1
        return plan_chunk(*args, **kwargs)

    monkeypatch.setattr(pipeline, "plan_chunk", spy)
    return memo


def protein(rng, n):
    return encode("".join(AMINO_ACIDS[i] for i in rng.integers(0, 20, n)))


def database(rng, n=300, top=80):
    return pipeline._db_from_encoded([protein(rng, int(k)) for k in rng.integers(1, top, n)])


def several_chunks(monkeypatch):
    monkeypatch.setattr(pipeline, "MAX_STREAM_SLOTS", 1)


def long_queries(monkeypatch):
    """A query over 16 rows is searched through K2, in stripes of 8 rows."""
    monkeypatch.setattr(swa_cuda, "MAX_QUERY_ROWS", 16)
    monkeypatch.setattr(swa_cuda, "STRIPE_ROWS", 8)


def plan_arrays(planned):
    """Copies of every array the memo holds for ``planned``."""
    out = [planned.offsets.copy(), planned.lengths.copy(), planned.order.copy()]
    for key, cut in planned.cuts.items():
        out.append(np.asarray(cut.bounds).copy())
        for plan in cut.plans.values():
            out += [a.copy() for a in (plan.order, plan.slot_w, plan.slot_start,
                                       plan.slot_lb, plan.fs)]
    return out


def streams_hash(monkeypatch):
    """A list that takes the sha256 of each chunk's packed streams and
    segment table, as the search packs them."""
    hashes, pack = [], pipeline.pack_streams_device

    def spy(*args, **kwargs):
        streams, fs = pack(*args, **kwargs)
        h = hashlib.sha256(streams.cpu().numpy().tobytes())
        h.update(fs.cpu().numpy().tobytes())
        hashes.append(h.hexdigest())
        return streams, fs

    monkeypatch.setattr(pipeline, "pack_streams_device", spy)
    return hashes


@pytest.mark.parametrize("route", ["k1", "k2", "k3", "wavefront"])
def test_a_second_search_of_the_records_hits(route, scoring, memo, monkeypatch):
    """The second search of a database plans nothing and finds the first's
    entry; its scores equal the first's, and a copy of the database (another
    object, the same records) hits as well."""
    several_chunks(monkeypatch)
    long_queries(monkeypatch)
    rng = np.random.default_rng(71)
    db = database(rng, 900)
    lengths = {"k1": [12], "k2": [40], "k3": [12, 9, 15], "wavefront": [12]}[route]
    queries = [protein(rng, n) for n in lengths]
    engine = "wavefront" if route == "wavefront" else None

    def search(d):
        if len(queries) > 1:
            return pipeline.search_database_multi(queries, d, scoring, device="cpu")[0]
        return pipeline.search_database(queries[0], d, scoring, engine=engine, device="cpu")[0]

    first = search(db)
    (entry,) = memo.entries
    planned = memo.planned
    assert planned == (0 if engine else len(pipeline.chunk_bounds(db, entry.order, (
        pipeline.striped_chunk_residues() if route == "k2" else None))))
    copy = pipeline._db_from_encoded([db.record(i).copy() for i in range(db.n)])
    for d in (db, copy):
        np.testing.assert_array_equal(search(d), first)
        assert memo.entries == [entry] and memo.planned == planned


def test_scores_on_a_hit_equal_a_fresh_process(scoring, memo, tmp_path):
    """A search that hits the memo scores as a new process's first search
    of the same records."""
    rng = np.random.default_rng(73)
    db = database(rng)
    q = protein(rng, 30)
    pipeline.search_database(q, db, scoring, device="cpu")
    hit, _ = pipeline.search_database(q, db, scoring, device="cpu")
    assert memo.planned == 1
    np.savez(tmp_path / "case.npz", seq=db.seq, offsets=db.offsets, query=q)
    script = f"""
import numpy as np
from seqalign_tpu_torch import pipeline
from seqalign_tpu_torch.host import EncodedDatabase, ScoringModel, load_builtin
case = np.load({str(tmp_path / "case.npz")!r})
db = EncodedDatabase(seq=case["seq"], offsets=case["offsets"], names=[""] * (len(case["offsets"]) - 1))
sc = load_builtin("BLOSUM62", ScoringModel(gap_open=-11, gap_extend=-1, use_match_mismatch=False))
scores, _ = pipeline.search_database(case["query"], db, sc, device="cpu")
np.save({str(tmp_path / "fresh.npy")!r}, scores)
"""
    subprocess.run([sys.executable, "-c", script], cwd=ROOT, check=True, timeout=300,
                   env={"PATH": "/usr/bin:/bin", "SEQALIGN_PLATFORM": "cpu",
                        "PYTHONPATH": str(ROOT), "HOME": str(tmp_path)})
    np.testing.assert_array_equal(hit, np.load(tmp_path / "fresh.npy"))


@pytest.mark.parametrize("copy", ["whole", "per chunk"])
def test_the_packed_streams_are_equal_on_a_hit_and_a_miss(copy, scoring, memo, monkeypatch):
    several_chunks(monkeypatch)
    if copy == "per chunk":
        monkeypatch.setattr(pipeline, "device_free_bytes", lambda device: 1000)
    hashes = streams_hash(monkeypatch)
    rng = np.random.default_rng(79)
    db = database(rng, 900)
    q = protein(rng, 20)
    pipeline.search_database(q, db, scoring, device="cpu")
    miss = list(hashes)
    assert len(miss) == memo.planned > 1
    hashes.clear()
    pipeline.search_database(q, db, scoring, device="cpu")
    assert hashes == miss and memo.planned == len(miss)


def test_stream_chunks_take_the_search_s_plans(scoring, memo, monkeypatch):
    """After a search of a database, ``stream_chunks`` over its records
    plans nothing, yields the search's chunks in its order and packs the
    streams the search packed, which a fresh memo packs too."""
    several_chunks(monkeypatch)
    hashes = streams_hash(monkeypatch)
    rng = np.random.default_rng(127)
    db = database(rng, 900)
    pipeline.search_database(protein(rng, 20), db, scoring, device="cpu")
    (entry,) = memo.entries
    (cut,) = entry.cuts.values()
    searched, planned = list(hashes), memo.planned
    assert len(searched) == planned == len(cut.bounds) > 1
    hashes.clear()
    chunks = [c for c, _ in pipeline.stream_chunks(db, None, torch.device("cpu"))]
    assert memo.planned == planned and memo.entries == [entry]
    assert len(chunks) == len(cut.bounds)
    for (start, stop), chunk in zip(cut.bounds, chunks):
        np.testing.assert_array_equal(chunk, entry.order[start:stop])
    assert hashes == searched
    hashes.clear()
    monkeypatch.setattr(pipeline, "PLANS", pipeline.PlanMemo())
    fresh = [c for c, _ in pipeline.stream_chunks(db, None, torch.device("cpu"))]
    assert memo.planned == 2 * planned and hashes == searched
    for a, b in zip(chunks, fresh, strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sort", [True, False])
def test_the_order_is_the_stable_length_sort(sort, scoring, memo):
    """The memo's order is the stable descending argsort of the lengths (or
    ``arange`` unsorted), and the plans hold it chunk by chunk."""
    rng = np.random.default_rng(83)
    db = database(rng, 600, top=12)  # many equal lengths: the sort's stability shows
    pipeline.search_database(protein(rng, 20), db, scoring, sort=sort, device="cpu")
    (entry,) = memo.entries
    want = np.argsort(-db.lengths, kind="stable") if sort else np.arange(db.n)
    np.testing.assert_array_equal(entry.order, want)
    (cut,) = entry.cuts.values()
    np.testing.assert_array_equal(
        np.concatenate([cut.plans[a].order for a, _ in cut.bounds]), want)


@pytest.mark.parametrize("change", ["offsets in place", "another database"])
def test_other_records_miss(change, scoring, memo, monkeypatch):
    """A database whose offsets changed in place, or another of the same
    size, is planned afresh and scores as with a memo of its own."""
    rng = np.random.default_rng(89)
    db = database(rng)
    q = protein(rng, 20)
    pipeline.search_database(q, db, scoring, device="cpu")
    if change == "offsets in place":
        k = int(np.flatnonzero(db.lengths[:-1] > 1)[0])
        db.offsets[k + 1] -= 1  # one residue moves from record k to k + 1
        other = db
    else:
        other = database(rng)
        assert other.n == db.n and not np.array_equal(other.offsets, db.offsets)
    got, _ = pipeline.search_database(q, other, scoring, device="cpu")
    assert len(memo.entries) == 2 and memo.planned == 2
    np.testing.assert_array_equal(memo.entries[-1].offsets, other.offsets)
    monkeypatch.setattr(pipeline, "PLANS", pipeline.PlanMemo())
    want, _ = pipeline.search_database(q, other, scoring, device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("second", ["other lanes", "striped", "unsorted"])
def test_other_cuts_are_other_entries(second, scoring, memo, monkeypatch):
    """Other lanes, a long query's striped chunks and the unsorted order are
    planned apart from the first search's, and each hits after."""
    long_queries(monkeypatch)
    rng = np.random.default_rng(97)
    db = database(rng)
    short, long = protein(rng, 12), protein(rng, 40)
    first = dict(query=short)
    other = {"other lanes": dict(query=short, lanes=512), "striped": dict(query=long),
             "unsorted": dict(query=short, sort=False)}[second]

    def search(query, **kw):
        return pipeline.search_database(query, db, scoring, device="cpu", **kw)[0]

    a, b = search(**first), search(**other)
    assert memo.planned == 2
    cuts = sum(len(e.cuts) for e in memo.entries)
    assert (len(memo.entries), cuts) == ((2, 2) if second == "unsorted" else (1, 2))
    np.testing.assert_array_equal(search(**first), a)
    np.testing.assert_array_equal(search(**other), b)
    assert memo.planned == 2


@pytest.mark.parametrize("what", ["databases", "cuts"])
def test_the_memo_keeps_at_most_its_size(what, scoring, memo):
    """Past its size the memo drops the entry used least recently: six
    databases leave the last four, six lanes settings the last four cuts."""
    rng = np.random.default_rng(101)
    q = protein(rng, 12)
    dbs = [database(rng, 100) for _ in range(6)] if what == "databases" else [database(rng)] * 6
    for k, db in enumerate(dbs):
        lanes = None if what == "databases" else 256 * (k + 1)
        pipeline.search_database(q, db, scoring, lanes=lanes, device="cpu")
        sizes = [len(e.cuts) for e in memo.entries]
        assert len(sizes) <= pipeline.PLAN_MEMO_SIZE and max(sizes) <= pipeline.PLAN_MEMO_SIZE
    assert memo.planned == 6
    if what == "databases":
        assert [e.offsets.tolist() for e in memo.entries] == [d.offsets.tolist() for d in dbs[2:]]
    else:
        (entry,) = memo.entries
        assert [key[0] for key in entry.cuts] == [256 * k for k in range(3, 7)]
    # The first is gone: planned again.
    pipeline.search_database(q, dbs[0], scoring, lanes=None if what == "databases" else 256,
                             device="cpu")
    assert memo.planned == 7


@pytest.mark.parametrize("route", ["whole copy", "per-chunk copy", "striped", "batch",
                                   "checkpoint"])
def test_a_search_writes_nothing_the_memo_holds(route, scoring, memo, monkeypatch, tmp_path):
    several_chunks(monkeypatch)
    long_queries(monkeypatch)
    if route == "per-chunk copy":
        monkeypatch.setattr(pipeline, "device_free_bytes", lambda device: 1000)
    rng = np.random.default_rng(103)
    db = database(rng, 700)
    queries = {"striped": [protein(rng, 40)], "batch": [protein(rng, n) for n in (12, 7)]}.get(
        route, [protein(rng, 14)])
    ck = str(tmp_path / "ck") if route == "checkpoint" else None

    def search():
        if len(queries) > 1:
            return pipeline.search_database_multi(queries, db, scoring, device="cpu")[0]
        return pipeline.search_database(queries[0], db, scoring, checkpoint_dir=ck,
                                        device="cpu")[0]

    search()
    (entry,) = memo.entries
    before = plan_arrays(entry)
    if ck:  # the rerun plans and packs the chunks the manifest lacks
        manifest = Path(ck, "manifest.json")
        state = json.loads(manifest.read_text())
        state["chunks"] = state["chunks"][:1]
        manifest.write_text(json.dumps(state))
    search()
    after = plan_arrays(entry)
    assert len(after) == len(before) > 3 + 5
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)


def test_a_checkpointed_scan_resumes_on_a_hit(scoring, memo, monkeypatch, tmp_path):
    """A scan resumed in the same process takes its order and chunks from
    the memo: the checkpoint's key is the same, the chunks the manifest
    holds launch nothing, and the one it lost launches alone."""
    several_chunks(monkeypatch)
    rng = np.random.default_rng(107)
    db = database(rng, 1200)
    q = protein(rng, 11)
    ck = tmp_path / "ck"
    first, _ = pipeline.search_database(q, db, scoring, checkpoint_dir=str(ck), device="cpu")
    state = json.loads((ck / "manifest.json").read_text())
    chunks = len(state["chunks"])
    assert chunks > 2 and memo.planned == chunks
    state["chunks"].remove(512)
    (ck / "manifest.json").write_text(json.dumps(state))
    calls = swa_cuda.sw_stream_reference.calls
    again, _ = pipeline.search_database(q, db, scoring, checkpoint_dir=str(ck), device="cpu")
    assert swa_cuda.sw_stream_reference.calls - calls == 1
    assert memo.planned == chunks
    resumed = json.loads((ck / "manifest.json").read_text())
    assert resumed["key"] == state["key"] and sorted(resumed["chunks"]) == sorted(
        state["chunks"] + [512])
    np.testing.assert_array_equal(again, first)


def test_concurrent_searches_share_one_entry(scoring, memo):
    """Searches of one database on several threads find one entry, plan its
    chunk once and score alike."""
    import threading

    rng = np.random.default_rng(109)
    db = database(rng)
    q = protein(rng, 16)
    want, _ = pipeline.search_database(q, db, scoring, device="cpu")
    memo.entries.clear()
    memo.planned = 0
    out = [None] * 4

    def run(k):
        out[k] = pipeline.search_database(q, db, scoring, device="cpu")[0]

    threads = [threading.Thread(target=run, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert len(memo.entries) == 1 and memo.planned == 1
    for got in out:
        np.testing.assert_array_equal(got, want)


def test_no_device_tensor_is_kept(scoring, memo):
    rng = np.random.default_rng(113)
    db = database(rng)
    pipeline.search_database(protein(rng, 16), db, scoring, device="cpu")
    (entry,) = memo.entries
    held = [entry.offsets, entry.lengths, entry.order]
    for cut in entry.cuts.values():
        held += [v for p in cut.plans.values() for v in vars(p).values()]
    assert not any(isinstance(v, torch.Tensor) for v in held)
    assert all(isinstance(v, (np.ndarray, int)) for v in held)
