"""The port's native ingest, resumable scans and bounded-memory search on the
CPU, held to the pure-Python paths and to the JAX package: the native
library builds from ``native/`` into the build directory, parses, streams
and packs exactly as the Python readers do; ``_ScanCheckpoint`` resumes a
scan without launching; ``search_files_streaming`` scores as
``search_files`` and the JAX package's streaming search do."""

import gzip
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from seqalign_tpu import pipeline as jax_pipeline
from seqalign_tpu.utils import native_io as jax_native_io
from seqalign_tpu.utils import packing as jax_packing
from seqalign_tpu_torch import native, pipeline
from seqalign_tpu_torch.ops import swa_cuda
from seqalign_tpu_torch.utils import native_io, packing

from _torch_cases import make_scoring, random_records
from conftest import random_protein

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SEQALIGN_PLATFORM", "cpu")


@pytest.fixture
def python_only(monkeypatch):
    """The port's native_io with its pure-Python paths."""
    monkeypatch.setattr(native_io, "_load", lambda: None)


def _fasta_text(rng, n, lo=0, hi=80, wrap=None, desc=True):
    out = []
    for k in range(n):
        seq = random_protein(rng, int(rng.integers(lo, hi)))
        if k % 7 == 3:
            seq = seq.lower() + "X*"
        name = f"rec{k} some description {k}" if desc else f"rec{k}"
        if wrap:
            seq = "\n".join(seq[i : i + wrap] for i in range(0, len(seq), wrap))
        out.append(f">{name}\n{seq}\n")
    return "".join(out)


FORMATS = ["fasta", "wrapped", "gzip", "fastq", "crlf", "empty_records", "empty_file"]


def _write(fmt, tmp_path, rng):
    path = tmp_path / f"db_{fmt}.fa"
    if fmt == "fasta":
        path.write_text(_fasta_text(rng, 300))
    elif fmt == "wrapped":
        path.write_text(_fasta_text(rng, 120, wrap=13))
    elif fmt == "gzip":
        path = tmp_path / "db.fa.gz"
        with gzip.open(path, "wt") as f:
            f.write(_fasta_text(rng, 200))
    elif fmt == "fastq":
        path = tmp_path / "db.fq"
        recs = []
        for k in range(90):
            seq = random_protein(rng, int(rng.integers(1, 50)))
            recs.append(f"@read{k} x\n{seq}\n+\n{'I' * len(seq)}\n")
        path.write_text("".join(recs))
    elif fmt == "crlf":
        path.write_bytes(_fasta_text(rng, 60).replace("\n", "\r\n").encode())
    elif fmt == "empty_records":
        path.write_text(">a\n>b\nMKV\n>c\n\n>d\nHEAG\n")
    elif fmt == "empty_file":
        path.write_text("")
    return str(path)


def _same_db(got, want):
    np.testing.assert_array_equal(got.seq, want.seq)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert got.seq.dtype == np.int8 and got.offsets.dtype == np.int64
    assert list(got.names) == list(want.names)


def test_native_library_is_built_and_used():
    assert native_io.available()
    lib = native.load("fastio")
    assert Path(lib._name).parent == native.BUILD_DIR
    assert native.BUILD_DIR == ROOT / "build" / "seqalign_tpu_torch" / "host"


@pytest.mark.parametrize("fmt", FORMATS)
def test_parse_file_native_equals_python_and_jax(fmt, tmp_path):
    path = _write(fmt, tmp_path, np.random.default_rng(41))
    got = native_io.parse_file(path)
    assert isinstance(got._names, str)  # the native parser's raw name blob
    _same_db(got, native_io._parse_file_python(path))
    _same_db(got, jax_native_io._parse_file_python(path))


def _concat(chunks):
    n, seqs, names, offs, base = 0, [], [], [np.zeros(1, np.int64)], 0
    for ch in chunks:
        n += ch.n
        seqs.append(ch.seq)
        names.extend(ch.names)
        offs.append(ch.offsets[1:] + base)
        base += len(ch.seq)
    seq = np.concatenate(seqs) if seqs else np.zeros(0, np.int8)
    return n, seq, np.concatenate(offs), names


@pytest.mark.parametrize("chunk_records", [1, 7, 1000])
@pytest.mark.parametrize("fmt", ["fasta", "gzip", "fastq", "empty_records"])
def test_stream_chunks_native_equals_python_and_jax(fmt, chunk_records, tmp_path):
    path = _write(fmt, tmp_path, np.random.default_rng(42))
    chunks = list(native_io.stream_chunks(path, chunk_records))
    assert all(0 < c.n <= chunk_records for c in chunks)
    assert all(isinstance(c._names, str) for c in chunks)  # native
    n, seq, offsets, names = _concat(chunks)
    whole = native_io.parse_file(path)
    assert n == whole.n
    np.testing.assert_array_equal(seq, whole.seq)
    np.testing.assert_array_equal(offsets, whole.offsets)
    assert names == whole.names
    for plain in (native_io._stream_chunks_python(path, chunk_records),
                  jax_native_io._stream_chunks_python(path, chunk_records)):
        plain = list(plain)
        assert [c.n for c in plain] == [c.n for c in chunks]
        for a, b in zip(chunks, plain):
            _same_db(a, b)


def test_stream_chunks_python_route(python_only, tmp_path):
    """With no native library (or for stdin), the Python reader serves."""
    path = _write("fasta", tmp_path, np.random.default_rng(43))
    chunks = list(native_io.stream_chunks(path, 64))
    assert all(isinstance(c._names, list) for c in chunks)
    want = list(jax_native_io._stream_chunks_python(path, 64))
    assert len(chunks) == len(want)
    for a, b in zip(chunks, want):
        _same_db(a, b)


@pytest.mark.parametrize("reader", ["parse_file", "stream_chunks"])
@pytest.mark.parametrize("native_lib", [True, False])
def test_parse_errors_match_jax(reader, native_lib, tmp_path, monkeypatch):
    from seqalign_tpu.models import AlphabetError as JaxAlphabetError
    from seqalign_tpu_torch.models import AlphabetError

    if not native_lib:
        monkeypatch.setattr(native_io, "_load", lambda: None)
    bad = tmp_path / "bad.fa"
    bad.write_text(">ok\nMKV\n" * 20 + ">x\nAC1DE\n")

    def run(mod, path):
        if reader == "parse_file":
            return mod.parse_file(path)
        return list(mod.stream_chunks(path, 4))

    with pytest.raises(AlphabetError):
        run(native_io, str(bad))
    with pytest.raises(JaxAlphabetError):
        run(jax_native_io, str(bad))
    with pytest.raises(OSError):
        run(native_io, str(tmp_path / "missing.fa"))


@pytest.mark.parametrize("chunk_records", [1, 33, 5000])
def test_iter_cache_chunks_matches_jax(chunk_records, tmp_path):
    path = _write("fasta", tmp_path, np.random.default_rng(44))
    db = native_io.parse_file_cached(path, "auto")
    assert os.path.exists(path + ".sqc")
    cached = native_io.load_cache(path + ".sqc", src_path=path)
    assert isinstance(cached.seq, np.memmap)
    jcached = jax_native_io.load_cache(path + ".sqc", src_path=path)
    got = list(native_io.iter_cache_chunks(cached, chunk_records))
    want = list(jax_native_io.iter_cache_chunks(jcached, chunk_records))
    assert len(got) == len(want) == -(-db.n // chunk_records)
    for a, b in zip(got, want):
        _same_db(a, b)
    n, seq, offsets, names = _concat(got)
    np.testing.assert_array_equal(seq, db.seq)
    np.testing.assert_array_equal(offsets, db.offsets)
    assert names == db.names


@pytest.mark.parametrize("lanes, lb_pad", [(16, 48), (100, 96), (256, 16), (3, 400)])
def test_pack_batch_native_equals_python_and_jax(lanes, lb_pad, monkeypatch):
    rng = np.random.default_rng(45)
    db = pipeline._db_from_encoded(random_records(rng, 500, 0, 300))
    fits = np.flatnonzero(db.lengths <= lb_pad)  # callers pad to the longest
    order = rng.permutation(fits)[: lanes - (lanes > 3)]
    got = native_io.pack_batch(db, order, lanes, lb_pad)
    out = np.full((lb_pad, lanes), 7, np.int8)
    assert native_io.pack_batch(db, order, lanes, lb_pad, out=out) is out
    np.testing.assert_array_equal(out, got)
    np.testing.assert_array_equal(got, jax_native_io.pack_batch(db, order, lanes, lb_pad))
    monkeypatch.setattr(native_io, "_load", lambda: None)
    np.testing.assert_array_equal(got, native_io.pack_batch(db, order, lanes, lb_pad))


@pytest.mark.parametrize("nw", [1, 3, 8])
def test_pack_streams_native_equals_jax(nw):
    rng = np.random.default_rng(46)
    db = pipeline._db_from_encoded(random_records(rng, 1300, 1, 90))
    order = np.argsort(-db.lengths, kind="stable")
    got = packing.pack_streams(db, order, nw, win=256, jb=16, grain=16)
    want = jax_packing.pack_streams(db, order, nw, win=256, jb=16, grain=16)
    np.testing.assert_array_equal(got.streams, want.streams)
    np.testing.assert_array_equal(got.fs, want.fs)
    assert len(got.slot_ids) == len(want.slot_ids)
    for a, b in zip(got.slot_ids, want.slot_ids):
        np.testing.assert_array_equal(a, b)


_RACE = """
import sys
from pathlib import Path
sys.path.insert(0, {root!r})
from seqalign_tpu_torch import native
path = native.build(sys.argv[1], Path(sys.argv[2]))
import ctypes
ctypes.CDLL(str(path))
print(path)
"""


@pytest.mark.parametrize("name", ["fastio", "traceback"])
def test_build_race_ends_in_one_good_library(name, tmp_path):
    """Several processes building at once into an empty directory all load
    the same whole library, and leave no temporary file behind."""
    out = tmp_path / "build"
    script = tmp_path / "race.py"
    script.write_text(_RACE.format(root=str(ROOT)))
    procs = [subprocess.Popen([sys.executable, str(script), name, str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    results = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [r[1] for r in results]
    paths = {r[0].strip() for r in results}
    assert len(paths) == 1
    assert sorted(p.name for p in out.iterdir()) == [Path(paths.pop()).name]


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "native"
    src.mkdir()
    (src / "traceback.cc").write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCES", src)
    with pytest.raises(RuntimeError, match="error"):
        native.build("traceback", tmp_path / "out")
    assert not list((tmp_path / "out").glob("*"))


def test_build_is_keyed_on_source_flags_and_cpu(tmp_path, monkeypatch):
    first = native.build("traceback", tmp_path)
    assert native.build("traceback", tmp_path) == first
    monkeypatch.setattr(native, "_cpu", lambda: "another cpu")
    other = native.build("traceback", tmp_path)
    assert other != first and other.exists()
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ["-DSEQALIGN_TEST"])
    assert native.build("traceback", tmp_path) not in (first, other)


def test_no_compiler_keeps_the_python_paths(monkeypatch):
    monkeypatch.setattr(native, "compiler", lambda: None)
    monkeypatch.setattr(native, "_loaded", {})
    assert native.load("fastio") is None
    with pytest.raises(RuntimeError, match="no C"):
        native.build("fastio")


# --- resumable scans -------------------------------------------------------


def _launches():
    return (swa_cuda.sw_stream_reference.calls
            + swa_cuda.sw_stream_striped_pass_reference.calls)


@pytest.fixture
def scan(monkeypatch):
    """A 1500-record scan cut into six chunks of one lane group each."""
    monkeypatch.setattr(pipeline, "MAX_STREAM_SLOTS", 1)
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(47)
    q = sc.query_indices(random_protein(rng, 11))
    db = pipeline._db_from_encoded(random_records(rng, 1500, 1, 20))
    return sc, q, db


def _search(sc, q, db, ck, sort=True):
    return pipeline.search_database(q, db, sc, sort=sort, checkpoint_dir=ck)


@pytest.mark.parametrize("route", ["k1", "k2"])
def test_checkpoint_resume(route, scan, tmp_path, monkeypatch):
    sc, q, db = scan
    if route == "k2":  # the striped route at 16 rows, stripes of 8
        monkeypatch.setattr(swa_cuda, "MAX_QUERY_ROWS", 8)
        monkeypatch.setattr(swa_cuda, "STRIPE_ROWS", 8)
    ck = str(tmp_path / "ckpt")
    want, _ = jax_pipeline.search_database(q, db, sc, engine="oracle")
    per_chunk = 2 if route == "k2" else 1
    n0 = _launches()
    first, _ = _search(sc, q, db, ck)
    chunks = len(pipeline.chunk_bounds(db, np.argsort(-db.lengths, kind="stable")))
    assert chunks == 6 and _launches() - n0 == chunks * per_chunk
    np.testing.assert_array_equal(first, want)
    manifest = json.loads(Path(ck, "manifest.json").read_text())
    assert sorted(manifest["chunks"]) == [256 * k for k in range(6)]

    # A finished scan launches nothing and times nothing.
    n0 = _launches()
    second, dt = _search(sc, q, db, ck)
    assert _launches() == n0 and dt == 0.0
    np.testing.assert_array_equal(second, first)

    # One chunk dropped from the manifest: exactly that chunk relaunches.
    manifest["chunks"].remove(512)
    Path(ck, "manifest.json").write_text(json.dumps(manifest))
    n0 = _launches()
    third, _ = _search(sc, q, db, ck)
    assert _launches() - n0 == per_chunk
    np.testing.assert_array_equal(third, first)


@pytest.mark.parametrize("change", ["chunk_plan", "penalties", "order", "query"])
def test_checkpoint_of_another_scan_is_not_reused(change, scan, tmp_path, monkeypatch):
    sc, q, db = scan
    ck = str(tmp_path / "ckpt")
    _search(sc, q, db, ck)
    sort = True
    if change == "chunk_plan":
        monkeypatch.setattr(pipeline, "MAX_STREAM_SLOTS", 2)
    elif change == "penalties":
        sc = make_scoring("BLOSUM62")
        sc.gap_open -= 1
    elif change == "order":
        sort = False
    else:
        q = q[:-1]
    n0 = _launches()
    got, _ = _search(sc, q, db, ck, sort=sort)
    chunks = len(pipeline.chunk_bounds(db, np.arange(db.n)))
    assert _launches() - n0 == chunks
    want, _ = pipeline.search_database(q, db, sc, sort=sort)  # no checkpoint
    np.testing.assert_array_equal(got, want)


def test_checkpoint_of_a_striped_scan_keys_its_chunk_plan(tmp_path, monkeypatch):
    """The striped search's chunks come from STRIPED_SCRATCH_BYTES: a scan
    resumed under another budget starts afresh."""
    monkeypatch.setattr(swa_cuda, "MAX_QUERY_ROWS", 8)
    monkeypatch.setattr(swa_cuda, "STRIPE_ROWS", 8)
    monkeypatch.setattr(pipeline, "STRIPED_SCRATCH_BYTES", 16 * 2 * 4000)
    sc = make_scoring("PAM250")
    rng = np.random.default_rng(48)
    q = sc.query_indices(random_protein(rng, 13))
    db = pipeline._db_from_encoded(random_records(rng, 900, 1, 30))
    ck = str(tmp_path / "ckpt")
    first, _ = _search(sc, q, db, ck)
    order = np.argsort(-db.lengths, kind="stable")
    before = pipeline.chunk_bounds(db, order, pipeline.striped_chunk_residues())
    assert len(before) > 1
    monkeypatch.setattr(pipeline, "STRIPED_SCRATCH_BYTES", 16 * 2 * 9000)
    after = pipeline.chunk_bounds(db, order, pipeline.striped_chunk_residues())
    assert after != before
    n0 = swa_cuda.sw_stream_striped_pass_reference.calls
    second, _ = _search(sc, q, db, ck)
    assert swa_cuda.sw_stream_striped_pass_reference.calls - n0 == 2 * len(after)
    np.testing.assert_array_equal(first, second)
    want, _ = jax_pipeline.search_database(q, db, sc, engine="oracle")
    np.testing.assert_array_equal(second, want)


# --- bounded-memory search -------------------------------------------------


@pytest.fixture
def stream_files(tmp_path):
    rng = np.random.default_rng(49)
    q = tmp_path / "q.fa"
    q.write_text(">query one\n" + random_protein(rng, 19) + "\n")
    d = tmp_path / "db.fa"
    d.write_text(_fasta_text(rng, 700, 1, 60))
    return str(q), str(d)


@pytest.mark.parametrize("chunk_records", [97, 250, 700, 10000])
def test_search_files_streaming_matches_search_files_and_jax(chunk_records, stream_files):
    q, d = stream_files
    sc = make_scoring("PAM250")
    n0 = swa_cuda.sw_stream_reference.calls
    got = pipeline.search_files_streaming(q, d, sc, chunk_records=chunk_records)
    assert swa_cuda.sw_stream_reference.calls - n0 == -(-700 // chunk_records)
    whole = pipeline.search_files(q, d, sc)
    want = jax_pipeline.search_files_streaming(
        q, d, sc, engine="oracle", chunk_records=chunk_records)
    np.testing.assert_array_equal(got.scores, whole.scores)
    np.testing.assert_array_equal(got.scores, want.scores)
    assert got.names == whole.names == want.names
    assert (got.query_name, got.total_entries) == (want.query_name, 700)


def test_streaming_checkpoint_parts_resume(stream_files, tmp_path):
    q, d = stream_files
    sc = make_scoring("BLOSUM62")
    ck = tmp_path / "ck"
    first = pipeline.search_files_streaming(q, d, sc, chunk_records=300,
                                            checkpoint_dir=str(ck))
    assert sorted(p.name for p in ck.iterdir()) == ["part0", "part1", "part2"]
    n0 = _launches()
    again = pipeline.search_files_streaming(q, d, sc, chunk_records=300,
                                            checkpoint_dir=str(ck))
    assert _launches() == n0 and again.kernel_time == 0.0
    np.testing.assert_array_equal(first.scores, again.scores)
    np.testing.assert_array_equal(first.scores, pipeline.search_files(q, d, sc).scores)


def test_streaming_cache_route(stream_files, capsys):
    q, d = stream_files
    sc = make_scoring("BLOSUM45")
    want = pipeline.search_files(q, d, sc).scores
    # No cache yet: the FASTA streams, with a Note, and no cache is built.
    got = pipeline.search_files_streaming(q, d, sc, chunk_records=64, db_cache="auto")
    assert "Note: database cache" in capsys.readouterr().err
    assert not os.path.exists(d + ".sqc")
    np.testing.assert_array_equal(got.scores, want)
    native_io.parse_file_cached(d, "auto")
    calls = []
    real = native_io.iter_cache_chunks

    def spy(db, n):
        calls.append(n)
        return real(db, n)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native_io, "iter_cache_chunks", spy)
        cached = pipeline.search_files_streaming(q, d, sc, chunk_records=64,
                                                 db_cache="auto")
    assert calls == [64] and "Note:" not in capsys.readouterr().err
    np.testing.assert_array_equal(cached.scores, want)
    jcached = jax_pipeline.search_files_streaming(
        q, d, sc, engine="oracle", chunk_records=64, db_cache="auto")
    assert cached.names == jcached.names
    np.testing.assert_array_equal(cached.scores, jcached.scores)
    os.remove(d)  # a cache-only deployment streams too
    only = pipeline.search_files_streaming(q, d, sc, chunk_records=77, db_cache="auto")
    np.testing.assert_array_equal(only.scores, want)


@pytest.mark.parametrize("native_lib", [True, False])
def test_streaming_producer_error_reaches_the_caller(native_lib, tmp_path, monkeypatch):
    from seqalign_tpu_torch.models import AlphabetError

    if not native_lib:
        monkeypatch.setattr(native_io, "_load", lambda: None)
    rng = np.random.default_rng(50)
    q = tmp_path / "q.fa"
    q.write_text(">q\n" + random_protein(rng, 12) + "\n")
    d = tmp_path / "d.fa"
    d.write_text(_fasta_text(rng, 120, 1, 30, desc=False) + ">bad\nAC1DE\n")
    with pytest.raises(AlphabetError):
        pipeline.search_files_streaming(str(q), str(d), make_scoring("BLOSUM62"),
                                        chunk_records=32)


def test_streaming_producer_released_on_consumer_failure(stream_files, monkeypatch):
    q, d = stream_files
    calls = []

    def boom(*a, **k):
        calls.append(1)
        raise RuntimeError("simulated kernel failure")

    monkeypatch.setattr(pipeline, "search_database", boom)
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="simulated kernel failure"):
        pipeline.search_files_streaming(q, d, make_scoring("BLOSUM62"), chunk_records=50)
    assert calls == [1]  # the failure came with parts still to read
    deadline = time.time() + 10
    leaked = []
    while time.time() < deadline:
        leaked = [t for t in set(threading.enumerate()) - before if t.is_alive()]
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked
