"""The port's own copy of the host code (``seqalign_tpu_torch.models`` and
``.utils``) against the JAX package's: the same inputs give equal outputs."""

import gzip

import numpy as np
import pytest

from seqalign_tpu import models as jax_models
from seqalign_tpu.models import _matrix_data as jax_matrix_data
from seqalign_tpu.utils import fasta as jax_fasta
from seqalign_tpu.utils import native_io as jax_native_io
from seqalign_tpu.utils import packing as jax_packing
from seqalign_tpu_torch import models
from seqalign_tpu_torch.models import _matrix_data
from seqalign_tpu_torch.utils import fasta, native_io, packing

from conftest import random_protein

LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz*"

QUERIES = {
    "alphabet": LETTERS,
    "lowercase": "mkvlawqheag",
    "x_and_star": "MKXVL*AWX**Q",
}


def _scorings(pkg):
    """Both packages' scoring systems of one kind, by name."""
    return {
        "match_mismatch": pkg.sw_default_scoring(),
        "default": pkg.default_scoring(),
        "BLOSUM62": pkg.load_builtin(
            "BLOSUM62", pkg.ScoringModel(gap_open=-2, gap_extend=-1,
                                         use_match_mismatch=False)
        ),
        "PAM250": pkg.load_builtin(
            "PAM250", pkg.ScoringModel(gap_open=-5, gap_extend=-2,
                                       use_match_mismatch=False)
        ),
    }


@pytest.mark.parametrize("query", sorted(QUERIES))
@pytest.mark.parametrize("scoring", ["match_mismatch", "default", "BLOSUM62", "PAM250"])
def test_encode_and_query_indices_match(query, scoring):
    seq = QUERIES[query]
    got, want = models.encode(seq), jax_models.encode(seq)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    sc, jsc = _scorings(models)[scoring], _scorings(jax_models)[scoring]
    got, want = sc.query_indices(seq), jsc.query_indices(seq)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert sc.padding_safe_for_query(got) == jsc.padding_safe_for_query(want)
    assert models.decode(models.encode(seq)) == jax_models.decode(jax_models.encode(seq))


def test_illegal_character_raises_the_same():
    with pytest.raises(models.AlphabetError) as got:
        models.encode("MKV-L")
    with pytest.raises(jax_models.AlphabetError) as want:
        jax_models.encode("MKV-L")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", sorted(jax_matrix_data.BUILTIN_MATRICES))
def test_builtin_matrices_match(name):
    assert sorted(_matrix_data.BUILTIN_MATRICES) == sorted(jax_matrix_data.BUILTIN_MATRICES)
    sc = models.load_builtin(name, models.ScoringModel(gap_open=-2, gap_extend=-1))
    jsc = jax_models.load_builtin(name, jax_models.ScoringModel(gap_open=-2, gap_extend=-1))
    np.testing.assert_array_equal(sc.table, jsc.table)
    np.testing.assert_array_equal(sc.defined, jsc.defined)
    assert (sc.min_penalty, sc.max_penalty, sc.use_match_mismatch) == (
        jsc.min_penalty, jsc.max_penalty, jsc.use_match_mismatch
    )


@pytest.mark.parametrize("name", ["BLOSUM45", "PAM250"])
def test_matrix_file_round_trip_matches(name, tmp_path):
    ours, theirs = tmp_path / "ours.txt", tmp_path / "theirs.txt"
    models.write_matrix_file(str(ours), name)
    jax_models.write_matrix_file(str(theirs), name)
    assert ours.read_bytes() == theirs.read_bytes()
    sc = models.load_substitution_matrix(
        str(ours), models.ScoringModel(gap_open=-2, gap_extend=-1))
    jsc = jax_models.load_substitution_matrix(
        str(ours), jax_models.ScoringModel(gap_open=-2, gap_extend=-1))
    np.testing.assert_array_equal(sc.table, jsc.table)
    np.testing.assert_array_equal(sc.defined, jsc.defined)


def _write_inputs(tmp_path, kind):
    rng = np.random.default_rng(81)
    recs = [(f"r{k} desc {k}", random_protein(rng, int(rng.integers(1, 90))))
            for k in range(60)]
    if kind == "fastq":
        text = "".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n" for n, s in recs)
        path = tmp_path / "db.fq"
        path.write_text(text)
    else:
        # Wrapped lines and a blank line between records.
        text = "".join(
            f">{n}\n" + "\n".join(s[i : i + 30] for i in range(0, len(s), 30)) + "\n\n"
            for n, s in recs
        )
        path = tmp_path / ("db.fa.gz" if kind == "gzip" else "db.fa")
        if kind == "gzip":
            with gzip.open(path, "wt") as f:
                f.write(text)
        else:
            path.write_text(text)
    return str(path)


@pytest.mark.parametrize("kind", ["fasta", "fastq", "gzip"])
def test_read_fasta_and_parse_file_match(kind, tmp_path):
    path = _write_inputs(tmp_path, kind)
    got = [(r.name, r.seq) for r in fasta.read_fasta(path)]
    want = [(r.name, r.seq) for r in jax_fasta.read_fasta(path)]
    assert got == want and len(got) == 60
    first, jfirst = fasta.read_first(path), jax_fasta.read_first(path)
    assert (first.name, first.seq) == (jfirst.name, jfirst.seq)
    db = native_io._parse_file_python(path)
    jdb = jax_native_io._parse_file_python(path)
    assert db.seq.dtype == jdb.seq.dtype == np.int8
    np.testing.assert_array_equal(db.seq, jdb.seq)
    np.testing.assert_array_equal(db.offsets, jdb.offsets)
    assert db.names == jdb.names
    # The port's parse_file finds no native library beside itself.
    np.testing.assert_array_equal(native_io.parse_file(path).seq, jdb.seq)


def test_db_cache_round_trip_matches(tmp_path):
    path = _write_inputs(tmp_path, "fasta")
    ours, theirs = str(tmp_path / "ours.sqc"), str(tmp_path / "theirs.sqc")
    db = native_io.parse_file_cached(path, ours)
    jdb = jax_native_io.parse_file_cached(path, theirs)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    for cache in (ours, theirs):
        got = native_io.load_cache(cache, src_path=path)
        want = jax_native_io.load_cache(cache, src_path=path)
        np.testing.assert_array_equal(got.seq, want.seq)
        np.testing.assert_array_equal(got.offsets, want.offsets)
        assert got.names == want.names == jdb.names == db.names
    # A stale source makes both reject the cache.
    with open(path, "a") as f:
        f.write(">extra\nMKV\n")
    assert native_io.load_cache(ours, src_path=path) is None
    assert jax_native_io.load_cache(ours, src_path=path) is None


@pytest.mark.parametrize(
    "nw,win,jb,grain",
    [(1, 128, 4, 8), (3, 128, 4, 8), (5, 256, 16, 16), (4, 64, 8, 32)],
)
def test_pack_streams_and_pack_batch_match(nw, win, jb, grain):
    rng = np.random.default_rng(82 + nw)
    encoded = [models.encode(random_protein(rng, int(rng.integers(1, 70))))
               for _ in range(700)]
    offsets = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    seq = np.concatenate(encoded).astype(np.int8)
    db = native_io.EncodedDatabase(seq, offsets, [""] * len(encoded))
    jdb = jax_native_io.EncodedDatabase(seq, offsets, [""] * len(encoded))
    order = np.argsort(-db.lengths, kind="stable")
    got = packing.pack_streams(db, order, nw, win=win, jb=jb, grain=grain)
    want = jax_packing.pack_streams(jdb, order, nw, win=win, jb=jb, grain=grain)
    np.testing.assert_array_equal(got.streams, want.streams)
    np.testing.assert_array_equal(got.fs, want.fs)
    assert len(got.slot_ids) == len(want.slot_ids)
    for a, b in zip(got.slot_ids, want.slot_ids):
        np.testing.assert_array_equal(a, b)
    assert (got.real_residues, got.padded_cells_per_query_row) == (
        want.real_residues, want.padded_cells_per_query_row
    )
    ids = order[: win + 3]
    lb = packing.lattice_round_up(int(db.lengths[ids].max()))
    assert lb == jax_packing.lattice_round_up(int(db.lengths[ids].max()))
    np.testing.assert_array_equal(
        native_io.pack_batch(db, ids, win + 3, lb),
        jax_native_io.pack_batch(jdb, ids, win + 3, lb),
    )


def test_no_native_library_beside_the_copy():
    """The port's fastio loads from the build directory at the root of the
    checkout, built from ``native/fastio.cc``; nothing is built beside the
    port's ``native_io`` or anywhere in the JAX package's tree."""
    from pathlib import Path

    from seqalign_tpu_torch import native

    root = Path(__file__).resolve().parent.parent
    lib = native_io._load()
    assert lib is not None and native_io.available()
    path = Path(lib._name)
    assert path.parent == root / "build" / "seqalign_tpu_torch" / "host"
    assert path.name.startswith("_fastio_") and path.exists()
    assert native.load("fastio") is lib
    beside = Path(native_io.__file__).parent
    assert not list(beside.glob("*.so"))
    assert not list((root / "seqalign_tpu").rglob("*.so"))
