"""The port's public functions take the JAX package's parameters in the
JAX package's order, so a call that passes them by position means the same
in both; and the port's ``search_encoded`` against the JAX package's."""

import importlib
import inspect

import numpy as np
import pytest

from seqalign_tpu import pipeline as jax_pipeline
from seqalign_tpu_torch import pipeline

from _torch_cases import make_scoring, random_records
from conftest import random_protein

# The modules both packages define (a path under each package).
MODULES = ("pipeline", "parallel.longpair", "parallel.multidevice",
           "parallel.multihost", "parallel.sharding", "ops.traceback")


def _public_functions(module: str) -> list[str]:
    """The public top-level functions ``seqalign_tpu.<module>`` defines."""
    mod = importlib.import_module(f"seqalign_tpu.{module}")
    return sorted(name for name, f in vars(mod).items()
                  if not name.startswith("_") and inspect.isfunction(f)
                  and f.__module__ == mod.__name__)


CASES = [(m, name) for m in MODULES for name in _public_functions(m)]


@pytest.mark.parametrize("module,name", CASES, ids=[f"{m}.{n}" for m, n in CASES])
def test_port_takes_jax_parameters_in_jax_order(module, name):
    """JAX's parameter names are a prefix, in order, of the port's; the
    port's own extras (``sort``, ``device``) come after them."""
    jax_fn = getattr(importlib.import_module(f"seqalign_tpu.{module}"), name)
    port_fn = getattr(importlib.import_module(f"seqalign_tpu_torch.{module}"), name, None)
    assert port_fn is not None, f"the port has no {module}.{name}"
    want = list(inspect.signature(jax_fn).parameters)
    got = list(inspect.signature(port_fn).parameters)
    assert got[: len(want)] == want, (want, got)


def test_the_pipeline_checks_cover_the_repaired_functions():
    names = {n for m, n in CASES if m == "pipeline"}
    assert {"search_files", "search_database", "search_encoded"} <= names


@pytest.fixture
def _cpu(monkeypatch):
    monkeypatch.setenv("SEQALIGN_PLATFORM", "cpu")


# The port's engine and the JAX package's that scores the same exactly.
ENGINES = {"oracle": "oracle", "wavefront": "wavefront", "stream": "wavefront"}


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("sort", [True, False])
def test_search_encoded_matches_jax(engine, sort, _cpu):
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(11 + sort)
    q = sc.query_indices(random_protein(rng, 13))
    encoded = random_records(rng, 300 if engine == "oracle" else 700, 1, 30)
    want, _ = jax_pipeline.search_encoded(q, encoded, sc, engine=ENGINES[engine], sort=sort)
    got, dt = pipeline.search_encoded(q, encoded, sc, engine=engine, sort=sort)
    assert got.dtype == np.int32 and dt >= 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["empty_list", "empty_query"])
def test_search_encoded_empty_inputs(case, _cpu):
    sc = make_scoring("PAM250")
    rng = np.random.default_rng(12)
    q = sc.query_indices(random_protein(rng, 9))
    encoded = random_records(rng, 40, 1, 20)
    if case == "empty_list":
        encoded = []
    else:
        q = q[:0]
    want, _ = jax_pipeline.search_encoded(q, encoded, sc, engine="wavefront")
    got, dt = pipeline.search_encoded(q, encoded, sc)
    assert got.shape == want.shape == (len(encoded),) and dt == 0.0
    np.testing.assert_array_equal(got, want)


def test_search_goes_through_search_encoded(_cpu, monkeypatch):
    """``search`` scores its records through ``search_encoded``, as the JAX
    package's does."""
    from seqalign_tpu_torch.utils.fasta import SeqRecord

    sc = make_scoring("BLOSUM62")
    seen = []
    real = pipeline.search_encoded

    def spy(*args, **kw):
        seen.append(len(args[1]))
        return real(*args, **kw)

    monkeypatch.setattr(pipeline, "search_encoded", spy)
    recs = [SeqRecord(f"r{k}", s) for k, s in enumerate(["MKVLAW", "HEAGAWGHEE", "W"])]
    res = pipeline.search(SeqRecord("q", "HEAGAW"), recs, sc)
    assert seen == [3]
    want = jax_pipeline.search(SeqRecord("q", "HEAGAW"), recs, sc, engine="wavefront")
    np.testing.assert_array_equal(res.scores, want.scores)


def test_positional_checkpoint_dir_lands_where_jax_puts_it(tmp_path, _cpu):
    """A ``checkpoint_dir`` passed by position is a checkpoint in both
    packages, not a database cache or a device."""
    sc = make_scoring("BLOSUM62")
    q, d = tmp_path / "q.fa", tmp_path / "d.fa"
    q.write_text(">q\nHEAGAWGHEE\n")
    d.write_text("".join(f">r{k}\n{s}\n" for k, s in enumerate(["MKVLAW", "PAWHEAE", "W"])))
    ck = tmp_path / "ck"
    res = pipeline.search_files(str(q), str(d), sc, None, None, False, str(ck))
    assert ck.is_dir() and not list(tmp_path.glob("*.sqc"))
    db = pipeline._db_from_encoded([sc.query_indices(s) for s in ("MKVLAW", "PAWHEAE")])
    got, _ = pipeline.search_database(sc.query_indices("HEAGAW"), db, sc, None, None, True,
                                      str(tmp_path / "ck2"))
    assert (tmp_path / "ck2").is_dir()
    want, _ = jax_pipeline.search_database(sc.query_indices("HEAGAW"), db, sc, "wavefront")
    np.testing.assert_array_equal(got, want)
    assert res.scores.shape == (3,)
