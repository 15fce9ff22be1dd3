"""The port's CLI against the JAX package's CLI with ``--engine oracle``:
identical output once the ``Total Time`` line is dropped."""

import gzip
import json

import numpy as np
import pytest
import torch

from seqalign_tpu import cli as jax_cli
from seqalign_tpu_torch import cli

from conftest import random_protein


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("SEQALIGN_PLATFORM", "cpu")


@pytest.fixture
def files(tmp_path):
    rng = np.random.default_rng(31)
    q = tmp_path / "q.fa"
    q.write_text(">query1 test\n" + random_protein(rng, 24) + "\n")
    recs = "".join(
        f">entry{k} d{k}\n{random_protein(rng, int(rng.integers(1, 60)))}\n"
        for k in range(40)
    )
    db = tmp_path / "db.fa"
    db.write_text(recs)
    dbz = tmp_path / "db.fa.gz"
    with gzip.open(dbz, "wt") as f:
        f.write(recs)
    multi = tmp_path / "multi.fa"
    multi.write_text(">a\nMKVLAWQ\n>b\nHEAGAWGHEE\n")
    multi3 = tmp_path / "multi3.fa"
    multi3.write_text("".join(
        f">mq{k} query {k}\n{random_protein(rng, 5 + 7 * k)}\n" for k in range(3)
    ))
    return {"q": str(q), "db": str(db), "dbz": str(dbz), "multi": str(multi),
            "multi3": str(multi3)}


def _run(main, args, capsys):
    code = main(["smith_waterman"] + args)
    out, err = capsys.readouterr()
    return code, out, err


def _drop_time(out):
    return [ln for ln in out.splitlines() if not ln.startswith("Total Time:")]


CASES = {
    "default": [],
    "blosum62": ["--substitution_matrix", "BLOSUM62"],
    "pam250_gaps": ["--substitution_matrix", "PAM250", "--gapopen", "-5",
                    "--gapextend", "-2"],
    "gzip": ["--db", "dbz"],
    "topk": ["--substitution_matrix", "BLOSUM45", "--topk", "5"],
    "minscore": ["--minscore", "6"],
    "printfasta_seq": ["--printfasta", "--printseq"],
    "gapopen_positive": ["--gapopen", "2"],
    "no_sort_lanes": ["--no-sort", "--lanes", "512"],
    "first_query": ["--q", "multi", "--first-query"],
}


def _args(case, files):
    args = list(CASES[case])
    q, db = files["q"], files["db"]
    if "--db" in args:
        db = files[args.pop(args.index("--db") + 1)]
        args.remove("--db")
    if "--q" in args:
        q = files[args.pop(args.index("--q") + 1)]
        args.remove("--q")
    return ["--files", q, db] + args


@pytest.mark.parametrize("case", sorted(CASES))
def test_output_matches_jax_oracle(case, files, capsys):
    args = _args(case, files)
    # A positive gap makes '*' padding score: the JAX package routes that
    # system to its wavefront engine over the same lane batches, as the
    # port does, and the unpadded oracle scores it differently.
    jax_engine = "wavefront" if case == "gapopen_positive" else "oracle"
    code, out, _ = _run(cli.main, args, capsys)
    jcode, jout, _ = _run(jax_cli.main, args + ["--engine", jax_engine], capsys)
    assert code == jcode == 0
    assert "Entry #" in out and "Total Time:" in out
    assert _drop_time(out) == _drop_time(jout)


@pytest.mark.parametrize("extra", [[], ["--topk", "3", "--minscore", "5"]])
def test_json_matches_jax_oracle(extra, files, capsys):
    args = ["--files", files["q"], files["db"], "--json"] + extra
    code, out, _ = _run(cli.main, args, capsys)
    jcode, jout, _ = _run(jax_cli.main, args + ["--engine", "oracle"], capsys)
    assert code == jcode == 0
    got, want = (json.loads(o.splitlines()[-1]) for o in (out, jout))
    for d in (got, want):
        d.pop("total_time")
        d.pop("entries_per_s")
    assert got == want


@pytest.mark.parametrize("flag", cli.NOT_PORTED)
def test_flag_not_yet_ported(flag, files, capsys):
    code, out, err = _run(
        cli.main, ["--files", files["q"], files["db"], flag, "1"], capsys
    )
    assert code == 1
    assert f"Error: {flag} is not yet ported to seqalign_tpu_torch" in err
    assert "Entry #" not in out


def test_multi_record_query_not_yet_ported(files, capsys):
    """A multi-record query file is no longer refused: every record is
    scored, one ``Query #k`` block each, as the JAX CLI prints it."""
    args = ["--files", files["multi"], files["db"]]
    code, out, err = _run(cli.main, args, capsys)
    jcode, jout, _ = _run(jax_cli.main, args + ["--engine", "wavefront"], capsys)
    assert code == jcode == 0
    assert "is not yet ported" not in err
    assert [ln for ln in out.splitlines() if ln.startswith("Query #")] == [
        "Query #0: a", "Query #1: b",
    ]
    assert _drop_time(out) == _drop_time(jout)


MULTI_CASES = {
    "auto_batched": [],
    "all_queries": ["--all-queries"],
    "all_queries_one_record": ["--q", "q", "--all-queries"],
    "minscore": ["--minscore", "8"],
    "printfasta": ["--printfasta"],
    "topk_blosum62": ["--substitution_matrix", "BLOSUM62", "--topk", "4"],
    "gapopen_positive": ["--gapopen", "2"],
    "wavefront": ["--engine", "wavefront"],
}


@pytest.mark.parametrize("case", sorted(MULTI_CASES))
def test_multi_query_output_matches_jax(case, files, capsys):
    args = list(MULTI_CASES[case])
    q = files["multi3"]
    if "--q" in args:
        q = files[args.pop(args.index("--q") + 1)]
        args.remove("--q")
    args = ["--files", q, files["db"]] + args
    code, out, _ = _run(cli.main, args, capsys)
    jargs = args if "--engine" in args else args + ["--engine", "wavefront"]
    jcode, jout, _ = _run(jax_cli.main, jargs, capsys)
    assert code == jcode == 0
    assert "Query #0:" in out and "Total Entries: 40" in out
    assert _drop_time(out) == _drop_time(jout)


@pytest.mark.parametrize("extra", [["--topk", "3"], ["--minscore", "6"]])
def test_multi_query_json_matches_jax(extra, files, capsys):
    args = ["--files", files["multi3"], files["db"], "--json"] + extra
    code, out, _ = _run(cli.main, args, capsys)
    jcode, jout, _ = _run(jax_cli.main, args + ["--engine", "wavefront"], capsys)
    assert code == jcode == 0
    got, want = (json.loads(o.splitlines()[-1]) for o in (out, jout))
    for d in (got, want):
        d.pop("total_time")
    assert got == want and len(got["queries"]) == 3


def test_multi_query_above_row_limit_exits_1(files, capsys, tmp_path, monkeypatch):
    """A query file holding a record one row over MAX_QUERY_ROWS is no
    longer refused: the CLI scores both records (the long one through K2)
    and prints what the JAX CLI prints, with one Note: on stderr. The
    limits are shrunk (16 rows, stripes of 8) to keep the plain versions
    cheap."""
    from seqalign_tpu_torch.ops import swa_cuda

    monkeypatch.setattr(swa_cuda, "MAX_QUERY_ROWS", 16)
    monkeypatch.setattr(swa_cuda, "STRIPE_ROWS", 8)
    rng = np.random.default_rng(32)
    q = tmp_path / "long.fa"
    q.write_text(">short\nMKV\n>long\n" + random_protein(rng, 17) + "\n")
    args = ["--files", str(q), files["db"]]
    code, out, err = _run(cli.main, args, capsys)
    jcode, jout, _ = _run(jax_cli.main, args + ["--engine", "wavefront"], capsys)
    assert code == jcode == 0
    assert "Note: 1 of 2 queries exceed" in err
    assert "Query #1: long" in out
    assert _drop_time(out) == _drop_time(jout)


@pytest.fixture
def long_files(tmp_path, monkeypatch):
    """Long queries against the 40-record database, with K1's row limit
    shrunk to 16 and stripes of 8 rows so the striped route is cheap."""
    from seqalign_tpu_torch.ops import swa_cuda

    monkeypatch.setattr(swa_cuda, "MAX_QUERY_ROWS", 16)
    monkeypatch.setattr(swa_cuda, "STRIPE_ROWS", 8)
    rng = np.random.default_rng(33)
    long = tmp_path / "long.fa"
    long.write_text(">long query\n" + random_protein(rng, 45) + "\n")
    mixed = tmp_path / "mixed.fa"
    mixed.write_text(
        f">s1\n{random_protein(rng, 9)}\n>long\n{random_protein(rng, 33)}\n"
        f">s2\n{random_protein(rng, 14)}\n"
    )
    return {"long": str(long), "mixed": str(mixed)}


LONG_CASES = {
    "one_long_query": ("long", ["--substitution_matrix", "BLOSUM62"], "oracle"),
    "long_record_in_file": ("mixed", ["--substitution_matrix", "PAM250"], "wavefront"),
    "json_topk": ("long", ["--json", "--topk", "3"], "oracle"),
    "json_topk_mixed": ("mixed", ["--json", "--topk", "3"], "wavefront"),
}


@pytest.mark.parametrize("case", sorted(LONG_CASES))
def test_long_query_output_matches_jax(case, files, long_files, capsys):
    qname, extra, jax_engine = LONG_CASES[case]
    args = ["--files", long_files[qname], files["db"]] + extra
    code, out, err = _run(cli.main, args, capsys)
    jcode, jout, _ = _run(jax_cli.main, args + ["--engine", jax_engine], capsys)
    assert code == jcode == 0
    assert ("Note: 1 of 3 queries exceed" in err) == (qname == "mixed")
    if "--json" in extra:
        got, want = (json.loads(o.splitlines()[-1]) for o in (out, jout))
        for d in (got, want):
            d.pop("total_time")
            d.pop("entries_per_s", None)
        assert got == want
    else:
        assert "Entry #" in out
        assert _drop_time(out) == _drop_time(jout)


@pytest.mark.parametrize("query", ["q", "multi3"])
@pytest.mark.parametrize("engine", ["oracle", "pallas"])
def test_engine_names_of_the_jax_cli(engine, query, files, capsys):
    """``--engine oracle`` and ``--engine pallas`` (the JAX CLI's names: the
    NumPy oracle, and the kernel route, which the port runs as its stream
    kernels) print what the JAX CLI prints under the same name, for one
    query and for a multi-record query file, but for Total Time."""
    args = ["--files", files[query], files["db"], "--substitution_matrix", "BLOSUM62",
            "--engine", engine]
    code, out, err = _run(cli.main, args, capsys)
    jcode, jout, _ = _run(jax_cli.main, args, capsys)
    assert code == jcode == 0
    assert "Note:" not in err  # the port's kernel is the device route
    assert "Entry #" in out and ("Query #2:" in out) == (query == "multi3")
    assert _drop_time(out) == _drop_time(jout)


def test_unknown_engine_exits_1(files, capsys):
    code, out, err = _run(
        cli.main, ["--files", files["q"], files["db"], "--engine", "tpu"], capsys
    )
    assert code == 1
    assert "Error: Unknown engine 'tpu'" in err and "Entry #" not in out


@pytest.mark.parametrize(
    "args",
    [[], ["--match", "x"], ["--files", "a"], ["--bogus"], ["--match", "-3"]],
)
def test_usage_errors_match_jax(args, capsys):
    code, _, err = _run(cli.main, args, capsys)
    jcode, _, jerr = _run(jax_cli.main, args, capsys)
    assert code == jcode == 1
    assert err.splitlines()[0] == jerr.splitlines()[0]


def test_no_gpu_exits_1(files, capsys, monkeypatch):
    monkeypatch.delenv("SEQALIGN_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    code, out, err = _run(cli.main, ["--files", files["q"], files["db"]], capsys)
    assert code == 1
    assert "Error: no CUDA device" in err and "Entry #" not in out
