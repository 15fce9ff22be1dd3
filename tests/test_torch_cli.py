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
    "one_host": ["--hosts", "1", "--host-id", "0"],
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
    [[], ["--match", "x"], ["--files", "a"], ["--bogus"], ["--match", "-3"],
     ["--stream-chunk", "0"], ["--stream-chunk", "x"], ["--align", "x"],
     ["--hosts", "0"], ["--host-id", "-1"],
     ["--files", "q.fa", "db.fa", "--hosts", "2", "--host-id", "0"]],
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


def _json_drop_time(out):
    d = json.loads(out.splitlines()[-1])
    d.pop("total_time")
    d.pop("entries_per_s", None)
    return d


SINGLE_ONLY_CASES = {
    "align": ["--align", "5"],
    "align_json": ["--align", "4", "--json", "--substitution_matrix", "PAM250"],
    "align_all": ["--align", "100", "--substitution_matrix", "BLOSUM62"],
    "stream_chunk": ["--stream-chunk", "7"],
    "stream_chunk_json": ["--stream-chunk", "16", "--json", "--topk", "3"],
    "stream_chunk_checkpoint": ["--stream-chunk", "9", "--checkpoint", "CK"],
    "checkpoint": ["--checkpoint", "CK", "--substitution_matrix", "BLOSUM62"],
    "checkpoint_topk": ["--checkpoint", "CK", "--topk", "4", "--printfasta"],
}


@pytest.mark.parametrize("query", ["q", "multi3"])
@pytest.mark.parametrize("case", sorted(SINGLE_ONLY_CASES))
def test_single_query_modes_match_jax(case, query, files, capsys, tmp_path):
    """--align, --stream-chunk and --checkpoint print what the JAX CLI
    prints, and a multi-record query file keeps first-record behaviour
    under each. A --checkpoint run repeated resumes every chunk: no
    launch, the same output."""
    from seqalign_tpu_torch.ops import swa_cuda

    args = ["--files", files[query], files["db"]] + [
        str(tmp_path / "ck") if a == "CK" else a for a in SINGLE_ONLY_CASES[case]]
    jargs = [str(tmp_path / "jck") if a == str(tmp_path / "ck") else a for a in args]
    code, out, err = _run(cli.main, args, capsys)
    jcode, jout, _ = _run(jax_cli.main, jargs + ["--engine", "oracle"], capsys)
    assert code == jcode == 0 and "Query #" not in out
    if "--json" in args:
        assert _json_drop_time(out) == _json_drop_time(jout)
    else:
        assert "Entry #" in out
        assert _drop_time(out) == _drop_time(jout)
    if "--checkpoint" in args:
        launches = swa_cuda.sw_stream_reference.calls
        code, again, _ = _run(cli.main, args, capsys)
        assert code == 0 and swa_cuda.sw_stream_reference.calls == launches
        assert _drop_time(again) == _drop_time(out)
        assert "Total Time: 0.000000" in again


def _star_negative_matrix(path):
    """BLOSUM62 as a matrix file whose '*' row and column score -4, so that
    '*' padding cannot move an alignment's end and --align localizes long
    pairs through the wavefront ends engine."""
    from seqalign_tpu_torch.models import write_matrix_file

    write_matrix_file(str(path), "BLOSUM62")
    lines = path.read_text().splitlines()
    alphabet = lines[1].split()
    star = alphabet.index("*")
    out = lines[:2]
    for ln in lines[2:]:
        cells = ln.split()
        vals = ["-4" if (k == star or cells[0] == "*") else v
                for k, v in enumerate(cells[1:])]
        out.append(cells[0] + " " + " ".join(vals))
    path.write_text("\n".join(out) + "\n")


@pytest.mark.parametrize("as_json", [False, True])
def test_align_through_the_ends_engine_matches_jax(as_json, files, capsys, tmp_path,
                                                   monkeypatch):
    """Hits above the (shrunk) direct-fill threshold: one call of the
    wavefront ends engine localizes them, and the output equals the JAX
    CLI's, whose ends come from its XLA wavefront."""
    from seqalign_tpu.ops import traceback as jax_tb
    from seqalign_tpu_torch.ops import swa_torch
    from seqalign_tpu_torch.ops import traceback as tb

    matrix = tmp_path / "b62star.txt"
    _star_negative_matrix(matrix)
    for mod in (tb, jax_tb):
        monkeypatch.setattr(mod, "_DIRECT_CELLS", 1 << 9)
    args = ["--files", files["q"], files["db"], "--substitution_matrix", str(matrix),
            "--align", "6"] + (["--json"] if as_json else [])
    calls = swa_torch.sw_wavefront_ends.calls
    code, out, _ = _run(cli.main, args, capsys)
    assert swa_torch.sw_wavefront_ends.calls == calls + 1
    jcode, jout, _ = _run(jax_cli.main, args + ["--engine", "oracle"], capsys)
    assert code == jcode == 0
    if as_json:
        got = _json_drop_time(out)
        assert got == _json_drop_time(jout) and len(got["alignments"]) == 6
    else:
        assert out.count("CIGAR") == 6
        assert _drop_time(out) == _drop_time(jout)


@pytest.mark.parametrize("query", ["q", "multi3"])
def test_trace_writes_a_trace(query, files, capsys, tmp_path):
    trace = tmp_path / "trace"
    args = ["--files", files[query], files["db"]]
    code, out, err = _run(cli.main, args + ["--trace", str(trace)], capsys)
    assert code == 0 and "Note: profiler unavailable" not in err
    written = list(trace.glob("seqalign_trace_*.json"))
    assert len(written) == 1
    events = json.loads(written[0].read_text())["traceEvents"]
    assert any("sw_stream" in str(e.get("name", "")) or "aten::" in str(e.get("name", ""))
               for e in events)
    jcode, jout, _ = _run(jax_cli.main, args + ["--first-query", "--engine", "oracle"],
                          capsys)
    assert jcode == 0 and _drop_time(out) == _drop_time(jout)


@pytest.mark.parametrize("query", ["q", "multi3"])
def test_trace_names_the_search_and_its_steps(query, files, capsys, tmp_path):
    """``--trace``'s Chrome trace holds the search's own spans: one
    ``seqalign.search`` and its steps."""
    trace = tmp_path / "trace"
    code, _, _ = _run(cli.main, ["--files", files[query], files["db"], "--trace", str(trace)],
                      capsys)
    (written,) = trace.glob("seqalign_trace_*.json")
    names = [str(e.get("name", "")) for e in json.loads(written.read_text())["traceEvents"]]
    assert code == 0 and names.count("seqalign.search") == 1
    assert {"seqalign.sort", "seqalign.plan", "seqalign.launch", "seqalign.fetch"} <= set(names)


def test_trace_unavailable_is_a_note(files, capsys, monkeypatch):
    import torch.profiler

    def broken(*a, **k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    code, out, err = _run(
        cli.main, ["--files", files["q"], files["db"], "--trace", "unused"], capsys)
    assert code == 0 and "Entry #" in out
    assert "Note: profiler unavailable (no profiler here)" in err
