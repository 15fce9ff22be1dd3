"""The port's multi-host search (``seqalign_tpu_torch.parallel.multihost``)
in real 2-process runs over torch.distributed (gloo) on the CPU, against the
JAX package's single-process search, and the port's ``--hosts`` CLI
against the JAX CLI's multi-host output.

Run as a script, this file is the worker of the 2-process tests: it joins
the process group, searches its database stripe and saves the merged
result. The worker imports nothing of JAX, so nothing at this file's top
level does either; the tests import the JAX package inside themselves.
"""

import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT_S = 120


def _worker(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--nproc", type=int, required=True)
    p.add_argument("--pid", type=int, required=True)
    p.add_argument("--query", required=True)
    p.add_argument("--db", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--topk", type=int, default=0)
    p.add_argument("--db-cache", default=None)
    args = p.parse_args(argv)

    sys.path.insert(0, str(REPO))
    from seqalign_tpu_torch.host import ScoringModel, load_builtin, read_first
    from seqalign_tpu_torch.parallel.multihost import multihost_search

    sc = load_builtin(
        "BLOSUM62",
        ScoringModel(gap_open=-2, gap_extend=-1, use_match_mismatch=False),
    )
    q = sc.query_indices(read_first(args.query).seq)
    kw = dict(coordinator_address=args.coordinator, num_processes=args.nproc,
              process_id=args.pid, db_cache=args.db_cache)
    if args.topk:
        vals, ids, _ = multihost_search(q, args.db, sc, k=args.topk, **kw)
        np.savez(args.out, vals=vals, ids=ids)
    else:
        scores, _ = multihost_search(q, args.db, sc, **kw)
        np.save(args.out, scores)


def _protein(rng, n):
    aas = "ACDEFGHIKLMNPQRSTVWY"
    return "".join(aas[i] for i in rng.integers(0, len(aas), size=n))


def _write_fixtures(tmp_path, seed, n_records):
    rng = np.random.default_rng(seed)
    qp, dp = tmp_path / "q.fa", tmp_path / "db.fa"
    qp.write_text(f">q first\n{_protein(rng, 11)}\n>second\n{_protein(rng, 6)}\n")
    dp.write_text("".join(
        f">r{i}\n{_protein(rng, int(rng.integers(1, 30)))}\n" for i in range(n_records)))
    return str(qp), str(dp)


def _blosum62():
    from seqalign_tpu.models import ScoringModel, load_builtin

    return load_builtin(
        "BLOSUM62", ScoringModel(gap_open=-2, gap_extend=-1, use_match_mismatch=False))


def _jax_scores(qp, dp):
    from seqalign_tpu.pipeline import search_files

    return search_files(qp, dp, _blosum62(), engine="wavefront").scores


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(cmd_for, nproc=2):
    """Run ``cmd_for(pid, coordinator)`` for every pid at once on the CPU,
    each with a timeout, killing all on a timeout; returns every host's
    ``(exit code, stdout, stderr)``. A coordinator port taken between
    choosing and binding it is retried once on another."""
    env = dict(os.environ, SEQALIGN_PLATFORM="cpu", OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    for attempt in range(2):
        coord = f"127.0.0.1:{_free_port()}"
        procs = [subprocess.Popen(cmd_for(pid, coord), cwd=str(REPO), env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True)
                 for pid in range(nproc)]
        results = []
        try:
            for p in procs:
                out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
                results.append((p.returncode, out, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if attempt == 0 and any(
                "address already in use" in err.lower() for _, _, err in results):
            continue
        return results


def _run_pair(cmd_for):
    """:func:`_launch`, every host succeeding; their stdouts."""
    results = _launch(cmd_for)
    errs = "\n".join(err[-3000:] for _, _, err in results)
    assert all(rc == 0 for rc, _, _ in results), f"a host failed:\n{errs}"
    return [out for _, out, _ in results]


def _run_workers(tmp_path, qp, dp, topk=0, db_cache=None):
    ext = "npz" if topk else "npy"
    outs = [str(tmp_path / f"scores_{pid}.{ext}") for pid in range(2)]

    def cmd(pid, coord):
        c = [sys.executable, str(Path(__file__).resolve()), "--coordinator", coord,
             "--nproc", "2", "--pid", str(pid), "--query", qp, "--db", dp,
             "--out", outs[pid]]
        if topk:
            c += ["--topk", str(topk)]
        if db_cache:
            c += ["--db-cache", db_cache]
        return c

    _run_pair(cmd)
    return outs


def test_two_process_full_scores(tmp_path):
    """Each host scores its stripe; every host holds the whole vector,
    equal to the JAX package's single-process search."""
    qp, dp = _write_fixtures(tmp_path, 1, 600)
    want = _jax_scores(qp, dp)
    for out in _run_workers(tmp_path, qp, dp):
        got = np.load(out)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_two_process_topk(tmp_path):
    qp, dp = _write_fixtures(tmp_path, 2, 400)
    k = 7
    want = _jax_scores(qp, dp)
    best = np.sort(want)[::-1][:k]
    for out in _run_workers(tmp_path, qp, dp, topk=k):
        z = np.load(out)
        vals, ids = z["vals"], z["ids"]
        np.testing.assert_array_equal(vals, best)  # merged in descending order
        np.testing.assert_array_equal(want[ids], vals)  # ids score their values
        assert len(set(ids.tolist())) == k


def test_two_process_shared_sqc_cache(tmp_path):
    """Both hosts stripe one .sqc built up front, with the FASTA deleted:
    neither can be re-parsing it."""
    from seqalign_tpu_torch.utils.native_io import parse_file_cached

    qp, dp = _write_fixtures(tmp_path, 3, 500)
    want = _jax_scores(qp, dp)
    cp = str(tmp_path / "db.sqc")
    parse_file_cached(dp, cp)
    os.remove(dp)
    for out in _run_workers(tmp_path, qp, dp, db_cache=cp):
        np.testing.assert_array_equal(np.load(out), want)


@pytest.mark.parametrize("k", [None, 7])
@pytest.mark.parametrize("cached", [False, True])
def test_single_process_path(k, cached, tmp_path, monkeypatch):
    """nproc == 1 in this process: no process group, the same function, with
    and without a .sqc (served alone once the FASTA is gone)."""
    from seqalign_tpu_torch.host import read_first
    from seqalign_tpu_torch.parallel.multihost import multihost_search

    monkeypatch.setenv("SEQALIGN_PLATFORM", "cpu")
    qp, dp = _write_fixtures(tmp_path, 4, 200)
    want = _jax_scores(qp, dp)
    sc = _blosum62()
    q = sc.query_indices(read_first(qp).seq)
    cp = str(tmp_path / "db.sqc") if cached else None
    runs = 2 if cached else 1
    for run in range(runs):
        got = multihost_search(q, dp, sc, k=k, db_cache=cp)
        if k is None:
            np.testing.assert_array_equal(got[0], want)
        else:
            order = np.argsort(-want, kind="stable")[:k]
            np.testing.assert_array_equal(got[0], want[order])
            np.testing.assert_array_equal(got[1], order)
        if cached and run == 0:
            assert os.path.exists(cp)
            os.remove(dp)


CLI_CASES = {
    "plain": [],
    "topk_minscore": ["--topk", "5", "--minscore", "20"],
    "json": ["--json", "--topk", "4"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_two_hosts_match_jax_cli(case, tmp_path, monkeypatch, capsys):
    """``--hosts 2`` through the port's CLI in two processes: each host's
    stdout equals what the JAX CLI's multi-host mode prints for that host
    (its search replaced by the JAX package's single-process scores),
    but for Total Time. Host 1 prints only the line every host prints on
    reading --files. The query file's second record is ignored, as in
    JAX."""
    import json

    from seqalign_tpu import cli as jax_cli
    from seqalign_tpu.parallel import multihost as jax_multihost

    qp, dp = _write_fixtures(tmp_path, 5, 300)
    base = ["--substitution_matrix", "BLOSUM62", "--files", qp, dp, *CLI_CASES[case]]
    outs = _run_pair(lambda pid, coord: [
        sys.executable, "-m", "seqalign_tpu_torch.cli", *base, "--hosts", "2",
        "--host-id", str(pid), "--coordinator", coord])

    def jax_search(query_idx, db_path, scoring, **kw):
        from seqalign_tpu.pipeline import search_encoded
        from seqalign_tpu.utils.fasta import read_fasta
        from seqalign_tpu.models import encode

        return search_encoded(query_idx, [encode(r.seq) for r in read_fasta(db_path)],
                              scoring, engine="wavefront")

    monkeypatch.setattr(jax_multihost, "multihost_search", jax_search)
    want = []
    for pid in range(2):
        code = jax_cli.main(["smith_waterman", *base, "--hosts", "2", "--host-id",
                             str(pid), "--coordinator", "127.0.0.1:1"])
        assert code == 0
        want.append(capsys.readouterr().out)

    def drop_time(out):
        if case == "json":
            lines = out.splitlines()
            d = json.loads(lines[-1])
            d.pop("total_time")
            return lines[:-1] + [d]
        return [ln for ln in out.splitlines() if not ln.startswith("Total Time:")]

    assert drop_time(outs[0]) == drop_time(want[0])
    assert "Total Entries: 300" in outs[0] or '"total_entries": 300' in outs[0]
    assert outs[1] == want[1] == f"Query File={qp} and Database File={dp}\n"


def test_cli_host_failure_exits_1(tmp_path):
    """A query over MAX_QUERY_ROWS fails both hosts: each prints one
    ``Error:`` line and exits 1."""
    qp = tmp_path / "long.fa"
    qp.write_text(">long\n" + _protein(np.random.default_rng(6), 1600) + "\n")
    dp = tmp_path / "db.fa"
    dp.write_text(">a\nMKVLAW\n>b\nHEAGAWGHEE\n")
    results = _launch(lambda pid, coord: [
        sys.executable, "-m", "seqalign_tpu_torch.cli", "--files", str(qp), str(dp),
        "--hosts", "2", "--host-id", str(pid), "--coordinator", coord])
    for rc, out, err in results:
        assert rc == 1
        assert [ln for ln in err.splitlines() if ln.startswith("Error:")] == [
            "Error: query of 1600 rows exceeds MAX_QUERY_ROWS=1536 of the one-pass "
            "stream kernel"]
        assert "Entry #" not in out


if __name__ == "__main__":
    _worker()
