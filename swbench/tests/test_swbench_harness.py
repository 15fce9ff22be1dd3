"""A whole run on the CPU at a tiny size: the last line's schema, cells and
metrics found by name, the control and the faults that ``correct`` must
catch. The harness's look for a card is skipped (``execute`` is what
``run.main`` calls once it has found one)."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from swbench import cell as cells, control, run as entry
from swbench.tests.tamper import TAMPERS, from_port
from swbench.tests.tiny import SWBENCH, make_root

SEED = 2**31 + 99


@pytest.fixture
def root(tmp_path, monkeypatch):
    monkeypatch.setenv("SEQALIGN_PLATFORM", "cpu")
    return make_root(tmp_path)


def execute(root, name, traced=False, seconds=0.3):
    cell = cells.load_cell(name, root.parent / "BENCHMARK.json", root)
    return cell, cells.execute(cell, SEED, seconds, traced, torch.device("cpu"), time.time(),
                               log=lambda msg: None)


@pytest.mark.parametrize("name", ["tiny-single", "tiny-batch", "tiny-align"])
@pytest.mark.parametrize("traced", [False, True])
def test_last_line_schema(root, name, traced):
    cell, line = execute(root, name, traced)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    wanted = cell.per_layer if traced else cell.end_to_end
    units = {m.name: m.unit for m in wanted}
    assert set(line["metrics"]) <= set(units)
    for name_, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name_] and m["value"] > 0
    if not traced:
        # Every end-to-end metric is read; the card's memory only where there is a card.
        assert set(line["metrics"]) == set(units) - {"device_peak_gib"}
    else:
        assert "host_ms" in line["metrics"]  # the CPU has no device trace to read
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for check in line["checks"].values():
        assert "value" in check and len(check) == 2
    json.dumps(line)


def test_new_files_are_found_by_name(root):
    """A new configuration, traffic kind, workload and metric are taken from
    their files, with no edit to a file that was there."""
    bench_path = root.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    (root / "configs" / "tiny-new.json").write_text(
        (root / "configs" / "tiny-pam250.json").read_text())
    (root / "traffic" / "pairs.py").write_text(
        "from swbench.traffic.batch import submit\n"
        "from swbench.data import random_queries, seed_words\n"
        "import numpy as np\n"
        "def requests(params, config, db, seed):\n"
        "    rng = np.random.default_rng(seed_words(seed, 2))\n"
        "    while True:\n"
        "        yield random_queries(config, rng, [params['length']] * 2), []\n"
        "def warmup(params):\n"
        "    return [[params['length']] * 2]\n")
    (root / "metrics" / "searches_done.py").write_text(
        "def read(run):\n    return float(len(run.searches))\n")
    (root / "workloads" / "tiny-new-pairs.json").write_text(json.dumps(
        {"name": "tiny-new-pairs", "config": "tiny-new", "traffic": "pairs", "kind": "pairs",
         "params": {"length": 11}, "check": {"searches": 2, "records": 32, "extremes": 2,
                                              "samples": 2}, "why": "a test"}))
    bench["workloads"].append({"name": "tiny-new-pairs", "config": "tiny-new",
                               "traffic": "pairs", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "searches_done", "unit": "searches", "better": "higher",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["tiny-new-pairs"]})
    bench_path.write_text(json.dumps(bench))
    _, line = execute(root, "tiny-new-pairs")
    assert line["correct"] is True
    assert line["metrics"]["searches_done"]["value"] == line["attempted"]
    assert "gcups" in line["metrics"]


def test_cell_must_agree_with_benchmark(root):
    bench_path = root.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["workloads"][0]["traffic"] = "other"
    bench_path.write_text(json.dumps(bench))
    with pytest.raises(ValueError):
        cells.load_cell(bench["workloads"][0]["name"], bench_path, root)


def stale(real):
    def search(*args, **kwargs):
        scores, t = real(*args, **kwargs)
        return np.zeros_like(scores), t  # the output left as it started
    return search


def half_left_out(real):
    def search(*args, **kwargs):
        scores, t = real(*args, **kwargs)
        scores = scores.copy()
        scores[scores.shape[0] // 2 :] = 0  # half of a batch's queries, or of the records
        return scores, t
    return search


def one_altered(real):
    def search(*args, **kwargs):
        scores, t = real(*args, **kwargs)
        scores = scores.copy()
        scores[..., 0] += 1
        return scores, t
    return search


@pytest.mark.parametrize("name", ["tiny-single", "tiny-batch", "tiny-align"])
@pytest.mark.parametrize("fault", [stale, half_left_out, one_altered])
def test_faults_make_correct_false(root, monkeypatch, name, fault):
    from seqalign_tpu_torch import pipeline

    monkeypatch.setattr(pipeline, "_stream_search", fault(pipeline._stream_search))
    _, line = execute(root, name)
    assert line["correct"] is False
    assert line["checks"]["mismatches"]["value"] > 0


@pytest.mark.parametrize("name", ["tiny-single", "tiny-pam", "tiny-batch", "tiny-align"])
def test_control_is_not_correct(root, name):
    """The reference in saturating 8-bit integers, in the program's place:
    the queries' copies of their records score past 127."""
    cell = cells.load_cell(name, root.parent / "BENCHMARK.json", root)
    cell.workload["check"] = dict(cell.workload["check"], searches=6)
    (reading,) = control.control_readings(cell, SEED, 12, torch.device("cpu"), widths=(8,))
    assert reading["compared"] > 0 and reading["max_score"] > 127
    assert reading["mismatches"] > 0


@pytest.mark.parametrize("name", ["tiny-single", "tiny-batch", "tiny-pam"])
def test_kinds_without_hits_keep_their_checks(root, name):
    """A kind whose ``submit`` returns two items is judged as before: by
    its scores, with the same three checks."""
    _, line = execute(root, name)
    assert line["correct"] is True
    assert list(line["checks"]) == ["mismatches", "failed_searches", "scores_compared"]


def test_aligned_cell_is_correct(root):
    _, line = execute(root, "tiny-align")
    assert line["correct"] is True
    checks = line["checks"]
    assert list(checks)[-2:] == ["alignment_mismatches", "alignments_compared"]
    assert checks["alignment_mismatches"] == {"value": 0, "limit": 0}
    assert checks["alignments_compared"]["value"] >= 3


def planted(tamper):
    """``topk_alignments`` answering with ``tamper`` of its ``k + 1`` best."""
    from seqalign_tpu_torch.ops import traceback

    real = traceback.topk_alignments

    def align(query, db, scores, k, table, gap_open, gap_extend, **kwargs):
        hits = from_port(real(query, db, scores, k + 1, table, gap_open, gap_extend, **kwargs))
        return [(h.record, traceback.Alignment(h.score, h.query_start, h.query_end,
                                               h.record_start, h.record_end, h.query_aligned,
                                               h.record_aligned, h.cigar))
                for h in tamper(hits, table, gap_open, gap_extend)]
    return align


def test_a_sound_planted_answer_stays_correct(root, monkeypatch):
    from seqalign_tpu_torch.ops import traceback

    monkeypatch.setattr(traceback, "topk_alignments", planted(lambda hits, *_: hits[:-1]))
    _, line = execute(root, "tiny-align")
    assert line["correct"] is True and line["checks"]["alignments_compared"]["value"] >= 3


@pytest.mark.parametrize("tamper", TAMPERS, ids=lambda t: t.__name__)
def test_alignment_faults_make_correct_false(root, monkeypatch, tamper):
    from seqalign_tpu_torch.ops import traceback

    monkeypatch.setattr(traceback, "topk_alignments", planted(tamper))
    _, line = execute(root, "tiny-align")
    assert line["correct"] is False
    assert line["checks"]["alignment_mismatches"]["value"] > 0
    assert line["checks"]["mismatches"]["value"] == 0  # the scores are the program's own


def test_failed_searches_are_counted(root, monkeypatch):
    from seqalign_tpu_torch import pipeline

    def broken(*args, **kwargs):
        raise RuntimeError("planted")

    cell = cells.load_cell("tiny-single", root.parent / "BENCHMARK.json", root)
    line_ok = cells.execute(cell, SEED, 0.2, False, torch.device("cpu"), time.time(),
                            log=lambda m: None)
    assert line_ok["failed"] == 0
    real = pipeline._stream_search
    calls = {"n": 0}
    # The warm-up's searches (each shape over a few records, 2 over all) pass.
    warm = len(cell.traffic.warmup(cell.workload["params"])) + 2

    def sometimes(*args, **kwargs):
        calls["n"] += 1
        return broken() if calls["n"] > warm else real(*args, **kwargs)

    monkeypatch.setattr(pipeline, "_stream_search", sometimes)
    line = cells.execute(cell, SEED, 0.2, False, torch.device("cpu"), time.time(),
                         log=lambda m: None)
    assert line["failed"] == line["attempted"] >= 1 and line["correct"] is False


def test_entry_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", "swbench.run", "--workload",
                           "pam250-q144-single", "--seed", str(SEED), "--seconds", "1"],
                          capture_output=True, text=True, cwd=SWBENCH.parent)
    assert proc.returncode != 0 and proc.stdout == ""


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "seqalign_tpu_torch_fake", object())
    assert entry.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert entry.forbidden_modules() == ["jax"]
