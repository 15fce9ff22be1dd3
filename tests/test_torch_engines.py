"""The port's plain PyTorch engines against the NumPy oracle and the JAX
engines: identical int32 scores on the same numpy inputs."""

import numpy as np
import pytest
import torch

from seqalign_tpu.models import encode
from seqalign_tpu.ops.oracle import sw_score_batch
from seqalign_tpu.ops.swa_xla import sw_wavefront as jax_sw_wavefront
from seqalign_tpu_torch.ops import swa_torch

from _torch_cases import SCORINGS, make_scoring, pack_db, random_records
from conftest import random_protein

ENGINES = {"wavefront": swa_torch.sw_wavefront, "scan": swa_torch.sw_scan}


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("scoring", SCORINGS)
def test_engine_matches_oracle_and_jax(engine, scoring):
    sc = make_scoring(scoring)
    rng = np.random.default_rng(SCORINGS.index(scoring))
    q = sc.query_indices(random_protein(rng, 9))
    # Ragged lanes plus one all-'*' lane (an empty record).
    seqs = random_records(rng, 10, 1, 18) + [encode("")]
    db = pack_db(seqs)
    prof = swa_torch.make_profile(sc.table, q)
    go, ge = sc.gap_open_total, sc.gap_extend

    got = ENGINES[engine](
        torch.from_numpy(prof), torch.from_numpy(db), go, ge
    ).numpy()
    assert got.dtype == np.int32
    want = sw_score_batch(q, seqs, sc.table, sc.gap_open, sc.gap_extend)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jax_sw_wavefront(prof, db, go, ge)))
    assert got[-1] == 0


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("empty", ["query", "database"])
def test_engine_empty_inputs(engine, empty):
    sc = make_scoring("BLOSUM62")
    rng = np.random.default_rng(5)
    q = np.zeros(0, np.int32) if empty == "query" else sc.query_indices("MKV")
    seqs = [encode("")] * 3 if empty == "database" else random_records(rng, 3, 1, 9)
    db = pack_db(seqs)
    prof = swa_torch.make_profile(sc.table, q)
    got = ENGINES[engine](
        torch.from_numpy(prof), torch.from_numpy(db), sc.gap_open_total, sc.gap_extend
    ).numpy()
    want = sw_score_batch(q, seqs, sc.table, sc.gap_open, sc.gap_extend)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.zeros(3, np.int32))
