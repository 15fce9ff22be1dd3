"""Scoring systems and databases shared by the PyTorch port's tests.

Every input is made from a seed with numpy and handed to both packages.
"""

import os

import numpy as np
import torch

from seqalign_tpu.models import (
    PAD_INDEX, ScoringModel, encode, load_builtin, sw_default_scoring,
)

from conftest import random_protein

if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    # Each xdist worker's torch would take every core (6 workers x 8 threads on 8 cores).
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))

SCORINGS = [
    "BLOSUM45", "BLOSUM62", "PAM250", "match_mismatch", "random", "go_eq_ge",
]


def make_scoring(name: str) -> ScoringModel:
    """The scoring system a test case names (gap_open=-2, gap_extend=-1
    unless the case is about gaps)."""
    if name in ("BLOSUM45", "BLOSUM62", "PAM250"):
        return load_builtin(
            name,
            ScoringModel(gap_open=-2, gap_extend=-1, use_match_mismatch=False),
        )
    if name == "match_mismatch":
        return sw_default_scoring()
    if name == "random":
        rng = np.random.default_rng(77)
        t = rng.integers(-6, 7, size=(32, 32)).astype(np.int32)
        t = np.triu(t) + np.triu(t, 1).T
        t[PAD_INDEX, :] = t[:, PAD_INDEX] = -4  # '*' padding stays neutral
        sc = ScoringModel(gap_open=-3, gap_extend=-1, use_match_mismatch=False)
        sc.table = t
        sc.defined[:] = True
        return sc
    if name == "go_eq_ge":
        # gap_open = 0: opening costs the same as extending (go == ge).
        return load_builtin(
            "BLOSUM62",
            ScoringModel(gap_open=0, gap_extend=-2, use_match_mismatch=False),
        )
    raise KeyError(name)


def random_records(rng, n: int, lo: int, hi: int) -> list[np.ndarray]:
    """n encoded random proteins with lengths in [lo, hi)."""
    return [
        encode(random_protein(rng, int(rng.integers(lo, hi))))
        for _ in range(n)
    ]


def pack_db(seqs, pad_to: int = 0) -> np.ndarray:
    """Encoded sequences as one (Lb, B) int32 batch, '*'-padded."""
    lb = max([len(s) for s in seqs] + [pad_to])
    out = np.full((lb, len(seqs)), PAD_INDEX, dtype=np.int32)
    for b, s in enumerate(seqs):
        out[: len(s), b] = s
    return out
