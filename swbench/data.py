"""Inputs made from ``--seed``: the database and the queries.

Every seed gets the same record lengths (the configuration's own draw, so
that every run does the same work), in an order of its own, with residues
of its own. Residues follow the configuration's frequencies. A query is
what a search of a database with one of its own members sends: a copy of
a record drawn afresh for each request (``Homologs``), so that every
search has a hit scoring about as high as its query is long.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .scoring import AMINO_ACIDS, code

# Residues are drawn on the device as 16-bit uniforms mapped through a
# table, in pieces of this many at a time.
_LUT_BITS = 16
_PIECE = 1 << 25
# A query longer than all but this many records copies one of them.
HOMOLOG_POOL = 64


def seed_words(seed: int, *stream: int) -> list[int]:
    """Entropy for numpy's generators: any whole ``seed``, and the
    stream's own numbers, so that each use draws apart."""
    return [seed % (1 << 64), *stream]


def residue_freqs(config: dict) -> tuple[np.ndarray, np.ndarray]:
    """``(codes, probabilities)`` of the configuration's residues."""
    freqs = config["database"]["residue_freqs"]
    letters = [a for a in AMINO_ACIDS if a in freqs]
    p = np.array([float(freqs[a]) for a in letters])
    return np.array([code(a) for a in letters], dtype=np.int8), p / p.sum()


def record_lengths(db: dict, freqs: np.ndarray) -> np.ndarray:
    """The configuration's record lengths, the same for every seed:
    gamma(shape, scale) draws, cut to whole residues and clipped, from the
    generator seeded with ``lengths.seed`` after ``discard_choices`` residue
    draws (how ``bench.py`` drew them, query first)."""
    spec = db["lengths"]
    rng = np.random.default_rng(spec["seed"])
    rng.choice(len(freqs), spec.get("discard_choices", 0), p=freqs)
    lengths = rng.gamma(shape=spec["gamma_shape"], scale=spec["gamma_scale"], size=db["records"])
    return np.clip(lengths.astype(np.int64), spec["min"], spec["max"])


def residue_table(freqs: np.ndarray) -> np.ndarray:
    """``2**16`` residue indices, each index's share of them its
    frequency rounded by largest remainder."""
    size = 1 << _LUT_BITS
    exact = freqs * size
    counts = np.floor(exact).astype(np.int64)
    counts[np.argsort(-(exact - counts), kind="stable")[: size - counts.sum()]] += 1
    return np.repeat(np.arange(len(freqs)), counts)


@dataclasses.dataclass
class Database:
    """A database as the program takes it: residue codes end to end."""

    seq: np.ndarray  # (residues,) int8
    offsets: np.ndarray  # (records + 1,) int64

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def records(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """``(residues end to end, lengths)`` of the records ``ids``."""
        lengths = self.lengths[ids]
        starts = self.offsets[ids]
        idx = np.repeat(starts - np.concatenate(([0], np.cumsum(lengths)[:-1])), lengths)
        return self.seq[idx + np.arange(len(idx))], lengths


def seeded_lengths(config: dict, seed: int) -> np.ndarray:
    """The configuration's record lengths in an order drawn from ``seed``,
    checked against its stated residue count."""
    db = config["database"]
    lengths = record_lengths(db, residue_freqs(config)[1])
    if "residues" in db and int(lengths.sum()) != db["residues"]:
        raise ValueError(f"lengths sum to {int(lengths.sum())}, not {db['residues']}")
    return lengths[np.random.default_rng(seed_words(seed, 1)).permutation(len(lengths))]


def make_database(config: dict, seed: int, device: torch.device) -> Database:
    """The configuration's database for ``seed``: its fixed lengths in an
    order drawn from the seed, residues drawn on ``device`` from the seed
    and fetched once."""
    codes, freqs = residue_freqs(config)
    lengths = seeded_lengths(config, seed)
    offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    lut = torch.as_tensor(codes[residue_table(freqs)], device=device)
    total = int(offsets[-1])
    seq = torch.empty(total, dtype=torch.int8, device=device)
    for a in range(0, total, _PIECE):
        b = min(a + _PIECE, total)
        u = torch.randint(0, 1 << _LUT_BITS, (b - a,), generator=gen, device=device)
        seq[a:b] = lut[u]
    return Database(seq=seq.cpu().numpy(), offsets=offsets)


def random_queries(config: dict, rng: np.random.Generator, lengths) -> list[np.ndarray]:
    """One query of each length in ``lengths``, residues drawn by ``rng``
    at the configuration's frequencies, as int32 codes."""
    codes, freqs = residue_freqs(config)
    return [codes[rng.choice(len(freqs), int(n), p=freqs)].astype(np.int32) for n in lengths]


class Homologs:
    """Queries copied from ``db``'s records. A query of ``n`` residues
    copies a window of ``n`` residues of a record of at least ``n``, drawn
    from ``rng``; where fewer than ``HOMOLOG_POOL`` records are that long,
    it copies the whole of one of the ``HOMOLOG_POOL`` longest and fills
    the rest on both sides with random residues. A share ``mutate`` of its
    residues is then drawn afresh."""

    def __init__(self, config: dict, db: Database):
        self.codes, self.freqs = residue_freqs(config)
        self.db = db
        self.longest_first = np.argsort(db.lengths, kind="stable")[::-1]
        self.descending = db.lengths[self.longest_first]

    def record(self, rng: np.random.Generator, n: int) -> int:
        """A record to copy a query of ``n`` residues from."""
        pool = min(HOMOLOG_POOL, len(self.descending))
        floor = min(int(n), int(self.descending[pool - 1]))
        count = int(np.searchsorted(-self.descending, -floor, side="right"))
        return int(self.longest_first[rng.integers(count)])

    def query(self, rng: np.random.Generator, record: int, n: int, mutate: float) -> np.ndarray:
        """``n`` int32 residue codes copied from ``record``."""
        start, m = int(self.db.offsets[record]), int(self.db.lengths[record])
        residues = self.db.seq[start : start + m].astype(np.int32)
        if m >= n:
            a = int(rng.integers(m - n + 1))
            q = residues[a : a + n].copy()
        else:
            left = int(rng.integers(n - m + 1))
            q = np.concatenate([self.random(rng, left), residues, self.random(rng, n - m - left)])
        hit = rng.random(n) < mutate
        q[hit] = self.random(rng, int(hit.sum()))
        return q

    def random(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return self.codes[rng.choice(len(self.freqs), n, p=self.freqs)].astype(np.int32)
