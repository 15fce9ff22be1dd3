"""Scoring model: gap penalties + dense 32x32 substitution table.

The port's copy of ``seqalign_tpu.models.scoring``: the counterpart of the
reference's ``scoring_t``
(``src/alignment_scoring.h:21-37``): the substitution scores are a dense
``(32, 32)`` int32 array (``table``) indexed by alphabet indices, plus a
boolean presence mask (``defined``) that mirrors the reference's ``swap_set``
bitmask (used only to replace query characters absent from a loaded matrix
with ``X`` — reference ``src/alignment_cmdline.c:391-396``).

Semantics preserved from the reference:

- Gap of length N costs ``gap_open + N * gap_extend`` (both negative): the
  kernel uses ``go = gap_open + gap_extend`` for opening and ``ge =
  gap_extend`` for extending (``src/alignment.c:58``).
- Substitution scores must fit in int8 (``src/alignment_scoring.c:61``).
- ``match``/``mismatch`` mode fills the table diagonal/off-diagonal. (The
  reference leaves ``swap_scores`` *uninitialized* in this mode — a latent
  bug, SURVEY.md §7 — we define it properly instead.)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .alphabet import ALPHABET_SIZE, PAD_INDEX, letter_to_index


@dataclasses.dataclass
class ScoringModel:
    """Gap penalties plus the dense substitution table."""

    gap_open: int
    gap_extend: int
    match: int = 1
    mismatch: int = -2
    use_match_mismatch: bool = True
    case_sensitive: bool = False
    # (32, 32) int32 substitution scores, indexed by alphabet indices.
    table: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(
            (ALPHABET_SIZE, ALPHABET_SIZE), dtype=np.int32
        )
    )
    # (32, 32) bool: which (a, b) pairs were explicitly defined.
    defined: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(
            (ALPHABET_SIZE, ALPHABET_SIZE), dtype=bool
        )
    )
    min_penalty: int = 0
    max_penalty: int = 0

    def add_mutation(self, a: str, b: str, score: int) -> None:
        """Define the score for aligning characters ``a`` and ``b``.

        Parity with ``scoring_add_mutation`` (``src/alignment_scoring.c:60``),
        including the int8 range check.
        """
        if not (-128 < score < 128):
            raise ValueError(
                f"substitution score {score} for ({a},{b}) does not fit int8"
            )
        ia, ib = letter_to_index(a), letter_to_index(b)
        self.table[ia, ib] = score
        self.defined[ia, ib] = True
        self.min_penalty = min(self.min_penalty, score)
        self.max_penalty = max(self.max_penalty, score)

    def finalize(self) -> "ScoringModel":
        """Fill undefined table entries for match/mismatch mode.

        In match/mismatch mode every (a, b) pair scores ``match`` if the
        indices are equal else ``mismatch``; explicitly defined pairs keep
        their value. Returns self for chaining.
        """
        if self.use_match_mismatch:
            eye = np.eye(ALPHABET_SIZE, dtype=bool)
            fill = np.where(eye, self.match, self.mismatch).astype(np.int32)
            self.table = np.where(self.defined, self.table, fill)
        return self

    @property
    def gap_open_total(self) -> int:
        """Cost of a length-1 gap: ``gap_open + gap_extend``."""
        return self.gap_open + self.gap_extend

    def query_indices(self, seq: str) -> np.ndarray:
        """Encode a query, replacing chars absent from the matrix with 'X'.

        Parity with reference ``src/alignment_cmdline.c:391-396``: a query
        character whose *diagonal* entry was never defined is replaced by
        ``X`` before alignment.
        """
        from .alphabet import encode

        idx = encode(seq).astype(np.int32)
        if not self.use_match_mismatch:
            diag_defined = np.diagonal(self.defined).copy()
            x_index = letter_to_index("X")
            idx = np.where(diag_defined[idx], idx, x_index)
        return idx

    def padding_safe_for_query(self, query_idx: np.ndarray) -> bool:
        """True if '*'-padding can never increase this query's scores.

        Padding lanes/tails with '*' is score-invariant iff ``table[q, '*']``
        is <= 0 for every character ``q`` appearing in the query AND both gap
        penalties are <= 0 (positive gap scores let an alignment extend into
        the padding region for profit). Standard matrices use the minimum
        score in the '*' column *except* for the ('*','*') cell (+1), so
        this holds unless the query itself contains '*'. The pipeline checks
        this before relying on free padding (the reference pads the same way
        and would be equally pad-sensitive for '*'-bearing queries or
        positive gap scores — SURVEY.md §7.3 envelope).
        """
        if self.gap_open_total > 0 or self.gap_extend > 0:
            return False
        q = np.unique(np.asarray(query_idx))
        return bool((self.table[q, PAD_INDEX] <= 0).all())


def default_scoring() -> ScoringModel:
    """Reference ``scoring_system_default`` (``src/alignment_scoring.c:99``)."""
    return ScoringModel(
        gap_open=-4, gap_extend=-1, match=1, mismatch=-2
    ).finalize()


def sw_default_scoring() -> ScoringModel:
    """Smith-Waterman CLI defaults (``src/tools/sw_cmdline.c:27-35``)."""
    return ScoringModel(
        gap_open=-2, gap_extend=-1, match=2, mismatch=-2
    ).finalize()
