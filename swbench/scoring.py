"""The benchmark's own substitution tables and residue coding.

The matrices are the benchmark's copies in NCBI text form
(``matrices/<NAME>.txt``). Both sides get the same ``(32, 32)`` table: the
program inside its ``ScoringModel``, the reference as it is. Residues are
coded as the program's API takes them: ``A``-``Z`` are 1-26, ``*`` is 31
(upper and lower case alike).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

MATRIX_DIR = Path(__file__).resolve().parent / "matrices"
TABLE_SIZE = 32
STAR = 31
# The 20 standard amino acids, in the order configurations list their
# frequencies.
AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"


def code(letter: str) -> int:
    """A residue letter's code."""
    if letter == "*":
        return STAR
    c = ord(letter.upper()) - 64
    if not 1 <= c <= 26:
        raise ValueError(f"{letter!r} is not a residue letter")
    return c


def load_table(name: str, matrix_dir: Path = MATRIX_DIR) -> np.ndarray:
    """``(32, 32)`` int32 scores of ``matrix_dir/<name>.txt``, indexed by
    residue codes; pairs the file does not name score 0."""
    lines = [ln for ln in (matrix_dir / f"{name}.txt").read_text().splitlines()
             if ln.strip() and not ln.startswith("#")]
    columns = lines[0].split()
    table = np.zeros((TABLE_SIZE, TABLE_SIZE), dtype=np.int32)
    for line in lines[1:]:
        row, *scores = line.split()
        if len(scores) != len(columns):
            raise ValueError(f"{name}: row {row} has {len(scores)} scores, not {len(columns)}")
        for col, s in zip(columns, scores):
            table[code(row), code(col)] = int(s)
    return table
