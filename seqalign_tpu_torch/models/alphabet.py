"""Alphabet codec: characters <-> 32-slot substitution-table indices.

Behavioral parity with the reference codec (``letters_to_index`` /
``index_to_letters``, reference ``src/alignment_scoring.c:70-92``):

- ``a``-``z`` and ``A``-``Z`` both map to 1..26 (case-insensitive),
- ``*`` maps to 31 (used to pad short database sequences),
- any other character is an error.

Index 0 and indices 27..30 are never produced; the table is 32 wide so that
indices fit in 5 bits and one profile row is 32 int32 words, one per shared
memory bank.

The port's copy of ``seqalign_tpu.models.alphabet``.
"""

from __future__ import annotations

import numpy as np

ALPHABET_SIZE = 32
PAD_INDEX = 31  # index of '*', used to pad database sequences
X_CHAR = "X"


class AlphabetError(ValueError):
    """Raised for characters outside the a-z/A-Z/* alphabet."""


def letter_to_index(c: str) -> int:
    """Map a single character to its table index (parity with reference)."""
    o = ord(c)
    if 97 <= o < 123:  # a-z
        return o - 96
    if 65 <= o < 91:  # A-Z
        return o - 64
    if o == 42:  # '*'
        return PAD_INDEX
    raise AlphabetError(
        f"Error: {c} is not a legal character for the substitution matrix!"
    )


def index_to_letter(i: int) -> str:
    """Inverse map (uppercase canonical form)."""
    if 1 <= i < 27:
        return chr(i + 64)
    if i == PAD_INDEX:
        return "*"
    raise AlphabetError(
        f"Error: {i} is not a legal index for the substitution matrix!"
    )


# Vectorized encode table: ascii byte -> index, -1 for illegal characters.
_ENCODE_LUT = np.full(256, -1, dtype=np.int8)
for _o in range(97, 123):
    _ENCODE_LUT[_o] = _o - 96
for _o in range(65, 91):
    _ENCODE_LUT[_o] = _o - 64
_ENCODE_LUT[42] = PAD_INDEX


def encode(seq: str | bytes) -> np.ndarray:
    """Encode a sequence string to an int8 index array.

    Raises :class:`AlphabetError` on the first illegal character, matching the
    reference's fatal-error behavior.
    """
    if isinstance(seq, str):
        raw = seq.encode("ascii", errors="replace")
    else:
        raw = seq
    arr = np.frombuffer(raw, dtype=np.uint8)
    out = _ENCODE_LUT[arr]
    if (out < 0).any():
        bad = int(np.argmax(out < 0))
        raise AlphabetError(
            f"Error: {chr(arr[bad])} is not a legal character for the "
            "substitution matrix!"
        )
    return out


def decode(indices) -> str:
    """Decode an index array back to an uppercase string."""
    return "".join(index_to_letter(int(i)) for i in np.asarray(indices))
