"""Scoring models: alphabet codec, scoring parameters, substitution matrices.

The port's own copy of ``seqalign_tpu.models`` (numpy only), module for
module; the tests hold both copies to identical outputs.
"""

from .alphabet import (
    ALPHABET_SIZE,
    PAD_INDEX,
    AlphabetError,
    decode,
    encode,
    index_to_letter,
    letter_to_index,
)
from .matrices import (
    MatrixFormatError,
    load_builtin,
    load_matrix_file,
    load_substitution_matrix,
    write_matrix_file,
)
from .scoring import ScoringModel, default_scoring, sw_default_scoring

__all__ = [
    "ALPHABET_SIZE",
    "PAD_INDEX",
    "AlphabetError",
    "MatrixFormatError",
    "ScoringModel",
    "decode",
    "default_scoring",
    "encode",
    "index_to_letter",
    "letter_to_index",
    "load_builtin",
    "load_matrix_file",
    "load_substitution_matrix",
    "sw_default_scoring",
    "write_matrix_file",
]
