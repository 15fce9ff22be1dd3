"""The host side of the search that the port shares with the JAX package.

Encoding, scoring models, FASTA reading, the encoded database and the stream
packer are numpy code in ``seqalign_tpu.models`` and ``seqalign_tpu.utils``;
none of them loads JAX. The port takes them from here, its one import of the
JAX package, and never from ``seqalign_tpu.ops`` or ``seqalign_tpu.pipeline``
(those load JAX).
"""

from seqalign_tpu.models import (
    PAD_INDEX,
    ScoringModel,
    encode,
    load_builtin,
    load_substitution_matrix,
    sw_default_scoring,
)
from seqalign_tpu.utils.fasta import SeqRecord, read_fasta, read_first
from seqalign_tpu.utils.native_io import (
    EncodedDatabase,
    pack_batch,
    parse_file_cached,
)
from seqalign_tpu.utils.packing import StreamPack, lattice_round_up, pack_streams

__all__ = [
    "PAD_INDEX",
    "EncodedDatabase",
    "ScoringModel",
    "SeqRecord",
    "StreamPack",
    "encode",
    "lattice_round_up",
    "load_builtin",
    "load_substitution_matrix",
    "pack_batch",
    "pack_streams",
    "parse_file_cached",
    "read_fasta",
    "read_first",
    "sw_default_scoring",
]
