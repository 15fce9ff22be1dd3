"""The host side of the search: the names the rest of the port takes.

Encoding, scoring models, FASTA reading, the encoded database and the stream
packer are numpy code. The port keeps its own copy of them, module for
module under the JAX package's names (``models``, ``utils.fasta``,
``utils.native_io``, ``utils.packing``), and imports nothing of the JAX
package; the tests hold both copies to identical outputs.
"""

from .models import (
    PAD_INDEX,
    ScoringModel,
    encode,
    load_builtin,
    load_substitution_matrix,
    sw_default_scoring,
)
from .utils.fasta import SeqRecord, read_fasta, read_first
from .utils.native_io import EncodedDatabase, pack_batch, parse_file_cached
from .utils.packing import (
    StreamPack, StreamPlan, lattice_round_up, pack_streams, plan_streams,
)

__all__ = [
    "PAD_INDEX",
    "EncodedDatabase",
    "ScoringModel",
    "SeqRecord",
    "StreamPack",
    "StreamPlan",
    "encode",
    "lattice_round_up",
    "load_builtin",
    "load_substitution_matrix",
    "pack_batch",
    "pack_streams",
    "parse_file_cached",
    "plan_streams",
    "read_fasta",
    "read_first",
    "sw_default_scoring",
]
