"""Host-side utilities: FASTA IO, the encoded database, stream packing.

The port's copy of the parts of ``seqalign_tpu.utils`` that it uses (numpy
only); the tests hold both copies to identical outputs.
"""
