"""seqalign_tpu_torch: the Smith-Waterman database search on PyTorch + CUDA.

The port of ``seqalign_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA Hopper
GPU. It imports the JAX package's numpy-only host modules (``models``,
``utils.fasta``, ``utils.native_io``, ``utils.packing``) and never JAX.

Layers:
  ops/swa_torch - plain PyTorch engines (scan, wavefront)
  ops/swa_cuda  - the segmented-stream kernel (CUDA, csrc/sw_stream.cu) and
                  its plain version
  convert       - numpy inputs of the shared host code -> device tensors
  pipeline      - query-vs-database search
  cli           - ``smith_waterman``-compatible command line tool
"""

__version__ = "0.1.0"
