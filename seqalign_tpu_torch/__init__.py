"""seqalign_tpu_torch: the Smith-Waterman database search on PyTorch + CUDA.

The port of ``seqalign_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA Hopper
GPU. It keeps its own copy of the JAX package's numpy host modules
(``models``, ``utils.fasta``, ``utils.native_io``, ``utils.packing``) and
imports neither JAX nor the JAX package.

Layers:
  models, utils - host code: alphabet, scoring, FASTA, encoded database,
                  stream packing (``host`` re-exports what the port uses)
  ops/swa_torch - plain PyTorch engines (scan, wavefront)
  ops/swa_cuda  - the kernels (CUDA, csrc/): segmented streams for one
                  query (K1) and a batch (K3), one pass of a team kernel;
                  row stripes of a long query (K2); fixed lane batches (K4,
                  and K5 for timing the DP loop) behind the lane-batch
                  engine interface; and their plain versions
  ops/oracle    - the scalar NumPy oracle (``--engine oracle``)
  convert       - numpy inputs of the host code -> device tensors
  pipeline      - query-vs-database search
  cli           - ``smith_waterman``-compatible command line tool
"""

__version__ = "0.1.0"
