"""swbench: the benchmark of seqalign_tpu_torch, the PyTorch and CUDA port.

One run is one process: ``python -m swbench.run --workload <name> --seed
<n> --seconds <s> --trace <0|1>``. Everything that belongs to one cell is a
file found by name: ``configs/<config>.json`` (a deployment: scoring and
database), ``workloads/<cell>.json`` (traffic and check sizes),
``traffic/<kind>.py`` (the generator the workload names) and
``metrics/<metric>.py`` (one reader per metric that ``BENCHMARK.json``
names). ``reference.py`` is the plain Smith-Waterman-Gotoh recurrence that
decides ``correct``; it imports nothing of the program.
"""
