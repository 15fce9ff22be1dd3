"""One run of one benchmark cell.

    python -m swbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Sets up (the kernels from the program's
build directory in the checkout, the database made on the card from the
seed, a warm-up of every request shape), runs a closed loop of the cell's
searches for ``--seconds``, checks a sample of the answers against the
plain reference, and prints one JSON line: the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1`` (the window
under ``torch.profiler``). It exits non-zero, printing no result,
without the cards the cell asks for, or where JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

_IMPORTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# Top-level modules no run may hold once its window has closed: JAX, and
# the JAX package the program was ported from (names compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "seqalign_tpu")


def process_start() -> float:
    """The process's start on ``time.time()``'s clock, from ``/proc``;
    where that cannot be read, when this module was first imported."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        start = time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED
    return start if _IMPORTED - 60 < start <= _IMPORTED else _IMPORTED


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m swbench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    started = process_start()
    args = parse(argv)
    import torch

    from swbench.cell import execute, load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        say(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    line = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                   started, log=say)
    found = forbidden_modules()
    if found:
        say(f"loaded in this process: {', '.join(found)}; no result")
        return 3
    for name, check in line["checks"].items():
        say(f"{name} {check['value']} " + " ".join(f"{k} {v}" for k, v in check.items()
                                                  if k != "value"))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
