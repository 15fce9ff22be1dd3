"""The card's issue rate for the instructions the DP loops are made of.

    python -m seqalign_tpu_torch.probe [--out FILE.json]

launches each instance of ``csrc/isa_probe.cu`` (``VIADDMNMX``, the DPX
add-max; ``VIMNMX3``, the DPX three-way max; ``IADD3``; ``IMNMX``; ``LDS``;
``IMAD``; ``SHFL``; and four pairs, ``IMAD``, ``IADD3`` and ``SHFL`` each
beside ``VIADDMNMX``, and ``LDS`` beside ``SHFL``) over every SM of the
card, times it with CUDA events and
prints its thread-instructions per second beside the loop's opcodes, read
back from the SASS. A pair that runs at twice the rate of either member
issues on two pipes. The kernels' bounds (chip_smoke) count the integer
instructions of the busier pipe, ``IMAD`` on the FMA pipe and the rest on
the ALU pipe, at the rate derived from the data sheet, ``INT32_PER_S``;
:func:`bound_factor` says how much longer a loop takes at the measured
rates. Runs on a GPU only.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
from pathlib import Path

import torch

from . import sass
from .ops import _build
from .ops.swa_cuda import _call

# The probe's operations, by the index isa_probe_launch takes, and the
# (even, odd) chains' operations of each instance; a pair names two.
OPS = ("VIADDMNMX", "VIMNMX3", "IADD3", "IMNMX", "LDS", "IMAD",
       "IMAD+VIADDMNMX", "IADD3+VIADDMNMX", "SHFL", "SHFL+VIADDMNMX", "LDS+SHFL")
_CHAINS = {k: (k, k) for k in range(6)} | {6: (5, 0), 7: (2, 0), 8: (6, 6),
                                            9: (6, 0), 10: (4, 6)}
# Operations one thread runs per iteration: kUnroll x kChains.
OPS_PER_ITERATION = 16 * 8
THREADS = 256
# The data sheet's int32 rate of an H100 SXM: 67 TFLOP/s float32 = 132 SMs
# x 128 lanes x 2 (FMA) x 1.98 GHz, int32 on 64 lanes per SM.
INT32_PER_S = 67e12 / 2 / 2


def _loop(lib: Path, op: int) -> dict[str, int]:
    """Opcode histogram of probe ``op``'s timed loop, its longest."""
    for name, instrs in sass.sass_functions(lib).items():
        even, odd = _CHAINS[op]
        if "isa_probe_kernel" in name and re.search(rf"ILi{even}ELi{odd}EE", name):
            body = max(sass.loop_bodies(instrs), key=len, default=[])
            return dict(collections.Counter(o.split(".")[0] for o in body).most_common())
    raise RuntimeError(f"probe {OPS[op]}: kernel not found in the SASS")


def rates(iters: int = 4096, reps: int = 3) -> dict[str, dict]:
    """Per operation: thread-instructions per second on the card (best of
    ``reps`` launches), the SASS opcode its loop runs and the loop's
    opcodes."""
    _build.load()
    lib = _build.build()
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(dev)
    blocks = props.multi_processor_count * (props.max_threads_per_multi_processor // THREADS)
    out = torch.empty(blocks * THREADS, dtype=torch.int32, device=dev)
    result = {}
    for op, name in enumerate(OPS):

        def launch():
            _call("isa_probe", dev, op, out.data_ptr(), blocks, THREADS, iters, -1, 3)

        launch()  # warm-up
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        ops = blocks * THREADS * iters * OPS_PER_ITERATION
        loop = _loop(lib, op)
        result[name] = {
            "per_s": ops / min(times), "seconds": times,
            "opcode": max(loop, key=loop.get), "loop_opcodes": loop,
            "over_data_sheet": ops / min(times) / INT32_PER_S,
        }
    return result


def bound_factor(opcodes: dict[str, int], measured: dict[str, dict]) -> float:
    """How much longer a loop of ``opcodes`` (a SASS histogram) takes at the
    measured rates than at ``INT32_PER_S``, on the busier of its two integer
    pipes: ``IMAD`` on the FMA pipe at ``IMAD``'s rate; the other integer
    instructions one after another on the ALU pipe, each probed opcode at
    its own rate and every other at ``IADD3``'s (memory and control
    opcodes, ``LDS`` and ``SHFL`` among them, count in neither, as in the
    data-sheet bound)."""
    rate = {name: r["per_s"] for name, r in measured.items() if "+" not in name}
    rate |= {measured[name]["opcode"]: rate[name] for name in rate}
    alu = {op: n for op, n in opcodes.items()
           if not op.startswith(sass._NOT_ALU) and op != "IMAD"}
    imad = opcodes.get("IMAD", 0)
    published = max(sum(alu.values()), imad) / INT32_PER_S
    if not published:
        return 1.0
    t_alu = sum(n / rate.get(op, rate["IADD3"]) for op, n in alu.items())
    return max(t_alu, imad / rate["IMAD"]) / published


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA device")
    result = rates()
    for name, r in result.items():
        print(f"[probe] {name}: {r['per_s'] / 1e12} T/s ({r['over_data_sheet']} of "
              f"{INT32_PER_S / 1e12} T/s); loop {r['loop_opcodes']}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
