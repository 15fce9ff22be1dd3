"""What nvcc made of the port's kernels: registers, spills and SASS.

    python -m seqalign_tpu_torch.sass [--against DIR] [--out FILE.json]

builds ``csrc/*.cu`` as ``ops/_build.py`` does and prints, for each kernel
function: the registers and spills ptxas reports (``-Xptxas -v``), its
number of SASS instructions (``cuobjdump -sass``), and its innermost DP
loop (every kernel's step loop, R rows at two positions: K1 and K3's
``sw_stream_kernel<R>`` and, at one thread a lane, ``sw_stream_solo_kernel<R,
Q>`` (Q queries a step, two steps an iteration at Q = 1), K2's
``sw_stream_striped_kernel`` and its block
instance ``sw_striped_block_kernel``, K4 and K5's ``sw_windows_kernel``):
the instructions of the loop body, the DP cells one iteration computes
(one ``LDS``, the profile gather ``P'[i][c]``, each; a loop without a
gather, K5's, computes the 2 R of a step) and the integer
ALU instructions per cell; of those, the ``IMAD`` family issues on the FMA
pipe beside the ALU pipe that takes the rest (``seqalign_tpu_torch.probe``
measures the two side by side), so ``pipe_per_cell`` counts the busier
pipe's. The team kernels' shuffles (``SHFL``) are not ALU work: the probe runs them
beside ``VIADDMNMX`` at twice the rate of either, and beside ``LDS`` at
the rate of one, so they take the shared-memory path with ``LDS``. A template kernel's instances
are keyed apart by their arguments (``sw_windows_kernel<36, false, true>``,
``sw_stream_kernel<36, false>``, ``sw_stream_solo_kernel<18, 2>``,
``sw_stream_striped_kernel<16, true, true, false>``). With ``--against DIR``
it builds
``DIR/seqalign_tpu_torch/csrc/*.cu`` (another checkout, for example the
parent commit) the same way and says, kernel by kernel, whether both builds
compiled to the same SASS, instruction for instruction.

Runs where the CUDA toolkit is (``nvcc`` and ``cuobjdump``).
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import tempfile
from pathlib import Path

from .ops import _build

KERNELS = ("sw_stream_kernel", "sw_stream_solo_kernel", "sw_stream_striped_kernel",
           "sw_striped_block_kernel", "sw_windows_kernel")
# Positions one step of a team kernel (csrc/sw_team.cuh) covers, R rows
# each. Where the step loop gathers the profile it holds one LDS per cell,
# and the count of LDS must equal 2 R (expected_cells).
STRIPED_POSITIONS_PER_STEP = 2
# The team kernels, whose first template argument is R: every kernel.
TEAM_KERNELS = ("sw_stream_kernel<", "sw_stream_solo_kernel<", "sw_stream_striped_kernel<",
                "sw_striped_block_kernel<", "sw_windows_kernel<")
# Steps one iteration of a solo instance of the fixed-batch kernel
# (sw_windows_kernel<R, true, ...>) runs: the kSoloWords steps of its
# block, unrolled (csrc/sw_windows.cuh).
SOLO_WINDOWS_STEPS = 4


def solo_stream_steps(queries: int) -> int:
    """Steps one iteration of the hot loop of K1 and K3's solo kernel
    (``sw_stream_solo_kernel<R, Q>``) runs: ``solo_steps<Q>()`` of
    csrc/sw_stream_solo.cu, two (four positions) at Q = 1, else one."""
    return 2 if queries == 1 else 1

# Opcodes that are not integer ALU work: memory (SHFL shares LDS's path),
# control, conversion.
_NOT_ALU = ("LD", "ST", "SHFL", "BRA", "BAR", "NOP", "EXIT", "RET", "CALL",
            "BSYNC", "BSSY", "S2R", "CS2R", "MEMBAR", "ULD", "UST", "WARPSYNC",
            "DEPBAR")

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`?\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")
_TEMPLATE_ARGS = re.compile(r"I((?:L[bi]\d+E)+)E")


def kernel_key(mangled: str) -> str | None:
    """The kernel of ``KERNELS`` a mangled name belongs to, with its bool and
    int template arguments (``sw_stream_striped_kernel<16, true, true,
    false>``); None for another function."""
    short = next((k for k in sorted(KERNELS, key=len, reverse=True) if k in mangled), None)
    if short is None:
        return None
    m = _TEMPLATE_ARGS.match(mangled[mangled.index(short) + len(short):])
    if not m:
        return short
    args = ", ".join(
        v if t == "i" else ("true" if v == "1" else "false")
        for t, v in re.findall(r"L([bi])(\d+)E", m.group(1))
    )
    return f"{short}<{args}>"


def expected_cells(key: str) -> int:
    """The cells one iteration of a team kernel's step loop computes (K1,
    K3, K2, K4, K5): ``STRIPED_POSITIONS_PER_STEP`` x R, the first template
    argument, a step; ``SOLO_WINDOWS_STEPS`` steps for a solo instance of
    the fixed-batch kernel; Q queries a step, the second argument, for the
    solo kernel of K1 and K3 (``sw_stream_solo_kernel<R, Q>``: 2 Q R a
    step, :func:`solo_stream_steps` steps an iteration, so 4 R at Q = 1).
    Where the loop gathers the profile, its ``LDS``. Raises for a key
    without R."""
    m = re.match(r"[^<]*<(\d+)(?:, (true|\d+))?", key)
    if not key.startswith(TEAM_KERNELS) or not m:
        raise ValueError(f"{key!r} names no team kernel instance")
    steps = SOLO_WINDOWS_STEPS if key.startswith("sw_windows_kernel<") and m.group(2) else 1
    if key.startswith("sw_stream_solo_kernel<"):
        q = int(m.group(2))  # queries a step
        steps = q * solo_stream_steps(q)
    return STRIPED_POSITIONS_PER_STEP * int(m.group(1)) * steps


def resource_usage(lib: Path, text: str | None = None) -> dict[str, dict[str, int]]:
    """Function (mangled) -> the resources ``cuobjdump -res-usage`` reports
    (``REG``, ``STACK``, ``SHARED``, ``LOCAL``, ...); ``LOCAL`` and
    ``STACK`` 0 mean no spills (ptxas spills to the stack frame)."""
    if text is None:
        text = subprocess.run([_tool("cuobjdump"), "-res-usage", str(lib)],
                              capture_output=True, text=True, check=True).stdout
    usage, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function (\S+?):?\s*$", line)
        if m:
            cur = m.group(1)
            continue
        if cur and "REG:" in line:
            usage[cur] = {k: int(v) for k, v in re.findall(r"([A-Z]+(?:\[\d+\])?):(\d+)", line)}
            cur = None
    return usage


def _tool(name: str) -> str:
    return str(Path(_build._find_nvcc()).with_name(name))


def build_lib(csrc: Path, out_dir: Path) -> tuple[Path, str]:
    """Compile the ``.cu`` files of ``csrc`` with the port's flags and
    ``-Xptxas -v``; returns (library, ptxas's report)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "lib.so"
    cmd = [_build._find_nvcc(), "-Xptxas", "-v", *_build.NVCC_FLAGS, "-o", str(lib),
           *map(str, sorted(Path(csrc).glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return lib, proc.stdout + proc.stderr


def ptxas_usage(text: str) -> dict[str, str]:
    """Kernel (mangled) -> ptxas's 'Used N registers, ...' line."""
    usage, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
        elif current and ("Used" in line or "spill" in line):
            usage[current] = (usage.get(current, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return usage


def cuobjdump(lib: Path) -> str:
    return subprocess.run([_tool("cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout


def sass_functions(lib: Path, text: str | None = None
                   ) -> dict[str, list[tuple[int, str, str | None]]]:
    """Function (mangled) -> [(address, instruction, label before it)]."""
    if text is None:
        text = cuobjdump(lib)
    funcs, cur, label = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur, label = m.group(1), None
            funcs[cur] = []
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            label = m.group(1)
            continue
        m = _INSTR.search(line)
        if m:
            funcs[cur].append((int(m.group(1), 16), m.group(2).strip(), label))
            label = None
    return funcs


def opcode(instr: str) -> str:
    tok = instr.split()
    if tok and tok[0].startswith("@"):
        tok = tok[1:]
    return tok[0] if tok else ""


def loop_bodies(instrs) -> list[list[str]]:
    """The opcodes of each loop of a function: from a backward branch's
    target to the branch."""
    at = {lab: i for i, (_, _, lab) in enumerate(instrs) if lab}
    at.update({addr: i for i, (addr, _, _) in enumerate(instrs)})
    bodies = []
    for k, (_, ins, _) in enumerate(instrs):
        if opcode(ins).split(".")[0] != "BRA":
            continue
        m = _TARGET.search(ins)
        if not m:
            continue
        start = at.get(m.group(1) if m.group(1) else int(m.group(2), 16), k + 1)
        if start <= k:
            bodies.append([opcode(x) for _, x, _ in instrs[start : k + 1]])
    return bodies


def inner_loop(instrs, key: str | None = None) -> dict | None:
    """The innermost DP loop, the shortest backward branch whose body holds
    DP work (``VIADDMNMX``, the E and F updates): its size, its cells and
    integer ALU instructions per cell. The cells are its ``LDS`` (the
    profile gather), one each; only a kernel with no DP loop that gathers
    (K5) takes a loop without ``LDS``, of :func:`expected_cells` of its
    instance ``key`` (2 R a step)."""
    bodies = []
    for body in loop_bodies(instrs):
        if any(op.startswith("VIADDMNMX") for op in body):
            bodies.append(collections.Counter(op.split(".")[0] for op in body))
    if not bodies:
        return None
    # A loop that gathers beats any that does not; then the shortest.
    hist = min(bodies, key=lambda h: (not h["LDS"], sum(h.values())))
    if not hist["LDS"] and key is None:
        raise ValueError("a DP loop without a profile gather needs its instance key")
    cells = hist["LDS"] or expected_cells(key)
    alu = sum(n for op, n in hist.items() if not op.startswith(_NOT_ALU))
    size = sum(hist.values())
    return {"instructions": size, "cells": cells,
            "cells_from": "LDS" if hist["LDS"] else "step",
            "alu_per_cell": alu / cells,
            "imad_per_cell": hist["IMAD"] / cells,
            "pipe_per_cell": max(alu - hist["IMAD"], hist["IMAD"]) / cells,
            "instructions_per_cell": size / cells,
            "opcodes": dict(hist.most_common())}


def report(lib: Path, ptxas: str, strict: bool = True) -> dict:
    """Per kernel: ptxas usage, SASS size, inner loop, and the SASS. Not
    ``strict`` (another checkout's kernels), a loop this module cannot count
    (an older kernel's instance key) is reported as None."""
    usage = ptxas_usage(ptxas)
    out = {}
    for name, instrs in sass_functions(lib).items():
        key = kernel_key(name)
        if key is None:
            continue
        try:
            loop = inner_loop(instrs, key)
        except ValueError:
            if strict:
                raise
            loop = None
        out[key] = {
            "mangled": name,
            "ptxas": next((v for k, v in usage.items() if k == name), None),
            "sass_instructions": len(instrs),
            "inner_loop": loop,
            "sass": [ins for _, ins, _ in instrs],
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None,
                    help="another checkout whose kernels to compare with")
    ap.add_argument("--out", default=None)
    ap.add_argument("--dump", default=None, help="write the raw SASS here")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        lib, ptxas = build_lib(_build._CSRC, tmp / "this")
        if args.dump:
            Path(args.dump).parent.mkdir(parents=True, exist_ok=True)
            Path(args.dump).write_text(cuobjdump(lib))
        this = report(lib, ptxas)
        other = None
        if args.against:
            csrc = Path(args.against) / "seqalign_tpu_torch" / "csrc"
            olib, optxas = build_lib(csrc, tmp / "other")
            other = report(olib, optxas, strict=False)
    result = {"kernels": {}}
    for key, r in this.items():
        row = {k: v for k, v in r.items() if k != "sass"}
        if other is not None and key in other:
            row["same_sass_as_other"] = r["sass"] == other[key]["sass"]
            row["other_sass_instructions"] = other[key]["sass_instructions"]
        result["kernels"][key] = row
        loop = r["inner_loop"] or {}
        print(f"[sass] {key}: {r['ptxas']}; {r['sass_instructions']} SASS "
              f"instructions; inner loop {loop.get('instructions')} instructions, "
              f"{loop.get('cells')} cells, {loop.get('alu_per_cell')} integer ALU "
              f"instructions per cell; "
              + (f"same SASS as --against: {row['same_sass_as_other']} "
                 f"({row['other_sass_instructions']} there)"
                 if "same_sass_as_other" in row else ""), flush=True)
        print(f"[sass] {key} inner loop opcodes: {loop.get('opcodes')}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
