"""Build and load the host's native libraries at first use.

``native/fastio.cc`` (FASTA/FASTQ parse and encode, the chunked reader, the
lane-batch packer) and ``native/traceback.cc`` (the traceback fill and the
linear-space end pass) compile with the host's C++ compiler (``$CXX``, else
``g++``) into ``build/seqalign_tpu_torch/host/`` at the root of the checkout,
with the flags of ``native/Makefile``. The Makefile itself is not run: it
writes into the JAX package's tree.

A library's file name carries a hash of its source, the flags, the
compiler's ``--version`` and the CPU's model and feature flags: an edited
source or another compiler builds afresh, and so does another CPU, since
``-march=native`` may use instructions that a ``build/`` carried to another
machine would not find there. Each build writes a private temporary file
and renames it into place, so processes that build at once all end with
one whole library. A failed build raises ``RuntimeError`` with the
compiler's output; with no compiler on the ``PATH`` :func:`load` returns
None and the callers keep their pure-Python paths.

    python -m seqalign_tpu_torch.native

builds both libraries from nothing in a fresh directory under ``build/``
and prints the seconds each took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ROOT / "native"
BUILD_DIR = ROOT / "build" / "seqalign_tpu_torch" / "host"
FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-Wall"]
# Per library: its source, whether it prefers C++23 (fastio guards its use
# of std::string::resize_and_overwrite, so c++17 builds it too), and the
# libraries it links.
LIBRARIES = {
    "fastio": ("fastio.cc", True, ["-lz"]),
    "traceback": ("traceback.cc", False, []),
}

_loaded: dict[str, ctypes.CDLL | None] = {}


def compiler() -> str | None:
    """The host's C++ compiler, or None when there is none."""
    return shutil.which(os.environ.get("CXX") or "g++")


def _run(cmd) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True)


def _cpu() -> str:
    """The CPU's model name and feature flags (``/proc/cpuinfo``), which
    decide what ``-march=native`` emits."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.processor() or platform.machine()
    keys = ("model name", "flags", "Features", "CPU part")
    return "\n".join(sorted({ln for ln in lines if ln.split(":")[0].strip() in keys}))


def _std(cxx: str, prefer_2b: bool) -> str:
    """``-std=c++2b`` when wanted and the compiler takes it (as
    ``native/Makefile`` probes), else ``-std=c++17``."""
    if prefer_2b and _run(
        [cxx, "-std=c++2b", "-x", "c++", "-E", os.devnull]
    ).returncode == 0:
        return "-std=c++2b"
    return "-std=c++17"


def build(name: str, build_dir: Path = BUILD_DIR) -> Path:
    """Compile library ``name`` unless a build of this source, these flags
    and this compiler exists; returns the shared library's path."""
    src_name, prefer_2b, libs = LIBRARIES[name]
    cxx = compiler()
    if cxx is None:
        raise RuntimeError(
            f"no C++ compiler ({os.environ.get('CXX') or 'g++'}) on the PATH "
            f"to build native/{src_name}"
        )
    src = SOURCES / src_name
    flags = [*FLAGS, _std(cxx, prefer_2b)]
    h = hashlib.sha256(" ".join(flags + libs).encode())
    h.update(_run([cxx, "--version"]).stdout.encode())
    h.update(_cpu().encode())
    h.update(src.read_bytes())
    lib_path = Path(build_dir) / f"_{name}_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=lib_path.parent, prefix=lib_path.name, suffix=".tmp")
    os.close(fd)
    try:
        cmd = [cxx, *flags, "-o", tmp, str(src), *libs]
        proc = _run(cmd)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{Path(cxx).name} failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def load(name: str) -> ctypes.CDLL | None:
    """The loaded library ``name`` (built first if needed), or None when
    the host has no C++ compiler."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name))) if compiler() else None
    return _loaded[name]


def main() -> int:
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        for name in LIBRARIES:
            t0 = time.perf_counter()
            build(name, Path(tmp))
            print(f"[native] {name}: built in {time.perf_counter() - t0} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
