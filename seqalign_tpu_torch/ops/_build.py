"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, loaded with ``ctypes``; no PyTorch headers are involved, so a
build takes seconds. The sources compile in parallel, one ``nvcc -c`` each,
and are then linked. The library's file name carries a hash of the sources,
the headers they share (``csrc/*.cuh``) and the flags, so an edited source
is rebuilt and an unchanged one is loaded
from ``build/seqalign_tpu_torch/`` at the root of the checkout. A missing
``nvcc`` or a failed build raises ``RuntimeError``; nothing falls back.

    python -m seqalign_tpu_torch.ops._build

times a build from nothing both ways, in fresh directories under
``build/``: one ``nvcc`` over every source, and :func:`build`'s parallel
compiles and link.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "seqalign_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
]

_lib = None


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
        "of seqalign_tpu_torch are built with the CUDA toolkit"
    )


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the kernels unless a build of these exact sources exists.

    Returns the shared library's path.
    """
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs + sorted(_CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib_path = Path(build_dir) / f"libseqalign_kernels_{h.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _find_nvcc()
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in srcs]
    procs = []
    try:
        for src, obj in zip(srcs, objs):
            cmd = [nvcc, *compile_flags, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        for cmd, proc in procs:
            out, err = proc.communicate()
            _check(cmd, proc.returncode, out, err)
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _check(cmd, proc.returncode, proc.stdout, proc.stderr)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib_path)
    return lib_path


def _check(cmd, returncode, stdout, stderr) -> None:
    if returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({returncode}): {' '.join(cmd)}\n{stdout}{stderr}"
        )


def load() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.sw_stream_launch.restype = ctypes.c_int
        lib.sw_stream_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        )
        lib.sw_stream_solo_launch.restype = ctypes.c_int
        lib.sw_stream_solo_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        )
        lib.sw_stream_striped_launch.restype = ctypes.c_int
        lib.sw_stream_striped_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        )
        lib.sw_striped_block_launch.restype = ctypes.c_int
        lib.sw_striped_block_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        )
        lib.sw_windows_launch.restype = ctypes.c_int
        lib.sw_windows_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        )
        lib.sw_windows_team_threads.restype = ctypes.c_int
        lib.sw_windows_team_threads.argtypes = [ctypes.c_int]
        lib.stream_pack_launch.restype = ctypes.c_int
        lib.stream_pack_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_int64, ctypes.c_void_p]
        )
        lib.isa_probe_launch.restype = ctypes.c_int
        lib.isa_probe_launch.argtypes = (
            [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        )
        lib.tb_fill_launch.restype = ctypes.c_int
        lib.tb_fill_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int64] * 5
            + [ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        )
        lib.tb_fill_sync.restype = ctypes.c_int
        lib.tb_fill_sync.argtypes = [ctypes.c_void_p]
        lib.sw_stream_error_string.restype = ctypes.c_char_p
        lib.sw_stream_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def error_string(err: int) -> str:
    return load().sw_stream_error_string(err).decode()


def main() -> int:
    import tempfile
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(Path(tmp) / "one.so"),
               *map(str, _sources())]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        one = time.perf_counter() - t0
        _check(cmd, proc.returncode, proc.stdout, proc.stderr)
        t0 = time.perf_counter()
        build(Path(tmp) / "parallel")
        parallel = time.perf_counter() - t0
    print(f"[build] {len(_sources())} sources: one nvcc {one} s, one nvcc -c each "
          f"in parallel and a link {parallel} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
