"""The port loads no JAX, and its chip smoke test refuses to run without a
GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(args, cwd, **kw):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300, **kw,
    )


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import seqalign_tpu_torch, seqalign_tpu_torch.pipeline, "
        "seqalign_tpu_torch.cli, seqalign_tpu_torch.ops.swa_cuda, "
        "seqalign_tpu_torch.ops.swa_torch, seqalign_tpu_torch.convert\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
        "if m.startswith('jax'))\n"
        "print('ok')\n"
    )
    proc = _run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """Without a CUDA device, and in a directory holding nothing of the repo
    but the script, chip_smoke.py exits nonzero and prints no result."""
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    proc = _run(["chip_smoke.py"], cwd)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _imported_modules(path):
    import ast

    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path",
    [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "seqalign_tpu_torch").rglob("*.py")),
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_only_host_module_imports_jax_package(path):
    """chip_smoke.py and the port take the JAX package's numpy host code
    through ``seqalign_tpu_torch.host`` alone, and never import jax."""
    mods = list(_imported_modules(path))
    assert not [m for m in mods if m == "jax" or m.startswith("jax.")]
    direct = [m for m in mods if m == "seqalign_tpu" or m.startswith("seqalign_tpu.")]
    if path.name == "host.py":
        assert direct and all(
            m.startswith(("seqalign_tpu.models", "seqalign_tpu.utils."))
            for m in direct
        )
    else:
        assert direct == []
