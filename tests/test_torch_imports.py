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


PORT_MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in (ROOT / "seqalign_tpu_torch").rglob("*.py")
)


def test_port_imports_no_jax():
    """Importing every module of the port, in a fresh interpreter, loads
    neither jax nor any module of the JAX package."""
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith"
        "(('jax.', 'seqalign_tpu.')) or m == 'seqalign_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = _run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    assert "seqalign_tpu_torch.host" in PORT_MODULES
    assert "seqalign_tpu_torch.utils.native_io" in PORT_MODULES


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
    """No file of the port, and not chip_smoke.py, imports jax or the JAX
    package: the port keeps its own copy of the host code (``models``,
    ``utils``), which ``seqalign_tpu_torch.host`` re-exports."""
    mods = list(_imported_modules(path))
    assert not [m for m in mods if m == "jax" or m.startswith("jax.")]
    assert not [m for m in mods if m == "seqalign_tpu" or m.startswith("seqalign_tpu.")]


@pytest.mark.parametrize(
    "path",
    sorted((ROOT / "seqalign_tpu_torch" / "ops").glob("*.py")),
    ids=lambda p: p.name,
)
def test_ops_layer_does_not_import_the_pipeline(path):
    """The kernel wrappers sit below the pipeline: no module of ``ops``
    imports it, at module level or inside a function (the device a host
    array goes to comes from ``seqalign_tpu_torch.device``)."""
    import ast

    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            names = [node.module or ""] + [a.name for a in node.names]
            assert "pipeline" not in names and not (node.module or "").endswith(
                ".pipeline"), f"{path.name}:{node.lineno} imports the pipeline"
        elif isinstance(node, ast.Import):
            assert not [a.name for a in node.names if a.name.endswith("pipeline")]


def test_an_xdist_worker_takes_its_share_of_the_cores():
    """Under xdist each worker's torch runs its share of the cores' intra-op
    threads (``_torch_cases``), not every core."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        pytest.skip("not an xdist worker")
    import torch

    import _torch_cases  # noqa: F401  sets the share at import

    assert torch.get_num_threads() == max(1, (os.cpu_count() or 1) // int(workers))
