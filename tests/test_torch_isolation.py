"""The PyTorch port stands alone: no module of ``dcarl_tpu_torch``, and
not ``chip_smoke.py``, imports JAX or the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "dcarl_tpu")
PORT_FILES = sorted((ROOT / "dcarl_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_module_imports_no_jax(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import dcarl_tpu_torch\n"
        "import dcarl_tpu_torch.interop\n"
        "import dcarl_tpu_torch.planning.fast_rollout\n"
        "import dcarl_tpu_torch.ops.store_kernels\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'dcarl_tpu')]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
