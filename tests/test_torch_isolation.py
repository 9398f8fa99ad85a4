"""The PyTorch port stands alone: no module of ``dcarl_tpu_torch``, not
``chip_smoke.py`` and not the rank programs that spawned ranks import
(``tests/torch_rank_programs.py``) imports JAX or the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "dcarl_tpu")
PORT_FILES = sorted((ROOT / "dcarl_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_rank_programs.py"]


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
        "import dcarl_tpu_torch.train_fast\n"
        "import dcarl_tpu_torch.models.dqn\n"
        "import dcarl_tpu_torch.improvement\n"
        "import dcarl_tpu_torch.session\n"
        "import dcarl_tpu_torch.workingset\n"
        "import dcarl_tpu_torch.utils.checkpoint\n"
        "import dcarl_tpu_torch.core.confidence\n"
        "import dcarl_tpu_torch.data\n"
        "import dcarl_tpu_torch.models.networks\n"
        "import dcarl_tpu_torch.models.segment\n"
        "import dcarl_tpu_torch.models.trustset\n"
        "import dcarl_tpu_torch.ops.geometry\n"
        "import dcarl_tpu_torch.ops.spline\n"
        "import dcarl_tpu_torch.ops.kinematics\n"
        "import dcarl_tpu_torch.ops.motion_models\n"
        "import dcarl_tpu_torch.env.driving_env\n"
        "import dcarl_tpu_torch.control.controller\n"
        "import dcarl_tpu_torch.planning.predictor\n"
        "import dcarl_tpu_torch.planning.werling\n"
        "import dcarl_tpu_torch.planning.rollout\n"
        "import dcarl_tpu_torch.planning.veg\n"
        "import dcarl_tpu_torch.train\n"
        "import dcarl_tpu_torch.parallel.mesh\n"
        "import dcarl_tpu_torch.parallel.collectives\n"
        "import dcarl_tpu_torch.parallel.distributed\n"
        "import dcarl_tpu_torch.parallel.sharded_store\n"
        "import dcarl_tpu_torch.parallel.normalize\n"
        "import dcarl_tpu_torch.parallel.launch\n"
        "import dcarl_tpu_torch.planning.multilane\n"
        "import dcarl_tpu_torch.planning.idm\n"
        "import dcarl_tpu_torch.planning.lane_utility\n"
        "import dcarl_tpu_torch.planning.decision\n"
        "import dcarl_tpu_torch.planning.safeguard\n"
        "import dcarl_tpu_torch.planning.local_trajectory\n"
        "import dcarl_tpu_torch.env.multilane_env\n"
        "import dcarl_tpu_torch.cognition\n"
        "import dcarl_tpu_torch.navigation\n"
        "import dcarl_tpu_torch.navigation.opendrive\n"
        "import dcarl_tpu_torch.parallel.vec_env\n"
        "import dcarl_tpu_torch.control.calibration\n"
        "import dcarl_tpu_torch.utils.nan_guard\n"
        "import dcarl_tpu_torch.utils.profiling\n"
        "import dcarl_tpu_torch.algos\n"
        "from dcarl_tpu_torch.algos import (a2c, acer, acktr, common, ddpg,\n"
        "    gail, her, nets, ppo, sac, td3, trpo)\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_rank_programs\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'dcarl_tpu')]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
