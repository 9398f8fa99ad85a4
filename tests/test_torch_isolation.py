"""The PyTorch port stands alone: no module of ``dcarl_tpu_torch``, not
``chip_smoke.py`` and not the rank programs that spawned ranks import
(``tests/torch_rank_programs.py``) imports JAX, the JAX package, its
``examples/`` or ``msgpack`` (the port speaks the planner protocol with
its own codec); the bridge and the utilities import without ``msgpack``
and ``matplotlib``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "dcarl_tpu",
             "examples", "msgpack")
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
        "import dcarl_tpu_torch.utils\n"
        "import dcarl_tpu_torch.utils.native\n"
        "import dcarl_tpu_torch.driver\n"
        "import dcarl_tpu_torch.bridge\n"
        "import dcarl_tpu_torch.bridge.agent_session\n"
        "import dcarl_tpu_torch.algos\n"
        "import dcarl_tpu_torch.bench, dcarl_tpu_torch.cli\n"
        "from dcarl_tpu_torch.examples import (bench_scaling, bench_store,\n"
        "    profile_step, run_field_replay, run_improvement, run_rollout,\n"
        "    run_simulation1, run_simulation2, run_vehicle_life,\n"
        "    train_multihost)\n"
        "from dcarl_tpu_torch.tools import bench_store_scale\n"
        "from dcarl_tpu_torch.algos import (a2c, acer, acktr, common, ddpg,\n"
        "    gail, her, nets, ppo, sac, td3, trpo)\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_rank_programs\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'dcarl_tpu', 'msgpack')]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_bridge_and_utils_import_without_msgpack_or_matplotlib():
    code = (
        "import sys\n"
        "for name in ('msgpack', 'matplotlib', 'matplotlib.pyplot'):\n"
        "    sys.modules[name] = None\n"
        "import dcarl_tpu_torch.bridge, dcarl_tpu_torch.utils\n"
        "import dcarl_tpu_torch.bridge.agent_session\n"
        "from dcarl_tpu_torch.bridge import wire\n"
        "u = wire.Unpacker()\n"
        "u.feed(wire.packb([1.5, 2, None]))\n"
        "assert list(u) == [[1.5, 2, None]]\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_every_jax_module_has_a_counterpart():
    """Each module of ``dcarl_tpu`` has one of the same path in the port,
    except ``ops/pallas_store.py``, whose kernels live in
    ``ops/store_kernels.py`` and ``csrc/``."""
    def modules(pkg):
        return {p.relative_to(ROOT / pkg).as_posix()
                for p in (ROOT / pkg).rglob("*.py")}

    missing = modules("dcarl_tpu") - modules("dcarl_tpu_torch")
    assert missing == {"ops/pallas_store.py"}


# Public names of JAX modules the port leaves out by design, each with
# its reason; ``ops/pallas_store`` as a whole (its kernels are
# ``ops/store_kernels.py`` and ``csrc/``).
MISSING_BY_DESIGN = {
    # the port's DQN holds its state in place (models/dqn.py)
    ("models/dqn", "DQNState"),
    # the vec env over the port's env is TorchVecEnv
    ("parallel/vec_env", "JaxVecEnv"),
    # the port's get_absolute_state broadcasts over a batch
    ("ops/kinematics", "get_absolute_state_batch"),
    # the port's named regions are profiling.span, behind the tracing
    # switch, and its timings come from the device trace: no host timer
    ("utils/profiling", "annotate"),
    ("utils/profiling", "StepTimer"),
}
JAX_MODULES = sorted(
    p.relative_to(ROOT / "dcarl_tpu").with_suffix("").as_posix()
    for p in (ROOT / "dcarl_tpu").rglob("*.py")
    if p.relative_to(ROOT / "dcarl_tpu").as_posix() != "ops/pallas_store.py")


def _defined_names(path: Path) -> set:
    """Public names a module defines at its top level (defs, classes,
    assignments) or re-exports in ``__all__``; its imports do not count."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == "__all__":
                        names |= set(ast.literal_eval(node.value))
    return {n for n in names if not n.startswith("_")}


def _plain(v) -> bool:
    if isinstance(v, (bool, int, float, str)):
        return True
    return isinstance(v, (tuple, list)) and not hasattr(v, "_fields") \
        and all(_plain(x) for x in v)


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_jax_name_exists_in_the_port(rel):
    """Each public top-level name of a JAX module is an attribute of its
    counterpart (compared by attribute: the port may import it), and an
    equal constant (plain values, config instances) has the same value."""
    import dataclasses
    import importlib

    parts = [x for x in rel.split("/") if x != "__init__"]
    jmod = importlib.import_module(".".join(["dcarl_tpu", *parts]))
    tmod = importlib.import_module(".".join(["dcarl_tpu_torch", *parts]))
    mod = "/".join(parts)
    names = _defined_names(ROOT / "dcarl_tpu" / (rel + ".py"))
    missing = sorted(n for n in names if not hasattr(tmod, n)
                     and (mod, n) not in MISSING_BY_DESIGN)
    assert not missing, f"{rel}: the port lacks {missing}"
    for n in sorted(names):
        if not hasattr(tmod, n):
            continue
        jv, tv = getattr(jmod, n), getattr(tmod, n)
        if _plain(jv):
            assert tv == jv, f"{rel}.{n}: {tv!r} != JAX's {jv!r}"
        elif dataclasses.is_dataclass(jv) and not isinstance(jv, type):
            assert dataclasses.asdict(tv) == dataclasses.asdict(jv), \
                f"{rel}.{n} differs from JAX's"


def test_allowed_missing_names_are_still_missing():
    """The allow-list holds only names that JAX has and the port lacks."""
    import importlib

    for mod, name in sorted(MISSING_BY_DESIGN):
        path = ROOT / "dcarl_tpu" / (mod + ".py")
        assert name in _defined_names(path), (mod, name)
        tmod = importlib.import_module(
            "dcarl_tpu_torch." + mod.replace("/", "."))
        assert not hasattr(tmod, name), (mod, name)


# Entry points of the repo that stay unported, with the reason.
UNPORTED_ENTRY_POINTS = {
    # compiles for a TPU topology (jax.experimental.topologies): no
    # counterpart on one card
    "tools/aot_scaling_audit.py",
    # ablates XLA fusions; the port profiles with torch.profiler
    # (utils/profiling.py, tools/torch_field_profile.py)
    "tools/profile_breakdown.py",
    # drives the port already
    "tools/algo_seed_rates.py",
}
# JAX entry points whose counterpart has another path.
ENTRY_RENAMES = {"examples/run_agent_server.py": "bridge/agent_session.py"}


def test_every_entry_point_has_a_counterpart():
    """``bench.py``, ``examples/*.py`` and ``tools/*.py`` each have their
    counterpart under ``dcarl_tpu_torch/`` at the same path (``tools/``'s
    own ``torch_*.py`` drive the port already), except the listed ones."""
    entries = ["bench.py"] + sorted(
        p.relative_to(ROOT).as_posix()
        for d in ("examples", "tools") for p in (ROOT / d).glob("*.py")
        if not p.name.startswith("torch_"))
    missing = [e for e in entries if e not in UNPORTED_ENTRY_POINTS
               and not (ROOT / "dcarl_tpu_torch"
                        / ENTRY_RENAMES.get(e, e)).is_file()]
    assert not missing, f"entry points without a counterpart: {missing}"
    for e in UNPORTED_ENTRY_POINTS:
        assert (ROOT / e).is_file() and not (ROOT / "dcarl_tpu_torch"
                                             / e).exists(), e
