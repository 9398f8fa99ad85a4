"""The port's state constructors run on the card by default.

Each public constructor that takes ``device=None`` puts its tensors on
``cuda`` through ``device.resolve_device``, which raises when there is
no card: a missing GPU never turns into a quiet CPU store.  With
``device="cpu"`` every tensor it returns lies on the CPU.
``gumbel_noise`` follows its generator's device instead.  The last case
scans the package's source for any public ``def`` whose ``device``
defaults to ``None`` and that neither resolves it nor hands it on to a
function that does.
"""

import ast
from pathlib import Path

import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu_torch.algos import acer as ACER
from dcarl_tpu_torch.algos import her as HER
from dcarl_tpu_torch.core import confidence as C
from dcarl_tpu_torch.core import rls as R
from dcarl_tpu_torch.core import store as ST
from dcarl_tpu_torch.models import dqn as DQ
from dcarl_tpu_torch.models import replay as RB
from dcarl_tpu_torch.models import segment as SEG
from dcarl_tpu_torch.models import trustset as TS
from dcarl_tpu_torch.ops import kinematics as K
from dcarl_tpu_torch.parallel import launch as L
from dcarl_tpu_torch.parallel import normalize as N

ROOT = Path(__file__).resolve().parent.parent

CONSTRUCTORS = {
    "store_init": lambda **kw: ST.store_init(8, 3, **kw),
    "traj_buffer_init": lambda **kw: R.traj_buffer_init(4, 3, **kw),
    "golden_init": lambda **kw: C.golden_init(2, 3, 4, **kw),
    "running_init": lambda **kw: C.running_init((2, 3), **kw),
    "replay_init": lambda **kw: RB.replay_init(8, 3, **kw),
    "param_noise_init": lambda **kw: DQ.param_noise_init(0.1, **kw),
    "segment_init": lambda **kw: SEG.segment_init(2, 3, **kw),
    "trustset_init": lambda **kw: TS.trustset_init(8, 3, **kw),
    "rms_init": lambda **kw: N.rms_init((3,), **kw),
    "vec_normalize_init": lambda **kw: N.vec_normalize_init((3,), 2, **kw),
    "RigidBodyState.create": lambda **kw: K.RigidBodyState.create(**kw),
    "her_buffer_init": lambda **kw: HER.her_buffer_init(4, 3, 2, **kw),
    "segment_buffer_init": lambda **kw: ACER.segment_buffer_init(
        2, 3, 4, 5, 3, **kw),
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_default_device_needs_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CONSTRUCTORS[name]()
    out = CONSTRUCTORS[name](device="cpu")
    leaves = list(_tensors(out))
    assert leaves
    assert all(t.device.type == "cpu" for t in leaves), name


def test_run_ranks_default_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        L.run_ranks(print, 2)


def test_gumbel_noise_follows_its_generator(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator().manual_seed(0)
    assert RB.gumbel_noise((4, 5), g).device.type == "cpu"
    assert RB.gumbel_noise((4, 5), g, device="cpu").device.type == "cpu"


# Functions that take ``device=None`` and place nothing themselves:
# ``gumbel_noise`` defaults to its generator's device, and the two suites
# hand ``device`` on inside a keyword dict (``dict(..., device=device)``)
# to ``run_improvement`` / ``make_trainer_fast``, which resolve it.
PASS_THROUGH = {"gumbel_noise", "run_improvement_suite",
                "run_two_session_improvement"}


def _call_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    return f.id if isinstance(f, ast.Name) else ""


def _passes_device(call: ast.Call) -> bool:
    args = list(call.args) + [k.value for k in call.keywords]
    return any(isinstance(a, ast.Name) and a.id == "device" for a in args)


def _device_defs():
    """(file, name, node, device defaults to None) of every def with a
    ``device`` parameter."""
    for path in sorted((ROOT / "dcarl_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            a = node.args
            pos = a.posonlyargs + a.args
            defaults = dict(zip([x.arg for x in pos][len(pos)
                                                      - len(a.defaults):],
                                a.defaults))
            defaults.update({k.arg: d for k, d in zip(a.kwonlyargs,
                                                      a.kw_defaults)
                             if d is not None})
            if "device" not in [x.arg for x in pos + a.kwonlyargs]:
                continue
            d = defaults.get("device")
            yield (path.relative_to(ROOT), node.name, node,
                   isinstance(d, ast.Constant) and d.value is None)


def test_device_none_defaults_resolve():
    """Every public ``device=None`` def resolves its device, or hands it
    on to a def (public or private) that does."""
    defs = list(_device_defs())
    public = [(str(p), name) for p, name, _, none in defs
              if none and not name.startswith("_")]
    assert len(public) > 20
    ok = {"resolve_device"} | PASS_THROUGH
    calls = {(str(p), name): [c for c in ast.walk(node)
                              if isinstance(c, ast.Call)]
             for p, name, node, _ in defs}
    grew = True
    while grew:   # a def is fine once it hands device to a fine def
        grew = False
        for (p, name), cs in calls.items():
            if name in ok:
                continue
            if any(_call_name(c) == "resolve_device" for c in cs) or any(
                    _call_name(c) in ok and _passes_device(c) for c in cs):
                ok.add(name)
                grew = True
    bad = sorted(f"{p}::{name}" for (p, name) in public if name not in ok)
    assert not bad, ("device=None not resolved (the default would be the "
                     f"CPU): {bad}")
