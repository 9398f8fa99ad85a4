"""Start ranks on one host: :func:`run_ranks`.

Each rank is a fresh interpreter (``python -m
dcarl_tpu_torch.parallel.launch``) that imports the port and the module
of the rank program, joins a process group at a ``file://`` rendezvous
in a temporary directory (no port to contend for, so concurrent test
workers never meet), runs ``fn(mesh, *args)`` and hands its result back
as a pickle the parent reads.  Each rank runs with one CPU thread.  The
rendezvous, every collective and the whole run have a time limit; when
a rank fails or the limit passes, every rank is killed and the parent
raises with the failed rank's output.  A rank that has imported JAX or
the JAX package when its program returns fails: the port stands alone.

This is how the tests run several gloo ranks on the CPU, and how
``chip_smoke.py`` runs two ranks on one card.  On a machine with one
card a rank each, start the ranks with the ``DCARL_*`` environment of
``distributed.initialize_from_env`` instead.
"""

from __future__ import annotations

import datetime
import importlib
import importlib.util
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, List, Sequence

_PKG_ROOT = Path(__file__).resolve().parent.parent.parent
_FOREIGN = ("jax", "jaxlib", "dcarl_tpu")


def _module_path(fn: Callable) -> "tuple[str, str]":
    """(module name, source file) of ``fn``: the child imports the module
    with the file's directory on its path."""
    mod = sys.modules[fn.__module__]
    path = getattr(mod, "__file__", None)
    if path is None:
        raise ValueError(f"{fn.__module__} has no file: a rank cannot "
                         "import it")
    return fn.__module__, str(Path(path).resolve())


def run_ranks(fn: Callable, world_size: int, backend: str = "gloo",
              device: "str | None" = None, timeout_s: float = 60.0,
              args: Sequence[Any] = ()) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``world_size`` ranks of one process
    group (``backend`` "gloo" or "nccl", every rank's tensors on
    ``device``) and return the ranks' results in rank order.  ``fn`` is
    a module-level function; its module and ``args`` must import and
    unpickle in a fresh interpreter.  ``device=None`` puts the ranks on
    ``cuda`` (which must exist), as every entry point of the port does;
    pass ``device="cpu"`` for host ranks."""
    from dcarl_tpu_torch.device import resolve_device

    device = str(resolve_device(device))
    module, path = _module_path(fn)
    with tempfile.TemporaryDirectory(prefix="dcarl_ranks_") as tmp:
        tmp = Path(tmp)
        with open(tmp / "job.pkl", "wb") as f:
            pickle.dump({"module": module, "path": path,
                         "name": fn.__qualname__, "args": tuple(args),
                         "world": world_size, "backend": backend,
                         "device": device, "timeout_s": timeout_s}, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(_PKG_ROOT), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
        env["OMP_NUM_THREADS"] = "1"
        procs, logs = [], []
        try:
            for rank in range(world_size):
                log = open(tmp / f"rank{rank}.log", "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "dcarl_tpu_torch.parallel.launch",
                     str(tmp), str(rank)], env=env, stdout=log,
                    stderr=subprocess.STDOUT, cwd=str(_PKG_ROOT)))
            deadline = time.monotonic() + timeout_s
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    raise RuntimeError(
                        f"rank {bad[0]} of {world_size} exited with "
                        f"{codes[bad[0]]}:\n{_tail(logs[bad[0]])}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world_size} ranks of {module}.{fn.__qualname__} "
                        f"ran past {timeout_s} s:\n{_tail(logs[0])}")
                time.sleep(0.05)
            out = []
            for rank in range(world_size):
                with open(tmp / f"result{rank}.pkl", "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            for log in logs:
                log.close()


def _tail(log, n: int = 4000) -> str:
    log.flush()
    log.seek(0)
    return log.read()[-n:]


def _rank_main(tmp: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    from dcarl_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    with open(Path(tmp) / "job.pkl", "rb") as f:
        job = pickle.load(f)
    if job["module"] == "__main__":   # a script's function: load its file
        spec = importlib.util.spec_from_file_location("__rank_main__",
                                                      job["path"])
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        sys.path.insert(0, str(Path(job["path"]).parent))
        mod = importlib.import_module(job["module"])
    fn = mod
    for part in job["name"].split("."):
        fn = getattr(fn, part)
    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        job["backend"], init_method=f"file://{tmp}/rendezvous",
        world_size=job["world"], rank=rank,
        timeout=datetime.timedelta(seconds=job["timeout_s"]))
    try:
        result = fn(make_mesh("env", dist.group.WORLD, device), *job["args"])
        foreign = sorted({m.split(".")[0] for m in sys.modules
                          if m.split(".")[0] in _FOREIGN})
        if foreign:
            raise RuntimeError(f"rank {rank} imported {foreign}")
        with open(Path(tmp) / f"result{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
