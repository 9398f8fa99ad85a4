"""Imported by the port's test modules (``tests/test_torch_*.py``) for
its side effect: under pytest-xdist, where every worker is a process of
its own, torch's intra-op threads are capped at the cores over the
workers, so that the workers' loops of small torch ops do not spin for
each other's cores (beside five busy eight-thread workers, the closed
loop's fixture took as long on eight threads as on one, three times its
time alone).  Every worker collects every module before it runs a test,
so the cap holds for module-scoped fixtures too.  Outside xdist it does
nothing."""

import os

import torch

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                              // int(_WORKERS)))
