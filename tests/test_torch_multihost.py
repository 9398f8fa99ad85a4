"""PyTorch port: starting ranks from the ``DCARL_*`` environment
(``parallel/distributed.py``), as ``tests/test_multihost.py`` starts the
JAX package's processes.

* one process with ``DCARL_NUM_PROCESSES=1``: the group, the mesh and
  the integrated trainer stepping over it;
* two OS processes with ``DCARL_NUM_PROCESSES=2`` at a ``tcp://``
  rendezvous: a ``psum`` of 1 and 2 gives 3 on both ranks, and the
  (hosts, devices) mesh is 1 x 2;
* the mesh builders without a group;
* ``n_devices`` must be the mesh's size in ``session.py`` and
  ``improvement.py``;
* a two-rank ``TrainSession``: rank 0 writes the checkpoint in the JAX
  layout (leading axis 2), a fresh session resumes from it, and the
  resumed run equals the uninterrupted one bit for bit.

The workers are fresh interpreters on gloo (the CPU); each run has a
time limit, and a worker that imports JAX fails."""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu_torch import config as tcfg
from dcarl_tpu_torch import improvement as timp
from dcarl_tpu_torch.parallel import distributed as D
from dcarl_tpu_torch.parallel.launch import run_ranks
from dcarl_tpu_torch.parallel.mesh import ProcessMesh
from dcarl_tpu_torch.session import TrainSession, check_devices

import torch_rank_programs as RP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = """
import json, sys
import torch
from dcarl_tpu_torch.parallel import collectives as coll
from dcarl_tpu_torch.parallel import distributed as D
torch.set_num_threads(1)
n = D.initialize_from_env(device="cpu")
mesh = D.host_device_mesh(device="cpu")
total = coll.psum(torch.tensor([float(mesh.rank + 1)]), mesh)
m2 = D.host_device_mesh_2d(device="cpu")
rec = dict(world=n, rank=mesh.rank, size=mesh.size, backend=mesh.backend,
           psum=float(total[0]), hosts=m2.host.size, devices=m2.device.size)
if {train}:
    from dcarl_tpu_torch import config as tcfg
    from dcarl_tpu_torch.train_fast import make_trainer_fast
    cfg = tcfg.DCARLConfig(dqn=tcfg.DQNConfig(batch_size=4,
                                               replay_capacity=64))
    init, step, _, _ = make_trainer_fast(
        cfg, batch_per_device=4, store_capacity_per_device=64,
        replay_capacity_per_device=64, use_kernel=False, mesh=mesh)
    state, gen = init(0), torch.Generator().manual_seed(1)
    for _ in range(2):
        state, m = step(state, gen)
    rec["loss"] = float(m.loss)
    rec["frame"] = int(state.frame)
assert not [k for k in sys.modules if k.split(".")[0] in ("jax", "dcarl_tpu")]
print("RESULT " + json.dumps(rec), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_workers(n: int, train: bool):
    env = dict(os.environ)
    env.update({"DCARL_NUM_PROCESSES": str(n),
                "DCARL_COORDINATOR": f"localhost:{_free_port()}",
                "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    procs = []
    for rank in range(n):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER.format(train=train)],
            env=dict(env, DCARL_PROCESS_ID=str(rank)), cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    recs = []
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, out
        recs.append(json.loads(line[0][len("RESULT "):]))
    return recs


def test_multihost_smoke_one_process():
    rec, = _run_workers(1, train=True)
    assert rec["world"] == 1 and rec["size"] == 1 and rec["rank"] == 0
    assert rec["backend"] == "gloo" and rec["psum"] == 1.0
    assert rec["frame"] == 2 and rec["loss"] == rec["loss"]  # finite


def test_two_process_collective():
    """A real world size of 2: two OS processes join at a ``tcp://``
    rendezvous, and a psum over the ranks gives 1 + 2 = 3 on both."""
    recs = _run_workers(2, train=False)
    assert sorted(r["rank"] for r in recs) == [0, 1]
    for r in recs:
        assert r["world"] == 2 and r["size"] == 2 and r["psum"] == 3.0
        assert (r["hosts"], r["devices"]) == (1, 2)


def test_host_device_mesh_shapes():
    """Without a group: one rank, a 1 x 1 (hosts, devices) mesh."""
    m1 = D.host_device_mesh(device="cpu")
    assert (m1.size, m1.rank, m1.group) == (1, 0, None)
    m2 = D.host_device_mesh_2d(device="cpu")
    assert m2.host.size * m2.device.size == 1
    assert D.backend_for(torch.device("cpu")) == "gloo"


def test_n_devices_must_match_the_mesh(tmp_path):
    two = ProcessMesh(None, 0, 2, torch.device("cpu"), "gloo")
    check_devices(2, two)
    check_devices(1, None)
    cfg = tcfg.DCARLConfig(dqn=tcfg.DQNConfig(batch_size=4,
                                              replay_capacity=64))
    with pytest.raises(ValueError, match="mesh has 2 rank"):
        timp.train_store(cfg, n_devices=1, device="cpu", mesh=two)
    with pytest.raises(ValueError, match="mesh has 1 rank"):
        TrainSession(str(tmp_path), cfg, n_devices=2, device="cpu")
    with pytest.raises(ValueError, match="mesh has 2 rank"):
        TrainSession(str(tmp_path), cfg, n_devices=1, mesh=two,
                     device="cpu")


def test_two_rank_session_resumes_bit_equal(tmp_path):
    p = {"dir": str(tmp_path / "s"), "dir_ref": str(tmp_path / "ref")}
    outs = run_ranks(RP.session_checks, 2, "gloo", "cpu", timeout_s=60,
                     args=(p,))
    for o in outs:
        assert o["resumed_step"] == 3
        assert o["bit_equal"] and o["learner_equal"]
        assert o["history_rows"] == outs[0]["history_rows"]
    ckpt = torch.load(os.path.join(p["dir"], "ckpt", f"step_{3:010d}"),
                      weights_only=True)
    assert ckpt["state.store_keys"].shape[0] == 2
    assert ckpt["state.env.ego"].shape[0] == 2
