"""Ranks, gradient averaging and the data-parallel update
(``dcarl_tpu/parallel/distributed.py``).

The reference's ``MpiAdam`` flattens the gradients, sums them with one
``MPI.Allreduce`` and applies Adam on every rank
(common/mpi_adam.py:8-121); JAX's step does ``lax.pmean`` of the
gradient tree.  The port keeps that one collective in sight:
:func:`pmean_gradients` is one ``all_reduce`` over one flat bucket of
every gradient, divided by the world size, and every rank then applies
the same optimizer step to the same bits, so replicated parameters stay
equal across ranks.  (``DistributedDataParallel`` is not used: its
hooks bucket and overlap the reduction out of the step's sight.)

Environment contract of :func:`initialize_from_env` (the JAX package's):

* ``DCARL_NUM_PROCESSES`` world size (set it to opt in);
* ``DCARL_PROCESS_ID``    this process's rank (default 0);
* ``DCARL_COORDINATOR``   ``host:port`` of rank 0 (default
  ``localhost:8476``, valid for ranks on one host only).

Each rank is one process on one device: NCCL on CUDA devices, gloo on
the CPU, chosen from the device and never swapped for the other.
"""

from __future__ import annotations

import datetime
import os
from typing import Callable, NamedTuple, Sequence

import torch
import torch.distributed as dist

from dcarl_tpu_torch.device import resolve_device
from dcarl_tpu_torch.parallel.collectives import pmean
from dcarl_tpu_torch.parallel.mesh import ProcessMesh, make_mesh

# How long a rank waits at the rendezvous and in a collective.
TIMEOUT = datetime.timedelta(seconds=300)


def backend_for(device: torch.device) -> str:
    """NCCL for a CUDA device (which must be available), gloo for the
    CPU."""
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this torch build has no NCCL: the ranks of a "
                               "CUDA run cannot reduce on the card")
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device {device}")


def local_device(rank: int, device: "str | torch.device | None" = None
                 ) -> torch.device:
    """The device of ``rank``: ``cuda:{rank mod the host's cards}`` for a
    CUDA run (ranks fill a host's cards in order), the CPU as asked."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def initialize_from_env(require: bool = False,
                        device: "str | torch.device | None" = None) -> int:
    """Join the process group that ``DCARL_NUM_PROCESSES``,
    ``DCARL_PROCESS_ID`` and ``DCARL_COORDINATOR`` describe (a ``tcp://``
    rendezvous at the coordinator); returns the world size.  Without
    ``DCARL_NUM_PROCESSES`` this process stays alone (world size 1), or
    raises when ``require``.  Calling again after joining is a no-op."""
    if dist.is_initialized():
        return dist.get_world_size()
    n = int(os.environ.get("DCARL_NUM_PROCESSES", "0"))
    if n <= 0:
        if require:
            raise RuntimeError("DCARL_NUM_PROCESSES is not set: no process "
                               "group to join")
        return 1
    rank = int(os.environ.get("DCARL_PROCESS_ID", "0"))
    coord = os.environ.get("DCARL_COORDINATOR", "localhost:8476")
    dev = local_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method=f"tcp://{coord}",
                            world_size=n, rank=rank, timeout=TIMEOUT)
    return n


def host_device_mesh(env_axis: str = "env",
                     device: "str | torch.device | None" = None
                     ) -> ProcessMesh:
    """The 1-D env mesh over every rank of the joined group, in rank
    order (host-major when each host's ranks are consecutive); a single
    rank when no group was joined."""
    if not dist.is_initialized():
        return make_mesh(env_axis, None, device)
    return make_mesh(env_axis, dist.group.WORLD,
                     local_device(dist.get_rank(), device))


class Mesh2D(NamedTuple):
    """A (hosts, devices a host) layout: ``device`` is this rank's group
    of ranks on its host, ``host`` its group of ranks with the same
    place on every host."""

    host: ProcessMesh
    device: ProcessMesh


def host_device_mesh_2d(host_axis: str = "host", device_axis: str = "device",
                        local_size: "int | None" = None,
                        device: "str | torch.device | None" = None
                        ) -> Mesh2D:
    """:class:`Mesh2D` over the joined group, ``local_size`` ranks a host
    (default: the host's CUDA cards on a CUDA run, every rank on the
    CPU), ranks host-major.  Reduce over ``device`` first (the fast
    links), then ``host``.  Every rank must call it (it makes groups)."""
    if not dist.is_initialized():
        return Mesh2D(make_mesh(host_axis, None, device),
                      make_mesh(device_axis, None, device))
    world, rank = dist.get_world_size(), dist.get_rank()
    dev = local_device(rank, device)
    if local_size is None:
        local_size = torch.cuda.device_count() if dev.type == "cuda" \
            else world
    if world % local_size:
        raise ValueError(f"world size {world} is not a whole number of "
                         f"hosts of {local_size} ranks")
    dev_group, _ = dist.new_subgroups_by_enumeration(
        [list(range(h * local_size, (h + 1) * local_size))
         for h in range(world // local_size)], timeout=TIMEOUT)
    host_group, _ = dist.new_subgroups_by_enumeration(
        [list(range(i, world, local_size)) for i in range(local_size)],
        timeout=TIMEOUT)
    return Mesh2D(make_mesh(host_axis, host_group, dev),
                  make_mesh(device_axis, dev_group, dev))


def pmean_gradients(grads: Sequence[torch.Tensor], mesh: ProcessMesh
                    ) -> Sequence[torch.Tensor]:
    """The MpiAdam ``Allreduce``: every gradient averaged over the mesh,
    in place, by one ``all_reduce`` of one flat bucket divided by the
    mesh size.  Returns ``grads``."""
    if mesh.size == 1 or not grads:
        return grads
    flat = pmean(torch.cat([g.reshape(-1) for g in grads]), mesh)
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return grads


def make_data_parallel_update(loss_fn: Callable, params: Sequence[torch.Tensor],
                              optimizer: torch.optim.Optimizer,
                              mesh: ProcessMesh):
    """A data-parallel step over ``mesh``: ``step(local_batch)`` takes
    this rank's block of the batch, differentiates ``loss_fn(local_batch)``
    with respect to ``params``, averages the gradients over the mesh
    (:func:`pmean_gradients`), applies ``optimizer`` and returns the loss
    averaged over the mesh.  Equal to one step on the whole batch when
    ``loss_fn`` is a mean over equal local blocks."""
    params = list(params)

    def step(local_batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(local_batch)
        loss.backward()
        pmean_gradients([p.grad for p in params], mesh)
        optimizer.step()
        return pmean(loss.detach(), mesh)

    return step


def tree_replicated_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (a replicated tree's
    global norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))

