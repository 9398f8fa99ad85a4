"""The process mesh (``dcarl_tpu/parallel/mesh.py``).

JAX lays one program over a ``Mesh`` of devices; the port runs one
process a device, and a :class:`ProcessMesh` is this process's view of
the 1-D env axis: its rank, the number of ranks, its device and the
``torch.distributed`` group the collectives of ``collectives.py`` run
over.  Env batches and the confidence store shard over the ranks;
statistics and gradients combine with one collective each.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from dcarl_tpu_torch.device import resolve_device
from dcarl_tpu_torch.parallel.collectives import broadcast


class ProcessMesh(NamedTuple):
    """This rank's place on the env axis.  ``group`` None: a single rank,
    and every collective is the identity (none is issued)."""

    group: Optional[Any]      # torch.distributed ProcessGroup
    rank: int
    size: int
    device: torch.device
    backend: Optional[str]    # "nccl", "gloo" or None (a single rank)
    axis_name: str = "env"


def make_mesh(axis_name: str = "env", group=None,
              device: "str | torch.device | None" = None) -> ProcessMesh:
    """A 1-D mesh over the ranks of ``group`` (None: this process alone).
    ``device=None`` takes ``cuda`` (the current CUDA device, which must
    exist), as every entry point of the port does."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if group is None:
        return ProcessMesh(None, 0, 1, dev, None, axis_name)
    backend = str(dist.get_backend(group))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL group needs a CUDA device, got {dev}")
    return ProcessMesh(group, dist.get_rank(group),
                       dist.get_world_size(group), dev, backend, axis_name)


def tree_map(fn, x, *rest):
    """``fn`` over every tensor of a tensor, NamedTuple, tuple, list or
    dict (other leaves unchanged), and over the matching leaves of
    ``rest``, trees of the same structure."""
    if isinstance(x, torch.Tensor):
        return fn(x, *rest)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(tree_map(fn, *vs) for vs in zip(x, *rest)))
    if isinstance(x, (tuple, list)):
        return type(x)(tree_map(fn, *vs) for vs in zip(x, *rest))
    if isinstance(x, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in x.items()}
    return x


def shard_leading(x, mesh: ProcessMesh):
    """This rank's block of the leading axis of a tensor (or of every
    tensor of a tree), on the mesh's device.  The axis must divide by the
    mesh size, as JAX's sharding requires."""
    def take(t):
        n = t.shape[0]
        if n % mesh.size:
            raise ValueError(f"leading axis {n} does not divide by the "
                             f"mesh size {mesh.size}")
        k = n // mesh.size
        return t[mesh.rank * k:(mesh.rank + 1) * k].to(mesh.device)
    return tree_map(take, x)


def replicate(x, mesh: ProcessMesh):
    """A tensor (or every tensor of a tree) on every rank as rank 0 holds
    it, on the mesh's device."""
    return tree_map(lambda t: broadcast(t.to(mesh.device), mesh), x)
