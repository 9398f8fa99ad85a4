"""The port's counterparts of ``lax.all_gather(tiled=True)``,
``lax.psum_scatter(tiled=True)``, ``lax.psum`` and ``lax.pmean`` over a
:class:`~dcarl_tpu_torch.parallel.mesh.ProcessMesh`.

* A mesh of one rank issues no collective: each function returns its
  input (``pmean`` divides by 1, which changes no bit).
* The backend sets where the data lies, once, by rule:
  - an NCCL group works on the rank's card (``all_gather_into_tensor``,
    ``reduce_scatter_tensor``, ``all_reduce``, ``broadcast``); a host
    tensor (an optimizer's step counter) is copied there and back;
  - a gloo group works on host tensors: a CUDA tensor is copied to the
    host, reduced there, and copied back to its device.  Gloo's
    ``all_gather`` (a list of blocks) and ``all_reduce`` are what every
    gloo build has; its ``psum_scatter`` is the ``all_reduce`` followed
    by this rank's block, the same sums.
* A failed collective raises: nothing here retries it another way.

Every rank receives the same bits from an ``all_reduce``, so replicated
values (parameters, reduced statistics) stay equal across ranks.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch
import torch.distributed as dist

if TYPE_CHECKING:
    from dcarl_tpu_torch.parallel.mesh import ProcessMesh


def _staged(x: torch.Tensor, mesh: "ProcessMesh") -> torch.Tensor:
    """A contiguous copy of ``x`` that the collective may overwrite: on
    the rank's card for NCCL (which takes only CUDA tensors), on the host
    for gloo."""
    where = mesh.device if mesh.backend == "nccl" else torch.device("cpu")
    return x.detach().to(where, copy=True).contiguous()


def all_gather(x: torch.Tensor, mesh: "ProcessMesh") -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0, in rank order
    (``lax.all_gather(x, axis, axis=0, tiled=True)``)."""
    if mesh.size == 1:
        return x
    h = _staged(x, mesh)
    if mesh.backend == "nccl":
        out = torch.empty((mesh.size * h.shape[0],) + h.shape[1:],
                          dtype=h.dtype, device=h.device)
        dist.all_gather_into_tensor(out, h, group=mesh.group)
        return out.to(x.device)
    parts = [torch.empty_like(h) for _ in range(mesh.size)]
    dist.all_gather(parts, h, group=mesh.group)
    return torch.cat(parts).to(x.device)


def reduce_scatter(x: torch.Tensor, mesh: "ProcessMesh") -> torch.Tensor:
    """The sum of every rank's ``x``, this rank's block of dim 0
    (``lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)``).
    Dim 0 must divide by the mesh size, as JAX requires."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"reduce_scatter: dim 0 ({x.shape[0]}) does not "
                         f"divide by the mesh size {mesh.size}")
    if mesh.size == 1:
        return x
    k = x.shape[0] // mesh.size
    h = _staged(x, mesh)
    if mesh.backend == "nccl":
        out = torch.empty((k,) + h.shape[1:], dtype=h.dtype, device=h.device)
        dist.reduce_scatter_tensor(out, h, op=dist.ReduceOp.SUM,
                                   group=mesh.group)
        return out.to(x.device)
    dist.all_reduce(h, op=dist.ReduceOp.SUM, group=mesh.group)
    return h[mesh.rank * k:(mesh.rank + 1) * k].to(x.device)


def psum(x: torch.Tensor, mesh: "ProcessMesh") -> torch.Tensor:
    """The sum of every rank's ``x`` on every rank (``lax.psum``)."""
    if mesh.size == 1:
        return x
    h = _staged(x, mesh)
    dist.all_reduce(h, op=dist.ReduceOp.SUM, group=mesh.group)
    return h.to(x.device)


def pmean(x: torch.Tensor, mesh: "ProcessMesh") -> torch.Tensor:
    """The mean of every rank's ``x`` on every rank (``lax.pmean``): the
    sum divided by the mesh size."""
    if mesh.size == 1:
        return x
    return psum(x, mesh) / mesh.size


def broadcast(x: torch.Tensor, mesh: "ProcessMesh", src: int = 0
              ) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank."""
    if mesh.size == 1:
        return x
    h = _staged(x, mesh)
    dist.broadcast(h, src=dist.get_global_rank(mesh.group, src),
                   group=mesh.group)
    return h.to(x.device)


def broadcast_object(obj, mesh: "ProcessMesh", src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank (for trees whose
    shape only ``src`` knows, such as a restored optimizer state)."""
    if mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(
        box, src=dist.get_global_rank(mesh.group, src), group=mesh.group,
        device=mesh.device if mesh.backend == "nccl" else None)
    return box[0]
