"""The confidence store sharded over ranks
(``dcarl_tpu/parallel/sharded_store.py``).

Rows stripe over the ranks (each rank holds an independent local
:class:`~dcarl_tpu_torch.core.store.ConfidenceStore`); a box query gives
every rank the same queries, each rank takes its partial (count, sum v,
sum v^2) moments against its own rows, and one ``psum`` combines them:
the moments are additive, so the union of the shards answers as the one
store would.  Inserts go to each rank's own shard with no traffic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dcarl_tpu_torch.core.store import (ConfidenceStore, QueryStats,
                                        _raw_moments, moments_to_stats,
                                        store_init, store_insert, store_valid)
from dcarl_tpu_torch.parallel.collectives import psum
from dcarl_tpu_torch.parallel.mesh import ProcessMesh


class ShardedStore(NamedTuple):
    """This rank's shard of a store striped over ``mesh``."""

    local: ConfidenceStore
    mesh: ProcessMesh

    @property
    def num_shards(self) -> int:
        return self.mesh.size


def sharded_store_init(mesh: ProcessMesh, capacity_total: int, key_dim: int,
                       dtype=torch.float32) -> ShardedStore:
    """An empty store of ``capacity_total`` rows, ceil(capacity / S) on
    each of the S ranks, on the mesh's device."""
    n_local = -(-capacity_total // mesh.size)
    return ShardedStore(store_init(n_local, key_dim, dtype, mesh.device), mesh)


def stripe(x: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """This rank's rows of a batch striped over the mesh: rank i takes
    rows i, i + S, i + 2S, ... of the batch zero-padded to a multiple of
    S (the JAX package's striping; padded rows carry mask False)."""
    s = mesh.size
    pad = -x.shape[0] % s
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
    return x[mesh.rank::s]


def sharded_insert(store: ShardedStore, keys: torch.Tensor,
                   actions: torch.Tensor, values: torch.Tensor,
                   mask: torch.Tensor, policy: str = "ring") -> ShardedStore:
    """Append a record batch that every rank holds whole ([M, D], [M],
    [M], [M] bool), striped over the shards; each shard applies
    ``policy`` (``core.store.store_insert``) to its own capacity.
    Records where ``mask`` is False are dropped."""
    m = store.mesh
    dev = m.device
    local = store_insert(store.local, stripe(keys.to(dev), m),
                         stripe(actions.to(dev), m),
                         stripe(values.to(dev), m),
                         stripe(mask.to(dev), m), policy=policy)
    return ShardedStore(local, m)


def sharded_query_stats(store: ShardedStore, queries: torch.Tensor,
                        half_widths: torch.Tensor) -> QueryStats:
    """Box-query statistics over the union of the shards: this rank's
    partial moments, then one ``psum`` (every rank passes the same
    queries and gets the same statistics)."""
    local = store.local
    part = _raw_moments(local.keys, local.values, store_valid(local),
                        queries.to(store.mesh.device),
                        half_widths.to(store.mesh.device))
    return moments_to_stats(psum(part, store.mesh))
