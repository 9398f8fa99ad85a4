"""Running observation / return normalisation, on one rank or over a
mesh (``dcarl_tpu/parallel/normalize.py``).

The SB fork's ``RunningMeanStd`` (the parallel-variance merge,
stable_baselines/common/running_mean_std.py:5-37) and ``VecNormalize``
(common/vec_env/vec_normalize.py); its MPI moments
(``mpi_moments``) become one ``psum`` of the local sums over the mesh,
so the statistics of a sharded batch are those of the whole batch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dcarl_tpu_torch.device import resolve_device
from dcarl_tpu_torch.parallel.collectives import psum
from dcarl_tpu_torch.parallel.mesh import ProcessMesh


class RunningMeanStd(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor  # scalar (float, starts at epsilon)


def rms_init(shape, epsilon: float = 1e-4, dtype=torch.float32,
             device=None) -> RunningMeanStd:
    device = resolve_device(device)
    return RunningMeanStd(
        mean=torch.zeros(shape, dtype=dtype, device=device),
        var=torch.ones(shape, dtype=dtype, device=device),
        count=torch.full((), epsilon, dtype=dtype, device=device))


def rms_update_from_moments(rms: RunningMeanStd, batch_mean, batch_var,
                            batch_count) -> RunningMeanStd:
    """Chan et al.'s parallel-variance merge (running_mean_std.py:21-37)."""
    like = rms.mean
    batch_mean = torch.as_tensor(batch_mean, dtype=like.dtype,
                                 device=like.device)
    batch_var = torch.as_tensor(batch_var, dtype=like.dtype,
                                device=like.device)
    batch_count = torch.as_tensor(batch_count, dtype=rms.count.dtype,
                                  device=like.device)
    delta = batch_mean - rms.mean
    tot = rms.count + batch_count
    new_mean = rms.mean + delta * batch_count / tot
    m_a = rms.var * rms.count
    m_b = batch_var * batch_count
    m2 = m_a + m_b + delta ** 2 * rms.count * batch_count / tot
    return RunningMeanStd(mean=new_mean, var=m2 / tot, count=tot)


def rms_update(rms: RunningMeanStd, batch: torch.Tensor) -> RunningMeanStd:
    """Update from a local [B, ...] batch (population variance)."""
    return rms_update_from_moments(
        rms, batch.mean(dim=0), batch.var(dim=0, unbiased=False),
        batch.shape[0])


def rms_update_distributed(rms: RunningMeanStd, local_batch: torch.Tensor,
                           mesh: ProcessMesh) -> RunningMeanStd:
    """Update from a batch sharded over ``mesh`` (this rank holds
    ``local_batch``): the sums, sums of squares and counts of every rank
    in one ``psum``, then the merge (mpi_moments.py:1-71)."""
    n_local = local_batch.shape[0]
    stacked = torch.stack([local_batch.sum(dim=0),
                           (local_batch ** 2).sum(dim=0),
                           torch.full_like(local_batch[0], float(n_local))])
    s, ss, n = psum(stacked, mesh)
    mean = s / n
    var = torch.clamp(ss / n - mean ** 2, min=0.0)
    return rms_update_from_moments(rms, mean, var, n.reshape(-1)[0])


class VecNormalizeState(NamedTuple):
    """VecNormalize: observation and discounted-return statistics."""

    obs_rms: RunningMeanStd
    ret_rms: RunningMeanStd
    returns: torch.Tensor  # [B] running discounted returns


def vec_normalize_init(obs_shape, batch: int, device=None
                       ) -> VecNormalizeState:
    device = resolve_device(device)
    return VecNormalizeState(
        obs_rms=rms_init(obs_shape, device=device),
        ret_rms=rms_init((), device=device),
        returns=torch.zeros((batch,), device=device))


def normalize_obs(state: VecNormalizeState, obs: torch.Tensor,
                  clip: float = 10.0, epsilon: float = 1e-8) -> torch.Tensor:
    return torch.clamp((obs - state.obs_rms.mean)
                       / torch.sqrt(state.obs_rms.var + epsilon), -clip, clip)


def normalize_reward(state: VecNormalizeState, reward: torch.Tensor,
                     clip: float = 10.0, epsilon: float = 1e-8
                     ) -> torch.Tensor:
    return torch.clamp(reward / torch.sqrt(state.ret_rms.var + epsilon),
                       -clip, clip)


def vec_normalize_update(state: VecNormalizeState, obs, reward, done,
                         gamma: float = 0.99) -> VecNormalizeState:
    """Track the observation and discounted-return statistics
    (vec_normalize.py step_wait: the returns restart where done)."""
    returns = state.returns * gamma + reward
    return VecNormalizeState(
        obs_rms=rms_update(state.obs_rms, obs),
        ret_rms=rms_update(state.ret_rms, returns),
        returns=torch.where(done, torch.zeros_like(returns), returns))
