"""On-device prioritized replay (``dcarl_tpu/models/replay.py``).

Fixed preallocated tensors, ring writes, and prioritized sampling by
per-draw Gumbel argmax: each of the batch's ``argmax(log p + g)`` rows
is one exact draw (with replacement) from the ``prio^alpha / sum``
categorical that the reference's segment tree implements
(replay_buffer.py:5-71).  The Gumbel noise is an input, so a caller can
feed both packages the same draws; :func:`gumbel_noise` makes it from a
``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dcarl_tpu_torch.device import resolve_device


class Replay(NamedTuple):
    obs: torch.Tensor       # [N, D]
    action: torch.Tensor    # [N] i32
    reward: torch.Tensor    # [N]
    next_obs: torch.Tensor  # [N, D]
    done: torch.Tensor      # [N]
    priority: torch.Tensor  # [N] (>= 0; 0 for empty slots)
    size: torch.Tensor      # [] i32
    head: torch.Tensor      # [] i32


def replay_init(capacity: int, obs_dim: int, dtype=torch.float32,
                device=None, action_shape: tuple = (),
                action_dtype=None) -> Replay:
    """Discrete by default (scalar i32 actions); ``action_shape=(A,)``
    for continuous-control buffers (the fork's DDPG/TD3/SAC ReplayBuffer
    stores float action vectors)."""
    device = resolve_device(device)
    if action_dtype is None:
        action_dtype = torch.int32 if tuple(action_shape) == () else dtype

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return Replay(obs=z(capacity, obs_dim),
                  action=z(capacity, *action_shape, dt=action_dtype),
                  reward=z(capacity), next_obs=z(capacity, obs_dim),
                  done=z(capacity), priority=z(capacity),
                  size=z(dt=torch.int32), head=z(dt=torch.int32))


def replay_push(replay: Replay, obs: torch.Tensor, action: torch.Tensor,
                reward: torch.Tensor, next_obs: torch.Tensor,
                done: torch.Tensor, mask: Optional[torch.Tensor] = None
                ) -> Replay:
    """Batched append with max-priority init for the new rows
    (NaivePrioritizedBuffer.push:13-27).  Row i lands at slot ``head +
    (its position among the masked rows)`` mod capacity, which for an
    unmasked push is ``(head + i) % capacity``: the same slots as the JAX
    package's contiguous block write and its scatter."""
    capacity = replay.obs.shape[0]
    batch = obs.shape[0]
    dev = obs.device
    if batch > capacity:
        raise ValueError(f"push of {batch} rows into a capacity-{capacity} "
                         "replay")
    max_prio = torch.clamp(replay.priority.max(), min=1.0)
    if mask is None:
        slots = (replay.head + torch.arange(batch, device=dev)) % capacity
        n_new = batch
    else:
        m = mask.to(torch.int64)
        slots = torch.where(mask, (replay.head + torch.cumsum(m, 0) - m)
                            % capacity, capacity)
        n_new = m.sum()
    fields = dict(obs=obs, action=action, reward=reward, next_obs=next_obs,
                  done=done, priority=max_prio.expand(batch))
    new = {}
    for name, rows in fields.items():
        buf = getattr(replay, name)
        if mask is None:
            new[name] = buf.index_copy(0, slots, rows.to(buf.dtype))
        else:  # masked-out rows land in a spare dump row that is cut off
            ext = torch.cat([buf, buf[:1]])
            new[name] = ext.index_copy_(0, slots, rows.to(buf.dtype))[:-1]
    return Replay(**new,
                  size=torch.clamp(replay.size + n_new, max=capacity
                                   ).to(torch.int32),
                  head=((replay.head + n_new) % capacity).to(torch.int32))


class Batch(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    next_obs: torch.Tensor
    done: torch.Tensor
    indices: torch.Tensor
    weights: torch.Tensor  # importance-sampling weights (max-normalized)


def gumbel_noise(shape, generator: torch.Generator, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(U))``, U uniform on
    (tiny, 1) as ``jax.random.gumbel`` draws it, on ``generator``'s
    device unless ``device`` says otherwise."""
    if device is None:
        device = generator.device
    tiny = torch.finfo(dtype).tiny
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def replay_sample(replay: Replay, gumbel: torch.Tensor, alpha: float = 0.6,
                  beta=0.4) -> Batch:
    """Prioritized sample of ``gumbel.shape[0]`` rows
    (NaivePrioritizedBuffer.sample:29-56): p_i = prio_i^alpha / sum, IS
    weights (N p_i)^-beta normalized by their max.  ``gumbel`` is
    [batch, capacity] standard Gumbel noise."""
    capacity = replay.obs.shape[0]
    occupied = torch.arange(capacity, device=gumbel.device) < replay.size
    logits = alpha * torch.log(torch.clamp(replay.priority, min=1e-12))
    logits = torch.where(occupied, logits, -torch.inf)
    indices = torch.argmax(logits[None, :] + gumbel, dim=1)

    probs = torch.softmax(logits, dim=0)
    n = torch.clamp(replay.size.to(probs.dtype), min=1.0)
    w = (n * torch.clamp(probs[indices], min=1e-12)) ** (-beta)
    weights = w / w.max()
    return Batch(obs=replay.obs[indices], action=replay.action[indices],
                 reward=replay.reward[indices],
                 next_obs=replay.next_obs[indices],
                 done=replay.done[indices], indices=indices,
                 weights=weights.to(replay.obs.dtype))


def replay_take(replay: Replay, indices: torch.Tensor) -> Batch:
    """The rows at ``indices`` with unit weights: a uniform sample whose
    indices were drawn outside.  Where every stored priority is equal
    (every push at the running maximum, none updated, as in the
    off-policy learners of ``algos/``) it has the distribution of
    :func:`replay_sample`."""
    return Batch(obs=replay.obs[indices], action=replay.action[indices],
                 reward=replay.reward[indices],
                 next_obs=replay.next_obs[indices],
                 done=replay.done[indices], indices=indices,
                 weights=torch.ones(indices.shape, dtype=replay.obs.dtype,
                                    device=indices.device))


def replay_update_priorities(replay: Replay, indices: torch.Tensor,
                             priorities: torch.Tensor) -> Replay:
    """update_priorities (:68-71).  A row drawn twice in one batch gets
    the same priority from both draws (same transition, same TD error),
    so the order of the duplicate writes does not matter."""
    return replay._replace(priority=replay.priority.index_put(
        (indices,), priorities.to(replay.priority.dtype)))
