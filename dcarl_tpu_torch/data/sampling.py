"""Distribution-based dataset generation (``dcarl_tpu/data/sampling.py``).

The generative process of the reference's
``Data_Sampling/data_sampling.py``:

* ``state_num`` states with scalar descriptors ~ U(0, 1)          (:41)
* per-state true action values ~ U(min_value, max_value)          (:43-44)
* state visitation ~ floor(N(3, 1) / 6 * state_num)               (:12-17)
* uniform random actions, observed value ~ N(true, noise_scale)   (:5-9, :49-55)

drawn from a ``torch.Generator`` on its device.  Out-of-range state
draws are kept, clipped, with a validity mask (fixed shapes); consumers
filter by ``valid``.  Neither the reference's scipy stream nor JAX's
threefry stream is reproduced bit for bit: the two packages agree in
distribution.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SampledDataset(NamedTuple):
    data: torch.Tensor           # [N, 4] rows [state_idx, state_scalar, action, value]
    valid: torch.Tensor          # [N] bool: the state draw fell inside [0, state_num)
    action_values: torch.Tensor  # [S, A] ground truth
    states: torch.Tensor         # [S] state descriptors


def generate(generator: torch.Generator, state_num: int = 20,
             action_num: int = 11, size: int = 50000,
             min_value: float = -50.0, max_value: float = 100.0,
             noise_scale: float = 50.0) -> SampledDataset:
    """A float32 dataset on the generator's device."""
    dev = generator.device

    def uniform(shape):
        return torch.rand(shape, generator=generator, device=dev)

    states = uniform((state_num,))
    action_values = min_value + uniform((state_num, action_num)) \
        * (max_value - min_value)
    raw = torch.randn((size,), generator=generator, device=dev) + 3.0
    idx = torch.floor(raw / 6.0 * state_num).to(torch.int64)
    valid = (idx >= 0) & (idx < state_num)
    idx_c = torch.clamp(idx, 0, state_num - 1)
    act = torch.randint(0, action_num, (size,), generator=generator, device=dev)
    value = action_values[idx_c, act] + noise_scale * torch.randn(
        (size,), generator=generator, device=dev)
    data = torch.stack([idx_c.to(torch.float32), states[idx_c],
                        act.to(torch.float32), value], dim=1)
    return SampledDataset(data=data, valid=valid,
                          action_values=action_values, states=states)


def generate_state_indices_manual(generator: torch.Generator, state_num: int,
                                  size: int, rare_prob: float = 0.1
                                  ) -> torch.Tensor:
    """``random_state_manual`` (data_sampling.py:19-27): state 0 with
    probability ``rare_prob``, else uniform over [1, state_num).  i32."""
    dev = generator.device
    rare = torch.rand((size,), generator=generator, device=dev) <= rare_prob
    uni = torch.randint(1, state_num, (size,), generator=generator, device=dev)
    return torch.where(rare, 0, uni).to(torch.int32)
