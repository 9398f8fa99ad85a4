"""What the gated fleet and the trainer share: the port's configuration
objects built from a configuration file, and the trainer that fills a
store."""

from __future__ import annotations

import torch

from dcarl_bench import spec


def port_configs(cfg: dict):
    """The port's ``(EnvConfig, StoreConfig, DQNConfig)`` holding the
    configuration file's values."""
    from dcarl_tpu_torch.config import DQNConfig, EnvConfig, StoreConfig

    def tuples(d):
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in d.items()}

    return (EnvConfig(**tuples(cfg["env"])),
            StoreConfig(**tuples(cfg["store"])), DQNConfig(**cfg["dqn"]))


def make_trainer(cfg: dict, envs: int, store_rows: int, replay_rows: int,
                 backfill_budget: int, device: torch.device):
    """The port's integrated trainer (``make_trainer_fast``) on the
    T-intersection, through its store-query kernel on the card (its
    plain version on the CPU)."""
    from dcarl_tpu_torch.config import DCARLConfig
    from dcarl_tpu_torch.train_fast import make_trainer_fast

    env, store, dqn = port_configs(cfg)
    return make_trainer_fast(
        DCARLConfig(env=env, store=store, dqn=dqn), batch_per_device=envs,
        store_capacity_per_device=store_rows,
        replay_capacity_per_device=replay_rows, use_kernel=True,
        backfill_budget_per_step=backfill_budget, device=device)


def generator(device: torch.device, seed: int, purpose: str
              ) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        spec.torch_seed(seed, purpose))


def fill_store(cfg: dict, traffic: dict, device: torch.device):
    """The store a trained fleet deploys with: the port's trainer run
    from the fill's own seed (``traffic["fill"]``: seed, envs, steps,
    replay rows and backfill budget, the recipe of
    ``dcarl_tpu_torch/bench.py:157-195``: ``init_fn(seed)``, its steps'
    generator seeded ``seed + 1``) into a ring of
    ``traffic["store_rows"]`` rows.  The fill's seed is the traffic's,
    not the run's: the store's rows near the fleet set the query's work,
    which another training run changes many times over.  Returns (keys
    [N, 21], values [N], valid [N]); a row is valid below the store's
    size."""
    f = traffic["fill"]
    rows = int(traffic["store_rows"])
    init_fn, _, _, factory = make_trainer(cfg, f["envs"], rows,
                                          f["replay_rows"],
                                          f["backfill_budget"], device)
    state, _ = factory(int(f["steps"]))(
        init_fn(int(f["seed"])),
        torch.Generator(device=device).manual_seed(int(f["seed"]) + 1))
    keys = state.store_keys[0]
    values = state.store_values[0]
    valid = torch.arange(rows, device=device) < state.store_size[0]
    return keys, values, valid
