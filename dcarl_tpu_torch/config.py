"""Configuration of the PyTorch port: the store, lattice, env and
learner constants its drivers and trainer read.

A copy, not an import, of the matching dataclasses in the JAX package
(``dcarl_tpu/config.py``): the port stays free of that package.  Field
names, defaults and derived properties are identical, so a config built
for one package reads the same in the other; ``tests/test_torch_env.py``
holds the two copies equal.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ConfidenceConfig:
    """Hoeffding-style confidence-bound constants of the reference demos
    (Simulation_1/test_DCARL.py:10-28): value support [loc, loc+scale],
    level alpha, bound cap and the data-count gate."""

    alpha: float = 0.05
    loc: float = -50.0
    scale: float = 150.0
    value_max: float = 100.0
    n_thres: int = 10
    rule_action: int = 0
    rule_prior: float = 100.0   # optimistic init for the rule action
    other_prior: float = -50.0  # pessimistic init for other actions


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    """Continuous-state confidence store and its gate constants (the
    reference's R-tree half-widths and RLS thresholds, deepq/RLS.py)."""

    capacity: int = 1 << 17
    key_dim: int = 21  # 20-D obs + 1-D action
    visited_times_thres: int = 30
    rl_visited_times_min: int = 5
    confidence_thres: float = 0.5
    gamma: float = 0.95
    n_step_window: int = 10
    trajectory_buffer_len: int = 20
    rule_good_thres: float = -0.1
    num_candidate_actions: int = 8  # action 0 = rule, 1..7 candidates
    # Train-mode explore draw U(explore_low, explore_high); the
    # reference's U(-1, 0) matches its [-1, 0] per-step rewards.
    explore_low: float = -1.0
    explore_high: float = 0.0
    # Per-dimension box half-widths (obs dims, then the action dim).
    # None selects core/store.py FIELD_HALF_WIDTHS.
    half_widths: "Tuple[float, ...] | None" = None
    # Recorded-value semantics: "reference", "nstep" or "episode".
    value_mode: str = "reference"
    # Among passing candidates: "first" = lowest index (the reference's
    # ascending loop), "best" = highest z.
    select_mode: str = "first"


# Box half-widths for the driving env's 20-D world-frame observation
# [ego x, y, vx, vy, yaw] + 3 objects x [x, y, vx, vy, yaw] + action:
# ~2 m position, ~2 m/s velocity, object heading ignored, exact action.
DRIVING_HALF_WIDTHS = (
    1.0, 2.0, 2.0, 2.0, 0.3,
    2.0, 2.0, 2.0, 2.0, 10.0,
    2.0, 2.0, 2.0, 2.0, 10.0,
    2.0, 2.0, 2.0, 2.0, 10.0,
    0.1,
)


def driving_store_config(**overrides) -> StoreConfig:
    """StoreConfig matched to the driving env's reward scale
    (``sqrt(v) * 0.1`` per step, support ~[0, 0.38] at the speed cap)."""
    base = dict(
        explore_low=0.0,
        explore_high=0.38,
        rule_good_thres=0.34,
        visited_times_thres=10,
        rl_visited_times_min=5,
        half_widths=DRIVING_HALF_WIDTHS,
    )
    base.update(overrides)
    if base.get("value_mode") in ("nstep", "episode"):
        # n-step values are discounted window sums: scale the per-step
        # gate constants by the window's discount mass sum_{i<W} gamma^i
        # (only where the caller did not override them).
        w = base.get("n_step_window", StoreConfig.n_step_window)
        g = base.get("gamma", StoreConfig.gamma)
        m = float(w) if g >= 1.0 else (1.0 - g ** w) / (1.0 - g)
        if "explore_high" not in overrides:
            base["explore_high"] = 0.38 * m
        if "rule_good_thres" not in overrides:
            base["rule_good_thres"] = 0.34 * m
    return StoreConfig(**base)


@dataclasses.dataclass(frozen=True)
class WerlingConfig:
    """Frenet-lattice sampler constants
    (JunctionTrajectoryPlanner.py:14-40): a [n_d, n_T, n_v] grid of
    (quintic lateral, quartic longitudinal) polynomial pairs."""

    max_speed: float = 50.0 / 3.6
    max_accel: float = 10.0
    max_curvature: float = 500.0
    min_lateral: float = -4.0
    max_lateral: float = 4.0
    d_road_w: float = 2.0
    dt: float = 0.3
    min_t: float = 4.0
    max_t: float = 4.2
    target_speed: float = 30.0 / 3.6
    d_t_s: float = 15.0 / 3.6
    n_s_sample: int = 1
    obstacles_considered: int = 4
    robot_radius: float = 1.0
    move_gap: float = 1.0
    # cost weights
    kj: float = 0.1
    kt: float = 0.1
    kd: float = 1.0
    klat: float = 1.0
    klon: float = 1.0

    @property
    def d_offsets(self) -> Tuple[float, ...]:
        out, d = [], self.min_lateral
        while d < self.max_lateral + 1.0 - 1e-9:
            out.append(d)
            d += self.d_road_w
        return tuple(out)

    @property
    def horizons(self) -> Tuple[float, ...]:
        out, t = [], self.min_t
        while t < self.max_t - 1e-9:
            out.append(t)
            t += self.dt
        return tuple(out)

    @property
    def target_speeds(self) -> Tuple[float, ...]:
        lo = self.target_speed - self.d_t_s * self.n_s_sample
        hi = self.target_speed + self.d_t_s * self.n_s_sample
        out, v = [], lo
        while v < hi - 1e-9:
            out.append(v)
            v += self.d_t_s
        return tuple(out)

    @property
    def n_time_steps(self) -> int:
        # time grid arange(0, T, dt) of the shortest horizon
        return int(self.min_t / self.dt + 1e-9)

    @property
    def num_paths(self) -> int:
        return len(self.d_offsets) * len(self.horizons) * len(self.target_speeds)


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """T-intersection scenario (TestScenario_Town03.py:70-141 semantics
    on a kinematic model)."""

    dt: float = 0.05
    num_objects: int = 3          # objects exposed in the 20-D state
    num_vehicles: int = 6         # scripted traffic
    state_dim: int = 20
    action_dim: int = 11
    collision_radius: float = 1.0
    pedestrian_speed: float = 0.9
    stuck_speed: float = 0.1
    stuck_time: float = 2.0
    pass_line_y: float = 73.7
    reward_collision: float = -100.0
    reward_stuck: float = 0.0
    # per-step reward = speed_reward_scale * sqrt(v)
    speed_reward_scale: float = 0.1
    # bonus on the pass-line crossing step
    reward_pass: float = 0.0
    max_episode_steps: int = 400
    reset_jitter: float = 0.1     # spawn-pose jitter half-range [m]
    # end the episode as a collision when the ego strays this far from
    # the reference path; 0 disables
    offroute_dist: float = 0.0
    ego_start: Tuple[float, float, float] = (242.0, 110.0, -1.5707963267948966)
    target_speed: float = 30.0 / 3.6
    wheelbase: float = 3.15
    max_steer: float = 1.0
    max_accel: float = 5.0
    max_brake: float = 8.0


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    """Learner hyper-parameters (drl_library/dqn/dqn.py:253-271):
    epsilon 0.9 -> 0.1 over 1e6 frames, beta 0.4 -> 1.0 over 1e3,
    prioritized replay alpha 0.6."""

    gamma: float = 0.95
    lr: float = 1e-3
    batch_size: int = 32
    replay_capacity: int = 1 << 20
    priority_alpha: float = 0.6
    beta_start: float = 0.4
    beta_frames: int = 1000
    epsilon_start: float = 0.9
    epsilon_final: float = 0.1
    epsilon_decay: float = 1_000_000.0
    target_update_every: int = 10_000
    no_data_punishment: float = -10.0
    ucb_c: float = 5.0
    hidden_dim: int = 128
    attention_width: int = 3
    token_dim: int = 5


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Axis names of a multi-device layout: envs shard over 'env', the
    confidence dataset over 'store'."""

    env_axis: str = "env"
    store_axis: str = "store"


@dataclasses.dataclass(frozen=True)
class DCARLConfig:
    confidence: ConfidenceConfig = ConfidenceConfig()
    store: StoreConfig = StoreConfig()
    werling: WerlingConfig = WerlingConfig()
    env: EnvConfig = EnvConfig()
    dqn: DQNConfig = DQNConfig()
    mesh: MeshConfig = MeshConfig()


DEFAULT = DCARLConfig()
