"""HER: hindsight experience replay (``dcarl_tpu/algos/her.py``).

The fork's ``her/`` (163 LoC: HindsightExperienceReplayWrapper with the
'future' strategy, and the BitFlippingEnv test fixture,
common/bit_flipping_env.py).  Episodes are stored as fixed-length
``[episode, T, ...]`` tensors; relabeling draws a future achieved-goal
index per sampled transition.  Every random choice (the env's bits and
goals, the epsilon-greedy choice, the sample's episode, step, future
step and relabel coin) is a draw.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

import torch

from dcarl_tpu_torch.algos import common as C
from dcarl_tpu_torch.algos import nets
from dcarl_tpu_torch.device import resolve_device

# ---------------------------------------------------------------------------
# BitFlippingEnv fixture (common/bit_flipping_env.py)


class BitFlipState(NamedTuple):
    bits: torch.Tensor   # [B, n] {0,1} float
    goal: torch.Tensor   # [B, n]
    t: torch.Tensor      # [B] i32


class BitFlipDraws(NamedTuple):
    """A reset's Bernoulli(0.5) bits and goals, float {0, 1}."""

    bits: torch.Tensor   # [..., B, n]
    goal: torch.Tensor   # [..., B, n]


def bitflip_draws(shape, n_bits: int, generator: torch.Generator
                  ) -> BitFlipDraws:
    s = tuple(shape) + (n_bits,)
    return BitFlipDraws((C.uniform(s, generator) < 0.5).to(torch.float32),
                        (C.uniform(s, generator) < 0.5).to(torch.float32))


def bit_flipping_env(n_bits: int = 6, ep_len: Optional[int] = None):
    """(reset(draws), step(state, action[B] i32, draws), T): sparse
    reward 0 on goal match else -1 (the HER paper's canonical task),
    auto-reset from the step's draws."""
    T = ep_len or n_bits

    def reset(draws: BitFlipDraws):
        st = BitFlipState(draws.bits, draws.goal,
                          torch.zeros(draws.bits.shape[:1], dtype=torch.int32,
                                      device=draws.bits.device))
        return st, torch.cat([draws.bits, draws.goal], dim=-1)

    def step(state: BitFlipState, action, draws: BitFlipDraws):
        flip = torch.nn.functional.one_hot(action.long(), n_bits).to(
            state.bits.dtype)
        bits = torch.abs(state.bits - flip)
        solved = torch.all(bits == state.goal, dim=-1)
        reward = torch.where(solved, 0.0, -1.0)
        t = state.t + 1
        done = solved | (t >= T)
        d = done[:, None]
        bits_out = torch.where(d, draws.bits, bits)
        goal_out = torch.where(d, draws.goal, state.goal)
        t_out = torch.where(done, 0, t)
        obs = torch.cat([bits_out, goal_out], dim=-1)
        return BitFlipState(bits_out, goal_out, t_out), obs, reward, done

    return reset, step, T


# ---------------------------------------------------------------------------
# Episodic buffer + future-strategy relabeling


class HERBuffer(NamedTuple):
    """[E, T, ...] episode store; ``next_obs`` is the achieved-goal
    trajectory used for relabeling."""

    obs: torch.Tensor       # [E, T, n]  (state part only)
    action: torch.Tensor    # [E, T] i32
    next_obs: torch.Tensor  # [E, T, n]
    goal: torch.Tensor      # [E, n]     original episode goal
    length: torch.Tensor    # [E] i32
    size: torch.Tensor
    head: torch.Tensor


def her_buffer_init(episodes: int, ep_len: int, n: int,
                    device=None) -> HERBuffer:
    device = resolve_device(device)

    def z(*shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=device)

    return HERBuffer(obs=z(episodes, ep_len, n),
                     action=z(episodes, ep_len, dt=torch.int32),
                     next_obs=z(episodes, ep_len, n), goal=z(episodes, n),
                     length=z(episodes, dt=torch.int32),
                     size=z(dt=torch.int32), head=z(dt=torch.int32))


def her_buffer_push(buf: HERBuffer, obs, action, next_obs, goal, length
                    ) -> HERBuffer:
    """Append a batch of complete episodes ([B, T, ...])."""
    E = buf.obs.shape[0]
    b = obs.shape[0]
    slots = (buf.head + torch.arange(b, device=obs.device)) % E

    def put(dst, src):
        return dst.index_copy(0, slots, src.to(dst.dtype))

    return HERBuffer(obs=put(buf.obs, obs), action=put(buf.action, action),
                     next_obs=put(buf.next_obs, next_obs),
                     goal=put(buf.goal, goal), length=put(buf.length, length),
                     size=torch.clamp(buf.size + b, max=E),
                     head=(buf.head + b) % E)


class HERBatch(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    next_obs: torch.Tensor
    done: torch.Tensor


class HERSampleDraws(NamedTuple):
    """One sample's draws: episode indices in [0, max(size, 1)) and three
    uniforms (the step, the future step, the relabel coin)."""

    episode: torch.Tensor   # [batch] int
    u_step: torch.Tensor    # [batch]
    u_future: torch.Tensor  # [batch]
    u_relabel: torch.Tensor  # [batch]


def her_sample_draws(size: torch.Tensor, batch_size: int,
                     generator: torch.Generator) -> HERSampleDraws:
    return HERSampleDraws(C.below(size, (batch_size,), generator),
                          *(C.uniform((batch_size,), generator)
                            for _ in range(3)))


def her_sample(buf: HERBuffer, draws: HERSampleDraws,
               relabel_prob: float = 0.8) -> HERBatch:
    """'future' strategy (her/replay_buffer.py): with probability
    ``relabel_prob`` replace the goal by an achieved state from a
    uniformly drawn future step of the same episode; reward and done are
    recomputed against the (possibly new) goal."""
    tmax = buf.obs.shape[1]
    ep = draws.episode.long()
    length = buf.length[ep]
    t = (draws.u_step * length.to(torch.float32)).to(torch.int32)
    t = torch.clamp(t, 0, tmax - 1)
    # future index in (t, length]
    fut = t + 1 + (draws.u_future * (length - t - 1).to(torch.float32)
                   ).to(torch.int32)
    fut = torch.clamp(fut, 0, tmax - 1)
    relabel = draws.u_relabel < relabel_prob
    goal = torch.where(relabel[:, None], buf.next_obs[ep, fut.long()],
                       buf.goal[ep])
    tl = t.long()
    s, s2 = buf.obs[ep, tl], buf.next_obs[ep, tl]
    solved = torch.all(s2 == goal, dim=-1)
    return HERBatch(obs=torch.cat([s, goal], dim=-1),
                    action=buf.action[ep, tl],
                    reward=torch.where(solved, 0.0, -1.0),
                    next_obs=torch.cat([s2, goal], dim=-1),
                    done=(solved | (t + 1 >= length)).to(torch.float32))


# ---------------------------------------------------------------------------
# HER + DQN learner (the fork runs HER over DQN/SAC/TD3; DQN matches the
# BitFlipping benchmark, test_her.py)


class HERDQNConfig(NamedTuple):
    gamma: float = 0.98
    lr: float = 1e-3
    batch_size: int = 128
    buffer_episodes: int = 512
    epsilon: float = 0.2
    target_period: int = 40


class HERDQNState(NamedTuple):
    params: dict
    target_params: dict
    opt_state: Any
    buffer: HERBuffer
    step: torch.Tensor


class HERDQNDraws(NamedTuple):
    reset: BitFlipDraws          # [B, n]
    eps_uniform: torch.Tensor    # [T, B]
    random_action: torch.Tensor  # [T, B] in [0, n_bits)
    step_reset: BitFlipDraws     # [T, B, n]
    samples: List[HERSampleDraws]  # n_updates


def make_her_dqn(n_bits: int, cfg: HERDQNConfig = HERDQNConfig(),
                 hidden=(256,), mesh=None):
    """Returns (init_fn(generator) -> state, update_fn(state, generator,
    batch=16, n_updates=8) -> state, q_fn(state, obs), (reset_fn,
    step_fn, T)) for BitFlippingEnv."""
    reset_fn, step_fn, T = bit_flipping_env(n_bits)

    def build(g=None):
        return nets.MLP(2 * n_bits, (*hidden, n_bits), generator=g)

    net = build()
    tx = C.adam(cfg.lr)

    def init_fn(generator: torch.Generator) -> HERDQNState:
        params = nets.init_params(build, generator)
        return HERDQNState(params, params, tx.init(params),
                           her_buffer_init(cfg.buffer_episodes, T, n_bits,
                                           generator.device),
                           torch.zeros((), dtype=torch.int32,
                                       device=generator.device))

    def rollout_episodes(params, draws: HERDQNDraws):
        st, obs = reset_fn(draws.reset)
        goal = st.goal
        b = obs.shape[0]
        done_seen = torch.zeros((b,), dtype=torch.bool, device=obs.device)
        length = torch.zeros((b,), dtype=torch.int32, device=obs.device)
        recs = []
        with torch.no_grad():
            for t in range(T):
                greedy = torch.argmax(nets.apply(net, params, obs), dim=-1)
                act = torch.where(draws.eps_uniform[t] < cfg.epsilon,
                                  draws.random_action[t].long(), greedy)
                bits_before = st.bits
                st, obs, rew, done = step_fn(
                    st, act, C.tree_map(lambda d: d[t], draws.step_reset))
                # the achieved state after the flip, not st.bits, which is
                # already auto-reset on terminal steps
                achieved = torch.abs(bits_before - torch.nn.functional.one_hot(
                    act, n_bits).to(bits_before.dtype))
                recs.append((bits_before, act.to(torch.int32),
                             torch.where(done_seen[:, None], bits_before,
                                         achieved)))
                length = length + (~done_seen).to(torch.int32)
                done_seen = done_seen | done
        bits, acts, next_bits = (torch.stack(x, dim=1) for x in zip(*recs))
        return bits, acts, next_bits, goal, length

    def td_loss(params, target_params, mb: HERBatch):
        q = nets.apply(net, params, mb.obs)
        qa = torch.gather(q, -1, mb.action.long()[:, None])[:, 0]
        with torch.no_grad():
            nq = torch.max(nets.apply(net, target_params, mb.next_obs),
                           dim=-1).values
            y = mb.reward + cfg.gamma * (1.0 - mb.done) * nq
        return torch.mean((qa - y) ** 2)

    def draw(state: HERDQNState, generator: torch.Generator, batch: int = 16,
             n_updates: int = 8) -> HERDQNDraws:
        size_after = torch.clamp(state.buffer.size + batch,
                                 max=cfg.buffer_episodes)
        return HERDQNDraws(
            bitflip_draws((batch,), n_bits, generator),
            C.uniform((T, batch), generator),
            torch.randint(0, n_bits, (T, batch), generator=generator,
                          device=generator.device),
            bitflip_draws((T, batch), n_bits, generator),
            [her_sample_draws(size_after, cfg.batch_size, generator)
             for _ in range(n_updates)])

    def with_draws(state: HERDQNState, draws: HERDQNDraws) -> HERDQNState:
        bits, acts, next_bits, goal, length = rollout_episodes(state.params,
                                                               draws)
        buf = her_buffer_push(state.buffer, bits, acts, next_bits, goal,
                              length)
        params, opt_state = state.params, state.opt_state
        for sd in draws.samples:
            mb = her_sample(buf, sd)
            g = C.maybe_pmean(C.grad(td_loss, params, state.target_params,
                                     mb), mesh)
            up, opt_state = tx.update(g, opt_state, params)
            params = C.apply_updates(params, up)
        step = state.step + 1
        sync = step % cfg.target_period == 0
        target = C.tree_map(lambda t, p: torch.where(sync, p, t),
                            state.target_params, params)
        return HERDQNState(params, target, opt_state, buf, step)

    def update_fn(state: HERDQNState, generator: torch.Generator,
                  batch: int = 16, n_updates: int = 8) -> HERDQNState:
        return with_draws(state, draw(state, generator, batch, n_updates))

    def q_fn(state: HERDQNState, obs):
        with torch.no_grad():
            return nets.apply(net, state.params, obs)

    update_fn.draw = draw
    update_fn.with_draws = with_draws
    update_fn.net = net
    return init_fn, update_fn, q_fn, (reset_fn, step_fn, T)
