"""DCARL agent server — the ``DCARL_agent.py`` entry point on the port
(``examples/run_agent_server.py``: ``AgentSession``, ``selftest``,
``main``).

The reference agent process (SW/tools/DCARL/DCARL_agent.py:18-43) makes
a socket-backed gym env (``zzz_lane-v0``: reward 1/step, 0 on
collision — gym_routing/envs/zzz.py:62-105), loads-or-creates a DQN,
and learns online while the on-vehicle planner connects over msgpack
TCP (port 2345) for decisions.

Here the DQN, the replay buffer, the continuous-state confidence store
and the RLS gate live on the session's device (the card unless the
caller passes ``device="cpu"``), and the socket bridge
(:class:`dcarl_tpu_torch.bridge.AgentServer`) moves 20-float states and
one int per tick.  Per tick, in the JAX example's order:

  reward bookkeeping (1/step, 0 on collision) -> n-step trajectory push
  into the confidence store -> replay push -> eps-greedy DQN proposal ->
  one store query for every action (``rls.all_action_stats``: on the
  card the ``sorted_moments`` kernel) -> ``act_train`` / ``act_test``
  -> one prioritized SGD step and the target sync.

The conditions the JAX tick computes on the device (enough replay rows
to train, the target-sync frame) are host counters here, so a tick
reads one value back: the reply's action.  Random draws come from the
session's ``torch.Generator``; :meth:`AgentSession.with_draws` takes
them from the caller instead (the test mode draws nothing).

On a CUDA device a tick is compiled, as JAX's ``jax.jit(tick)``: the
session's state (store, n-step window, replay, frame, previous (obs,
action), the learner's weights and Adam state) is updated in place and
is the static state of one captured CUDA graph for each variant the host
counters pick (train or not, target sync or not, the session's draws or
the caller's; ``utils/graphs.CallRunner``).  A request copies its floats
in and replays the graph.  On the CPU the tick runs eagerly;
:meth:`AgentSession.decide_eager` runs the eager tick on any device,
the reference a replayed tick is held to bit for bit.

    python -m dcarl_tpu_torch.bridge.agent_session --selftest

runs the full loop with an in-process synthetic planner (no ROS needed):
a few hundred ticks, then the learning state of the store.
"""

from __future__ import annotations

import argparse
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from dcarl_tpu_torch.bridge.agent_server import AgentServer, PlannerClient
from dcarl_tpu_torch.config import DQNConfig, StoreConfig
from dcarl_tpu_torch.core import rls
from dcarl_tpu_torch.core import store as cstore
from dcarl_tpu_torch.device import disable_tf32, resolve_device
from dcarl_tpu_torch.models import dqn as DQ
from dcarl_tpu_torch.models import replay as RB
from dcarl_tpu_torch.models.networks import MLPQNet
from dcarl_tpu_torch.train_fast import TrainDraws, make_draws
from dcarl_tpu_torch.utils import checkpoint as ckpt
from dcarl_tpu_torch.utils import graphs
from dcarl_tpu_torch.utils.logging import MetricsLogger

OBS_DIM = 20
NUM_ACTIONS = 8  # 0 = rule (LaneUtility), 1 = brake, 2-7 lane/speed deltas
HALF_WIDTHS = cstore.FIELD_HALF_WIDTHS[:OBS_DIM] + (0.1,)


class AgentSession:
    """Owns the agent's device state; thread-safe for the
    multi-connection server (one lock around each tick).

    The example's widths by default: ``StoreConfig()`` (2^17 rows),
    ``DQNConfig(batch_size=32, replay_capacity=1 << 16)``, an
    ``MLPQNet`` of 8 actions over the 20-float state (hidden 128) and
    the half-widths ``FIELD_HALF_WIDTHS[:20] + (0.1,)``."""

    def __init__(self, seed: int = 0, is_training: bool = True,
                 ckpt_path: Optional[str] = None, device=None,
                 store_config: Optional[StoreConfig] = None,
                 dqn_config: Optional[DQNConfig] = None,
                 half_widths: Sequence[float] = HALF_WIDTHS):
        self.device = dev = resolve_device(device)
        self.scfg = store_config or StoreConfig()
        self.dcfg = dqn_config or DQNConfig(batch_size=32,
                                            replay_capacity=1 << 16)
        self.is_training = is_training
        net = MLPQNet(NUM_ACTIONS, OBS_DIM,
                      generator=torch.Generator().manual_seed(seed))
        # capturable Adam on the card, compiled or not: both routes give
        # the same bits (torch takes it on CUDA tensors only)
        self.dqn = DQ.DQN(net.to(dev), self.dcfg,
                          capturable=dev.type == "cuda")
        self.half_widths = torch.tensor(half_widths, dtype=torch.float32,
                                        device=dev)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.store = cstore.store_init(self.scfg.capacity, OBS_DIM + 1,
                                       device=dev)
        self.traj = rls.traj_buffer_init(self.scfg.n_step_window, OBS_DIM,
                                         device=dev)
        self.replay = RB.replay_init(self.dcfg.replay_capacity, OBS_DIM,
                                     device=dev)
        self._frame_t = torch.zeros((), dtype=torch.int32, device=dev)
        # the previous tick's (obs, action), read by a tick whose has_prev
        # flag is set (none after an episode's end)
        self.prev_obs = torch.zeros(OBS_DIM, device=dev)
        self.prev_action = torch.zeros((), dtype=torch.int32, device=dev)
        self.has_prev = False
        self.frame = 0
        self.replay_rows = 0
        self.lock = threading.Lock()
        self.logger = MetricsLogger()
        self.ticks = 0
        self.episodes = 0
        self.ckpt_path = ckpt_path
        self._sync = torch.ones((), dtype=torch.bool, device=dev)
        self.runner = graphs.CallRunner(self._tick, dev.type == "cuda",
                                        state=self.state_tensors)
        if ckpt_path and os.path.exists(ckpt_path):
            self.load_checkpoint(ckpt_path)
            print(f"loaded model from {ckpt_path}")

    # ------------------------------------------------------------------
    def _carried(self) -> list:
        """The tensors a tick writes its new values into, in place."""
        return graphs.tensors_of((self.store, self.traj, self.replay,
                                  self._frame_t, self.prev_obs,
                                  self.prev_action))

    def state_tensors(self) -> list:
        """Every tensor a tick updates in place: what :meth:`_carried`
        names, and the learner's weights and Adam state (the compiled
        tick's static state)."""
        return self._carried() + self.dqn.state_tensors()

    def set_learner_state(self, replay: RB.Replay, frame: int) -> None:
        """Copy ``replay`` and the frame counter in; the host counters
        that decide training follow them (one read of ``replay.size``)."""
        for name, dst, src in zip(RB.Replay._fields, self.replay, replay):
            if dst.shape != src.shape:
                raise ValueError(f"replay.{name}: {tuple(src.shape)} given, "
                                 f"the session holds {tuple(dst.shape)}")
            dst.copy_(src)
        self.frame = int(frame)
        self.replay_rows = int(replay.size)
        self._frame_t.fill_(self.frame)

    def checkpoint_state(self) -> dict:
        """What the JAX example checkpoints (its ``DQNState``): online and
        target weights, Adam's state, the replay and the frame."""
        net = self.dqn.net
        return {"net": net.state_dict(),
                "target": self.dqn.target_net.state_dict(),
                "adam": {name: self.dqn.optimizer.state[p]
                         for name, p in net.named_parameters()},
                "replay": self.replay, "frame": self._frame_t}

    def save_checkpoint(self, path: str) -> None:
        ckpt.save_npz(path, self.checkpoint_state())

    def load_checkpoint(self, path: str) -> None:
        self.load_state(ckpt.load_npz(path, self.checkpoint_state()))

    def load_state(self, saved: dict) -> None:
        """Copy a learner state in :meth:`checkpoint_state`'s layout into
        the session's tensors (a compiled tick goes on using them)."""
        self.dqn.net.load_state_dict(saved["net"])
        self.dqn.target_net.load_state_dict(saved["target"])
        for name, p in self.dqn.net.named_parameters():
            held = self.dqn.optimizer.state[p]
            for k, v in saved["adam"][name].items():
                held[k].copy_(v)
        self.set_learner_state(saved["replay"], int(saved["frame"]))

    # ------------------------------------------------------------------
    def draw(self) -> TrainDraws:
        """One training tick's draws from the session's generator: the
        epsilon uniform and random action, the gate's explore uniform,
        the replay sample's Gumbel noise."""
        return self._draw(self.generator)

    def _draw(self, generator: torch.Generator) -> TrainDraws:
        return make_draws(generator, 1, NUM_ACTIONS, self.scfg, self.dcfg,
                          self.dcfg.replay_capacity, self.device)

    def decide(self, msg) -> int:
        """Bridge policy callback: msg = 20-D state + [collision,
        leave_mmap]; returns the gated action."""
        return self.with_draws(msg, None)

    def with_draws(self, msg, draws: Optional[TrainDraws]) -> int:
        """:meth:`decide` on the caller's ``draws`` (None: the session
        draws them itself, under the lock, in the order of arrival)."""
        return self._serve(msg, draws, eager=False)

    def decide_eager(self, msg, draws: Optional[TrainDraws] = None) -> int:
        """:meth:`with_draws` through the eager tick, on any device: the
        reference of the compiled tick, and its route on the CPU."""
        return self._serve(msg, draws, eager=True)

    def _serve(self, msg, draws: Optional[TrainDraws], eager: bool) -> int:
        if len(msg) < OBS_DIM + 1:
            raise ValueError(f"a planner message holds {OBS_DIM} state "
                             f"floats and the collision flag; got {len(msg)}")
        floats = [float(x) for x in msg[:OBS_DIM + 1]]
        leave = float(msg[OBS_DIM + 1]) > 0 if len(msg) > OBS_DIM + 1 \
            else False
        compiled = self.runner.compiled and not eager
        with self.lock:
            head = torch.tensor(floats + [float(self.has_prev)],
                                dtype=torch.float32)
            # the collision flag as the JAX tick sees it, in float32
            done = bool(head[OBS_DIM] > 0)
            if self.device.type == "cuda":
                # through a pinned block, so the copy waits for nothing;
                # under the lock, so that no thread issues it while
                # another captures a tick
                head = head.pin_memory()
                if not compiled:
                    head = head.to(self.device, non_blocking=True)
            if self.has_prev:
                self.replay_rows = min(self.replay_rows + 1,
                                       self.dcfg.replay_capacity)
            self.frame += 1
            # what the JAX tick's two lax.cond read, from the host counters
            variant = (self.is_training
                       and self.replay_rows >= self.dcfg.batch_size,
                       self.frame % self.dcfg.target_update_every == 0)
            tick = self.runner if compiled else self._tick
            action, loss = tick(variant, (head, draws), self.generator)
            a = int(action)
            self.has_prev = not (done or leave)
            self.ticks += 1
            if done or leave:
                self.episodes += 1
                if self.ckpt_path and self.episodes % 20 == 0:
                    self.save_checkpoint(self.ckpt_path)
            if self.ticks % 200 == 0:
                self.logger.logkv("ticks", self.ticks)
                self.logger.logkv("episodes", self.episodes)
                self.logger.logkv("store_rows", int(self.store.size))
                self.logger.logkv("loss", float(loss))
                self.logger.dumpkvs()
        return a

    def _tick(self, variant, inputs, generator: torch.Generator):
        """One tick (run_agent_server.py:79-122), its new state written
        into the session's tensors.  ``variant`` is (train, target sync);
        ``inputs`` is (head, draws): head [22] f32 holds the state, the
        collision flag and the has_prev flag, and ``draws`` None draws
        from ``generator`` in training (test mode draws nothing).  Returns
        (action, loss) as device scalars.  Test mode skips the
        epsilon-greedy proposal, which the JAX tick computes and
        discards."""
        train, sync = variant
        head, draws = inputs
        dev, scfg = self.device, self.scfg
        obs, collision = head[:OBS_DIM], head[OBS_DIM]
        has_prev = head[OBS_DIM + 1] > 0
        if draws is None and self.is_training:
            draws = self._draw(generator)
        with torch.no_grad():
            # reward for the PREVIOUS action (zzz.py:69-77 semantics)
            reward = torch.where(collision > 0, 0.0, 1.0)
            done_t = collision > 0
            # zeros without a previous tick, as the JAX example passes
            prev_obs = torch.where(has_prev, self.prev_obs, 0.0)
            prev_action = torch.where(has_prev, self.prev_action, 0)

            # record the executed action in both datasets (dqn.py:226-236)
            traj, recs = rls.traj_buffer_push(
                self.traj, prev_obs, prev_action.to(torch.float32), reward,
                done_t, scfg)
            recs = recs._replace(valid=recs.valid & has_prev)
            store = rls.insert_records(self.store, recs)
            replay = RB.replay_push(
                self.replay, prev_obs[None], prev_action[None],
                reward[None], obs[None], done_t.to(torch.float32)[None],
                mask=has_prev.reshape(1))

            # decide: eps-greedy proposal filtered by confidence gating
            stats = rls.all_action_stats(store, obs[None], self.half_widths,
                                         NUM_ACTIONS)
            if self.is_training:
                proposal = self.dqn.act_epsilon_greedy(
                    obs[None], self._frame_t, draws.eps_uniform,
                    draws.random_action)
                action = rls.act_train(stats, proposal, draws.gate_uniform,
                                       scfg)[0]
            else:
                action = rls.act_test(stats, scfg)[0]

        # learn once the replay has a batch
        if train:
            replay, frame, loss = self.dqn.train_step(replay, self._frame_t,
                                                      draws.gumbel)
        else:
            frame = self._frame_t + 1
            loss = torch.zeros((), device=dev)
        if sync:
            self.dqn.update_target(self._sync)
        graphs.write_back(self._carried(), graphs.tensors_of(
            (store, traj, replay, frame, obs, action)))
        return action, loss


def selftest(session: AgentSession, port: int, n_ticks: int = 400) -> dict:
    """Synthetic planner: random-walk multilane states, occasional
    collisions — checks the full socket + learning loop end-to-end.
    Returns the replies and each round trip's seconds.

    The client falls back to -1, which no policy returns, so a failed
    round trip fails the selftest instead of passing for the rule action
    0; its 120 s timeout covers the first tick of a fresh process, which
    loads the device's modules."""
    client = PlannerClient(port=port, timeout=120.0, fallback_action=-1)
    rng = np.random.default_rng(0)
    state = np.zeros(OBS_DIM)
    actions, latency = [], []
    for t in range(n_ticks):
        state[1] = rng.integers(0, 2)          # ego lane
        state[2] = np.clip(state[2] + rng.normal(0, 0.5), 0, 12)  # speed
        state[4:] = rng.normal(0, 5, OBS_DIM - 4)
        collision = int(rng.random() < 0.02)
        t0 = time.perf_counter()
        actions.append(client.decide(state.tolist(), collision=collision))
        latency.append(time.perf_counter() - t0)
    client.close()
    if any(a not in range(NUM_ACTIONS) for a in actions):
        raise RuntimeError(f"selftest: replies outside 0..{NUM_ACTIONS - 1} "
                           "(a fallback or a broken reply)")
    hist = np.bincount(actions, minlength=NUM_ACTIONS)
    rows = int(session.store.size)
    print(f"selftest: {n_ticks} ticks, episodes={session.episodes}, "
          f"store_rows={rows}, action hist={hist.tolist()}")
    if session.ticks != n_ticks or rows <= 0:
        raise RuntimeError(f"selftest: {session.ticks} ticks for {n_ticks} "
                           f"requests, {rows} store rows")
    print("selftest OK")
    return {"actions": actions, "latency_s": latency}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=2345)
    ap.add_argument("--test", action="store_true",
                    help="test mode: z-test confidence gating, no learning")
    ap.add_argument("--ckpt", default=None, help="npz checkpoint path")
    ap.add_argument("--selftest", action="store_true")
    args = ap.parse_args(argv)

    disable_tf32()
    session = AgentSession(is_training=not args.test, ckpt_path=args.ckpt)
    port = 0 if args.selftest else args.port
    with AgentServer(session.decide, port=port) as srv:
        print(f"DCARL agent serving on {srv.address}")
        if args.selftest:
            selftest(session, srv.address[1])
            return
        threading.Event().wait()  # serve forever


if __name__ == "__main__":
    main()
