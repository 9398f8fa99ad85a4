"""The port's planner bridge and DCARL agent session against the JAX
package's.

* ``bridge/wire.py`` against ``msgpack`` (imported here only): the same
  bytes from ``packb``, the same objects from ``Unpacker`` fed in random
  splits.
* The bridge: each package's client against each package's server
  (``tests/test_aux.py``'s two bridge cases, both protocols), messages
  split across ``recv`` chunks, the fallback semantics.
* ``bridge/agent_session.py`` against ``examples/run_agent_server.py``'s
  ``AgentSession`` (loaded with ``importlib``, its store and DQN configs
  shrunk through ``monkeypatch``: 1,024 store rows, replay 256, batch
  32), both starting from the JAX session's state (``interop``): in test
  mode 64 ticks with bit-equal actions and equal store and replay; in
  training mode 48 ticks on JAX's own draws with equal actions and
  losses, on the eager tick and on the static-buffer route of the
  compiled one (``tests/test_torch_agent_graphs.py``), with the host's
  Adam and the card's.  JAX runs with 64-bit mode off, the float32 it
  was written for.
"""

import importlib.util
import socket
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from flax import linen as nn
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.config import DQNConfig as JDQNConfig
from dcarl_tpu.config import StoreConfig as JStoreConfig
from dcarl_tpu.core import store as JS
from dcarl_tpu.models import replay as JRB
from dcarl_tpu.models.dqn import DQN as JDQN
from dcarl_tpu.models.networks import MLPQNet as JMLPQNet
from dcarl_tpu_torch import interop
from dcarl_tpu_torch.bridge import AgentServer, PlannerClient, wire
from dcarl_tpu_torch.bridge import agent_session as AS
from dcarl_tpu_torch.config import DQNConfig, StoreConfig
from dcarl_tpu_torch.core.store import ConfidenceStore
from dcarl_tpu_torch.models import replay as RB
from dcarl_tpu_torch.train_fast import TrainDraws
from dcarl_tpu_torch.utils import graphs

from torch_algos_jax import one_torch_thread  # noqa: F401 (fixture)

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"
CAP, REPLAY, BATCH = 1024, 256, 32
INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1, -1, -32, -33, -128, -129,
             -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]


def _messages(rng, n: int):
    """Seeded protocol traffic: 22-item lane messages (20 floats, two int
    flags), VEG replies, float32 states, edge ints, nested lists."""
    out = []
    for _ in range(n):
        state = rng.normal(0, 5, 20)
        out.append([float(x) for x in state] + [int(rng.random() < 0.1), 0])
        out.append([float(np.float32(x)) for x in state] + [0, 1])
        out.append([float(x) for x in rng.normal(0, 2, 4)])
        out.append(int(rng.integers(-2 ** 40, 2 ** 40)))
    out += INT_EDGES + [None, True, False, [], [[1, 2.5], [None, True]],
                        (1, 2, 3), list(range(16)),
                        [0.0, -0.0, 1e308, -1e-308, float("inf")]]
    return out


LONG = [list(range(70000)), [0.5] * 300, "y" * 70000, "z" * 300]


def test_packb_is_byte_equal_to_msgpack():
    msgpack = pytest.importorskip("msgpack")
    for obj in _messages(np.random.default_rng(0), 40) + LONG[:2]:
        assert wire.packb(obj) == msgpack.packb(obj), obj


def test_packb_refuses_what_msgpack_refuses_and_the_rest():
    msgpack = pytest.importorskip("msgpack")
    for obj in (np.float32(1.0), np.int64(3), object()):
        with pytest.raises(TypeError):
            msgpack.packb(obj)
        with pytest.raises(TypeError):
            wire.packb(obj)
    # msgpack encodes these; the protocol has no use for them
    for obj in (b"raw", {"a": 1}, "text", [1.0, b"x"]):
        with pytest.raises(TypeError):
            wire.packb(obj)
    for n in (2 ** 64, -2 ** 63 - 1):
        with pytest.raises(OverflowError):
            wire.packb(n)


def test_unpacker_matches_msgpack_in_random_splits():
    msgpack = pytest.importorskip("msgpack")
    rng = np.random.default_rng(1)
    objs = _messages(rng, 30) + ["lane", "é" * 40, "x" * 300]
    stream = b"".join(msgpack.packb(o) for o in objs)
    # float32 on the wire (a planner packing single floats)
    singles = [[float(x) for x in rng.normal(0, 5, 22)] for _ in range(5)]
    stream += b"".join(msgpack.packb(o, use_single_float=True)
                       for o in singles)
    ours, theirs = wire.Unpacker(), msgpack.Unpacker(raw=False)
    got, want = [], []
    pos = 0
    while pos < len(stream):
        step = int(rng.integers(1, 64)) if rng.random() < 0.9 else 5000
        chunk = stream[pos:pos + step]
        pos += step
        ours.feed(chunk)
        theirs.feed(chunk)
        got += list(ours)
        want += list(theirs)
        assert len(got) == len(want)
    assert got == want and len(got) == len(objs) + len(singles)
    # array16 / array32 and str16 / str32, fed whole
    ours.feed(b"".join(msgpack.packb(o) for o in LONG))
    assert list(ours) == LONG


@pytest.mark.parametrize("data", [b"\xc1", b"\xc4\x01x", b"\x81\x01\x02",
                                  b"\xd4\x00\x00", b"\xc7\x00\x00"],
                         ids=["never_used", "bin8", "fixmap", "fixext",
                              "ext8"])
def test_unpacker_refuses_other_types(data):
    u = wire.Unpacker()
    u.feed(data)
    with pytest.raises(ValueError, match="outside the protocol"):
        list(u)


# ----------------------------------------------------------------- bridge

def _bridge(kind: str):
    if kind == "jax":
        pytest.importorskip("msgpack")
        import dcarl_tpu.bridge as jb

        return jb.AgentServer, jb.PlannerClient
    return AgentServer, PlannerClient


PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]


@pytest.mark.parametrize("server,client", PAIRS,
                         ids=[f"{s}_server-{c}_client" for s, c in PAIRS])
def test_agent_bridge_roundtrip_and_fallback(server, client):
    Server, _ = _bridge(server)
    _, Client = _bridge(client)

    def policy(msg):
        # lane protocol: 20-D state + [collision, leave_mmap]
        assert len(msg) == 22
        return int(msg[0] > 0.5)

    with Server(policy) as srv:
        c = Client(port=srv.address[1])
        assert c.decide([1.0] + [0.0] * 19) == 1
        assert c.decide([0.0] * 20) == 0
        assert c.decide(np.full(20, 0.75, np.float32)) == 1
        c.close()
    # server gone -> fallback to the rule action
    dead = Client(port=srv.address[1], timeout=0.2, fallback_action=-1)
    assert dead.decide([1.0] * 20) == -1


@pytest.mark.parametrize("server,client", PAIRS,
                         ids=[f"{s}_server-{c}_client" for s, c in PAIRS])
def test_agent_bridge_veg_protocol(server, client):
    Server, _ = _bridge(server)
    _, Client = _bridge(client)

    def veg_policy(msg):
        return [0.5, -1.5, float(len(msg)), 3.25]  # action, q values...

    with Server(veg_policy) as srv:
        c = Client(port=srv.address[1])
        assert c.decide([0.0] * 10) == [0.5, -1.5, 12.0, 3.25]
        c.close()


def test_server_decodes_split_and_batched_messages():
    seen = []

    def policy(msg):
        seen.append(msg)
        return len(seen)

    msgs = [[float(i)] * 20 + [0, 0] for i in range(3)]
    data = b"".join(wire.packb(m) for m in msgs)
    with AgentServer(policy) as srv:
        with socket.create_connection(srv.address, timeout=5) as s:
            s.sendall(data[:7])
            time.sleep(0.05)
            s.sendall(data[7:])          # the rest, two and a bit messages
            u = wire.Unpacker()
            replies = []
            while len(replies) < 3:
                u.feed(s.recv(4096))
                replies += list(u)
    assert replies == [1, 2, 3] and seen == msgs


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_policy_exception_ends_the_connection_and_the_client_falls_back():
    def policy(msg):
        raise RuntimeError("policy failed")

    with AgentServer(policy) as srv:
        c = PlannerClient(port=srv.address[1], timeout=2.0,
                          fallback_action=-1)
        assert c.decide([0.0] * 20) == -1
        for t in srv._threads:      # the connection's thread has ended
            t.join(timeout=5)
            assert not t.is_alive()


# ---------------------------------------------------------- agent session

def _load_example():
    spec = importlib.util.spec_from_file_location(
        "_run_agent_server_example", ROOT / "examples" / "run_agent_server.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small_configs():
    return (StoreConfig(capacity=CAP),
            DQNConfig(batch_size=BATCH, replay_capacity=REPLAY))


def _anchors(rng, k: int) -> np.ndarray:
    """[k, 20] states drawn like the example selftest's planner."""
    a = np.zeros((k, 20))
    a[:, 1] = rng.integers(0, 2, k)
    a[:, 2] = rng.uniform(0, 12, k)
    a[:, 4:] = rng.normal(0, 5, (k, 16))
    return a


def _prefill(rng, anchors, per_action: int):
    """Store rows near the anchors, ``per_action`` for each action, values
    drawn around a mean for each (anchor, action)."""
    hw = np.asarray(AS.HALF_WIDTHS)
    k = len(anchors)
    mu = rng.uniform(-1.0, 0.0, (k, AS.NUM_ACTIONS))
    idx = np.repeat(np.arange(k), AS.NUM_ACTIONS * per_action)
    act = np.tile(np.repeat(np.arange(AS.NUM_ACTIONS), per_action), k)
    keys = np.zeros((len(idx), 21), np.float32)
    keys[:, :20] = anchors[idx] + rng.uniform(-0.2, 0.2, (len(idx), 20)) \
        * hw[:20]
    keys[:, 20] = act
    vals = (mu[idx, act] + rng.normal(0, 0.1, len(idx))).astype(np.float32)
    return keys, act.astype(np.float32), vals


def _traffic(rng, anchors, n: int, collide: float = 0.05):
    hw = np.asarray(AS.HALF_WIDTHS)
    out = []
    for _ in range(n):
        s = anchors[rng.integers(len(anchors))] \
            + rng.uniform(-0.2, 0.2, 20) * hw[:20]
        out.append([float(x) for x in s]
                   + [int(rng.random() < collide), int(rng.random() < 0.03)])
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_draws(key, cfg_store, cfg_dqn) -> TrainDraws:
    """The draws of one JAX tick (run_agent_server.py:80-81, :131;
    dqn.py:94-99, rls.py:138, replay.py:146) from the key ``decide``
    splits off, in the port's ``draw`` layout."""
    with jax.enable_x64(False):
        k_eps, k_gate, k_train = jax.random.split(key, 3)
        k_e, k_act = jax.random.split(k_eps)
        out = TrainDraws(
            eps_uniform=jax.random.uniform(k_e, (1,)),
            random_action=jax.random.randint(k_act, (1,), 0, AS.NUM_ACTIONS),
            gate_uniform=jax.random.uniform(
                k_gate, (1,), minval=cfg_store.explore_low,
                maxval=cfg_store.explore_high),
            gumbel=jax.random.gumbel(k_train, (cfg_dqn.batch_size,
                                               cfg_dqn.replay_capacity)))
    return TrainDraws(*(torch.as_tensor(np.array(x)) for x in out))


def _run_jax(is_training: bool, ticks: int, seed: int):
    """The example's session at the small widths: its start state (after
    a seeded pre-fill of its store), the traffic, and per tick the key
    ``decide`` split off, the action and the loss; then its end state."""
    jcfg_s = JStoreConfig(capacity=CAP)
    jcfg_d = JDQNConfig(batch_size=BATCH, replay_capacity=REPLAY)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(False):
        mod = _load_example()
        mp.setattr(mod, "StoreConfig", lambda: jcfg_s)
        mp.setattr(mod, "DQNConfig",
                   lambda **kw: JDQNConfig(**{**kw, "replay_capacity": REPLAY}))
        sess = mod.AgentSession(seed=seed, is_training=is_training)
        rng = np.random.default_rng(seed)
        anchors = _anchors(rng, 4)
        keys, act, vals = _prefill(rng, anchors, per_action=30)
        sess.store = JS.store_insert(sess.store, jnp.asarray(keys),
                                     jnp.asarray(act), jnp.asarray(vals),
                                     jnp.ones(len(keys), bool))
        start = _np((sess.state, sess.store, sess.traj))
        losses = []
        tick = sess._tick

        def recorded(*args):
            out = tick(*args)
            losses.append(float(out[-1]))
            return out

        sess._tick = recorded
        traffic = _traffic(rng, anchors, ticks)
        tick_keys, actions, states = [], [], []
        for msg in traffic:
            tick_keys.append(jax.random.split(sess.key)[1])
            states.append(_np(sess.state))
            actions.append(sess.decide(msg))
        end = _np((sess.state, sess.store, sess.traj))
    return dict(start=start, traffic=traffic, keys=tick_keys,
                actions=actions, losses=losses, states=states, end=end,
                cfg=(jcfg_s, jcfg_d), episodes=sess.episodes)


def _carry_learner(sess: AS.AgentSession, state) -> None:
    """The JAX ``DQNState`` (online and target nets, Adam, replay, frame)
    into the port's session."""
    interop.qnet_from_flax(state.params, sess.dqn.net)
    interop.qnet_from_flax(state.target_params, sess.dqn.target_net)
    interop.adam_state_from_optax(state.opt_state, sess.dqn.optimizer,
                                  sess.dqn.net)
    sess.set_learner_state(interop.replay_from_numpy(state.replay, CPU),
                           int(state.frame))


def _port_session(start, is_training: bool) -> AS.AgentSession:
    """The port's session on the CPU, carrying the JAX session's state."""
    scfg, dcfg = _small_configs()
    sess = AS.AgentSession(seed=0, is_training=is_training, device=CPU,
                           store_config=scfg, dqn_config=dcfg)
    state, store, traj = start
    _carry_learner(sess, state)
    keys, values, _ = interop.store_from_numpy(
        np.array(store.keys), np.array(store.values),
        np.arange(CAP) < int(store.size), CPU)
    sess.store = ConfidenceStore(
        keys, torch.as_tensor(np.array(store.actions)), values,
        torch.as_tensor(np.array(store.size)),
        torch.as_tensor(np.array(store.head)))
    sess.traj = interop.traj_buffer_from_numpy(traj, CPU)
    return sess


def _assert_store_and_replay(sess, end, prio_tol):
    state, store, traj = end
    for name in ("keys", "actions", "size", "head"):
        np.testing.assert_array_equal(getattr(sess.store, name).numpy(),
                                      np.asarray(getattr(store, name)), name)
    np.testing.assert_allclose(sess.store.values.numpy(), store.values,
                               rtol=1e-6, atol=1e-6)
    for name in ("obs", "action", "reward", "next_obs", "done", "size",
                 "head"):
        np.testing.assert_array_equal(getattr(sess.replay, name).numpy(),
                                      np.asarray(getattr(state.replay, name)),
                                      name)
    np.testing.assert_allclose(sess.replay.priority.numpy(),
                               state.replay.priority, **prio_tol)
    for name in ("obs", "action", "length"):
        np.testing.assert_array_equal(getattr(sess.traj, name).numpy(),
                                      np.asarray(getattr(traj, name)), name)
    np.testing.assert_allclose(sess.traj.reward.numpy(), traj.reward,
                               rtol=1e-6)
    assert sess.frame == int(state.frame)


@pytest.fixture(scope="module")
def jax_test_mode():
    return _run_jax(is_training=False, ticks=64, seed=1)


@pytest.fixture(scope="module")
def jax_train_mode():
    return _run_jax(is_training=True, ticks=48, seed=2)


def test_session_test_mode_matches_jax(jax_test_mode):
    run = jax_test_mode
    sess = _port_session(run["start"], is_training=False)
    actions = [sess.decide(m) for m in run["traffic"]]
    assert actions == run["actions"]
    assert len(set(actions)) > 1, "the gate never fired"
    assert sess.ticks == 64 and sess.episodes == run["episodes"] > 0
    _assert_store_and_replay(sess, run["end"], dict(rtol=0, atol=0))
    assert run["losses"] == [0.0] * 64


def _recording(sess: AS.AgentSession) -> list:
    """The loss of each of ``sess``'s ticks, appended as it runs."""
    losses, tick = [], sess._tick

    def recorded(*args):
        out = tick(*args)
        losses.append(float(out[1]))
        return out

    sess._tick = recorded
    return losses


def test_session_training_mode_matches_jax_on_its_draws(jax_train_mode):
    """48 ticks on JAX's draws.  Each tick from JAX's learner state of
    that tick: equal actions, losses within rtol 1e-5 / atol 1e-6.  Run
    freely from the start state: equal actions, store and replay rows,
    weights within 1e-5; the losses drift to ~5e-4 relative by the 16th
    SGD step, and no further than rtol 1e-3.  That drift is float32
    rounding: the same learner in float64 on both sides agrees within
    rtol 1e-12 (:func:`test_training_loss_drift_is_float32_rounding`)."""
    run = jax_train_mode
    scfg, dcfg = run["cfg"]
    draws = [_jax_draws(k, scfg, dcfg) for k in run["keys"]]
    trained = [i for i, x in enumerate(run["losses"]) if x != 0.0]
    assert len(trained) >= 8, "fewer than eight SGD steps in the run"

    sess = _port_session(run["start"], is_training=True)
    losses = _recording(sess)
    actions = []
    for m, d, st in zip(run["traffic"], draws, run["states"]):
        _carry_learner(sess, st)
        actions.append(sess.with_draws(m, d))
    assert actions == run["actions"]
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-5, atol=1e-6)

    sess = _port_session(run["start"], is_training=True)
    losses = _recording(sess)
    actions = [sess.with_draws(m, d) for m, d in zip(run["traffic"], draws)]
    assert actions == run["actions"]
    assert len(set(actions)) > 1
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-3, atol=1e-6)
    _assert_store_and_replay(sess, run["end"], dict(rtol=1e-3, atol=1e-5))
    state = run["end"][0]
    for lin, name in zip(sess.dqn.net.dense, ("Dense_0", "Dense_1",
                                             "Dense_2")):
        np.testing.assert_allclose(
            lin.weight.detach().numpy(),
            np.asarray(state.params["params"][name]["kernel"]).T,
            rtol=0, atol=1e-5)


@pytest.mark.parametrize("adam", ["host", "capturable"])
def test_session_static_route_matches_eager_and_jax(jax_train_mode,
                                                    monkeypatch, adam):
    """JAX's 48 ticks on JAX's draws (the caller's-draws variant), through
    the first SGD steps.  The static route from JAX's learner state of
    each tick: JAX's actions, losses within rtol 1e-5 / atol 1e-6.  Run
    freely from the start state, the static route equals the eager tick
    bit for bit and both agree with JAX as
    ``test_session_training_mode_matches_jax_on_its_draws`` holds the eager
    tick.  ``capturable``: the card's Adam (capturable, its step count in
    float64), as ``test_capturable_adam_trainer_against_jax`` sets it up."""
    from test_torch_agent_graphs import (_assert_sessions_equal, _losses,
                                         _static, static_call)
    from test_torch_graphs import _card_adam

    monkeypatch.setattr(graphs.CallRunner, "__call__", static_call)
    if adam == "capturable":
        _card_adam(monkeypatch)
    run = jax_train_mode
    draws = [_jax_draws(k, *run["cfg"]) for k in run["keys"]]

    sess = _static(_port_session(run["start"], is_training=True))
    assert sess.dqn.optimizer.defaults["capturable"] == (adam == "capturable")
    losses = _losses(sess)
    actions = []
    for m, d, st in zip(run["traffic"], draws, run["states"]):
        _carry_learner(sess, st)
        actions.append(sess.with_draws(m, d))
    assert actions == run["actions"]
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-5, atol=1e-6)

    routes = []
    for static in (True, False):
        sess = _port_session(run["start"], is_training=True)
        if static:
            _static(sess)
        losses = _losses(sess)
        actions = [sess.with_draws(m, d) for m, d in zip(run["traffic"],
                                                         draws)]
        routes.append((sess, actions, losses))
    (s_sess, s_act, s_loss), (e_sess, e_act, e_loss) = routes
    assert s_act == e_act == run["actions"] and s_loss == e_loss
    _assert_sessions_equal(s_sess, e_sess, "static route against eager")
    assert s_sess.episodes == run["episodes"] > 0
    assert sum(x != 0.0 for x in s_loss) >= 8
    np.testing.assert_allclose(s_loss, run["losses"], rtol=1e-3, atol=1e-6)
    _assert_store_and_replay(s_sess, run["end"], dict(rtol=1e-3, atol=1e-5))
    state = run["end"][0]
    for lin, name in zip(s_sess.dqn.net.dense, ("Dense_0", "Dense_1",
                                               "Dense_2")):
        np.testing.assert_allclose(
            lin.weight.detach().numpy(),
            np.asarray(state.params["params"][name]["kernel"]).T,
            rtol=0, atol=1e-5)


def _learner_ticks(run):
    """Per tick of a training run, read off the JAX session's recorded
    states: the replay row the tick pushed (None after an episode's end)
    and whether it took an SGD step (the replay held a batch after the
    push)."""
    end = int(run["end"][0].replay.size)
    sizes = [int(s.replay.size) for s in run["states"]] + [end]
    return [(sizes[t] if sizes[t + 1] > sizes[t] else None,
             sizes[t + 1] >= BATCH) for t in range(len(run["states"]))]


class _JQNet64(nn.Module):
    """``MLPQNet``'s layers in float64, its Q-values too (``MLPQNet``
    returns float32 whatever its ``dtype``)."""

    num_actions: int
    hidden: int = 128

    @nn.compact
    def __call__(self, x):
        x = x.astype(jnp.float64)
        x = nn.relu(nn.Dense(self.hidden, dtype=jnp.float64)(x))
        x = nn.relu(nn.Dense(self.hidden, dtype=jnp.float64)(x))
        return nn.Dense(self.num_actions, dtype=jnp.float64)(x)


def _jax_learner(run, x64: bool):
    """The run's learner alone: its replay pushes, SGD steps on its keys
    and target syncs, from its start state, through the JAX package's
    ``DQN`` (float64 throughout where ``x64``, the Q-net
    :class:`_JQNet64`).  Returns the losses."""
    jcfg_d = run["cfg"][1]
    rows = run["end"][0].replay
    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32

        def cast(a):
            a = np.asarray(a)
            return jnp.asarray(a, dt if a.dtype.kind == "f" else a.dtype)

        net = (_JQNet64 if x64 else JMLPQNet)(num_actions=AS.NUM_ACTIONS)
        dqn = JDQN(net, AS.OBS_DIM, jcfg_d)
        push = jax.jit(JRB.replay_push)
        state = jax.tree.map(cast, run["start"][0])
        losses = []
        for key, (row, train) in zip(run["keys"], _learner_ticks(run)):
            if row is not None:
                r = slice(row, row + 1)
                state = state._replace(replay=push(
                    state.replay, cast(rows.obs[r]), rows.action[r],
                    cast(rows.reward[r]), cast(rows.next_obs[r]),
                    cast(rows.done[r])))
            if train:
                state, loss = dqn.train_step(state,
                                             jax.random.split(key, 3)[2])
                losses.append(float(loss))
            else:
                state = state._replace(frame=state.frame + 1)
            if int(state.frame) % jcfg_d.target_update_every == 0:
                state = dqn.update_target(state)
    return losses


def _port_learner_f64(run):
    """:func:`_jax_learner` on the port's ``DQN`` in float64 (the Q-nets'
    layers and Q-values too), its Gumbel draws JAX's in 64-bit mode."""
    _, dcfg = _small_configs()
    sess = _port_session(run["start"], is_training=True)
    dqn, replay = sess.dqn, sess.replay
    for net in (dqn.net, dqn.target_net):
        net.double()
        net.forward = lambda x, d=net.dense: d[2](torch.relu(d[1](
            torch.relu(d[0](x.double())))))
    for st in dqn.optimizer.state.values():
        st["exp_avg"] = st["exp_avg"].double()
        st["exp_avg_sq"] = st["exp_avg_sq"].double()
    replay = RB.Replay(*(x.double() if x.is_floating_point() else x
                         for x in replay))
    frame = torch.tensor(int(run["start"][0].frame), dtype=torch.int32)
    rows = run["end"][0].replay
    losses = []
    for key, (row, train) in zip(run["keys"], _learner_ticks(run)):
        if row is not None:
            r = slice(row, row + 1)
            replay = RB.replay_push(replay, *(
                torch.as_tensor(np.array(getattr(rows, f)[r]))
                for f in ("obs", "action", "reward", "next_obs", "done")))
        if train:
            with jax.enable_x64(True):
                g = jax.random.gumbel(jax.random.split(key, 3)[2],
                                      (BATCH, REPLAY))
            replay, frame, loss = dqn.train_step(replay, frame,
                                                 torch.as_tensor(np.array(g)))
            losses.append(float(loss))
        else:
            frame = frame + 1
        if int(frame) % dcfg.target_update_every == 0:
            dqn.update_target(torch.ones((), dtype=torch.bool))
    return losses


def test_training_loss_drift_is_float32_rounding(jax_train_mode):
    """The witness for the free run's rtol 1e-3: its learner alone (the
    same pushes, SGD steps, keys and target syncs) in float64 on both
    sides, the port's losses within rtol 1e-12 of JAX's at every SGD step
    (1e-14 relative on the CPU), so the float32 drift is rounding, not a
    difference in the priority update, the importance weights or Adam.
    The float32 JAX learner alone first reproduces the session's losses
    bit for bit, so the chain is the session's learner."""
    run = jax_train_mode
    trained = [x for x in run["losses"] if x != 0.0]
    assert _jax_learner(run, x64=False) == trained
    j64 = _jax_learner(run, x64=True)
    p64 = _port_learner_f64(run)
    assert len(p64) == len(j64) == len(trained) >= 8
    np.testing.assert_allclose(p64, j64, rtol=1e-12, atol=0)


# ------------------------------------------------- serving, on the CPU

def _small_session(**kw) -> AS.AgentSession:
    scfg, dcfg = _small_configs()
    return AS.AgentSession(device=CPU, store_config=scfg, dqn_config=dcfg,
                           **kw)


def _guarded(policy, log: list, errors: list, lock: threading.Lock):
    """``policy`` with each call's message and reply logged in the order
    the calls ran, and any exception recorded before it propagates."""
    def wrapped(msg):
        with lock:
            try:
                reply = policy(msg)
            except Exception as e:
                errors.append(repr(e))
                raise
            log.append((msg, reply))
            return reply
    return wrapped


def test_concurrent_clients_match_a_replay_in_arrival_order():
    """Three planners at once against one training session: the same
    decisions as a fresh session (same seed) fed the messages in the
    order the first one recorded them."""
    rng = np.random.default_rng(5)
    anchors = _anchors(rng, 3)
    sess = _small_session(seed=3, is_training=True)
    log, errors, lock = [], [], threading.Lock()
    replies = {}

    def planner(i, msgs):
        c = PlannerClient(port=srv.address[1], timeout=10.0,
                          fallback_action=-1)
        replies[i] = [c.decide(m[:20], collision=m[20], leave_mmap=m[21])
                      for m in msgs]
        c.close()

    traffic = {i: _traffic(rng, anchors, 16) for i in range(3)}
    with AgentServer(_guarded(sess.decide, log, errors, lock)) as srv:
        threads = [threading.Thread(target=planner, args=(i, traffic[i]))
                   for i in traffic]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    assert not errors and sess.ticks == 48 == len(log)
    assert all(a in range(AS.NUM_ACTIONS) for r in replies.values() for a in r)
    assert sorted(r for _, r in log) == sorted(a for r in replies.values()
                                               for a in r)
    replay = _small_session(seed=3, is_training=True)
    assert [replay.decide(m) for m, _ in log] == [r for _, r in log]
    np.testing.assert_array_equal(replay.store.keys.numpy(),
                                  sess.store.keys.numpy())


def test_selftest_serves_the_synthetic_planner():
    sess = _small_session(is_training=True)
    with AgentServer(sess.decide) as srv:
        out = AS.selftest(sess, srv.address[1], n_ticks=60)
    assert sess.ticks == 60 and len(out["latency_s"]) == 60
    assert int(sess.store.size) > 0 and int(sess.replay.size) > BATCH
    assert sess.frame == 60


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_selftest_fails_on_a_fallback_reply():
    """A tick that fails ends its connection and the client falls back:
    the selftest's fallback is -1, not the rule action 0, so it raises
    instead of passing."""
    sess = _small_session(is_training=False)

    def policy(msg):
        if sess.ticks == 5:
            raise RuntimeError("tick failed")
        return sess.decide(msg)

    with AgentServer(policy) as srv:
        with pytest.raises(RuntimeError, match="fallback"):
            AS.selftest(sess, srv.address[1], n_ticks=10)


def test_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(6)
    anchors = _anchors(rng, 2)
    sess = _small_session(seed=4, is_training=True)
    for m in _traffic(rng, anchors, 40):
        sess.decide(m)
    path = str(tmp_path / "agent.npz")
    sess.save_checkpoint(path)
    back = _small_session(seed=9, is_training=True, ckpt_path=path)
    assert back.frame == sess.frame == 40
    assert back.replay_rows == sess.replay_rows == int(sess.replay.size)
    for a, b in zip(back.dqn.net.parameters(), sess.dqn.net.parameters()):
        assert torch.equal(a, b)
    for p, q in zip(back.dqn.net.parameters(), sess.dqn.net.parameters()):
        sa, sb = back.dqn.optimizer.state[p], sess.dqn.optimizer.state[q]
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
        assert float(sa["step"]) == float(sb["step"]) > 0
    assert torch.equal(back.replay.obs, sess.replay.obs)


def test_session_refuses_a_quiet_cpu_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AS.AgentSession()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AS.main(["--selftest"])
    with pytest.raises(ValueError):
        _small_session().decide([0.0] * 20)
