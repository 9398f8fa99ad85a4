"""PyTorch port: the served agent tick and the trust-set trainer, compiled
(``bridge/agent_session.py`` on ``utils/graphs.CallRunner``, the
counterpart of JAX's ``jax.jit(tick)``; ``models/segment.py``'s
``run_fn`` on ``graphs.TickRunner``, the counterpart of its
``jax.jit(lax.scan(one_step))``).

On the card a session replays one captured CUDA graph a request (one a
variant: train or not, target sync or not, its own draws or the
caller's) and the trust-set trainer one a warm-free step.  Here, with no
card, each runs its static-buffer route with every call eager:
:func:`static_call` loads a call's inputs into the runner's static
buffers and runs the tick on them with the runner's own generator, which
takes the caller's state and hands it back; ``tests/test_torch_graphs.py``'s
``static_run`` does the same for a run of steps.  Each static route must
equal its eager route bit for bit (replies, losses, store, n-step window,
replay, frame, previous (obs, action), weights, Adam state, generator
state; for the trust set its metrics and whole carry).  Their JAX
comparisons sit beside the JAX runs they reuse, so that no JAX program
is built twice: ``tests/test_torch_bridge.py``'s
``test_session_static_route_matches_eager_and_jax`` and
``tests/test_torch_segment.py``'s
``test_trustset_static_run_matches_loop_and_jax``.

The cases here take helpers from those two files (which import JAX)
inside their bodies, so that the ``cuda``-marked case at the end, both
compiled routes against their eager ones on the card, runs on a machine
without JAX: ``python -m pytest --noconftest
tests/test_torch_agent_graphs.py -m cuda``.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu_torch import config as tcfg
from dcarl_tpu_torch.bridge import agent_session as AS
from dcarl_tpu_torch.core import store as cstore
from dcarl_tpu_torch.models import segment as SEG
from dcarl_tpu_torch.utils import graphs

from test_torch_graphs import (assert_bit_equal,  # noqa: F401
                               one_torch_thread, static_run)

CAP, REPLAY, BATCH = 1024, 256, 32   # tests/test_torch_bridge.py's widths
TICKS = 48


def static_call(runner, variant, inputs, generator):
    """What a replayed call computes, eagerly: the runner's static input
    buffers of ``variant`` loaded with ``inputs``, the tick on them with
    the runner's generator (set to ``generator``'s state, handed back)."""
    call = runner._load(variant, inputs)
    gen = runner._own_generator(generator)
    out = runner._run(call, gen)
    generator.set_state(gen.get_state())
    return out


@pytest.fixture
def static_route(monkeypatch):
    """A session marked with :func:`_static` takes the static-buffer
    route."""
    monkeypatch.setattr(graphs.CallRunner, "__call__", static_call)


def _static(sess: AS.AgentSession) -> AS.AgentSession:
    sess.runner.compiled = True
    return sess


def _losses(sess: AS.AgentSession) -> list:
    """Each tick's loss as the tick returns it, on either route."""
    losses = []
    static = sess.runner.compiled
    tick = sess.runner.fn if static else sess._tick

    def recorded(*args):
        out = tick(*args)
        losses.append(float(out[1]))
        return out

    if static:
        sess.runner.fn = recorded
    else:
        sess._tick = recorded
    return losses


def _session_state(sess: AS.AgentSession):
    """Everything a tick changes, device tensors and host counters."""
    return ((sess.store, sess.traj, sess.replay, sess._frame_t, sess.prev_obs,
             sess.prev_action, sess.dqn.state_dict(),
             sess.generator.get_state()),
            (sess.frame, sess.replay_rows, sess.has_prev, sess.ticks,
             sess.episodes))


def _assert_sessions_equal(a: AS.AgentSession, b: AS.AgentSession, what):
    (ta, ha), (tb, hb) = _session_state(a), _session_state(b)
    assert ha == hb, what
    assert_bit_equal(ta, tb, what)


# ---------------------------------------------------------------------------
# The agent: the static route == the eager tick, and == JAX
# ---------------------------------------------------------------------------


def _small_session(seed: int, is_training: bool, **dqn) -> AS.AgentSession:
    return AS.AgentSession(
        seed=seed, is_training=is_training, device="cpu",
        store_config=tcfg.StoreConfig(capacity=CAP),
        dqn_config=tcfg.DQNConfig(batch_size=BATCH, replay_capacity=REPLAY,
                                  **dqn))


def _prefilled(sess: AS.AgentSession, rng, anchors) -> AS.AgentSession:
    """``sess`` with ``tests/test_torch_bridge.py``'s pre-fill in its
    store (rows near the anchors, so the gate fires)."""
    import test_torch_bridge as TB

    keys, act, vals = TB._prefill(rng, anchors, per_action=30)
    sess.store = cstore.store_insert(
        sess.store, torch.as_tensor(keys), torch.as_tensor(act),
        torch.as_tensor(vals), torch.ones(len(keys), dtype=torch.bool))
    return sess


@pytest.mark.parametrize("is_training", [True, False],
                         ids=["training", "test_mode"])
def test_session_static_route_with_its_own_draws(static_route, is_training):
    """The session's own draws (drawn inside the tick from the runner's
    generator), 64 ticks with episode ends: in training through the first
    SGD steps and target syncs every 8th frame, in test mode on a
    pre-filled store where the gate fires.  The static route equals the
    eager tick bit for bit, the generator included, and reuses one set of
    static buffers for each variant."""
    import test_torch_bridge as TB

    rng = np.random.default_rng(7)
    anchors = TB._anchors(rng, 4)
    traffic = TB._traffic(rng, anchors, 64, collide=0.08)
    routes = []
    for static in (True, False):
        sess = _prefilled(_small_session(5, is_training,
                                         target_update_every=8),
                          np.random.default_rng(8), anchors)
        if static:
            _static(sess)
        losses = _losses(sess)
        actions = [sess.decide(m) for m in traffic]
        routes.append((sess, actions, losses))
    (s_sess, s_act, s_loss), (e_sess, e_act, e_loss) = routes
    assert s_act == e_act and s_loss == e_loss
    _assert_sessions_equal(s_sess, e_sess, "static route against eager")
    assert s_sess.episodes > 0 and set(s_act) != {0}
    variants = {call.variant for call in s_sess.runner._calls.values()}
    if is_training:
        assert sum(x != 0.0 for x in s_loss) >= 8
        assert variants == {(False, False), (False, True), (True, False),
                            (True, True)}
    else:
        assert set(s_loss) == {0.0}
        assert variants == {(False, False), (False, True)}
    assert len(s_sess.runner._calls) == len(variants)


def test_checkpoint_round_trip_through_static_buffers(static_route,
                                                      tmp_path):
    """A checkpoint of a session on its static route, loaded by a new one
    (static and eager), gives the same learner, replay and frame; the two
    then tick alike.  A ``load_state`` copies into the tensors the static
    buffers hold, so the runner keeps its buffers."""
    import test_torch_bridge as TB

    rng = np.random.default_rng(9)
    anchors = TB._anchors(rng, 2)
    sess = _static(_small_session(4, True, target_update_every=16))
    for m in TB._traffic(rng, anchors, 40):
        sess.decide(m)
    path = str(tmp_path / "agent.npz")
    sess.save_checkpoint(path)
    at_save = (sess.dqn.state_dict(), [t.clone() for t in sess.replay],
               sess._frame_t.clone(), sess.replay_rows)
    calls = dict(sess.runner._calls)
    held = sess.state_tensors()
    sess.load_state(AS.ckpt.load_npz(path, sess.checkpoint_state()))
    assert all(a is b for a, b in zip(sess.state_tensors(), held))
    sess.decide(TB._traffic(rng, anchors, 1)[0])
    assert len(calls) >= 2 and all(sess.runner._calls[k] is c
                                   for k, c in calls.items())

    more = TB._traffic(rng, anchors, 16)
    back = []
    for static in (True, False):
        b = _small_session(11, True, target_update_every=16)
        b.load_checkpoint(path)
        if static:
            _static(b)
        back.append(b)
    assert back[0].frame == 40 and back[0].replay_rows == at_save[3]
    assert_bit_equal((back[0].dqn.state_dict(), list(back[0].replay),
                      back[0]._frame_t), at_save[:3], "loaded checkpoint")
    replies = [[b.decide(m) for m in more] for b in back]
    assert replies[0] == replies[1]
    _assert_sessions_equal(*back, "loaded sessions, static against eager")


# ---------------------------------------------------------------------------
# The trust-set trainer: the static run == the eager loop, and == JAX
# ---------------------------------------------------------------------------


def test_trustset_run_fn_static_route_equals_loop(monkeypatch):
    """``run_fn`` from ``init_fn`` with its own draws (reset jitter on),
    across the warm boundary: warm steps eager, the rest through its
    runner.  With the runner on its static route the run equals the
    eager loop bit for bit: metrics, carry, learner, generator."""
    import test_torch_segment as TSG

    kw = dict(TSG._kw(tcfg, SEG), env_cfg=tcfg.EnvConfig(reset_jitter=0.05))
    init_t, run_t = SEG.make_trustset_trainer(**kw, device="cpu")
    carry0 = init_t(seed=0)
    start = run_t.learner.state_dict()
    routes = []
    for static in (True, False):
        run_t.learner.load_state_dict(start)
        g = torch.Generator().manual_seed(1)
        with monkeypatch.context() as mp:
            if static:
                mp.setattr(graphs.TickRunner, "__call__", static_run)
            out = run_t(carry0, g, TSG.STEPS)
        routes.append((out, run_t.learner.state_dict(), g.get_state()))
    assert_bit_equal(routes[0], routes[1], "trust-set run_fn static route")
    (carry, m), _, _ = routes[0]
    assert tuple(m) == SEG.METRIC_KEYS and not carry.warm
    warm = int((m["ts_rows"] == 0).sum())
    # the warm steps and the one that fills a batch ran eagerly
    assert 1 <= warm < TSG.STEPS - 4 and run_t.runner.last is not None
    assert run_t.runner.last.n_steps == TSG.STEPS - warm - 1


# ---------------------------------------------------------------------------
# On the card: both compiled routes equal their eager ones
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph is captured and "
                    "replayed only on the card)")
    from dcarl_tpu_torch import disable_tf32

    disable_tf32()
    return torch.device("cuda")


@pytest.mark.cuda
def test_compiled_routes_equal_eager_on_the_card(cuda):
    """A training session (store 2^12 rows, replay 256, target sync every
    8th frame) served 48 requests compiled and eagerly from one seed:
    replies and every state tensor, learner and generator bit-equal, one
    ``sorted_moments`` launch a tick by the counters; then the trust-set
    trainer (64 envs, 40 steps) through ``run_fn`` against a loop of its
    eager steps, one launch a trained step."""
    from dcarl_tpu_torch.ops import _cuda

    rng = np.random.default_rng(0)
    traffic = []
    for _ in range(TICKS):
        s = rng.normal(0, 5, AS.OBS_DIM)
        traffic.append([float(x) for x in s]
                       + [int(rng.random() < 0.05), 0])
    runs = []
    for compiled in (True, False):
        sess = AS.AgentSession(
            seed=3, device=cuda, store_config=tcfg.StoreConfig(capacity=4096),
            dqn_config=tcfg.DQNConfig(batch_size=BATCH,
                                      replay_capacity=REPLAY,
                                      target_update_every=8))
        _cuda.LAUNCHES.clear()
        serve = sess.decide if compiled else sess.decide_eager
        replies = [serve(m) for m in traffic]
        torch.cuda.synchronize()
        runs.append((sess, replies, dict(_cuda.LAUNCHES)))
    (sess_c, rep_c, l_c), (sess_e, rep_e, l_e) = runs
    assert rep_c == rep_e and l_c == l_e == {"sorted_moments": TICKS}
    assert sess_c.runner.last.graph is not None
    _assert_sessions_equal(sess_c, sess_e, "agent: compiled against eager")

    init_t, run_t = SEG.make_trustset_trainer(batch=64, device=cuda)
    carry0 = init_t(seed=0)
    start = run_t.learner.state_dict()
    routes = []
    for compiled in (True, False):
        run_t.learner.load_state_dict(start)
        g = torch.Generator(device=cuda).manual_seed(1)
        _cuda.LAUNCHES.clear()
        if compiled:
            out = run_t(carry0, g, 40)
        else:
            carry, ms = carry0, []
            for _ in range(40):
                carry, m = run_t.step(carry, g)
                ms.append(m)
            out = carry, {k: torch.stack([m[k] for m in ms])
                          for k in SEG.METRIC_KEYS}
        torch.cuda.synchronize()
        routes.append((out, run_t.learner.state_dict(), g.get_state(),
                       dict(_cuda.LAUNCHES)))
    trained = int((routes[1][0][1]["ts_rows"] > 0).sum())
    assert trained > 0 and routes[0][3] == routes[1][3] == {
        "sorted_moments": trained}
    assert_bit_equal(routes[0][:3], routes[1][:3], "trust set: compiled "
                     "against eager")
