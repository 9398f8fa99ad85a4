"""PyTorch port: the batch-first env step against the JAX package.

Both packages start from the JAX package's vmapped state, carried across
with ``interop.env_state_from_numpy``, and take the same numpy actions.
The cases are those of ``tests/test_env.py``: a throttle run, a stuck
stop, a pass and a collision (by teleporting the ego), auto-reset and the
vectorised env.  Auto-reset draws come from different generators, so the
parity runs use ``reset_jitter=0``.  In float64 integer and boolean
fields must be bit-equal, real ones within 1e-12 (XLA contracts a
multiply and an add into one FMA inside a jitted function)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.config import EnvConfig as JEnvConfig
from dcarl_tpu.env import driving_env as jde
from dcarl_tpu.env.scenario import t_intersection as j_t_intersection
from dcarl_tpu_torch import interop
from dcarl_tpu_torch.config import EnvConfig
from dcarl_tpu_torch.env import driving_env as de
from dcarl_tpu_torch.env.scenario import t_intersection

CPU = torch.device("cpu")
TOL = dict(rtol=1e-12, atol=1e-12)
B = 6


def _pair(**cfg):
    jcfg, tcfg = JEnvConfig(**cfg), EnvConfig(**cfg)
    jsc, tsc = j_t_intersection(jcfg), t_intersection(tcfg)
    jsa = jde.scenario_to_device(jsc, jnp.float64)
    tsa = de.scenario_to_device(tsc, torch.float64, CPU)
    return (jcfg, jsa, jde.in_state_indices(jsc)), (tcfg, tsa,
                                                     de.in_state_indices(tsc))


def _jax_states(jenv, seed=0):
    jcfg, jsa, _ = jenv
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    return jax.vmap(lambda k: jde.reset(jsa, k, jcfg))(keys)


def _teleport(st):
    """env 2 just above the pass line moving fast; env 3 on the walker."""
    ego = np.array(st.ego)
    speed = np.array(st.ego_speed)
    ego[2] = [242.0, 73.9, 0.0, -10.0, -np.pi / 2]
    speed[2] = 10.0
    ego[3, 0:2] = [247.5, 80.0]
    ego[3, 3] = 0.0
    return st._replace(ego=jnp.asarray(ego), ego_speed=jnp.asarray(speed))


def _actions(rng, n):
    """[n, B, 2]: env 0 full throttle, env 1 idle (it gets stuck), the
    rest random."""
    a = np.stack([rng.uniform(-1, 1, (n, B)), rng.uniform(-0.3, 0.3, (n, B))],
                 axis=-1)
    a[:, 0] = [1.0, 0.0]
    a[:, 1] = 0.0
    return a


def _assert_state(got: de.EnvState, ref, where=""):
    for name in de.EnvState._fields:
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, r, err_msg=f"{name} {where}")
        else:
            np.testing.assert_allclose(g, r, err_msg=f"{name} {where}", **TOL)


def test_wrap_state_matches_jax():
    jenv, tenv = _pair()
    st = _jax_states(jenv)
    rng = np.random.default_rng(0)
    # random ego poses and yaws around the spawn, objects as spawned
    ego = np.array(st.ego) + rng.normal(0, 2, (B, 5))
    st = st._replace(ego=jnp.asarray(ego))
    obs_j, ori_j = jax.vmap(lambda s: jde.wrap_state(s, jenv[1], jenv[2],
                                                     jenv[0]))(st)
    ts = interop.env_state_from_numpy(st, CPU, torch.float64)
    obs, ori = de.wrap_state(ts, tenv[1], tenv[2], tenv[0])
    assert obs.shape == (B, 20) and ori.shape == (B, 20)
    np.testing.assert_allclose(obs.numpy(), np.asarray(obs_j), **TOL)
    np.testing.assert_array_equal(ori.numpy(), np.asarray(ori_j))
    # the ego-frame ego row is the origin; the walker is object 0
    obs0, ori0 = de.wrap_state(interop.env_state_from_numpy(
        _jax_states(jenv), CPU, torch.float64), tenv[1], tenv[2], tenv[0])
    np.testing.assert_allclose(obs0[:, :5].numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(ori0[:, 5:7].numpy(),
                               np.tile([248.0, 80.0], (B, 1)))


@pytest.mark.parametrize("offroute", [0.0, 3.0])
def test_step_matches_jax(offroute):
    """45 ticks of ``step`` (no reset): throttle, stuck (41 idle ticks),
    pass and collision envs, and road departure when it is on."""
    jenv, tenv = _pair(offroute_dist=offroute)
    st_j = _teleport(_jax_states(jenv))
    st_t = interop.env_state_from_numpy(st_j, CPU, torch.float64)
    acts = _actions(np.random.default_rng(1), 45)
    step_j = jax.jit(jax.vmap(lambda s, a: jde.step(s, a, jenv[1], jenv[2],
                                                    jenv[0])))
    for i, a in enumerate(acts):
        st_j, obs_j, r_j, d_j, ori_j = step_j(st_j, jnp.asarray(a))
        st_t, obs_t, r_t, d_t, ori_t = de.step(st_t, torch.as_tensor(a),
                                               tenv[1], tenv[2], tenv[0])
        _assert_state(st_t, st_j, f"tick {i}")
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
        np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), **TOL)
        np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), **TOL)
        np.testing.assert_allclose(ori_t.numpy(), np.asarray(ori_j), **TOL)
        if i == 0:
            assert bool(st_t.passed[2]) and bool(st_t.done[2])
            assert bool(st_t.collided[3])
            assert float(r_t[3]) == tenv[0].reward_collision
    # the throttle env drives south, the idle env got stuck with reward 0
    assert float(st_t.ego_speed[0]) > 5.0 and float(st_t.ego[0, 1]) < 109.0
    assert bool(st_t.stuck[1]) and float(r_t[1]) == 0.0
    assert int(st_t.stuck_steps[1]) == 45


def test_step_autoreset_matches_jax():
    """Auto-reset at ``reset_jitter=0``: the pass and collision envs come
    back at the spawn with their outcome flags kept, and every tick
    agrees with JAX."""
    jenv, tenv = _pair(reset_jitter=0.0)
    st_j = _teleport(_jax_states(jenv))
    st_t = interop.env_state_from_numpy(st_j, CPU, torch.float64)
    acts = _actions(np.random.default_rng(2), 45)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    step_j = jax.jit(jax.vmap(lambda s, a, k: jde.step_autoreset(
        s, a, k, jenv[1], jenv[2], jenv[0])))
    gen = torch.Generator().manual_seed(7)
    ended = np.zeros(B, bool)
    for i, a in enumerate(acts):
        st_j, obs_j, r_j, d_j, ori_j = step_j(st_j, jnp.asarray(a), keys)
        st_t, obs_t, r_t, d_t, ori_t = de.step_autoreset(
            st_t, torch.as_tensor(a), gen, tenv[1], tenv[2], tenv[0])
        _assert_state(st_t, st_j, f"tick {i}")
        np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), **TOL)
        np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), **TOL)
        np.testing.assert_allclose(ori_t.numpy(), np.asarray(ori_j), **TOL)
        if i == 0:
            # fresh state, outcome flags of the finished episode kept
            np.testing.assert_allclose(st_t.ego[2, 1].item(), 110.0)
            assert bool(st_t.passed[2]) and bool(st_t.collided[3])
            assert float(st_t.episode_return[2]) == 0.0
            np.testing.assert_allclose(ori_t[2, 1].item(), 110.0)
        ended |= d_t.numpy()
    assert ended[[1, 2, 3]].all()     # stuck, pass, collision


def test_make_vec_env_matches_jax():
    jcfg, tcfg = JEnvConfig(reset_jitter=0.0), EnvConfig(reset_jitter=0.0)
    reset_j, step_j = jde.make_vec_env(j_t_intersection(jcfg), jcfg,
                                       dtype=jnp.float64)
    reset_t, step_t = de.make_vec_env(t_intersection(tcfg), tcfg,
                                      dtype=torch.float64, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    st_j, obs_j, ori_j = reset_j(keys)
    gen = torch.Generator().manual_seed(0)
    st_t, obs_t, ori_t = reset_t(B, gen)
    _assert_state(st_t, st_j, "reset")
    np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), **TOL)
    np.testing.assert_array_equal(ori_t.numpy(), np.asarray(ori_j))
    acts = _actions(np.random.default_rng(3), 30)
    for i, a in enumerate(acts):
        st_j, obs_j, r_j, d_j, ori_j = step_j(
            st_j, jnp.asarray(a), jax.random.split(jax.random.PRNGKey(i), B))
        st_t, obs_t, r_t, d_t, ori_t = step_t(st_t, torch.as_tensor(a), gen)
        _assert_state(st_t, st_j, f"tick {i}")
        np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), **TOL)
        np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), **TOL)
    if not torch.cuda.is_available():
        # device=None means the card: no quiet CPU run
        with pytest.raises(RuntimeError):
            de.make_vec_env(t_intersection(tcfg), tcfg)
