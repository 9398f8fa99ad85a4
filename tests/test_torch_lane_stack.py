"""PyTorch port: the lane-level decision stack against the JAX package
(``planning/{multilane,idm,lane_utility,decision,safeguard}.py`` and
``env/multilane_env.py``).

Every case of ``tests/test_lane_stack.py`` has a counterpart here that
feeds the same inputs to both packages: the JAX world model (or env
state) is carried across with ``interop``, in float64 where JAX runs in
float64 (the suite enables x64).  Integer and boolean outputs (lanes,
actions, flags) must be equal, real ones within rtol 1e-5 / atol 1e-4
(XLA contracts a multiply and an add into one FMA inside a jitted
function; PyTorch rounds twice).  The env's reset draws are JAX's,
carried across whole as the ``fresh`` state of ``step_autoreset``.
Then the hazards of the port: XLA's ``x ** 4``, ``jnp.linspace``'s
rounding of the safeguard's scale ladder, the first-True ``argmax`` of
a bool mask, round half to even; and the gated lane tick: the store
query of every action, the sorted-band query at D = 21, and the rule and
gated loops of 16 envs x 40 ticks in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.config import StoreConfig as JStoreConfig
from dcarl_tpu.core import rls as JRLS
from dcarl_tpu.core import store as JST
from dcarl_tpu.env import multilane_env as ML
from dcarl_tpu.ops.pallas_store import box_query_moments_sorted as j_sorted
from dcarl_tpu.planning import decision as DEC
from dcarl_tpu.planning import idm
from dcarl_tpu.planning import lane_utility as LU
from dcarl_tpu.planning import multilane as JMUL
from dcarl_tpu.planning import safeguard as SG
from dcarl_tpu.planning.multilane import LaneVehicle, MultiLaneState
from dcarl_tpu_torch import interop
from dcarl_tpu_torch.config import StoreConfig
from dcarl_tpu_torch.core import rls as RLS
from dcarl_tpu_torch.core import store as ST
from dcarl_tpu_torch.env import multilane_env as TML
from dcarl_tpu_torch.ops.store_kernels import box_query_moments_sorted
from dcarl_tpu_torch.planning import decision as TDEC
from dcarl_tpu_torch.planning import idm as TIDM
from dcarl_tpu_torch.planning import lane_utility as TLU
from dcarl_tpu_torch.planning import multilane as TMUL
from dcarl_tpu_torch.planning import safeguard as TSG

CPU = torch.device("cpu")
F64 = torch.float64
TOL = dict(rtol=1e-5, atol=1e-4)
CFG, TCFG = ML.MultiLaneEnvConfig(), TML.MultiLaneEnvConfig()
HW = np.asarray(ST.FIELD_HALF_WIDTHS, np.float32)


def make_mmap(ego_lane=0.0, ego_speed=10.0, front_s=(50.0, 50.0),
              front_v=(20.0, 20.0), front_exists=(False, False),
              rear_s=(-50.0, -50.0), rear_v=(0.0, 0.0),
              rear_exists=(False, False), dist_junction=400.0,
              speed_limit=15.0):
    """``tests/test_lane_stack.py``'s world model."""
    L = 2
    lanes = jnp.arange(L, dtype=jnp.float32)
    return MultiLaneState(
        ego_lane_index=jnp.asarray(ego_lane),
        ego_speed=jnp.asarray(ego_speed),
        ego_vd=jnp.zeros(()),
        front=LaneVehicle(exists=jnp.asarray(front_exists),
                          s=jnp.asarray(front_s), d=lanes,
                          vs=jnp.asarray(front_v), vd=jnp.zeros((L,))),
        rear=LaneVehicle(exists=jnp.asarray(rear_exists),
                         s=jnp.asarray(rear_s), d=lanes,
                         vs=jnp.asarray(rear_v), vd=jnp.zeros((L,))),
        speed_limit=jnp.full((L,), speed_limit),
        distance_to_junction=jnp.asarray(dist_junction),
        target_lane_index=jnp.asarray(1.0),
        traffic_light_stop=jnp.zeros((L,), bool),
        stop_distance=jnp.full((L,), 1e6),
    )


def port(m):
    return interop.multilane_state_from_numpy(jax.device_get(m), CPU, F64)


def i(x):
    return torch.tensor(x)


def close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **TOL)


def test_idm_free_road_accelerates():
    m = make_mmap(ego_speed=5.0)
    v = TIDM.longitudinal_speed(port(m), i(0))
    close(v, idm.longitudinal_speed(m, jnp.asarray(0)))
    assert float(v) > 5.0


def test_idm_blocked_decelerates():
    m = make_mmap(ego_speed=12.0, front_exists=(True, False),
                  front_s=(8.0, 50.0), front_v=(2.0, 20.0))
    v_blocked = TIDM.longitudinal_speed(port(m), i(0))
    v_free = TIDM.longitudinal_speed(port(m), i(1))
    close(v_blocked, idm.longitudinal_speed(m, jnp.asarray(0)))
    close(v_free, idm.longitudinal_speed(m, jnp.asarray(1)))
    assert float(v_blocked) < float(v_free) and float(v_blocked) < 12.0


def test_idm_traffic_light():
    m = make_mmap(ego_speed=10.0)
    m = m._replace(traffic_light_stop=jnp.asarray([True, False]),
                   stop_distance=jnp.asarray([20.0, 1e6]))
    for lane in (0, 1):
        got = TIDM.longitudinal_speed(port(m), i(lane), traffic_light=True)
        close(got, idm.longitudinal_speed(m, jnp.asarray(lane),
                                          traffic_light=True))
    assert float(TIDM.longitudinal_speed(port(m), i(0),
                                         traffic_light=True)) == 0.0


def test_lane_utility_prefers_free_lane():
    m = make_mmap(ego_lane=0.0, ego_speed=10.0,
                  front_exists=(True, False), front_s=(12.0, 50.0),
                  front_v=(2.0, 20.0))
    m2 = m._replace(rear=LaneVehicle(
        exists=jnp.asarray([False, True]),
        s=jnp.asarray([-50.0, -5.0]), d=jnp.arange(2, dtype=jnp.float32),
        vs=jnp.asarray([0.0, 15.0]), vd=jnp.zeros((2,))))
    for mm, want in ((m, 1), (m2, 0)):
        got = TLU.generate_lane_change_index(port(mm))
        assert got.dtype == torch.int32
        assert int(got) == int(LU.generate_lane_change_index(mm)) == want
        for lane in (0, 1):
            close(TLU.lane_utility(port(mm), i(lane)),
                  LU.lane_utility(mm, jnp.asarray(lane)))


def test_lane_change_safe_gaps():
    m = make_mmap(front_exists=(False, True), front_s=(50.0, 25.0),
                  front_v=(20.0, 10.0), ego_speed=10.0)
    m2 = make_mmap(front_exists=(False, True), front_s=(50.0, 15.0),
                   front_v=(20.0, 10.0), ego_speed=10.0)
    got = [bool(TLU.lane_change_safe(port(mm), i(k)))
           for mm in (m, m2) for k in (-1, 0, 1, 2)]
    ref = [bool(LU.lane_change_safe(mm, jnp.asarray(k)))
           for mm in (m, m2) for k in (-1, 0, 1, 2)]
    assert got == ref
    assert got[2] and not got[6] and not got[0] and not got[3]


def test_wrap_state_layout():
    m = make_mmap(ego_lane=1.0, ego_speed=9.0,
                  front_exists=(True, False), front_s=(30.0, 50.0),
                  front_v=(8.0, 20.0))
    s = TDEC.wrap_state(port(m))
    assert s.shape == (20,)
    np.testing.assert_array_equal(s.numpy(), np.asarray(DEC.wrap_state(m)))
    np.testing.assert_allclose(s[4:8].numpy(), [30.0, 0.0, 8.0, 0.0])
    np.testing.assert_allclose(s[8:12].numpy(), [50.0, 1.0, 20.0, 0.0])


def test_decision_action_mapping():
    m = make_mmap(ego_lane=1.0, ego_speed=10.0)
    for a in range(8):
        d = TDEC.decision_from_discrete_action(port(m), i(a))
        dj = DEC.decision_from_discrete_action(m, jnp.asarray(a))
        assert d.target_lane_index.dtype == torch.int32
        assert int(d.target_lane_index) == int(dj.target_lane_index)
        close(d.target_speed, dj.target_speed)
    d1 = TDEC.decision_from_discrete_action(port(m), i(1))
    assert float(d1.target_speed) == pytest.approx(10.0 - 4.0 * 0.75)


def _safeguard_case():
    T = 14
    xy = jnp.stack([jnp.linspace(0, 40, T), jnp.zeros(T)], axis=1)
    speed = jnp.full((T,), 10.0)
    blocker = jnp.asarray([[20.0, 0.0, 0.0, 0.0, 0.0]])
    return xy, speed, blocker


def test_safeguard_caps_speed():
    xy, speed, blocker = _safeguard_case()
    txy, tsp, tbl = (torch.as_tensor(np.array(a)) for a in (xy, speed,
                                                              blocker))
    for valid in (True, False):
        jv = jnp.full((1,), valid)
        tv = torch.full((1,), valid)
        assert bool(TSG.check_trajectory(txy, tsp, tbl, tv)) \
            == bool(SG.check_trajectory(xy, speed, blocker, jv)) == (not valid)
        capped = TSG.get_safeguard_speed(txy, tsp, tbl, tv)
        close(capped, SG.get_safeguard_speed(xy, speed, blocker, jv))
    assert float(TSG.get_safeguard_speed(txy, tsp, tbl, torch.ones(1, dtype=torch.bool)
                                         ).max()) < 10.0


def _rule_tick_j(st, cfg):
    m = ML.to_multilane_state(st, cfg)
    lane, speed = LU.lateral_decision(m)
    st2, r, done = ML.step(st, lane, speed, cfg)
    return st2, (lane, speed, r, done)


def test_multilane_env_rule_policy_drives():
    """The §3.3 field loop (env -> MultiLaneState -> LaneUtility -> env)
    for the contract's three episodes, 200 ticks, both packages from
    JAX's reset states."""
    keys = jnp.stack([jax.random.PRNGKey(s) for s in range(3)])
    st_j = jax.vmap(lambda k: ML.reset(k, CFG))(keys)
    st_t = interop.multilane_env_state_from_numpy(jax.device_get(st_j), CPU,
                                                  F64)
    tick = jax.jit(jax.vmap(lambda s: _rule_tick_j(s, CFG)))
    ended = np.zeros(3, bool)
    for _ in range(CFG.max_steps):
        st_j, (lane_j, speed_j, r_j, done_j) = tick(st_j)
        m = TML.to_multilane_state(st_t, TCFG)
        lane, speed = TLU.lateral_decision(m)
        st_t, r, done = TML.step(st_t, lane, speed, TCFG)
        live = ~ended
        np.testing.assert_array_equal(lane.numpy()[live],
                                      np.asarray(lane_j)[live])
        np.testing.assert_array_equal(done.numpy()[live],
                                      np.asarray(done_j)[live])
        close(speed.numpy()[live], np.asarray(speed_j)[live])
        close(st_t.ego_s.numpy()[live], np.asarray(st_j.ego_s)[live])
        ended |= done.numpy()
    # the rule policy makes forward progress without constant collisions
    assert (st_t.ego_s.numpy() > 100.0).any()


def test_multilane_env_batched_with_rls_decision():
    B = 8
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    st_j = jax.vmap(lambda k: ML.reset(k, CFG))(keys)
    sk = jax.random.split(jax.random.PRNGKey(1), B)

    def one(st, a, k):
        m = ML.to_multilane_state(st, CFG)
        d = DEC.decision_from_discrete_action(m, a)
        return ML.step_autoreset(st, d.target_lane_index, d.target_speed, k,
                                 CFG)

    st2_j, r_j, done_j = jax.jit(jax.vmap(one))(
        st_j, jnp.zeros((B,), jnp.int32), sk)
    obs_j = jax.vmap(lambda st: DEC.wrap_state(ML.to_multilane_state(st, CFG)))(
        st2_j)

    st_t = interop.multilane_env_state_from_numpy(jax.device_get(st_j), CPU,
                                                  F64)
    fresh = interop.multilane_env_state_from_numpy(
        jax.device_get(jax.vmap(lambda k: ML.reset(k, CFG))(sk)), CPU, F64)
    m = TML.to_multilane_state(st_t, TCFG)
    d = TDEC.decision_from_discrete_action(m, torch.zeros(B, dtype=torch.int32))
    st2, r, done = TML.step_autoreset(st_t, d.target_lane_index,
                                      d.target_speed, None, TCFG, fresh=fresh)
    obs = TDEC.wrap_state(TML.to_multilane_state(st2, TCFG))
    assert obs.shape == (B, 20) and torch.isfinite(obs).all()
    np.testing.assert_array_equal(done.numpy(), np.asarray(done_j))
    close(r, r_j)
    close(obs, obs_j)


def test_interop_carries_env_state_and_world_model():
    """``multilane_env_state_from_numpy`` and ``multilane_state_from_numpy``
    carry every field of JAX's vmapped state across: values, with the
    integer and boolean fields kept as such."""
    st_j, st_t = _reset_pair(3, 4)
    st_j, _ = jax.vmap(lambda s: _rule_tick_j(s, CFG))(st_j)
    st_t = interop.multilane_env_state_from_numpy(jax.device_get(st_j), CPU)
    assert st_t.step_count.dtype == torch.int32
    assert st_t.done.dtype == st_t.left_road.dtype == torch.bool
    for f in TML.MultiLaneEnvState._fields:
        got = getattr(st_t, f).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(getattr(st_j, f)).astype(got.dtype), err_msg=f)
    m_j = jax.vmap(lambda s: ML.to_multilane_state(s, CFG))(st_j)
    m_t = port(m_j)
    assert m_t.front.exists.dtype == torch.bool and m_t.num_lanes == 2
    assert m_t.front.s.shape == (4, 2)
    np.testing.assert_array_equal(TDEC.wrap_state(m_t).numpy(),
                                  np.asarray(jax.vmap(DEC.wrap_state)(m_j)))


# ---------------------------------------------------------------------------
# The port's hazards
# ---------------------------------------------------------------------------


def test_pow4_is_xlas_integer_power():
    """``x ** 4`` in XLA is (x*x)*(x*x); ``pow4`` gives its bits in f32
    (``torch.pow(x, 4)`` rounds otherwise in about half the inputs)."""
    x = np.random.default_rng(0).uniform(0.0, 3.0, 100_000).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v: v ** 4)(jnp.asarray(x)))
    np.testing.assert_array_equal(TIDM.pow4(torch.as_tensor(x)).numpy(), ref)
    np.testing.assert_array_equal(
        TIDM.pow4(torch.as_tensor(x)).numpy(), np.asarray(jnp.asarray(x) ** 4))


@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_safeguard_scales_are_jax_linspace_bits(dt):
    ref = np.asarray(jnp.linspace(1.0, 1.0 / 8, 8, dtype=getattr(jnp, dt)))
    got = np.asarray(TSG.SCALES[getattr(torch, dt)], dtype=ref.dtype)
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def test_safeguard_takes_the_first_safe_scale():
    """Full speed conflicts, a slower scale clears the reachable set: the
    bool mask's first True picks it (``torch.argmax`` takes no bool).
    Also a crawl that conflicts at every scale -> 0."""
    T = 20
    xy = jnp.stack([jnp.linspace(0, 60, T), jnp.zeros(T)], axis=1)
    speed = jnp.full((T,), 12.0)
    # a crossing obstacle that reaches the path late: slow arrivals pass
    # behind it... and one sitting on the path
    crossing = jnp.asarray([[40.0, -20.0, 0.0, 6.0, 1.57]])
    sitting = jnp.asarray([[10.0, 0.0, 0.0, 0.0, 0.0]])
    for obst in (crossing, sitting):
        ok = jnp.ones((1,), bool)
        ref = SG.get_safeguard_speed(xy, speed, obst, ok)
        got = TSG.get_safeguard_speed(torch.as_tensor(np.array(xy)),
                                      torch.as_tensor(np.array(speed)),
                                      torch.as_tensor(np.array(obst)),
                                      torch.ones(1, dtype=torch.bool))
        close(got, ref)
    assert 0.0 < float(got.max()) or float(np.asarray(ref).max()) == 0.0
    scale_c = float(TSG.get_safeguard_speed(
        torch.as_tensor(np.array(xy)), torch.as_tensor(np.array(speed)),
        torch.as_tensor(np.array(crossing)),
        torch.ones(1, dtype=torch.bool))[0]) / 12.0
    assert 0.0 < scale_c < 1.0


@pytest.mark.parametrize("ego_lane", [0.5, 1.5, 0.49, 2.5])
def test_round_half_to_even_lane_index(ego_lane):
    m = make_mmap(ego_lane=ego_lane, ego_speed=10.0,
                  front_exists=(True, True), front_s=(12.0, 40.0),
                  front_v=(2.0, 12.0))
    pm = port(m)
    assert int(TLU.generate_lane_change_index(pm)) \
        == int(LU.generate_lane_change_index(m))
    for a in range(8):
        d = TDEC.decision_from_discrete_action(pm, i(a))
        dj = DEC.decision_from_discrete_action(m, jnp.asarray(a))
        assert int(d.target_lane_index) == int(dj.target_lane_index)
        close(d.target_speed, dj.target_speed)


def test_locate_objects_matches_jax():
    rng = np.random.default_rng(1)
    K = 6
    obj = dict(obj_s=rng.uniform(-80, 80, K), obj_lane=rng.uniform(-0.6, 2.4, K),
               obj_vs=rng.uniform(0, 20, K), obj_vd=rng.uniform(-1, 1, K),
               obj_valid=rng.random(K) < 0.8)
    front_j, rear_j = JMUL.locate_objects(
        3, jnp.asarray(5.0), jnp.asarray(1.0),
        **{k: jnp.asarray(v) for k, v in obj.items()})
    front, rear = TMUL.locate_objects(
        3, torch.tensor(5.0, dtype=F64), torch.tensor(1.0, dtype=F64),
        **{k: torch.as_tensor(v) for k, v in obj.items()})
    for got, ref in ((front, front_j), (rear, rear_j)):
        np.testing.assert_array_equal(got.exists.numpy(), np.asarray(ref.exists))
        for f in ("s", "d", "vs", "vd"):
            close(getattr(got, f), getattr(ref, f))
    assert front.exists.any() and rear.exists.any()


# ---------------------------------------------------------------------------
# The gated lane tick and the slice as a whole
# ---------------------------------------------------------------------------


def _reset_pair(seed, B):
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    st_j = jax.vmap(lambda k: ML.reset(k, CFG))(keys)
    return st_j, interop.multilane_env_state_from_numpy(
        jax.device_get(st_j), CPU, F64)


@pytest.fixture(scope="module")
def lane_store():
    """A store of wrap_state keys from the gated loop's 16 envs, rule
    driven for 40 ticks, with random actions and values that make the
    rule action (0) look poor and the higher actions better: the gate
    has something to find."""
    st_j, _ = _reset_pair(7, 16)
    rule = jax.jit(jax.vmap(lambda s: _rule_tick_j(s, CFG)))
    obs = []
    for _ in range(40):
        obs.append(np.asarray(jax.vmap(
            lambda s: DEC.wrap_state(ML.to_multilane_state(s, CFG)))(st_j)))
        st_j, _ = rule(st_j)
    obs = np.concatenate(obs).astype(np.float32)               # [640, 20]
    rng = np.random.default_rng(2)
    n = 4096
    rows = obs[rng.integers(0, len(obs), n)]
    act = rng.integers(0, 8, n).astype(np.float32)
    keys = np.concatenate([rows, act[:, None]], 1)
    vals = (-1.0 + 0.3 * act + 0.2 * rng.normal(size=n)).astype(np.float32)
    mask = np.ones(n, bool)
    j_store = JST.store_insert(JST.store_init(n, 21), jnp.asarray(keys),
                               jnp.asarray(act), jnp.asarray(vals),
                               jnp.asarray(mask))
    t_store = ST.store_insert(ST.store_init(n, 21, device="cpu"), torch.as_tensor(keys),
                              torch.as_tensor(act), torch.as_tensor(vals),
                              torch.as_tensor(mask))
    return j_store, t_store, obs


def test_all_action_stats_matches_jax(lane_store):
    j_store, t_store, obs = lane_store
    np.testing.assert_array_equal(t_store.keys.numpy(), np.asarray(j_store.keys))
    q = obs[::40].astype(np.float64)
    sj = JRLS.all_action_stats(j_store, jnp.asarray(q), jnp.asarray(HW), 8)
    st = RLS.all_action_stats(t_store, torch.as_tensor(q),
                              torch.as_tensor(HW), 8)
    np.testing.assert_array_equal(st.count.numpy(), np.asarray(sj.count))
    for f in ("mean", "var"):
        close(getattr(st, f), getattr(sj, f))
    assert (st.count.numpy() > 0).mean() > 0.5
    np.testing.assert_array_equal(RLS.act_test(st, StoreConfig()).numpy(),
                                  np.asarray(JRLS.act_test(sj, JStoreConfig())))


def test_sorted_plain_matches_jax_interpret_at_d21(lane_store):
    """The kernel's plain route (``box_query_moments_sorted`` on CPU
    tensors) against JAX's Pallas sorted-band kernel in interpret mode:
    64 queries (8 envs x 8 actions) x 1,024 lane-state rows."""
    j_store, t_store, obs = lane_store
    keys = np.array(j_store.keys)[:1024]
    vals = np.array(j_store.values)[:1024]
    valid = np.ones(1024, bool)
    q = np.asarray(JRLS.candidate_keys(jnp.asarray(obs[::16]), 8)
                   ).reshape(-1, 21).astype(np.float32)
    ref = np.asarray(j_sorted(jnp.asarray(keys), jnp.asarray(vals),
                              jnp.asarray(valid), jnp.asarray(q),
                              jnp.asarray(HW), interpret=True))
    got = box_query_moments_sorted(*(torch.as_tensor(a) for a in
                                     (keys, vals, valid, q, HW)))
    np.testing.assert_array_equal(got[:, 0].numpy(), ref[:, 0])
    np.testing.assert_allclose(got[:, 1:].numpy(), ref[:, 1:], rtol=1e-4,
                               atol=1e-3)
    assert (ref[:, 0] > 0).any()


def _compare_states(st_t, st_j):
    for f in TML.MultiLaneEnvState._fields:
        got, ref = getattr(st_t, f).numpy(), np.asarray(getattr(st_j, f))
        if got.dtype.kind in "bi":
            np.testing.assert_array_equal(got, ref, err_msg=f)
        else:
            np.testing.assert_allclose(got, ref, err_msg=f, **TOL)


@pytest.mark.parametrize("gated", [False, True], ids=["rule", "gated"])
def test_lane_loop_matches_jax(lane_store, gated):
    """16 envs x 40 ticks of the rule loop (to_multilane_state ->
    lateral_decision -> step_autoreset) or of the gated loop (wrap_state
    -> all_action_stats -> act_test -> decision_from_discrete_action ->
    step_autoreset) against a fixed store, both packages from the same
    state with JAX's reset draws."""
    j_store, t_store, _ = lane_store
    B, T = 16, 40
    st_j, st_t = _reset_pair(7, B)
    hw_j, hw_t = jnp.asarray(HW), torch.as_tensor(HW)

    def tick_j(st, keys):
        m = jax.vmap(lambda s: ML.to_multilane_state(s, CFG))(st)
        if gated:
            obs = jax.vmap(DEC.wrap_state)(m)
            a = JRLS.act_test(JRLS.all_action_stats(j_store, obs, hw_j, 8),
                              JStoreConfig())
            d = jax.vmap(DEC.decision_from_discrete_action)(m, a)
            lane, speed = d.target_lane_index, d.target_speed
        else:
            a = jnp.zeros((B,), jnp.int32)
            lane, speed = jax.vmap(LU.lateral_decision)(m)
        st2, r, done = jax.vmap(
            lambda s, l, v, k: ML.step_autoreset(s, l, v, k, CFG))(
                st, lane, speed, keys)
        fresh = jax.vmap(lambda k: ML.reset(k, CFG))(keys)
        return st2, (a, lane, speed, r, done), fresh

    tick_j = jax.jit(tick_j)
    acts, ended = [], 0
    for t in range(T):
        keys = jax.random.split(jax.random.PRNGKey(100 + t), B)
        st_j, (a_j, lane_j, speed_j, r_j, done_j), fresh_j = tick_j(st_j, keys)
        m = TML.to_multilane_state(st_t, TCFG)
        if gated:
            a = RLS.act_test(RLS.all_action_stats(
                t_store, TDEC.wrap_state(m), hw_t, 8), StoreConfig())
            d = TDEC.decision_from_discrete_action(m, a)
            lane, speed = d.target_lane_index, d.target_speed
            np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))
            acts.append(a.numpy())
        else:
            lane, speed = TLU.lateral_decision(m)
        fresh = interop.multilane_env_state_from_numpy(
            jax.device_get(fresh_j), CPU, F64)
        st_t, r, done = TML.step_autoreset(st_t, lane, speed, None, TCFG,
                                           fresh=fresh)
        np.testing.assert_array_equal(lane.numpy(), np.asarray(lane_j))
        np.testing.assert_array_equal(done.numpy(), np.asarray(done_j))
        close(speed, speed_j)
        close(r, r_j)
        _compare_states(st_t, st_j)
        ended += int(done.sum())
    assert ended > 0                   # the auto-reset draws entered
    if gated:
        assert (np.stack(acts) > 0).any()   # the gate let a candidate act


def test_chip_smoke_lane_and_field_phases_rehearse_on_cpu(capsys):
    """``chip_smoke.py``'s ``lane`` and ``field`` phases at a tiny size on
    the CPU (the gate through the kernel's plain version, no launch
    counted): every check in them passes and each prints its line."""
    import importlib.util
    from pathlib import Path

    from dcarl_tpu_torch.ops import _cuda, store_kernels as sk

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    cpu = torch.device("cpu")
    lane = cs.lane_phase(sk, _cuda, "cpu", cpu, dict(
        rule_envs=64, rule_ticks=40, fill_envs=128, fill_ticks=48,
        capacity=4096, gate_envs=256, gate_ticks=4, check_envs=256))
    cs.field_phase("cpu", cpu, dict(egos=48, objects=8, ticks=6, window=256,
                                    check_egos=16, check_every=3, hd_egos=32))
    out = capsys.readouterr().out
    assert "[lane] " in out and "[field] " in out
    assert lane["launches"] == 0 and lane["max_abs_err"] == 0.0
