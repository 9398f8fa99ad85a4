"""Carry state across from the JAX package.

The drivers' state is the env carry, the confidence store and the
reference-path tables; the trainers add trajectory buffers, act-hold
segments, a trust set, a replay buffer and the learner (a flax
Q-network and its optax Adam state).  The lane-level field stack adds
the multilane env's state (its reset draws included), the multilane
world model and the static local map; the agent session
(``bridge/agent_session.py``) an n-step trajectory window.
These helpers take that state as numpy arrays (``np.asarray`` of each
JAX array, or nested mappings of them; this module never imports JAX)
and return the port's tensors on a given device, or load them into the
port's modules, so both packages can start from the same state.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dcarl_tpu_torch.cognition.locator import StaticLocalMap
from dcarl_tpu_torch.core.rls import TrajectoryBuffer
from dcarl_tpu_torch.core.store import ConfidenceStore
from dcarl_tpu_torch.device import resolve_device
from dcarl_tpu_torch.env import driving_env as de
from dcarl_tpu_torch.env.multilane_env import MultiLaneEnvState
from dcarl_tpu_torch.models.networks import AttentionQNet
from dcarl_tpu_torch.models.replay import Replay
from dcarl_tpu_torch.planning.fast_rollout import FastEnvState, RefTables
from dcarl_tpu_torch.planning.multilane import LaneVehicle, MultiLaneState

_INT_FIELDS = ("stuck_steps", "step_count")
_BOOL_FIELDS = ("done", "collided", "passed", "stuck", "left_road",
                "exists", "traffic_light_stop", "stop_thru")


def _fields(src: Any) -> Mapping[str, Any]:
    """A NamedTuple (``_asdict``) or a mapping, by field name."""
    return src._asdict() if hasattr(src, "_asdict") else src


def _to(a, device, dt) -> torch.Tensor:
    return torch.as_tensor(np.array(np.asarray(a))).to(device, dt)


def fast_env_state_from_numpy(src: Any, device, dtype=torch.float32
                              ) -> FastEnvState:
    """The lane-major carry of the JAX drivers' ``init_fn``/``run_fn``
    (``dcarl_tpu.planning.fast_rollout.FastEnvState``, any object with
    its fields) as the port's FastEnvState on ``device``."""
    return FastEnvState(*_state_fields(_fields(src), FastEnvState._fields,
                                       device, dtype))


def env_state_from_numpy(src: Any, device, dtype=torch.float32
                         ) -> de.EnvState:
    """The JAX package's vmapped ``EnvState`` (every field with the env
    batch leading; any object with its fields) as the port's batch-first
    ``driving_env.EnvState`` on ``device``."""
    return de.EnvState(*_state_fields(_fields(src), de.EnvState._fields,
                                      device, dtype))


def _state_fields(f, names, device, dtype) -> Iterator[torch.Tensor]:
    for name in names:
        a = np.asarray(f[name])
        if name in _INT_FIELDS:
            t = torch.as_tensor(a.astype(np.int32))
        elif name in _BOOL_FIELDS:
            t = torch.as_tensor(a.astype(bool))
        else:
            t = torch.as_tensor(np.array(a)).to(dtype)
        yield t.to(device)


def multilane_env_state_from_numpy(src: Any, device, dtype=torch.float32
                                   ) -> MultiLaneEnvState:
    """The JAX package's vmapped ``multilane_env.MultiLaneEnvState`` (every
    field with the env batch leading) as the port's on ``device``; a
    vmapped ``reset(keys)`` carried this way is JAX's reset draws, which
    ``multilane_env.step_autoreset`` takes as ``fresh``."""
    return MultiLaneEnvState(*_state_fields(
        _fields(src), MultiLaneEnvState._fields, device, dtype))


def multilane_state_from_numpy(src: Any, device, dtype=torch.float32
                               ) -> MultiLaneState:
    """A ``planning.multilane.MultiLaneState`` (the mmap, front and rear
    ``LaneVehicle`` included, any leading batch dims) as the port's."""
    f = _fields(src)
    lanes = {side: LaneVehicle(*_state_fields(
        _fields(f[side]), LaneVehicle._fields, device, dtype))
        for side in ("front", "rear")}
    rest = [n for n in MultiLaneState._fields if n not in lanes]
    return MultiLaneState(**lanes, **dict(zip(
        rest, _state_fields(f, rest, device, dtype))))


def static_local_map_from_numpy(src: Any, device, dtype=torch.float32
                                ) -> StaticLocalMap:
    """A ``cognition.locator.StaticLocalMap`` as the port's (the target
    lane index as i64)."""
    f = _fields(src)
    lanes, tangents, speed_limit, stop_thru = _state_fields(
        f, ("lanes", "tangents", "speed_limit", "stop_thru"), device, dtype)
    return StaticLocalMap(lanes, tangents, speed_limit, stop_thru,
                          _to(f["target_lane_index"], device, torch.int64))


def store_from_numpy(keys, values, valid, device
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A store's (keys [N, D] f32, values [N] f32, valid [N] bool)."""
    keys = np.asarray(keys)
    values = np.asarray(values)
    valid = np.asarray(valid)
    if keys.ndim != 2 or values.shape != keys.shape[:1] \
            or valid.shape != keys.shape[:1]:
        raise ValueError(f"keys [N, D], values [N], valid [N] expected; got "
                         f"{keys.shape}, {values.shape}, {valid.shape}")
    return (torch.as_tensor(keys, dtype=torch.float32, device=device),
            torch.as_tensor(values, dtype=torch.float32, device=device),
            torch.as_tensor(valid.astype(bool), device=device))


def ref_tables_from_numpy(src: Any) -> RefTables:
    """The JAX package's ``RefTables`` (host float64 arrays) as the
    port's host tables; ``fast_rollout.tables_to`` makes device copies."""
    f = _fields(src)
    return RefTables(*(np.asarray(f[name], np.float64)
                       for name in RefTables._fields))


def fast_train_state_from_numpy(src: Any, device, dtype=torch.float32):
    """The JAX ``FastTrainState`` (``dcarl_tpu.train_fast``; any object
    with its fields) as the port's, field by field with the leading shard
    axis kept.  Env, observations, trajectory buffers and store rows take
    ``dtype``; the replay keeps its float32 / int32 layout.  The learner
    fields (``params``, ``target_params``, ``opt_state``) go into the
    port's learner instead: :func:`qnet_from_flax` and
    :func:`adam_state_from_optax`."""
    from dcarl_tpu_torch.train_fast import FastTrainState

    f = _fields(src)
    out = {"env": fast_env_state_from_numpy(f["env"], device, dtype),
           "replay": replay_from_numpy(f["replay"], device),
           "frame": _to(f["frame"], device, torch.int32)}
    for name in ("obs_ori", "traj_obs", "traj_act", "traj_rew",
                 "store_keys", "store_actions", "store_values"):
        out[name] = _to(f[name], device, dtype)
    for name in ("traj_len", "store_size", "store_head", "store_total"):
        out[name] = _to(f[name], device, torch.int32)
    return FastTrainState(**out)


def replay_from_numpy(src: Any, device) -> Replay:
    """A replay buffer (``dcarl_tpu.models.replay.Replay``, any leading
    axes kept): float32 rows, int32 action, size and head."""
    rp = _fields(src)
    return Replay(**{
        name: _to(rp[name], device, torch.int32
                  if name in ("action", "size", "head") else torch.float32)
        for name in Replay._fields})


def traj_buffer_from_numpy(src: Any, device) -> TrajectoryBuffer:
    """One env's n-step window (``dcarl_tpu.core.rls.TrajectoryBuffer``):
    float32 obs, action and reward rows, the int32 length."""
    f = _fields(src)
    return TrajectoryBuffer(**{
        name: _to(f[name], device, torch.int32 if name == "length"
                  else torch.float32)
        for name in TrajectoryBuffer._fields})


def trustset_from_numpy(src: Any, device):
    """A ``dcarl_tpu.models.trustset.TrustSet`` (its store and half-widths)
    as the port's."""
    from dcarl_tpu_torch.models.trustset import TrustSet

    f = _fields(src)
    st = _fields(f["store"])
    store = ConfidenceStore(**{
        name: _to(st[name], device, torch.int32 if name in ("size", "head")
                  else torch.float32) for name in ConfidenceStore._fields})
    return TrustSet(store=store,
                    half_widths=_to(f["half_widths"], device, torch.float32))


def segment_hold_from_numpy(src: Any, device, dtype=torch.float32):
    """A ``dcarl_tpu.models.segment.SegmentHold`` as the port's."""
    from dcarl_tpu_torch.models.segment import SegmentHold

    f = _fields(src)
    kinds = {"length": torch.int32, "action": torch.int32,
             "fresh": torch.bool, "tail": torch.bool}
    return SegmentHold(**{name: _to(f[name], device, kinds.get(name, dtype))
                          for name in SegmentHold._fields})


def trustset_carry_from_numpy(src: Any, learner, device, dtype=torch.float32):
    """The whole carry of the JAX ``make_trustset_trainer`` (its
    ``Carry``: ``env``, ``hold``, ``dqn``, ``ts``) as the port's
    ``TrustsetCarry``; the ``DQNState``'s params, target params and optax
    Adam state go into ``learner`` (the trainer's ``run_fn.learner``)."""
    from dcarl_tpu_torch.models.segment import TrustsetCarry

    f = _fields(src)
    dqn = _fields(f["dqn"])
    qnet_from_flax(dqn["params"], learner.net)
    qnet_from_flax(dqn["target_params"], learner.target_net)
    adam_state_from_optax(dqn["opt_state"], learner.optimizer, learner.net)
    return TrustsetCarry(
        env=fast_env_state_from_numpy(f["env"], device, dtype),
        hold=segment_hold_from_numpy(f["hold"], device, dtype),
        replay=replay_from_numpy(dqn["replay"], device),
        frame=_to(dqn["frame"], device, torch.int32),
        ts=trustset_from_numpy(f["ts"], device),
        warm=True)


_FLAX_LAYERS = (("q_lin",), ("k_lin",), ("v_lin",), ("head", "layers_0"),
                ("head", "layers_2"), ("head", "layers_4"))


def _flax_dense_pairs(tree: Any, net: nn.Module
                      ) -> Iterator[Tuple[Mapping[str, Any], nn.Linear]]:
    """(flax ``Dense`` leaf dict, matching ``nn.Linear``) pairs of a
    Q-network's param tree (with or without the ``params`` level): the
    named layers of ``AttentionQNet``, or ``Dense_0``, ``Dense_1``, ...
    of the ``@nn.compact`` nets in the order of the port net's
    ``dense``."""
    tree = _fields(tree)
    if "params" in tree:
        tree = _fields(tree["params"])
    if isinstance(net, AttentionQNet):
        pairs = zip(_FLAX_LAYERS, (net.q_lin, net.k_lin, net.v_lin,
                                   net.head[0], net.head[2], net.head[4]))
    else:
        pairs = ((("Dense_%d" % i,), lin) for i, lin in enumerate(net.dense))
    for path, mod in pairs:
        node = tree
        for key in path:
            node = _fields(node[key])
        yield node, mod


def qnet_from_flax(params: Any, net: nn.Module) -> nn.Module:
    """Load a flax Q-network's params (``MLPQNet``, ``AttentionQNet``,
    ``DuelingQNet``, ``BootstrapQNet``; or any tree of that layout, such
    as one of Adam's moments) into the port's net of the same kind (in
    place; returns it): a ``Dense`` kernel ``[in, out]`` becomes
    ``weight = kernel.T``."""
    with torch.no_grad():
        for node, lin in _flax_dense_pairs(params, net):
            lin.weight.copy_(torch.as_tensor(np.array(node["kernel"]).T))
            lin.bias.copy_(torch.as_tensor(np.array(node["bias"])))
    return net


def adam_state_from_optax(opt_state: Any,
                          optimizer: "Optional[torch.optim.Adam]",
                          net: Optional[nn.Module], device=None):
    """Load ``optax.adam``'s state ``(count, mu, nu)`` (its
    ``ScaleByAdamState``, alone or first in the chain's tuple) into
    ``optimizer``, a ``torch.optim.Adam`` over ``net``'s parameters, as
    each parameter's (step, exp_avg, exp_avg_sq).

    With ``optimizer=None`` it returns instead the whole optax state as
    the state of the port's functional transform of the same layout
    (``algos.common.adam``, chained or not) on ``device``, the moments
    on ``net``'s parameter dict (``net`` None: one array, as SAC's
    ``log_alpha``)."""
    if optimizer is None:
        return _optax_state(opt_state, net, resolve_device(device))
    st = opt_state
    if not hasattr(st, "mu"):
        st = next(s for s in opt_state if hasattr(s, "mu"))
    step = float(np.asarray(st.count))
    pairs = zip(_flax_dense_pairs(st.mu, net), _flax_dense_pairs(st.nu, net))
    for (mu, lin), (nu, _) in pairs:
        for name, tr in (("kernel", True), ("bias", False)):
            p = lin.weight if tr else lin.bias
            m, v = np.array(mu[name]), np.array(nu[name])
            capturable = optimizer.defaults["capturable"]
            optimizer.state[p] = {
                # torch keeps Adam's step on the host unless capturable;
                # the port's capturable step count is float64 (models/dqn)
                "step": torch.tensor(
                    step, dtype=torch.float64 if capturable
                    else torch.float32,
                    device=p.device if capturable else "cpu"),
                "exp_avg": torch.as_tensor(m.T if tr else m).to(p),
                "exp_avg_sq": torch.as_tensor(v.T if tr else v).to(p)}


# ---------------------------------------------------------------------------
# The algorithm family (``algos/``): flax params, ACKTR's Dense lists and
# the optax states


def algo_params_from_flax(tree: Any, module: nn.Module, device=None
                          ) -> Dict[str, torch.Tensor]:
    """The flax params of an ``algos`` module (``nets``' modules, ACER's
    ``PolicyQNet``, GAIL's ``Adversary``, HER's ``MLP``; with or without
    the ``params`` level; or any tree of that layout, such as one of
    Adam's moments) as the port module's parameter dict on ``device``: a
    ``Dense`` kernel ``[in, out]`` becomes ``weight = kernel.T``, a
    ``log_std`` is copied as it is.  The module's ``FLAX`` (or
    ``flax_key``) names each child's flax node."""
    device = resolve_device(device)
    tree = _fields(tree)
    if "params" in tree:
        tree = _fields(tree["params"])
    out: Dict[str, torch.Tensor] = {}

    def key(mod, name):
        return mod.FLAX[name] if hasattr(mod, "FLAX") else mod.flax_key(name)

    def leaf(a, transpose=False):
        a = np.array(a)
        return torch.as_tensor(a.T if transpose else a).to(device)

    def walk(mod, node, prefix, owner=None):
        """``owner``: the module that names a ModuleList's children."""
        for name, _ in mod.named_parameters(recurse=False):
            out[prefix + name] = leaf(node[key(mod, name)])
        for name, child in mod.named_children():
            if isinstance(child, nn.ModuleList):   # MLP.layers: Dense_<i>
                walk(child, node, prefix + name + ".", owner=mod)
                continue
            k = key(owner or mod, name)
            if isinstance(child, nn.Linear):
                d = _fields(node[k])
                out[prefix + name + ".weight"] = leaf(d["kernel"], True)
                out[prefix + name + ".bias"] = leaf(d["bias"])
            else:
                walk(child, _fields(node[k]), prefix + name + ".")

    walk(module, tree, "")
    return {name: out[name] for name, _ in module.named_parameters()}


def acktr_params_from_numpy(layers: Any, device=None):
    """ACKTR's explicit ``Dense(w [in, out], b)`` list (``acktr.py:62-110``,
    not flax) as the port's, on ``device``."""
    from dcarl_tpu_torch.algos.acktr import Dense

    device = resolve_device(device)
    return [Dense(_to(l.w, device, torch.float32),
                  _to(l.b, device, torch.float32)) for l in layers]


def _optax_state(state: Any, module: Optional[nn.Module], device):
    """An optax state (a chain's nested tuples of ``EmptyState``,
    ``ScaleByAdamState``, ``ScaleByRmsState``, ``ScaleByScheduleState``)
    as the port's transform state of the same layout; the moments follow
    ``module``'s parameter dict (``module`` None: they are one array, as
    SAC's ``log_alpha``)."""
    from dcarl_tpu_torch.algos import common as C

    def moments(tree):
        if module is None:
            return _to(tree, device, torch.float32)
        return algo_params_from_flax(tree, module, device)

    def count(c):
        return _to(c, device, torch.int32)

    kind = type(state).__name__
    if kind == "ScaleByAdamState":
        return C.ScaleByAdamState(count(state.count), moments(state.mu),
                                  moments(state.nu))
    if kind == "ScaleByRmsState":
        return C.ScaleByRmsState(moments(state.nu))
    if kind == "ScaleByScheduleState":
        return C.ScaleByScheduleState(count(state.count))
    if kind == "EmptyState":
        return C.EmptyState()
    if isinstance(state, tuple):
        return tuple(_optax_state(s, module, device) for s in state)
    raise TypeError(f"no port counterpart of optax state {kind}")


def rmsprop_state_from_optax(opt_state: Any, module: Optional[nn.Module],
                             device=None):
    """An optax state holding ``optax.rmsprop``'s (``chain(clip, rmsprop)``
    or alone) as the state of the port's transform of the same layout
    (``algos.common.rmsprop``), its ``nu`` on ``module``'s parameters."""
    device = resolve_device(device)
    return _optax_state(opt_state, module, device)
