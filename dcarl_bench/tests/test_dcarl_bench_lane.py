"""The lane cell's entry at a tiny size on the CPU: the port agrees with
the plain reference, traced or not, on the same calls; the control, a
shut gate and each fault planted in the port come out not correct."""

from __future__ import annotations

import dataclasses
import time

import pytest
import torch

from dcarl_bench import spec

CELL = "lane-gated-65k"
TINY = dict(envs=96, ticks_per_call=2, store_rows=8192,
            fill=dict(seed=7, envs=1024, ticks=16), warmup_calls=1,
            compare=dict(calls=2, within_first_calls=3, envs=48),
            trace=dict(first_call=1, calls=1))
SEED = 12345678901
# a gate that the tiny store's few matches open (one visit each, and a
# tie in means passes), so that the tiny cell compares decisions that
# left the rule
TINY_GATE = dict(visited_times_thres=1, rl_visited_times_min=1,
                 confidence_thres=0.4)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cell() -> spec.Cell:
    c = spec.load_cell(CELL)
    return dataclasses.replace(c, traffic=dict(c.traffic, **TINY))


def _run(trace: bool = False, control: str = "", **store) -> dict:
    c = _cell()
    c = dataclasses.replace(c, config=dict(c.config, store=dict(
        c.config["store"], **TINY_GATE, **store)))
    return spec.entry_module(c.config["entry"]).run(
        c, SEED, 0.05, trace, torch.device("cpu"), time.perf_counter(),
        control)


def test_port_agrees_with_reference_traced_or_not():
    from dcarl_tpu_torch.utils import profiling

    plain, traced = _run(), _run(trace=True)
    assert not profiling.enabled()          # the entry switched it back
    for line in (plain, traced):
        assert line["correct"], line["checks"]
        assert list(line)[-1] == "checks"
    s = plain["sample"]
    assert s["calls"] == traced["sample"]["calls"] == spec.compared_calls(
        SEED, _cell().traffic)
    assert s["envs"] == 2 * 48 and s["matched_pairs"] > 0
    e2e = {m["name"] for m in spec.load_cell(CELL).end_to_end}
    assert set(plain["metrics"]) == e2e
    assert all(v["value"] > 0 for v in plain["metrics"].values())
    assert set(traced["metrics"]) <= {m["name"] for m in
                                      spec.load_cell(CELL).per_layer}
    assert traced["metrics"]["store_fill_s.lane"]["value"] > 0
    assert s["gate_fired"] >= 1


def test_shut_gate_is_not_correct():
    """A gate that always keeps the rule agrees with the reference's on
    every decision, and still fails: it fired on none."""
    line = _run(rule_good_thres=-1e9)
    failed = [k for k, c in line["checks"].items() if not spec.holds(c)]
    assert failed == ["gate_fired"], line["checks"]


def test_control_is_not_correct():
    """The reference computed in TF32, in the port's place, fails."""
    line = _run(control="tf32")
    assert not line["correct"]
    failed = [k for k, c in line["checks"].items() if not spec.holds(c)]
    assert failed and "compared" not in failed


def _action_shifted():
    from dcarl_tpu_torch.core import rls

    orig = rls.candidate_keys

    def candidate_keys(obs, num_actions):
        k = orig(obs, num_actions).clone()
        k[..., -1] += 1.0
        return k
    return rls, "candidate_keys", candidate_keys


def _front_block_at_defaults():
    from dcarl_tpu_torch.planning import decision

    orig = decision.wrap_state

    def wrap_state(m):
        obs = orig(m).clone()
        obs[..., 8:12] = torch.tensor([50.0, 1.0, 20.0, 0.0])  # lane 1 ahead
        return obs
    return decision, "wrap_state", wrap_state


def _state_unchanged():
    from dcarl_tpu_torch.env import multilane_env

    def step_autoreset(st, lane, speed, generator, cfg, fresh=None):
        zero = torch.zeros_like(st.ego_s)
        return st, zero, zero.bool()
    return multilane_env, "step_autoreset", step_autoreset


FAULTS = {"action column shifted by one": _action_shifted,
          "lane 1's front block at its defaults": _front_block_at_defaults,
          "state unchanged": _state_unchanged}


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(fault, monkeypatch):
    obj, attr, broken = FAULTS[fault]()
    monkeypatch.setattr(obj, attr, broken)
    line = _run()
    assert not line["correct"], (fault, line["checks"])
