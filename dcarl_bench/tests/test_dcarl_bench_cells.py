"""The cells' entries at tiny sizes on the CPU: the port agrees with the
plain reference, and the control and each fault the cell can have come
out not correct."""

from __future__ import annotations

import pytest
import torch

from dcarl_bench import spec
from dcarl_bench.tests import tiny

CELLS = ("fleet-gated-256k", "trainer-32k", "fleet-gated-4m")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", CELLS)
def test_port_agrees_with_reference(name):
    line = tiny.run(name)
    assert line["correct"], line["checks"]
    assert line["checks"]["compared"]["value"] > 0
    assert list(line)[-1] == "checks"
    e2e = {m["name"] for m in spec.load_cell(name).end_to_end}
    assert set(line["metrics"]) == e2e
    assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("name", ("fleet-gated-256k", "trainer-32k"))
def test_sample_holds_matches(name):
    """The compared answers are not all empty: the store holds rows near
    the compared envs."""
    s = tiny.run(name)["sample"]
    assert s.get("matched_triples", s.get("matched_pairs")) > 0


@pytest.mark.parametrize("name", ("fleet-gated-256k", "trainer-32k"))
def test_same_compared_set_traced_or_not(name):
    plain, traced = tiny.run(name), tiny.run(name, trace=True)
    assert plain["sample"]["calls"] == traced["sample"]["calls"]
    assert plain["sample"]["calls"] == spec.compared_calls(
        tiny.SEED, tiny.cell(name).traffic)
    assert traced["correct"]
    assert set(traced["metrics"]) <= {m["name"] for m in
                                      spec.load_cell(name).per_layer}


@pytest.mark.parametrize("name", ("fleet-gated-256k", "trainer-32k"))
def test_control_is_not_correct(name):
    """The reference computed in TF32, in the port's place, fails."""
    line = tiny.run(name, control="tf32")
    assert not line["correct"]
    failed = [k for k, c in line["checks"].items() if not spec.holds(c)]
    assert failed and "compared" not in failed


def _gated_query_fault(kind):
    from dcarl_tpu_torch.ops import store_kernels

    orig = store_kernels.query_peraction_prepared

    def query(prep, queries, out_dtype=torch.float32):
        m = orig(prep, queries, out_dtype=out_dtype).clone()
        if kind == "altered":
            m[:, 0, 0] += 1.0
        else:       # half of the batch left out
            m[m.shape[0] // 2:] = 0.0
        return m
    return store_kernels, "query_peraction_prepared", query


def _gated_state_unchanged():
    from dcarl_tpu_torch.planning import fast_rollout

    def follow(tick, index, n_v, state, *a):
        b = index.shape[0]
        return (state, torch.zeros(b, dtype=tick.obs.dtype),
                torch.zeros(b, dtype=torch.bool))
    return fast_rollout, "_follow", follow


def _trainer_store_unchanged():
    from dcarl_tpu_torch.core import store

    return store, "store_insert", lambda st, *a, **kw: st


def _trainer_record_altered():
    from dcarl_tpu_torch.core import store

    orig = store.store_insert

    def insert(st, keys, actions, values, mask, *a, **kw):
        return orig(st, keys, actions, values + 1.0, mask, *a, **kw)
    return store, "store_insert", insert


def _trainer_half_batch():
    from dcarl_tpu_torch.models import dqn

    orig = dqn.DQN.td_loss

    def td_loss(self, batch, punishment):
        half = batch.obs.shape[0] // 2
        cut = type(batch)(*(f[:half] for f in batch))
        _, prios = orig(self, batch, punishment)
        return orig(self, cut, punishment[:half])[0], prios
    return dqn.DQN, "td_loss", td_loss


def _trainer_learner_unchanged():
    from dcarl_tpu_torch.models import dqn

    def train_on(self, batch, punishment, mesh=None):
        loss, prios = self.td_loss(batch, punishment)
        return loss.detach(), prios
    return dqn.DQN, "train_on", train_on


FAULTS = {
    "fleet-gated-256k": {
        "answer altered": lambda: _gated_query_fault("altered"),
        "half the batch left out": lambda: _gated_query_fault("half"),
        "state unchanged": _gated_state_unchanged,
    },
    "trainer-32k": {
        "store left unchanged": _trainer_store_unchanged,
        "record altered": _trainer_record_altered,
        "half the batch left out": _trainer_half_batch,
        "learner left unchanged": _trainer_learner_unchanged,
    },
}


@pytest.mark.parametrize("name,fault", [(c, f) for c in FAULTS
                                        for f in FAULTS[c]])
def test_fault_is_not_correct(name, fault, monkeypatch):
    """The run with the timed path broken underneath the harness."""
    obj, attr, broken = FAULTS[name][fault]()
    monkeypatch.setattr(obj, attr, broken)
    line = tiny.run(name)
    assert not line["correct"], (fault, line["checks"])
