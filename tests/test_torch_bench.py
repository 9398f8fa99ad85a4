"""The port's benchmark (``dcarl_tpu_torch/bench.py``) against the JAX
package's (``bench.py``), on the CPU at the JAX bench's CPU smoke widths.

The JSON line keeps the keys of the JAX line (read from ``bench.py`` by
``ast``), with ``pallas_parity_checked`` renamed ``kernel_parity_checked``
and ``device`` added; the store query's inputs are the JAX bench's draws
and its moments equal JAX's oracle (counts exact, sums rtol 1e-4 / atol
1e-3, the bench's own tolerance); a wrong moment from either timed query
raises.
"""

import ast
import contextlib
import io
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.core.store import FIELD_HALF_WIDTHS, _raw_moments
from dcarl_tpu_torch import bench
from dcarl_tpu_torch.ops import store_kernels

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
RATES = ("value", "confidence_evals_per_s", "train_env_steps_per_s",
         "gated_env_steps_per_s")


def _jax_line_keys():
    """Keys of the dict that ``bench.py``'s ``main`` prints, in order."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    call = next(n for n in ast.walk(main) if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute) and n.func.attr == "dumps")
    return [k.value for k in call.args[0].keys]


@pytest.fixture(scope="module")
def cpu_line():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--device", "cpu"])
    return rc, out.getvalue().splitlines()


def test_bench_prints_one_line_with_the_jax_keys(cpu_line):
    rc, lines = cpu_line
    assert rc == 0 and len(lines) == 1
    line = json.loads(lines[0])
    want = ["kernel_parity_checked" if k == "pallas_parity_checked" else k
            for k in _jax_line_keys()] + ["device"]
    assert list(line) == want
    assert line["vs_baseline"] is None and line["device"] is None
    assert line["backend"] == "cpu" and line["kernel_parity_checked"] is False
    w = bench.CPU_WIDTHS
    assert (line["confidence_store_rows"], line["train_batch"],
            line["train_store_rows"], line["gated_batch"],
            line["gated_store_rows"], line["env_batch"]) == (
        w["store_rows"], w["train_batch"], w["train_store"],
        w["gated_batch"], w["gated_rows"], w["batch"])
    for key in RATES:
        assert math.isfinite(line[key]) and line[key] > 0, key


def test_bench_widths_are_the_jax_benchs():
    """The card's and the CPU's widths are ``bench.py:260-268``'s."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    branch = next(n for n in ast.walk(main) if isinstance(n, ast.If)
                  and "backend" in ast.unparse(n.test))
    names = ("batch", "steps", "store_rows", "store_queries", "train_batch",
             "train_steps", "train_store", "gated_batch", "gated_steps",
             "gated_rows")

    def widths(body):
        vals = []
        for stmt in body:
            vals += [eval(ast.unparse(e)) for e in stmt.value.elts]
        return dict(zip(names, vals))

    assert widths(branch.body) == bench.CARD_WIDTHS
    assert widths(branch.orelse) == bench.CPU_WIDTHS


def _jax_confidence_inputs(n_rows, n_queries):
    """``bench.py:72-82`` as the JAX bench draws them."""
    rng = np.random.default_rng(0)
    d = len(FIELD_HALF_WIDTHS)
    keys = jnp.asarray(rng.normal(0, 5, (n_rows, d)), jnp.float32)
    keys = keys.at[:, -1].set(
        jnp.asarray(rng.integers(0, 8, n_rows), jnp.float32))
    values = jnp.asarray(rng.normal(0, 1, n_rows), jnp.float32)
    valid = jnp.ones((n_rows,), bool)
    queries = jnp.asarray(rng.normal(0, 5, (n_queries, d)), jnp.float32)
    queries = queries.at[:, -1].set(
        jnp.asarray(rng.integers(0, 8, n_queries), jnp.float32))
    w = jnp.asarray(FIELD_HALF_WIDTHS, jnp.float32)
    return keys, values, valid, queries, w


def test_confidence_query_matches_the_jax_oracle():
    """The bench's store query inputs are the JAX bench's draws, and the
    timed query (its plain version here) gives JAX's oracle moments:
    counts exact, sums rtol 1e-4 / atol 1e-3.  The bench's random queries
    meet no row (in JAX too), so queries next to stored rows are held to
    the oracle as well."""
    w = bench.CPU_WIDTHS
    ours = bench.confidence_inputs(w["store_rows"], w["store_queries"])
    theirs = _jax_confidence_inputs(w["store_rows"], w["store_queries"])
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, np.asarray(b))
    keys, values, valid, queries, hw = ours
    near = keys[:128] + np.float32(0.05)
    near[:, -1] = keys[:128, -1]
    for q in (queries, near):
        got = store_kernels.box_query_moments_sorted(
            *(torch.as_tensor(a) for a in (keys, values, valid, q, hw)))
        ref = np.asarray(_raw_moments(theirs[0], theirs[1], theirs[2],
                                      jnp.asarray(q), theirs[4]))
        np.testing.assert_array_equal(got.numpy()[:, 0], ref[:, 0])
        np.testing.assert_allclose(got.numpy()[:, 1:], ref[:, 1:],
                                   rtol=1e-4, atol=1e-3)
    assert ref[:, 0].min() >= 1


def _perturbed(fn):
    def wrong(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[..., 1] += 1.0
        return out
    return wrong


def test_store_query_parity_is_a_hard_failure(monkeypatch):
    monkeypatch.setattr(store_kernels, "box_query_moments_sorted",
                        _perturbed(store_kernels.box_query_moments_sorted))
    with pytest.raises(RuntimeError, match="sums differ"):
        bench.bench_confidence_evals(1024, 64, CPU, repeats=1)


def test_peraction_parity_is_a_hard_failure(monkeypatch):
    monkeypatch.setattr(store_kernels, "box_query_moments_peraction",
                        _perturbed(store_kernels.box_query_moments_peraction))
    with pytest.raises(RuntimeError, match="sums differ"):
        bench.bench_gated_steps(8, 1, 1024, CPU, repeats=1)


def test_trainer_store_is_the_first_rows_of_the_ring():
    init_t, _, run_t = bench.trainer_store_fill(256, 8, 40, CPU)
    state, _ = run_t(init_t(bench.FILL_SEED),
                     torch.Generator().manual_seed(bench.FILL_SEED + 1))
    keys, vals, valid = bench.trainer_store(state, 256)
    n = int(state.store_size[0])
    assert 0 < n <= 256 and int(valid.sum()) == n and bool(valid[:n].all())
    assert keys.shape == (256, 21) and vals.shape == (256,)
