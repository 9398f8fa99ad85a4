"""Inputs in the reference's layouts, generated for the tests that run
the entry points without the reference's own files (no JAX here)."""

import os

import numpy as np


def synthetic_scenario(path):
    """A 200-tick field-log scenario (``Field_testing/ScenarioN/``'s five
    text channels): the ego drives 30 m along x, one object 10 m ahead."""
    os.makedirs(path, exist_ok=True)
    t = 1000.0 + np.arange(200) * 0.05
    np.savetxt(os.path.join(path, "control.txt"),
               np.c_[t, np.full_like(t, 5.0),
                     np.where(np.arange(200) % 2, 65536.0 - 100.0, 100.0)])
    np.savetxt(os.path.join(path, "automode.txt"),
               np.c_[t, np.where(np.arange(200) < 50, 1.0, 2.0)])
    x = np.linspace(0, 30, 200)
    np.savetxt(os.path.join(path, "traffic.txt"),
               np.c_[t, np.zeros((200, 2)), x, np.zeros(200),
                     np.zeros((200, 3))])
    np.savetxt(os.path.join(path, "surrounding_obj.txt"),
               np.c_[t, x + 10, np.ones(200), np.zeros((200, 2))])
    np.savetxt(os.path.join(path, "decision.txt"),
               np.c_[t, np.ones(200), np.zeros(200), x, np.zeros(200)])
    return path


def demo_datasets(root, seed=0):
    """``Simulation_testing/Simulation_{1,2}/`` under ``root`` with the
    reference's file names and shapes, drawn as its data sampling draws
    them (Data_Sampling/data_sampling.py): rows [state_idx,
    state_scalar, action_idx, value] around per-state true values."""
    rng = np.random.default_rng(seed)
    for name, states, rows, files in (
            ("Simulation_1", 1, 20000, ("data_carla", "action_value_carla")),
            ("Simulation_2", 20, 25000, ("data", "action_value"))):
        d = os.path.join(root, "Simulation_testing", name)
        os.makedirs(d, exist_ok=True)
        truth = rng.uniform(-50.0, 100.0, (states, 11))
        scalar = rng.uniform(0.0, 1.0, states)
        idx = np.clip(np.floor(rng.normal(3.0, 1.0, rows) / 6.0 * states),
                      0, states - 1).astype(np.int64)
        act = rng.integers(0, 11, rows)
        value = truth[idx, act] + rng.normal(0.0, 50.0, rows)
        data = np.stack([idx, scalar[idx], act, value], 1).astype(np.float64)
        np.save(os.path.join(d, files[0] + ".npy"), data)
        np.save(os.path.join(d, files[1] + ".npy"), truth)
        if states > 1:
            np.save(os.path.join(d, "states.npy"), scalar)
    return root
