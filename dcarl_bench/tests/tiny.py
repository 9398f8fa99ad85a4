"""Cells of the benchmark cut to a size the CPU runs in seconds: the
same entries, configurations and checks, with the traffic's sizes
shrunk."""

from __future__ import annotations

import dataclasses
import time

import torch

from dcarl_bench import spec

TINY = {
    "gated_fleet": dict(
        envs=32, ticks_per_call=4, store_rows=2048,
        fill=dict(seed=7, envs=16, steps=40, replay_rows=256,
                  backfill_budget=64),
        warmup_calls=1, compare=dict(calls=2, within_first_calls=3, envs=8),
        trace=dict(first_call=1, calls=1)),
    "trainer": dict(
        envs=32, steps_per_call=3, store_rows=1024, replay_rows=512,
        backfill_budget=64, warmup_calls=40,
        compare=dict(calls=2, within_first_calls=3, envs=8),
        trace=dict(first_call=1, calls=1)),
}
SEED = 12345678901


def cell(name: str) -> spec.Cell:
    c = spec.load_cell(name)
    return dataclasses.replace(c, traffic=dict(c.traffic,
                                               **TINY[c.config["entry"]]))


def run(name: str, seed: int = SEED, trace: bool = False,
        control: str = "") -> dict:
    """One CPU run of the tiny cell ``name``: the result line's dict."""
    c = cell(name)
    return spec.entry_module(c.config["entry"]).run(
        c, seed, 0.05, trace, torch.device("cpu"), time.perf_counter(),
        control)
