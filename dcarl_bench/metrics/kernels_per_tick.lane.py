"""Kernels a replayed lane tick ran, from the traced replays (kernels
matched to their graph launch), the harness's probes included."""

from dcarl_bench.metrics._replays import kernels_per_replay


def read(m):
    return kernels_per_replay(m)
