"""Compiled runs: one captured CUDA graph of a tick, replayed once a tick.

The JAX package compiles each driver's and trainer's run into one device
program, ``jax.jit`` over ``lax.scan(tick)``.  The port's counterpart on
a GPU is :class:`TickRunner`: a tick function is captured once as a CUDA
graph and the graph is replayed ``S`` times a run, so a tick costs one
graph launch from the host instead of a few hundred kernel launches.

The tick is a function ``tick(carry, inputs, generator) -> (carry,
outs)`` of tensor trees (tensors in nested tuples and NamedTuples; other
leaves are constants).  The runner keeps, for each capture:

* static device buffers of the carry and of the run's inputs (a prepared
  store, an offset).  Each run copies the caller's values into them, and
  each tick writes its new carry back into them in place;
* ``[S, ...]`` output buffers, which each tick writes at a device-side
  step index, so no tick needs a host copy;
* the graph, in its own private memory pool.

Captures are cached by what fixes them: the shapes, dtypes and constant
leaves of the carry and the inputs, and ``S``.  A new store of the same
size is copied into the captured buffers, not captured again.  Tensors
outside the carry that the tick updates in place (a learner's weights
and Adam state) are named by ``state()``.  The runner holds them, and it
captures again when they are no longer the tensors it captured.

Randomness stays the caller's stream bit for bit.  The runner's own
generator takes the caller's generator's state, is registered with each
graph (a replay draws what the eager tick would draw from that state),
and hands its state back at the end of the run, so the caller's
generator ends where the eager loop would leave it.

A cache miss runs the run's first tick eagerly on a side stream: the
warm-up a capture needs, which also builds the kernels, fills the
per-device constant caches and creates the cuBLAS handles.  Then it
captures one tick and replays the rest.  A failed capture raises; no run
falls back to the eager loop.

The store kernels' launch counters (``ops._cuda.LAUNCHES``) count at
Python call time, which a replay skips.  The runner takes the launches
recorded during a capture out of the counters (the capture launched
nothing) and adds them back once for every replay.

A maker compiles its run on a CUDA device and without a mesh (gloo
cannot be captured, and NCCL capture is not done yet); elsewhere the
runner runs :func:`run_loop`, the eager loop, which is also the
reference a replayed run is held to bit for bit.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, List, Optional, Sequence

import torch

from dcarl_tpu_torch.ops import _cuda

_TENSOR = "tensor"
_CONST = "const"
# captures a runner keeps, the least recently used dropped first: each
# holds a private memory pool of a tick's intermediates
_MAX_CAPTURES = 2


def _flatten(tree, leaves: list):
    """Append ``tree``'s tensors to ``leaves`` in order; return its spec:
    the structure, each tensor's (shape, dtype, device) and the constant
    leaves, hashable."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return (_TENSOR, tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, tuple):
        return (type(tree), tuple(_flatten(x, leaves) for x in tree))
    return (_CONST, tree)


def _unflatten(spec, leaves):
    """The tree of ``spec`` with its tensors taken from the iterator
    ``leaves``."""
    head = spec[0]
    if head == _TENSOR:
        return next(leaves)
    if head == _CONST:
        return spec[1]
    kids = [_unflatten(s, leaves) for s in spec[1]]
    return head(*kids) if hasattr(head, "_fields") else head(kids)


def run_loop(tick: Callable, carry, inputs, n_steps: int,
             generator: torch.Generator):
    """The eager run: ``n_steps`` ticks in a Python loop, each tick's
    outputs stacked to ``[n_steps, ...]`` (the route off a CUDA device
    or over a mesh, and the reference of the replayed one)."""
    outs = []
    for _ in range(n_steps):
        carry, out = tick(carry, inputs, generator)
        outs.append(out)
    first = outs[0]
    stacked = [torch.stack(f) for f in zip(*outs)]
    return carry, (type(first)(*stacked) if hasattr(first, "_fields")
                   else tuple(stacked))


class _Capture:
    """The static buffers, output buffers and graph of one cache key."""

    def __init__(self, carry: List[torch.Tensor], inputs: List[torch.Tensor],
                 held: List[torch.Tensor], n_steps: int):
        self.carry = carry
        self.inputs = inputs
        self.held = held
        self.grads: List[torch.Tensor] = []
        self.n_steps = n_steps
        self.step = torch.zeros(1, dtype=torch.int64, device=carry[0].device)
        self.storages = {t.untyped_storage().data_ptr() for t in carry}
        self.outs: Optional[List[torch.Tensor]] = None
        self.out_spec = None
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.launches: "collections.Counter[str]" = collections.Counter()
        self.capture_seconds = 0.0
        self.pool_bytes = 0

    def holds(self, state: Sequence[torch.Tensor]) -> bool:
        return len(state) == len(self.held) and all(
            a is b for a, b in zip(state, self.held))


class TickRunner:
    """A maker's run of ``tick``: ``runner(carry, inputs, n_steps,
    generator) -> (carry, outs)``.  ``compiled``: one captured CUDA
    graph replayed a tick; else the eager loop (:func:`run_loop`).

    ``tick(carry, inputs, generator) -> (carry, outs)`` must return a
    carry of the structure, shapes and dtypes it was given and must not
    write into its arguments; it may update the tensors ``state()``
    names in place."""

    def __init__(self, tick: Callable, compiled: bool,
                 state: "Callable[[], Sequence[torch.Tensor]] | None" = None):
        self.tick = tick
        self.compiled = compiled
        self.state = state
        self._captures: "collections.OrderedDict" = collections.OrderedDict()
        self._generator: Optional[torch.Generator] = None
        self._stream: Optional["torch.cuda.Stream"] = None
        self.last: Optional[_Capture] = None

    def __call__(self, carry, inputs, n_steps: int,
                 generator: torch.Generator):
        """``(carry, outs)`` after ``n_steps`` ticks, as :func:`run_loop`
        returns them (fresh tensors the caller owns); ``generator`` ends
        where the eager loop leaves it."""
        if not self.compiled:
            return run_loop(self.tick, carry, inputs, n_steps, generator)
        cap, specs = self._load(carry, inputs, n_steps)
        gen = self._own_generator(generator)
        done = 0
        if cap.graph is None:
            self._warm_up(cap, specs, gen)
            done = 1
            if n_steps > 1:
                self._capture(cap, specs, gen)
        for _ in range(n_steps - done):
            cap.graph.replay()
        for name, n in cap.launches.items():
            _cuda.LAUNCHES[name] += n * (n_steps - done)
        generator.set_state(gen.get_state())
        return self._result(cap, specs)

    # ------------------------------------------------------------------
    def _state(self) -> List[torch.Tensor]:
        return list(self.state()) if self.state is not None else []

    def _load(self, carry, inputs, n_steps: int):
        """The capture of this run's key (made if missing), its static
        buffers holding ``carry`` and ``inputs`` and its step index at 0;
        and the trees' specs."""
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        c_leaves, i_leaves = [], []
        c_spec = _flatten(carry, c_leaves)
        i_spec = _flatten(inputs, i_leaves)
        if not c_leaves:
            raise ValueError("the carry holds no tensor")
        state = self._state()
        key = (c_spec, i_spec, n_steps)
        cap = self._captures.get(key)
        if cap is not None and not cap.holds(state):
            self._drop(key)     # the in-place state was replaced
            cap = None
        if cap is None:
            cap = _Capture([t.clone() for t in c_leaves],
                           [t.clone() for t in i_leaves], state, n_steps)
            self._captures[key] = cap
            while len(self._captures) > _MAX_CAPTURES:
                self._drop(next(iter(self._captures)))
        else:
            for dst, src in zip(cap.carry, c_leaves):
                dst.copy_(src)
            for dst, src in zip(cap.inputs, i_leaves):
                dst.copy_(src)
            cap.step.zero_()
        self._captures.move_to_end(key)
        self.last = cap
        return cap, (c_spec, i_spec)

    @staticmethod
    def _result(cap: _Capture, specs):
        """Copies of the final carry and of the stacked outputs."""
        new_carry = _unflatten(specs[0], iter([t.clone() for t in cap.carry]))
        outs = _unflatten(cap.out_spec, iter([b.clone() for b in cap.outs]))
        return new_carry, outs

    def _tick(self, cap: _Capture, specs, generator) -> None:
        """One tick on the static buffers: outputs at the step index, the
        new carry written back, the step index advanced (mod S)."""
        c_spec, i_spec = specs
        new, outs = self.tick(_unflatten(c_spec, iter(cap.carry)),
                              _unflatten(i_spec, iter(cap.inputs)), generator)
        out_leaves: List[torch.Tensor] = []
        out_spec = _flatten(outs, out_leaves)
        if cap.outs is None:
            cap.out_spec = out_spec
            cap.outs = [torch.empty((cap.n_steps,) + tuple(o.shape),
                                    dtype=o.dtype, device=o.device)
                        for o in out_leaves]
        elif out_spec != cap.out_spec:
            raise TypeError("the tick's outputs changed structure, shape or "
                            "dtype between ticks")
        for buf, o in zip(cap.outs, out_leaves):
            buf.index_copy_(0, cap.step, o.unsqueeze(0))
        new_leaves: List[torch.Tensor] = []
        if _flatten(new, new_leaves) != c_spec:
            raise TypeError("the tick must return a carry of the structure, "
                            "shapes and dtypes it was given")
        # a new leaf that shares memory with another static buffer would
        # read a value already overwritten: copy it out first
        srcs = [src if src is dst
                or src.untyped_storage().data_ptr() not in cap.storages
                else src.clone() for dst, src in zip(cap.carry, new_leaves)]
        for dst, src in zip(cap.carry, srcs):
            if src is not dst:
                dst.copy_(src)
        cap.step.add_(1).remainder_(cap.n_steps)

    def _own_generator(self, generator: torch.Generator) -> torch.Generator:
        """The runner's generator (registered with its graphs), set to
        the caller's generator's state."""
        if self._generator is None:
            self._generator = torch.Generator(device=generator.device)
        self._generator.set_state(generator.get_state())
        return self._generator

    def _side_stream(self, device: torch.device) -> "torch.cuda.Stream":
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def _warm_up(self, cap: _Capture, specs, gen) -> None:
        """The run's first tick, eagerly, on the side stream the capture
        then uses."""
        device = cap.carry[0].device
        side = self._side_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._tick(cap, specs, gen)
        torch.cuda.current_stream(device).wait_stream(side)

    def _capture(self, cap: _Capture, specs, gen) -> None:
        """Capture one tick; record its launches, seconds and pool bytes."""
        device = cap.carry[0].device
        side = self._side_stream(device)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(gen)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        counted = collections.Counter(_cuda.LAUNCHES)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=side):
            self._tick(cap, specs, gen)
        cap.capture_seconds = time.perf_counter() - t0
        # the capture launched nothing: its counts go to the replays
        cap.launches = collections.Counter(_cuda.LAUNCHES) - counted
        _cuda.LAUNCHES.clear()
        _cuda.LAUNCHES.update(counted)
        cap.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        # the gradients a captured backward made live in the graph's pool
        # and are written by every replay: hold them
        cap.grads = [p.grad for p in cap.held
                     if getattr(p, "grad", None) is not None]
        cap.graph = graph

    def _drop(self, key) -> None:
        cap = self._captures.pop(key)
        if cap.graph is not None:
            # its buffers may still be read by queued replays
            torch.cuda.current_stream(cap.carry[0].device).synchronize()
        if self.last is cap:
            self.last = None
