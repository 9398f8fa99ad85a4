"""Compiled runs and calls: captured CUDA graphs, replayed from the host.

The JAX package compiles each driver's and trainer's run into one device
program, ``jax.jit`` over ``lax.scan(tick)``, and the agent's tick into
one ``jax.jit`` program a request.  Their counterparts on a GPU capture
the function once as a CUDA graph and replay the graph, so a tick or a
request costs one graph launch from the host instead of a few hundred
kernel launches:

* :class:`TickRunner` (a run of ``S`` ticks): a tick function ``tick(carry,
  inputs, generator) -> (carry, outs)`` of tensor trees (tensors in
  nested tuples, NamedTuples and dicts; other leaves are constants).  For
  each capture it keeps static device buffers of the carry and of the
  run's inputs (a prepared store, an offset), which each run copies the
  caller's values into and each tick writes its new carry back into in
  place; ``[S, ...]`` output buffers, which each tick writes at a
  device-side step index, so no tick needs a host copy; and the graph.
  Captures are cached by the shapes, dtypes and constant leaves of the
  carry and the inputs, and ``S``.  A new store of the same size is
  copied into the captured buffers, not captured again.
* :class:`CallRunner` (one call a request): a function ``fn(variant,
  inputs, generator) -> outs`` that updates the caller's state in place.
  Its static buffers are the caller's own state tensors, for the whole
  session; a call copies in only its inputs and hands back only its
  outputs.  ``variant`` is a hashable host constant that picks the
  program (where JAX branches on the device with ``lax.cond``, the
  caller's host counters already know the branch), so there is one
  capture a variant, all in one memory pool.

Tensors that a run or a call updates in place (a learner's weights and
Adam state; for a :class:`CallRunner` its whole state) are named by
``state()``.  The runner holds them, and it captures again when they are
no longer the tensors it captured.

Randomness stays the caller's stream bit for bit.  The runner's own
generator takes the caller's generator's state, is registered with each
graph (a replay draws what the eager function would draw from that
state), and hands its state back at the end, so the caller's generator
ends where the eager route would leave it.

A capture's first use runs the function eagerly on a side stream: the
warm-up a capture needs, which also builds the kernels, fills the
per-device constant caches and creates the cuBLAS handles.  A
:class:`TickRunner` warms up on a run's first tick, captures the second
and replays the rest; a :class:`CallRunner` warms up on a variant's first
call, captures on its second and replays from then on.  A failed capture
raises; nothing falls back to the eager route.

The store kernels' launch counters (``ops._cuda.LAUNCHES``) count at
Python call time, which a replay skips.  The runner takes the launches
recorded during a capture out of the counters (the capture launched
nothing) and adds them back once for every replay.

A maker compiles on a CUDA device and without a mesh (gloo cannot be
captured, and NCCL capture is not done yet); elsewhere it runs the eager
route (:func:`run_loop`, or the function itself), which is also the
reference a replay is held to bit for bit.

Tracing (``utils/profiling``, when on): a :class:`TickRunner` call opens
the host spans ``dcarl.load``, ``dcarl.capture``, ``dcarl.replay.<name>``
(the whole replay loop) and ``dcarl.result``; its capture records the
tick's phase table under the runner's name, the tick's own write of its
outputs and carry being the phase ``writeback``.  The switch is part of a
capture's key, so a run after it flips captures anew.
"""

from __future__ import annotations

import collections
import concurrent.futures
import time
from typing import Callable, Hashable, List, Optional, Sequence

import torch

from dcarl_tpu_torch.ops import _cuda
from dcarl_tpu_torch.utils import profiling

_TENSOR = "tensor"
_CONST = "const"
# captures a TickRunner keeps, the least recently used dropped first:
# each holds a private memory pool of a tick's intermediates
_MAX_CAPTURES = 2


def _flatten(tree, leaves: list):
    """Append ``tree``'s tensors to ``leaves`` in order; return its spec:
    the structure (a dict's keys in order), each tensor's (shape, dtype,
    device) and the constant leaves, hashable."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return (_TENSOR, tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, tuple):
        return (type(tree), tuple(_flatten(x, leaves) for x in tree))
    if isinstance(tree, dict):
        return (dict, tuple(tree), tuple(_flatten(x, leaves)
                                         for x in tree.values()))
    return (_CONST, tree)


def _unflatten(spec, leaves):
    """The tree of ``spec`` with its tensors taken from the iterator
    ``leaves``."""
    head = spec[0]
    if head == _TENSOR:
        return next(leaves)
    if head == _CONST:
        return spec[1]
    if head is dict:
        return {k: _unflatten(s, leaves) for k, s in zip(spec[1], spec[2])}
    kids = [_unflatten(s, leaves) for s in spec[1]]
    return head(*kids) if hasattr(head, "_fields") else head(kids)


def tensors_of(tree) -> List[torch.Tensor]:
    """The tensors of a tree of tuples, NamedTuples and dicts, in order."""
    leaves: List[torch.Tensor] = []
    _flatten(tree, leaves)
    return leaves


def write_back(dsts: Sequence[torch.Tensor],
               srcs: Sequence[torch.Tensor]) -> None:
    """Copy each new tensor into its static buffer, in place (a buffer
    given back as its own new value is left alone).  A new tensor that
    shares memory with another static buffer would be read after that
    buffer was overwritten: it is copied out first."""
    storages = {t.untyped_storage().data_ptr() for t in dsts}
    srcs = [src if src is dst
            or src.untyped_storage().data_ptr() not in storages
            else src.clone() for dst, src in zip(dsts, srcs)]
    for dst, src in zip(dsts, srcs):
        if src is not dst:
            dst.copy_(src)


def run_loop(tick: Callable, carry, inputs, n_steps: int,
             generator: torch.Generator):
    """The eager run: ``n_steps`` ticks in a Python loop, each tick's
    outputs stacked to ``[n_steps, ...]`` (the route off a CUDA device
    or over a mesh, and the reference of the replayed one)."""
    outs = []
    for _ in range(n_steps):
        carry, out = tick(carry, inputs, generator)
        outs.append(out)
    spec = _flatten(outs[0], [])
    stacked = [torch.stack(f) for f in zip(*map(tensors_of, outs))]
    return carry, _unflatten(spec, iter(stacked))


class _Graph:
    """A captured graph and its bookkeeping: the in-place state it was
    captured on, the launches one replay makes, the capture's seconds and
    pool bytes, and the gradients its captured backward writes."""

    def __init__(self, held: List[torch.Tensor]):
        self.held = held
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.grads: List[torch.Tensor] = []
        self.launches: "collections.Counter[str]" = collections.Counter()
        self.capture_seconds = 0.0
        self.pool_bytes = 0

    def holds(self, state: Sequence[torch.Tensor]) -> bool:
        return len(state) == len(self.held) and all(
            a is b for a, b in zip(state, self.held))

    def replay(self, times: int = 1) -> None:
        for _ in range(times):
            self.graph.replay()
        for name, n in self.launches.items():
            _cuda.LAUNCHES[name] += n * times


class _Runner:
    """What both runners share: the route, the in-place state, the
    generator registered with the graphs, the side stream, the capture.
    ``name`` (None: not traced) registers each capture's phase table."""

    def __init__(self, compiled: bool,
                 state: "Callable[[], Sequence[torch.Tensor]] | None",
                 name: Optional[str] = None):
        self.compiled = compiled
        self.state = state
        self.name = name
        self._generator: Optional[torch.Generator] = None
        self._stream: Optional["torch.cuda.Stream"] = None

    def _state(self) -> List[torch.Tensor]:
        return list(self.state()) if self.state is not None else []

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

    def _eager_on_side(self, device: torch.device, body: Callable):
        """``body()`` eagerly on the side stream the captures use."""
        side = self._side_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            out = body()
        torch.cuda.current_stream(device).wait_stream(side)
        return out

    def _capture(self, cap: _Graph, device: torch.device, body: Callable,
                 gen: torch.Generator, pool=None) -> None:
        """Capture ``body()`` into ``cap`` (in ``pool`` where given);
        record its launches, seconds and pool bytes."""
        side = self._side_stream(device)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(gen)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        counted = collections.Counter(_cuda.LAUNCHES)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=pool, stream=side), \
                profiling.capturing(self.name):
            body()
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


class _Capture(_Graph):
    """The static buffers, output buffers and graph of one run's key."""

    def __init__(self, carry: List[torch.Tensor], inputs: List[torch.Tensor],
                 held: List[torch.Tensor], n_steps: int):
        super().__init__(held)
        self.carry = carry
        self.inputs = inputs
        self.n_steps = n_steps
        self.step = torch.zeros(1, dtype=torch.int64, device=carry[0].device)
        self.outs: Optional[List[torch.Tensor]] = None
        self.out_spec = None


class TickRunner(_Runner):
    """A maker's run of ``tick``: ``runner(carry, inputs, n_steps,
    generator) -> (carry, outs)``.  ``compiled``: one captured CUDA
    graph replayed a tick; else the eager loop (:func:`run_loop`).

    ``tick(carry, inputs, generator) -> (carry, outs)`` must return a
    carry of the structure, shapes and dtypes it was given and must not
    write into its arguments; it may update the tensors ``state()``
    names in place.  ``name`` names the runner's replay span and phase
    table (``utils/profiling``)."""

    def __init__(self, tick: Callable, compiled: bool,
                 state: "Callable[[], Sequence[torch.Tensor]] | None" = None,
                 name: Optional[str] = None):
        super().__init__(compiled, state, name)
        self.tick = tick
        self._captures: "collections.OrderedDict" = collections.OrderedDict()
        self.last: Optional[_Capture] = None
        self._replay_span = f"dcarl.replay.{name}"

    def __call__(self, carry, inputs, n_steps: int,
                 generator: torch.Generator):
        """``(carry, outs)`` after ``n_steps`` ticks, as :func:`run_loop`
        returns them (fresh tensors the caller owns); ``generator`` ends
        where the eager loop leaves it."""
        if not self.compiled:
            return run_loop(self.tick, carry, inputs, n_steps, generator)
        with profiling.span("dcarl.load"):
            cap, specs = self._load(carry, inputs, n_steps)
            gen = self._own_generator(generator)
        done = 0
        if cap.graph is None:
            with profiling.span("dcarl.capture"):
                device = cap.carry[0].device
                self._eager_on_side(device,
                                    lambda: self._tick(cap, specs, gen))
                done = 1
                if n_steps > 1:
                    self._capture(cap, device,
                                  lambda: self._tick(cap, specs, gen), gen)
        with profiling.span(self._replay_span):
            cap.replay(n_steps - done)
        generator.set_state(gen.get_state())
        with profiling.span("dcarl.result"):
            return self._result(cap, specs)

    # ------------------------------------------------------------------
    def _load(self, carry, inputs, n_steps: int):
        """The capture of this run's key (made if missing), its static
        buffers holding ``carry`` and ``inputs`` and its step index at 0;
        and the trees' specs.  The key holds the tracing switch: a graph
        captured with it off has no phase table and no counters."""
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        c_leaves, i_leaves = [], []
        c_spec = _flatten(carry, c_leaves)
        i_spec = _flatten(inputs, i_leaves)
        if not c_leaves:
            raise ValueError("the carry holds no tensor")
        state = self._state()
        key = (c_spec, i_spec, n_steps, profiling.enabled())
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
        with profiling.phase("writeback"):
            out_leaves: List[torch.Tensor] = []
            out_spec = _flatten(outs, out_leaves)
            if cap.outs is None:
                cap.out_spec = out_spec
                cap.outs = [torch.empty((cap.n_steps,) + tuple(o.shape),
                                        dtype=o.dtype, device=o.device)
                            for o in out_leaves]
            elif out_spec != cap.out_spec:
                raise TypeError("the tick's outputs changed structure, shape "
                                "or dtype between ticks")
            for buf, o in zip(cap.outs, out_leaves):
                buf.index_copy_(0, cap.step, o.unsqueeze(0))
            new_leaves: List[torch.Tensor] = []
            if _flatten(new, new_leaves) != c_spec:
                raise TypeError("the tick must return a carry of the "
                                "structure, shapes and dtypes it was given")
            write_back(cap.carry, new_leaves)
            cap.step.add_(1).remainder_(cap.n_steps)

    def _drop(self, key) -> None:
        cap = self._captures.pop(key)
        if cap.graph is not None:
            # its buffers may still be read by queued replays
            torch.cuda.current_stream(cap.carry[0].device).synchronize()
        if self.last is cap:
            self.last = None


class _Call(_Graph):
    """The static input buffers, outputs and graph of one variant."""

    def __init__(self, variant: Hashable, in_spec, inputs: List[torch.Tensor],
                 held: List[torch.Tensor]):
        super().__init__(held)
        self.variant = variant
        self.in_spec = in_spec
        self.inputs = inputs
        self.warm = False
        self.outs: List[torch.Tensor] = []
        self.out_spec = None


class CallRunner(_Runner):
    """A session's call of ``fn``: ``runner(variant, inputs, generator) ->
    outs``, the counterpart of one ``jax.jit`` call.  ``compiled``: one
    captured CUDA graph a variant, replayed a call; else ``fn`` itself.

    ``fn(variant, inputs, generator) -> outs`` updates the tensors
    ``state()`` names in place (they are the graphs' static state) and
    must not write into ``inputs``.  Inputs may lie in pinned host memory:
    a call copies them into its static device buffers without waiting.
    The outputs of a replayed call are the graph's own buffers, valid
    until the runner's next call.

    Compiled calls run one at a time on one thread of the runner's own,
    whichever thread calls: a capture must find the per-thread state the
    warm-up made (the cuBLAS handles of the thread), and a server calls
    from a thread a connection."""

    def __init__(self, fn: Callable, compiled: bool,
                 state: "Callable[[], Sequence[torch.Tensor]]"):
        super().__init__(compiled, state)
        self.fn = fn
        self._calls: dict = {}
        self._pool = None   # the memory pool every variant's graph shares
        self._worker: "concurrent.futures.ThreadPoolExecutor | None" = None
        self.last: Optional[_Call] = None

    def __call__(self, variant: Hashable, inputs, generator: torch.Generator):
        if not self.compiled:
            return self.fn(variant, inputs, generator)
        if self._worker is None:
            self._worker = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="graphs")
        return self._worker.submit(self._call, variant, inputs,
                                   generator).result()

    def _call(self, variant: Hashable, inputs, generator: torch.Generator):
        """A compiled call, on the runner's thread."""
        call = self._load(variant, inputs)
        gen = self._own_generator(generator)
        device = self._device()
        if not call.warm:
            outs = self._eager_on_side(device, lambda: self._run(call, gen))
            current = torch.cuda.current_stream(device)
            for t in tensors_of(outs):
                t.record_stream(current)
            call.warm = True
        else:
            if call.graph is None:
                self._capture(call, device, lambda: self._record(call, gen),
                              gen, self._pool)
                if self._pool is None:
                    self._pool = call.graph.pool()
            call.replay()
            outs = _unflatten(call.out_spec, iter(call.outs))
        generator.set_state(gen.get_state())
        return outs

    # ------------------------------------------------------------------
    def _device(self) -> torch.device:
        return self._state()[0].device

    def _load(self, variant: Hashable, inputs) -> _Call:
        """The call of this variant and input layout (made if missing, its
        static input buffers on the state's device), holding ``inputs``.
        Every capture goes when the state is no longer the one held."""
        leaves: List[torch.Tensor] = []
        spec = _flatten(inputs, leaves)
        state = self._state()
        if self._calls and not next(iter(self._calls.values())).holds(state):
            self._drop_all()
        key = (variant, spec)
        call = self._calls.get(key)
        if call is None:
            device = state[0].device
            call = _Call(variant, spec,
                         [torch.empty(t.shape, dtype=t.dtype, device=device)
                          for t in leaves], state)
            self._calls[key] = call
        for dst, src in zip(call.inputs, leaves):
            dst.copy_(src, non_blocking=True)
        self.last = call
        return call

    def _run(self, call: _Call, generator: torch.Generator):
        """``fn`` on the call's static inputs, eagerly."""
        return self.fn(call.variant, _unflatten(call.in_spec,
                                                iter(call.inputs)), generator)

    def _record(self, call: _Call, generator: torch.Generator) -> None:
        """The captured body: ``fn`` on the static inputs, its outputs
        kept as the call's."""
        out = self._run(call, generator)
        call.outs = []
        call.out_spec = _flatten(out, call.outs)

    def _drop_all(self) -> None:
        if any(c.graph is not None for c in self._calls.values()):
            # the buffers may still be read by queued replays
            torch.cuda.current_stream(self._device()).synchronize()
        self._calls.clear()
        self._pool = None
        self.last = None
