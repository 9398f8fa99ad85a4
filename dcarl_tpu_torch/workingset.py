"""Vehicle-life working set (``dcarl_tpu/workingset.py``): an unbounded
host history served through a bounded device cache with asynchronous
re-centering.

* The FULL history lives on the host (numpy arrays, optionally the
  spooled reference text format), unbounded.
* The device carries only the rows that can affect queries in the
  fleet's current operating region (:func:`~dcarl_tpu_torch.core.store.
  active_region_mask`, exact: a dropped row matches NO in-region query),
  compacted to a fixed cache shape.
* As the fleet drifts along its route, a worker thread builds the next
  cache and uploads it while the card drives the current chunk; the loop
  swaps caches at a chunk boundary.

On CUDA the upload goes from pinned host buffers on a side stream; the
worker waits for it to land, and :meth:`AsyncRecenter.ready` makes the
caller's stream wait on its event too, so a cache is never read before
its upload is complete.  A failed re-center raises in ``ready()``, never
quietly serving a stale region.

Frame model: the scenario is translation-invariant, so a fleet at world
position X runs the local-frame gated driver while its store queries
address the world-frame history at ``local_obs + offset(X)`` (the gated
driver's ``with_query_offset``).  The x dims {0, 5, 10, 15} of the
20-D observation carry the shift.

Exactness contract, checked at audits during the run
(:func:`run_vehicle_life`):

1. match COUNTS from the full history, the region-masked history and the
   compacted cache are bit-identical on the device;
2. an f64 host oracle over the full history equals the same oracle over
   the region rows bitwise;
3. device f32 moments of the cache and the full history agree to
   reduction-order tolerance (< 1e-5 relative); the full-vs-masked
   same-shape comparison is recorded as bitwise or not.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dcarl_tpu_torch.core.store import _raw_moments, active_region_mask
from dcarl_tpu_torch.device import resolve_device

# observation dims that carry the world-frame x shift:
# [ego, walker, obj1, obj2] blocks of [x, y, vx, vy, yaw]
X_DIMS = (0, 5, 10, 15)


def offset_vector(dx: float, state_dim: int = 20) -> np.ndarray:
    """[state_dim] query-offset vector for a world-frame shift of dx."""
    off = np.zeros(state_dim, np.float32)
    for d in X_DIMS:
        off[d] = np.float32(dx)
    return off


def shift_keys(keys: np.ndarray, dx: float) -> np.ndarray:
    """World-frame copy of local-frame [N, D] store keys (action column
    last, untouched)."""
    out = keys.astype(np.float32).copy()
    for d in X_DIMS:
        out[:, d] = (out[:, d].astype(np.float64) + dx).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# History: collect once in the local frame, lay out along the route
# ---------------------------------------------------------------------------


def collect_local_records(n_envs: int, n_steps: int, seed: int = 7,
                          env_cfg=None, max_rows: Optional[int] = None,
                          device: "str | torch.device | None" = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Collection-stack records in the local frame: run the lane-major
    value collector (``make_collector_fast``) and keep the
    {recorded_state, used_action, episode_return} row of every completed
    triggered episode (dqn_value_collect.py:128-145).

    Returns (keys [K, 21], values [K]) as float32 host arrays."""
    from dcarl_tpu_torch.config import EnvConfig
    from dcarl_tpu_torch.env.scenario import t_intersection
    from dcarl_tpu_torch.planning.fast_rollout import make_collector_fast

    device = resolve_device(device)
    env_cfg = env_cfg or EnvConfig()
    init_fn, run_fn = make_collector_fast(t_intersection(env_cfg), env_cfg,
                                          device=device)
    carry = init_fn(n_envs, torch.Generator(device=device).manual_seed(seed))
    _, recs = run_fn(carry, n_steps,
                     torch.Generator(device=device).manual_seed(seed + 1))
    k, v = episode_rows(recs.done, recs.recorded_state.transpose(1, 2),
                        recs.used_action, recs.episode_return)
    if max_rows is not None:
        k, v = k[:max_rows], v[:max_rows]
    return (k.cpu().numpy().astype(np.float32),
            v.cpu().numpy().astype(np.float32))


def episode_rows(done: torch.Tensor, recorded_state: torch.Tensor,
                 used_action: torch.Tensor, episode_return: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The collected dataset's rule (dqn_value_collect.py:128-145): one
    row {recorded_state, used_action} -> episode_return for every
    completed episode that triggered (its locked state has ego y != 0).
    Records are step-major: ``done``, ``used_action`` and
    ``episode_return`` [S, B], ``recorded_state`` [S, B, 20]; rows come
    out in that order.  Returns (keys [K, 21], values [K]) in the records'
    dtype, on their device."""
    states = recorded_state.reshape(-1, recorded_state.shape[-1])
    ok = done.reshape(-1) & (states[:, 1] != 0.0)
    k = torch.cat([states, used_action.reshape(-1, 1).to(states.dtype)],
                  dim=1)[ok]
    return k, episode_return.reshape(-1)[ok]


def build_life_history(local_keys: np.ndarray, local_values: np.ndarray,
                       offsets: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """World-frame history: the local dataset laid out at every route
    position (translation invariance makes each shifted copy what a fleet
    operating there records).  Returns (keys [K*M, 21], values [K*M]) in
    route order."""
    ks, vs = [], []
    for dx in offsets:
        ks.append(shift_keys(local_keys, float(dx)))
        vs.append(local_values)
    return np.concatenate(ks), np.concatenate(vs)


# ---------------------------------------------------------------------------
# Region cache + async re-centering
# ---------------------------------------------------------------------------


class RegionCache:
    """A fixed-capacity cache of the history rows reachable from queries
    inside |q_x - center| <= radius (exact: active_region_mask on the
    ego-x dim)."""

    def __init__(self, history_keys: np.ndarray, history_values: np.ndarray,
                 half_widths: np.ndarray, capacity: int):
        self.hk = history_keys
        self.hv = history_values
        self.w = np.asarray(half_widths, np.float32)
        self.capacity = capacity

    def region_mask(self, center: float, radius: float) -> np.ndarray:
        return active_region_mask(self.hk, self.w, (0,), (center,),
                                  (radius,))

    def build(self, center: float, radius: float):
        """(keys [C, D], values [C], valid [C], n_rows, mask_idx) host
        arrays; rows past ``n_rows`` hold 1e9 keys and are invalid.
        Raises if the region outgrows the cache."""
        mask = self.region_mask(center, radius)
        idx = np.nonzero(mask)[0]
        n = len(idx)
        if n > self.capacity:
            raise ValueError(
                f"region at center {center} holds {n} rows > cache "
                f"capacity {self.capacity}; shrink the radius or grow "
                "the cache")
        d = self.hk.shape[1]
        keys = np.full((self.capacity, d), 1.0e9, np.float32)
        vals = np.zeros((self.capacity,), np.float32)
        keys[:n] = self.hk[idx]
        vals[:n] = self.hv[idx]
        valid = np.zeros((self.capacity,), bool)
        valid[:n] = True
        return keys, vals, valid, n, idx


def upload(arrays, device: torch.device,
           stream: "torch.cuda.Stream | None" = None):
    """Host arrays as tensors on ``device``.  On CUDA with a ``stream``:
    copies from pinned buffers on that stream; returns (tensors, event
    recorded after the copies)."""
    if device.type != "cuda" or stream is None:
        return tuple(torch.as_tensor(a, device=device) for a in arrays), None
    with torch.cuda.stream(stream):
        out = tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                    .to(device, non_blocking=True) for a in arrays)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


class AsyncRecenter:
    """One worker thread preparing the next cache while the card drives
    the current chunk.  ``request`` does not block; ``ready`` returns the
    uploaded cache ((keys, values, valid), n_rows, center, seconds) once
    done, else None, and raises the worker's exception if it failed."""

    def __init__(self, cache: RegionCache, device: torch.device):
        self.cache = cache
        self.device = device
        self._stream = (torch.cuda.Stream(device=device)
                        if device.type == "cuda" else None)
        self._lock = threading.Lock()
        self._result = None
        self._error: Optional[BaseException] = None
        self._busy = False
        self._prep_seconds = 0.0

    def request(self, center: float, radius: float) -> bool:
        with self._lock:
            if self._busy:
                return False
            self._busy = True
        threading.Thread(target=self._work, args=(center, radius),
                         daemon=True).start()
        return True

    def _work(self, center, radius):
        try:
            t0 = time.perf_counter()
            keys, vals, valid, n, _ = self.cache.build(center, radius)
            dev, event = upload((keys, vals, valid), self.device, self._stream)
            if event is not None:
                event.synchronize()       # the upload has landed
            dt = time.perf_counter() - t0
            with self._lock:
                self._result = (dev, n, center, dt, event)
                self._prep_seconds += dt
        except Exception as e:            # raised in the caller by ready()
            with self._lock:
                self._error = e
        finally:
            with self._lock:
                self._busy = False

    def ready(self):
        with self._lock:
            if self._error is not None:
                err, self._error = self._error, None
                raise RuntimeError("region re-center failed") from err
            r, self._result = self._result, None
        if r is None:
            return None
        dev, n, center, dt, event = r
        if event is not None:
            # the caller's stream reads the cache after the upload, and
            # the allocator keeps the side-stream blocks until it is done
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in dev:
                t.record_stream(current)
        return dev, n, center, dt

    def wait(self, timeout: float = 600.0):
        """Block until the pending request finishes; then :meth:`ready`."""
        t_end = time.perf_counter() + timeout
        while True:
            with self._lock:
                busy = self._busy
            if not busy:
                return self.ready()
            if time.perf_counter() > t_end:
                raise TimeoutError("region re-center did not finish")
            time.sleep(0.001)


# ---------------------------------------------------------------------------
# The life run
# ---------------------------------------------------------------------------


def _f64_oracle(keys: np.ndarray, values: np.ndarray, queries: np.ndarray,
                w: np.ndarray, num_actions: int) -> np.ndarray:
    """[Q, A, 3] f64 moments over rows in ORIGINAL order: the exact
    arithmetic reference (same row set and order -> same bits).  Prunes
    per query by exact dim-0 containment."""
    out = np.zeros((len(queries), num_actions, 3), np.float64)
    k0 = keys[:, 0]
    for qi, q in enumerate(queries):
        cand = np.nonzero(np.abs(k0 - q[0]) <= w[0])[0]
        if len(cand) == 0:
            continue
        kk = keys[cand]
        inside = np.all(np.abs(kk[:, :-1] - q[None, :]) <= w[None, :-1],
                        axis=1)
        rows = cand[inside]
        for a in range(num_actions):
            m = np.abs(keys[rows, -1] - a) <= w[-1]
            v = values[rows][m].astype(np.float64)
            out[qi, a] = [len(v), v.sum(), (v * v).sum()]
    return out


def run_vehicle_life(
    n_envs: int = 65536,
    chunk_steps: int = 50,
    n_chunks: int = 120,
    local_rows: int = 30000,
    n_offsets: int = 150,
    offset_spacing: float = 8.0,
    cache_capacity: int = 1 << 18,
    region_radius: float = 25.0,
    recenter_margin: float = 10.0,
    drift_per_chunk: float = 2.0,
    checkpoints: int = 3,
    checkpoint_queries: int = 256,
    collect_envs: int = 4096,
    collect_steps: int = 2048,
    use_kernel: Optional[bool] = None,
    seed: int = 0,
    history: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    spool_dir: Optional[str] = None,
    store_cfg=None,
    device: "str | torch.device | None" = None,
) -> Dict:
    """Drive the gated fleet for a vehicle-life segment: the history
    (``local_rows * n_offsets`` world-frame rows) lives on the host, the
    card serves from a region cache, the offset drifts
    ``drift_per_chunk`` per chunk, and the host re-centers
    asynchronously.  Returns the report dict (the keys of the JAX
    package's WORKINGSET_r05.json).  ``use_kernel`` (None = on CUDA)
    serves and audits through the per-action kernel."""
    from dcarl_tpu_torch.config import EnvConfig, driving_store_config
    from dcarl_tpu_torch.env import driving_env as de
    from dcarl_tpu_torch.env.scenario import t_intersection
    from dcarl_tpu_torch.planning import fast_rollout as FR

    device = resolve_device(device)
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    env_cfg = EnvConfig()
    # the history stores whole-episode returns, so the gate constants
    # live on the episode-return scale (value_mode='episode', W ~ the
    # episode length)
    scfg = store_cfg or driving_store_config(
        value_mode="episode", gamma=1.0, n_step_window=250)
    w = np.asarray(scfg.half_widths, np.float32)
    num_actions = env_cfg.action_dim

    # --- history: collect once locally, lay out along the route
    if history is None:
        lk, lv = collect_local_records(collect_envs, collect_steps,
                                       seed=seed + 7, env_cfg=env_cfg,
                                       max_rows=local_rows, device=device)
    else:
        lk, lv = history
    offsets = np.arange(n_offsets, dtype=np.float64) * offset_spacing
    hk, hv = build_life_history(lk, lv, offsets)
    n_hist = len(hk)

    if spool_dir is not None:
        # the unbounded append-only persistence of the reference
        # (RLS.py:185-215): the whole life history in text form
        import os

        from dcarl_tpu_torch.core.store import ConfidenceStore
        from dcarl_tpu_torch.utils.checkpoint import StoreSpooler

        os.makedirs(spool_dir, exist_ok=True)
        sp = StoreSpooler(os.path.join(spool_dir, "visited_state.txt"),
                          os.path.join(spool_dir, "visited_value.txt"))
        sp.spool(ConfidenceStore(keys=hk, actions=hk[:, -1], values=hv,
                                 size=np.int32(n_hist), head=np.int32(0)),
                 n_inserted=n_hist)

    # --- driver (one driver for the whole life)
    sc = t_intersection(env_cfg)
    init_fn, run_fn = FR.make_gated_driver_fast(
        sc, env_cfg, store_cfg=scfg, device=device, use_kernel=use_kernel,
        with_query_offset=True)
    in_idx = de.in_state_indices(sc)

    cache = RegionCache(hk, hv, w, cache_capacity)
    recenter = AsyncRecenter(cache, device)

    # local ego-x span -> region center tracks offset + mid-span
    x_mid = float(np.median(lk[:, 0]))
    center = 0.0 + x_mid
    keys0, vals0, valid0, cache_rows, _ = cache.build(center, region_radius)
    dev_keys, dev_vals, dev_valid = upload((keys0, vals0, valid0), device)[0]
    # the full history on the card, for audits only (serving never
    # touches it)
    full_keys_dev = None
    full_vals_dev = None

    carry = init_fn(n_envs, torch.Generator(device=device).manual_seed(seed))

    def offset_on_device(dx):
        return torch.as_tensor(offset_vector(dx, env_cfg.state_dim),
                               device=device)

    # warm-up (kernel build, allocator), excluded from the sustained clock
    run_fn(carry, chunk_steps, dev_keys, dev_vals, dev_valid,
           offset_on_device(0.0),
           generator=torch.Generator(device=device).manual_seed(seed + 1))
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    ckpt_every = max(1, n_chunks // max(checkpoints, 1))
    ckpt_results: List[Dict] = []
    timeline = []
    recenters = 0
    pending = False
    offset_now = 0.0
    gen = torch.Generator(device=device).manual_seed(seed + 2)

    t_run0 = time.perf_counter()
    for ci in range(n_chunks):
        carry, out = run_fn(carry, chunk_steps, dev_keys, dev_vals, dev_valid,
                            offset_on_device(offset_now), generator=gen)
        # block on ONE scalar; the re-center thread overlaps the chunk
        frac = float((out[5] != 0).to(torch.float32).mean())
        timeline.append({
            "chunk": ci,
            "offset": offset_now,
            "cache_rows": int(cache_rows),
            "activation_fraction": frac,
        })

        # swap in a finished re-center
        r = recenter.ready()
        if r is not None:
            (dev_keys, dev_vals, dev_valid), cache_rows, center, _ = r
            recenters += 1
            pending = False

        # drift; request a re-center before the fleet reaches the edge
        offset_now += drift_per_chunk
        fleet_center = offset_now + x_mid
        if not pending and abs(fleet_center - center) > recenter_margin:
            pending = recenter.request(fleet_center, region_radius)

        if (ci + 1) % ckpt_every == 0 and len(ckpt_results) < checkpoints:
            if full_keys_dev is None:
                full_keys_dev, full_vals_dev = upload((hk, hv), device)[0]
            ckpt_results.append(_checkpoint(
                hk, hv, full_keys_dev, full_vals_dev, w, num_actions,
                FR._obs_ori_soa(carry, in_idx), offset_now, dev_keys, dev_vals, dev_valid, center,
                region_radius, cache, checkpoint_queries, use_kernel))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_run = time.perf_counter() - t_run0
    if pending:
        recenter.wait()   # leave no worker running; raises if it failed

    steps_total = n_chunks * chunk_steps * n_envs
    # audits are instrumentation, not serving
    t_ckpt = sum(c["seconds"] for c in ckpt_results)
    sustained = steps_total / (t_run - t_ckpt)

    return {
        "history_rows": int(n_hist),
        "local_rows": int(len(lk)),
        "n_offsets": int(n_offsets),
        "offset_spacing": offset_spacing,
        "route_length_m": float(offsets[-1]),
        "cache_capacity": int(cache_capacity),
        "region_radius": region_radius,
        "n_envs": n_envs,
        "chunk_steps": chunk_steps,
        "n_chunks": n_chunks,
        "env_steps_total": int(steps_total),
        "wall_seconds": t_run,
        "checkpoint_seconds": t_ckpt,
        "sustained_env_steps_per_s": sustained,
        "recenters": recenters,
        "recenter_prep_seconds_total": recenter._prep_seconds,
        "activation_fraction_mean": float(np.mean(
            [t["activation_fraction"] for t in timeline])),
        "checkpoints": ckpt_results,
        "timeline": timeline,
    }


def _checkpoint(hk, hv, full_keys, full_vals, w, num_actions, obs,
                offset_now, dev_keys, dev_vals, dev_valid, center, radius,
                cache: RegionCache, n_queries: int, use_kernel: bool) -> Dict:
    """The exactness audit (module docstring, items 1-3) against the live
    fleet's current query batch."""
    from dcarl_tpu_torch.ops.store_kernels import box_query_moments_peraction

    t0 = time.perf_counter()
    device = full_keys.device
    obs = obs.cpu().numpy()                                # [20, B]
    q_local = obs.T[: n_queries // 2].astype(np.float32)
    q_world = q_local + offset_vector(offset_now, obs.shape[0])[None, :]
    # only in-region queries are covered by the contract; the margin
    # logic must have kept the fleet inside
    in_region = np.abs(q_world[:, 0] - center) <= radius
    if not in_region.all():
        raise AssertionError(
            f"fleet escaped the region before re-centering: "
            f"|{q_world[:, 0].min()}..{q_world[:, 0].max()} - {center}| vs "
            f"{radius}: shrink drift_per_chunk or recenter_margin")
    # ...plus probes AT in-region evidence rows, so that every audit also
    # exercises real multi-row aggregation
    mask_probe = cache.region_mask(center, radius)
    rows_in = np.nonzero(mask_probe)[0]
    if len(rows_in):
        take = rows_in[:: max(1, len(rows_in) // max(n_queries // 2, 1))]
        take = take[: n_queries // 2]
        probes = hk[take, :-1].astype(np.float32)
        guard = np.abs(probes[:, 0] - center) <= radius
        q_world = np.concatenate([q_world, probes[guard]])

    q_dev = torch.as_tensor(q_world, device=device)
    w_dev = torch.as_tensor(w, device=device)

    def device_moments(keys, vals, valid):
        if use_kernel:
            return box_query_moments_peraction(
                keys, vals, valid, q_dev, w_dev,
                num_actions=num_actions).cpu().numpy()
        return _raw_moments(
            keys, vals, valid, q_dev, w_dev, num_actions).cpu().numpy(
            ).reshape(len(q_world), num_actions, 3)

    # X: the full history (on the card for audits only)
    x = device_moments(full_keys, full_vals,
                       torch.ones((len(hk),), dtype=torch.bool, device=device))
    # Y: same shape, region rows valid only: mask exactness on the card
    mask = cache.region_mask(center, radius)
    y = device_moments(full_keys, full_vals, torch.as_tensor(mask,
                                                             device=device))
    # Z: the compacted serving cache (exactly what served the fleet)
    z = device_moments(dev_keys, dev_vals, dev_valid)

    counts_xy = bool((x[:, :, 0] == y[:, :, 0]).all())
    counts_xz = bool((x[:, :, 0] == z[:, :, 0]).all())
    bitwise_xy = bool((x == y).all())

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))

    # exact-arithmetic oracle: full rows vs region rows, f64, original
    # row order -> identical bits iff the region mask loses nothing
    o_full = _f64_oracle(hk, hv, q_world, w, num_actions)
    o_region = _f64_oracle(hk[mask], hv[mask], q_world, w, num_actions)
    f64_bitwise = bool((o_full == o_region).all())

    res = {
        "offset": offset_now,
        "n_queries": int(len(q_world)),
        "matched_counts_total": int(x[:, :, 0].sum()),
        "counts_exact_full_vs_masked": counts_xy,
        "counts_exact_full_vs_cache": counts_xz,
        "device_bitwise_full_vs_masked": bitwise_xy,
        "f64_oracle_bitwise_full_vs_region": f64_bitwise,
        "max_rel_moment_diff_cache_vs_full": rel(z, x),
        "max_rel_moment_diff_device_vs_f64": rel(
            x.astype(np.float64), o_full),
        "seconds": 0.0,
    }
    if not (counts_xy and counts_xz and f64_bitwise
            and res["max_rel_moment_diff_cache_vs_full"] < 1e-5):
        raise AssertionError(f"working-set exactness audit failed: {res}")
    res["seconds"] = time.perf_counter() - t0
    return res
