"""What the per-layer readers share: the traced replays' numbers."""

from dcarl_bench import roofline
from dcarl_bench import trace as T


def kernels_per_replay(m):
    """Kernels one replayed graph ran, averaged over the traced replays."""
    t = m.get("trace") or {}
    if not t.get("replays") or not t.get("replay_kernels"):
        return None
    return t["replay_kernels"] / t["replays"]


def idle_pct(m):
    """Share of the traced window with nothing running on the device."""
    t = m.get("trace") or {}
    if not t.get("window_s") or not t.get("busy_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernel_s(m, kernel):
    """Seconds the named kernel's launches took in the traced replays."""
    t = m.get("trace") or {}
    parts = m.get("kernels", {}).get(kernel)
    if not t.get("replays") or not parts:
        return None
    return T.kernel_seconds(t, parts)


def query_roofline_pct(m, kernel):
    """The query's least time (``roofline.query_bound``, from its inputs
    and the counts it returned) over the kernel's traced seconds, in %."""
    s = kernel_s(m, kernel)
    c = m.get("counters") or {}
    if not s or not c.get("ticks"):
        return None
    ticks = c["ticks"]
    one = roofline.query_bound(c["rows"], c["key_dim"], c["queries"],
                               c["query_dim"], c["answers"],
                               c["matched"] / ticks, "f64",
                               roofline.peaks())
    return roofline.share_pct(one["bound_s"] * ticks, s)
