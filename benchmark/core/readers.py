"""Arithmetic shared by the per-metric readers in benchmark/metrics/.

Each reader takes the run's readings `m`: units (iterations summed over
the videos, or frames) and window_s of the window; setup_s; with --trace 1
also device_events (kernels, memcpys and memsets of the traced window, each
marked `compositor` or not), busy_s, and work (the benchmark's own count
per unit: flops, compositor_flops, compositor_bytes). A reader with nothing
to read returns None, and the metric is left out of the line.
"""
from __future__ import annotations


def rate(m):
    return m["units"] / m["window_s"] if m["window_s"] > 0 else None


def kernels(m, compositor=None):
    return [e for e in m.get("device_events", ()) if e["kernel"] and (
        compositor is None or e["compositor"] == compositor)]


def launches_per_unit(m):
    ks = kernels(m)
    return len(ks) / m["units"] if ks and m["units"] else None


def device_ms_per_unit(m, compositor: bool):
    evs = [e for e in m.get("device_events", ()) if e.get("compositor", False) == compositor]
    return sum(e["dur"] for e in evs) * 1e3 / m["units"] if evs and m["units"] else None


def compositor_roofline(m):
    """Least time of the counted compositor work (the larger of its FLOPs at
    the float32 peak and its bytes at HBM bandwidth) over the compositor
    kernels' device time, in percent."""
    ks = kernels(m, compositor=True)
    w = m.get("work")
    if not ks or not w or not m["units"]:
        return None
    least = max(w["compositor_flops"] / m["peak_flops"],
                w["compositor_bytes"] / m["peak_bytes_per_s"]) * m["units"]
    return 100.0 * least / sum(e["dur"] for e in ks)


def idle_share(m):
    if "busy_s" not in m or m["window_s"] <= 0 or m["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - m["busy_s"] / m["window_s"])


def mfu(m):
    """The counted FLOPs of the window's units over the window at the
    float32 peak, in percent."""
    w = m.get("work")
    if not w or m["window_s"] <= 0:
        return None
    return 100.0 * w["flops"] * m["units"] / (m["window_s"] * m["peak_flops"])
