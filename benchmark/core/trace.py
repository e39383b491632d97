"""The traced window: torch.profiler over the window's steps, read back
from its Chrome trace.

On the card only CUDA activity is traced (kernels, copies, fills and the
CUDA runtime calls that launched them): recording every host op as well
slows a launch-bound step by a third, which would read as device idle
time. Device activity is every kernel, memcpy and memset event; busy
seconds are the union of their intervals. Idle gaps are the spaces between
them inside the device's span, each named by what the host was doing: the
blocking runtime call it sat in, or else launching the op that ends the
gap.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    def __init__(self, device):
        self.device = device
        self.prof = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CUDA if self.device.type == "cuda"
                else torch.profiler.ProfilerActivity.CPU]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()

    def stop(self) -> None:
        self.prof.__exit__(None, None, None)

    def events(self) -> Tuple[List[dict], List[dict]]:
        """(device events, host runtime calls) of the trace, in seconds."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.remove(path)
        dev, host = [], []
        for e in trace.get("traceEvents", []):
            if e.get("ph") != "X" or "dur" not in e:
                continue
            rec = dict(name=e.get("name", ""), t0=float(e["ts"]) * 1e-6,
                       dur=float(e["dur"]) * 1e-6)
            if e.get("cat") in DEVICE_CATS:
                rec["kernel"] = e.get("cat") == "kernel"
                dev.append(rec)
            elif e.get("cat") in ("cuda_runtime", "cuda_driver", "cpu_op"):
                host.append(rec)
        return dev, host


def busy_seconds(dev: List[dict]) -> float:
    total, end = 0.0, None
    for e in sorted(dev, key=lambda e: e["t0"]):
        t0, t1 = e["t0"], e["t0"] + e["dur"]
        if end is None or t0 >= end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total


def top_device_ops(dev: List[dict], n: int = 10) -> List[list]:
    by = defaultdict(float)
    for e in dev:
        by[e["name"]] += e["dur"]
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(dev: List[dict], host: List[dict], n: int = 10) -> List[list]:
    """Idle seconds between device intervals, summed by what the host was
    doing, largest first: "host waits in <call>" when a blocking runtime
    call spans the gap's middle, else "host, then <op that ends the gap>"."""
    evs = sorted(dev, key=lambda e: e["t0"])
    blocking = sorted((e for e in host if any(b in e["name"] for b in ("Synchronize", "Memcpy"))
                       and "Async" not in e["name"]), key=lambda e: e["t0"])
    starts = [e["t0"] for e in blocking]
    by: Dict[str, float] = defaultdict(float)
    end = None
    for e in evs:
        t0, t1 = e["t0"], e["t0"] + e["dur"]
        if end is not None and t0 > end:
            mid = 0.5 * (end + t0)
            i = bisect.bisect_right(starts, mid)
            wait = next((b for b in reversed(blocking[max(0, i - 50):i])
                         if b["t0"] + b["dur"] >= mid), None)
            name = f"host waits in {wait['name']}" if wait else f"host, then {e['name'][:80]}"
            by[name] += t0 - end
        end = t1 if end is None else max(end, t1)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
