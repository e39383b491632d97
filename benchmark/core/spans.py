"""The program's spans in a traced window: which span launched each device
event, the blocking runtime calls made inside spans, and the idle gaps by
the span the program's loop was in.

The program names the layers of its training step with `record_function`
ranges "egogs.<name>" (`egogaussian_tpu_torch/utils/logging.py:span`)
while a profiler records. `SpanTracer` records the CUDA activity (kernels,
copies, fills and the runtime calls that launched them) and, of the host's,
only those ranges (`RecordScope.USER_SCOPE`): recording every host op as
well slows a launch-bound step by a third. A device event belongs to the
innermost span open on the thread that launched it (the runtime call with
the event's correlation id) when it did: the forward's spans on the
program's thread, the backward's on autograd's device thread.

`parse` reads the device events and runtime calls of a Chrome trace as
`benchmark/core/trace.py` does (same names, times and kinds), with their
correlation ids and threads besides. `benchmark/span_trace.py` runs a cell
with this tracer and prints the attribution.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from benchmark.core.trace import DEVICE_CATS

HOST_CATS = ("cuda_runtime", "cuda_driver", "cpu_op")
SPAN_PREFIX = "egogs."  # the program's spans (egogaussian_tpu_torch/utils/logging.py)
OUTSIDE = "outside the program's spans"
# spans that name a loop's phase, not a layer of the step
PHASES = ("step", "interval")


class SpanTracer:
    """The profiler over a window: CUDA activity and the program's spans on
    the card; every host op on the CPU."""

    def __init__(self, device):
        self.device = device
        self.result = None
        self.thread = None  # the thread that runs the program's loop

    def start(self) -> None:
        from torch._C._autograd import _enable_profiler, _prepare_profiler
        from torch._C._profiler import (
            ProfilerActivity,
            ProfilerConfig,
            ProfilerState,
            RecordScope,
            _ExperimentalConfig,
        )

        self.thread = threading.get_native_id()
        if self.device.type == "cuda":
            acts = {ProfilerActivity.CUDA, ProfilerActivity.CPU}
            scopes = {RecordScope.USER_SCOPE}
        else:
            acts, scopes = {ProfilerActivity.CPU}, set()  # every host op
        cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                             _ExperimentalConfig())
        _prepare_profiler(cfg, acts)
        _enable_profiler(cfg, acts, scopes)

    def stop(self) -> None:
        from torch._C._autograd import _disable_profiler

        self.result = _disable_profiler()

    def trace(self) -> dict:
        """The recorded Chrome trace."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.result.save(path)
            with open(path) as f:
                return json.load(f)
        finally:
            os.remove(path)


def parse(trace: dict) -> Tuple[List[dict], List[dict], List[dict]]:
    """The trace's device events (name, t0, dur, kernel, corr), host runtime
    calls (name, t0, dur, tid, corr) and program spans (name without the
    prefix, tid, t0, dur), times in seconds."""
    dev, host, spans = [], [], []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        rec = dict(name=e.get("name", ""), t0=float(e["ts"]) * 1e-6,
                   dur=float(e["dur"]) * 1e-6)
        cat = e.get("cat")
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            rec.update(kernel=cat == "kernel", corr=corr)
            dev.append(rec)
        elif cat in HOST_CATS:
            rec.update(tid=e.get("tid"), corr=corr)
            host.append(rec)
        elif cat == "user_annotation" and rec["name"].startswith(SPAN_PREFIX):
            rec.update(name=rec["name"][len(SPAN_PREFIX):], tid=e.get("tid"))
            spans.append(rec)
    return dev, host, spans


class Spans:
    """The program's spans of a trace, by thread: `at(tid, t)` is the name
    of the innermost span open on thread tid at time t, or None."""

    def __init__(self, spans: List[dict]):
        by = defaultdict(list)
        for s in spans:
            by[s["tid"]].append(s)
        self._by = {}
        for tid, ss in by.items():
            ss.sort(key=lambda s: s["t0"])
            ends, reach = [], float("-inf")
            for s in ss:
                reach = max(reach, s["t0"] + s["dur"])
                ends.append(reach)  # the latest end among spans begun by then
            self._by[tid] = (ss, [s["t0"] for s in ss], ends)

    def __bool__(self) -> bool:
        return bool(self._by)

    def at(self, tid, t: float) -> Optional[str]:
        if tid not in self._by:
            return None
        ss, starts, reach = self._by[tid]
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and reach[i] >= t:  # spans begun later nest inside earlier ones
            if ss[i]["t0"] + ss[i]["dur"] >= t:
                return ss[i]["name"]
            i -= 1
        return None


def blocking(name: str) -> bool:
    """A runtime call that returns only when the device has caught up (as
    `benchmark/core/trace.py:idle_gaps` names them)."""
    return any(b in name for b in ("Synchronize", "Memcpy")) and "Async" not in name


def attribute(dev: List[dict], host: List[dict], spans: Spans) -> None:
    """Sets each device event's `span`: the innermost program span open on
    the launching thread at the launch (the runtime call of the same
    correlation id), or None."""
    launch = {e["corr"]: e for e in host if e.get("corr") is not None}
    for e in dev:
        h = launch.get(e.get("corr"))
        e["span"] = spans.at(h["tid"], h["t0"]) if h is not None else None


def layer_ms_per_unit(dev: List[dict], units: int, span: Optional[str]) -> float:
    """Device ms per unit of the attributed events of span `span`; None:
    those under no layer's span (no span, or only a loop phase's)."""
    names = (None,) + PHASES if span is None else (span,)
    return sum(e["dur"] for e in dev if e.get("span") in names) * 1e3 / max(units, 1)


def blocking_in_spans(host: List[dict], spans: Spans) -> Dict[str, Dict[str, int]]:
    """Blocking runtime calls (synchronisations and synchronous copies) made
    inside a program span, counted by the innermost span and the call."""
    by: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    for e in host:
        s = spans.at(e["tid"], e["t0"]) if blocking(e["name"]) else None
        if s:
            by[s][e["name"]] += 1
    return {s: dict(c) for s, c in by.items()}


def device_ms_by_span(dev: List[dict], units: int) -> Dict[str, float]:
    """Device ms per unit by the span each event belongs to, largest first."""
    by: Dict[str, float] = defaultdict(float)
    for e in dev:
        by[e.get("span") or OUTSIDE] += e["dur"] * 1e3 / max(units, 1)
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def ops_by_span(dev: List[dict], n: int = 10) -> Dict[str, Dict[str, float]]:
    """The n device ops of most time, each op's seconds by span."""
    total: Dict[str, float] = defaultdict(float)
    by: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    for e in dev:
        total[e["name"]] += e["dur"]
        by[e["name"]][e.get("span") or OUTSIDE] += e["dur"]
    top = sorted(total, key=lambda k: -total[k])[:n]
    return {k: dict(by[k]) for k in top}


def idle_gaps_by_span(dev: List[dict], spans: Spans, tid) -> Dict[str, float]:
    """Idle seconds between device intervals, summed by the innermost
    program span thread tid (the program's loop) was in at each gap's
    middle, largest first."""
    by: Dict[str, float] = defaultdict(float)
    end = None
    for e in sorted(dev, key=lambda e: e["t0"]):
        t0, t1 = e["t0"], e["t0"] + e["dur"]
        if end is not None and t0 > end:
            by[spans.at(tid, 0.5 * (end + t0)) or OUTSIDE] += t0 - end
        end = t1 if end is None else max(end, t1)
    return dict(sorted(by.items(), key=lambda kv: -kv[1]))
