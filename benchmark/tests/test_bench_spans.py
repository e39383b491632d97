"""The reading of the program's spans (benchmark/core/spans.py), on a
hand-built Chrome trace: device events attributed by correlation id to the
innermost span open on the launching thread (the backward's spans on a
second thread), blocking calls counted inside spans, the unspanned time,
idle gaps by the main thread's span; the trace's device events and runtime
calls read as benchmark/core/trace.py reads them; and
benchmark/span_trace.py's readings of a tiny cell with that trace in the
profiler's place."""
import pytest

from benchmark.core import readers
from benchmark.core import spans as sp
from benchmark.core import trace as tr

MAIN, BWD, OTHER = 11, 22, 33  # the program's thread, autograd's, a third
US = 1e-6

# (name, tid, t0, dur) in µs: a forward on MAIN, its backward on BWD
SPANS = [("step", MAIN, 0, 100), ("project", MAIN, 10, 5), ("layout", MAIN, 15, 10),
         ("bin", MAIN, 16, 4), ("composite", MAIN, 25, 5), ("loss", MAIN, 30, 5),
         ("loss", BWD, 40, 5), ("composite", BWD, 45, 5), ("layout", BWD, 50, 20),
         ("project", BWD, 70, 5), ("adam", MAIN, 80, 10)]
# correlation id: (launching thread, launch time, device t0, device dur, cat, name)
LAUNCHES = {
    1: (MAIN, 5, 6, 1, "kernel", "vectorized_elementwise_kernel"),
    2: (MAIN, 11, 12, 2, "kernel", "elementwise_kernel"),
    3: (MAIN, 17, 18, 1, "kernel", "radixSortKernel"),
    4: (MAIN, 22, 23, 1, "kernel", "vectorized_gather_kernel"),
    5: (MAIN, 26, 26.5, 3, "kernel", "egogs::tilegrid_fwd_kernel<3, 32>"),
    6: (MAIN, 31, 31, 2, "kernel", "conv_depthwise2d_forward_kernel"),
    7: (BWD, 41, 42, 1, "kernel", "conv_depthwise2d_backward_kernel"),
    8: (BWD, 46, 46, 2, "kernel", "egogs::tilegrid_bwd_kernel<3, 32>"),
    9: (BWD, 55, 48, 20, "kernel", "indexing_backward_kernel_small_stride"),
    10: (BWD, 72, 72, 1, "kernel", "elementwise_kernel"),
    11: (MAIN, 85, 85, 1, "gpu_memset", "Memset (Device)"),
    12: (MAIN, 150, 150, 1, "kernel", "elementwise_kernel"),
    13: (OTHER, 30, 152, 1, "kernel", "elementwise_kernel"),
}
EXPECTED_SPAN = {1: "step", 2: "project", 3: "bin", 4: "layout", 5: "composite", 6: "loss",
                 7: "loss", 8: "composite", 9: "layout", 10: "project", 11: "adam", 12: None,
                 13: None, 99: None}
# blocking or not: (name, tid, t0, dur)
HOST = [("cudaStreamSynchronize", MAIN, 6, 3), ("cudaMemcpy", MAIN, 82, 1),
        ("cudaMemcpyAsync", MAIN, 83, 1), ("cudaStreamSynchronize", MAIN, 120, 2),
        ("cudaDeviceSynchronize", BWD, 60, 1)]


def _x(cat, name, ts, dur, tid, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=1, tid=tid, args=args)


def trace(with_spans=True):
    evs = [_x("cuda_runtime", "cudaLaunchKernel", t, 0.5, tid, correlation=c)
           for c, (tid, t, *_) in LAUNCHES.items()]
    evs += [_x(cat, name, t0, dur, 7, correlation=c)
            for c, (_, _, t0, dur, cat, name) in LAUNCHES.items()]
    evs.append(_x("kernel", "elementwise_kernel", 151, 1, 7, correlation=99))  # no launch seen
    evs += [_x("cuda_runtime", n, t, d, tid) for n, tid, t, d in HOST]
    evs.append(dict(ph="s", cat="ac2g", name="ac2g", ts=5, id=1, pid=1, tid=MAIN))
    if with_spans:
        evs += [_x("user_annotation", "egogs." + n, t, d, tid) for n, tid, t, d in SPANS]
        evs.append(_x("user_annotation", "some other range", 0, 200, MAIN))
        evs.append(_x("gpu_user_annotation", "egogs.layout", 15, 60, 7))
    return {"traceEvents": evs}


def readings(with_spans=True, units=2):
    """The readings `m` the existing readers take, the attributed device
    events among them, and the runtime calls and spans."""
    dev, host, span_ev = sp.parse(trace(with_spans))
    for e in dev:
        e["compositor"] = e["kernel"] and "tilegrid" in e["name"]
    spans = sp.Spans(span_ev)
    sp.attribute(dev, host, spans)
    m = dict(units=units, window_s=200 * US, device_events=dev, busy_s=tr.busy_seconds(dev))
    return m, host, spans


def test_attribution_by_launching_thread():
    m, _, _ = readings()
    got = {e["corr"]: e["span"] for e in m["device_events"]}
    assert got == EXPECTED_SPAN


def test_blocking_calls_inside_spans():
    _, host, spans = readings()
    # two on the program's thread, one on autograd's; the async copy and the
    # sync after the step's span are not counted
    assert sp.blocking_in_spans(host, spans) == {
        "step": {"cudaStreamSynchronize": 1}, "adam": {"cudaMemcpy": 1},
        "layout": {"cudaDeviceSynchronize": 1}}


def test_layer_and_unspanned_ms():
    m, _, _ = readings()
    dev = m["device_events"]
    ms = {s: sp.layer_ms_per_unit(dev, 2, s)
          for s in ("project", "bin", "layout", "composite", "loss", "adam")}
    assert ms == pytest.approx({"project": 1.5e-3, "bin": 0.5e-3, "layout": 10.5e-3,
                                "composite": 2.5e-3, "loss": 1.5e-3, "adam": 0.5e-3})
    # the launch in `step` alone, outside every span, on a thread without
    # spans, and with no launch seen
    assert sp.layer_ms_per_unit(dev, 2, None) == pytest.approx(2e-3)
    whole = readers.device_ms_per_unit(m, True) + readers.device_ms_per_unit(m, False)
    assert sum(ms.values()) + sp.layer_ms_per_unit(dev, 2, None) == pytest.approx(whole)
    by = sp.device_ms_by_span(dev, 2)
    assert by == pytest.approx({"layout": 10.5e-3, "composite": 2.5e-3, sp.OUTSIDE: 1.5e-3,
                                "project": 1.5e-3, "loss": 1.5e-3, "bin": 0.5e-3,
                                "adam": 0.5e-3, "step": 0.5e-3})
    top = sp.ops_by_span(dev, n=2)
    assert list(top) == ["indexing_backward_kernel_small_stride", "elementwise_kernel"]
    assert top["elementwise_kernel"] == pytest.approx(
        {"project": 3 * US, sp.OUTSIDE: 3 * US})


def test_idle_gaps_by_the_main_threads_span():
    m, _, spans = readings()
    gaps = sp.idle_gaps_by_span(m["device_events"], spans, MAIN)
    assert gaps == pytest.approx({"bin": 4 * US, "layout": 4 * US, "composite": 2.5 * US,
                                  "loss": 1.5 * US, "step": 33 * US, sp.OUTSIDE: 64 * US})
    assert list(gaps)[0] == sp.OUTSIDE  # largest first
    assert sum(gaps.values()) == pytest.approx(109 * US)


class _Exported:
    """Stands in for torch.profiler.profile: exports a given trace."""

    def __init__(self, t):
        self.t = t

    def export_chrome_trace(self, path):
        import json

        with open(path, "w") as f:
            json.dump(self.t, f)


@pytest.mark.parametrize("with_spans", [False, True], ids=["no_spans", "spans"])
def test_parse_reads_what_the_benchmarks_tracer_reads(with_spans):
    """spans.parse reads the device events and runtime calls that
    trace.Tracer.events reads from the same trace, so the existing readers
    read from its events what they read in the benchmark's traced run."""
    t = trace(with_spans)
    tracer = tr.Tracer(None)
    tracer.prof = _Exported(t)
    old_dev, old_host = tracer.events()
    dev, host, spans = sp.parse(t)
    assert [{k: e[k] for k in ("name", "t0", "dur", "kernel")} for e in dev] == old_dev
    assert [{k: e[k] for k in ("name", "t0", "dur")} for e in host] == old_host
    assert tr.idle_gaps(dev, host) == tr.idle_gaps(old_dev, old_host)
    assert bool(spans) == with_spans


class _HandTracer:
    """Stands in for SpanTracer: the hand-built trace, its main thread."""

    thread = MAIN

    def start(self):
        pass

    def stop(self):
        pass

    def trace(self):
        return trace()


def test_span_trace_reads_a_tiny_cell(tmp_path):
    """benchmark/span_trace.py over a tiny static cell on the CPU with the
    hand-built trace in the profiler's place: the layers' and the
    unspanned ms sum to the existing readers' compositor and other ops'."""
    import gzip
    import json

    import torch

    from benchmark.span_trace import span_readings
    from benchmark.tests.bench_tiny import SEED, tiny_cell

    keep = tmp_path / "t.json.gz"
    res = span_readings(tiny_cell("scene_static_std"), SEED, torch.device("cpu"),
                        tracer=_HandTracer(), keep=str(keep))
    assert res["steps"] == 3 and res["spans_recorded"] == len(SPANS)
    n = res["units"]
    layers = res["device_ms_per_it"]
    ex = res["existing"]
    assert sum(layers.values()) == pytest.approx(ex["compositor_ms_per_it"]
                                                 + ex["torch_ops_ms_per_it"])
    assert layers["layout"] == pytest.approx(21e-3 / n)
    assert res["host_syncs_per_it"] == pytest.approx(3 / n)
    assert res["idle_ms_per_it_by_span"]["bin"] == pytest.approx(4e-3 / n)
    assert res["events_without_launch"] == 1
    with gzip.open(keep, "rt") as f:
        assert json.load(f) == trace()


def test_span_tracer_records_the_programs_spans():
    """SpanTracer on the CPU records the program's span on the thread it
    names as the loop's."""
    import torch

    from egogaussian_tpu_torch.utils.logging import span

    tracer = sp.SpanTracer(torch.device("cpu"))
    tracer.start()
    with span("layout"):
        torch.ones(4).sum()
    tracer.stop()
    _, _, span_ev = sp.parse(tracer.trace())
    assert [(s["name"], s["tid"]) for s in span_ev] == [("layout", tracer.thread)]
