"""Traces one cell's window with the program's spans and prints, as one JSON
line, where its device time, idle time and host syncs fall by span.

    python3 benchmark/span_trace.py --workload <name> --seed <n> [--keep trace.json.gz]

Builds and warms up the cell as `benchmark/run.py` does, then records the
cell's `trace_steps` window steps with `benchmark.core.spans.SpanTracer`
(CUDA activity and the program's "egogs.*" ranges only), and reads the
trace: device ms per unit by the layer span that launched each event (and
under none), the existing readers' numbers from the same events for
comparison, the blocking runtime calls made inside each span, the idle
gaps by the span the program's loop was in, and the top device ops split
by span. No correctness check is made. `--keep` writes the raw Chrome
trace, gzipped.
"""
import time  # noqa: I001  (the process clock starts here)

_T0 = time.monotonic()

import argparse  # noqa: E402
import gzip  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

LAYERS = ("project", "bin", "layout", "composite", "loss", "adam", "densify")


def span_readings(cell, seed: int, device, tracer=None, keep=None) -> dict:
    """Runs `cell` to the end of its traced window and reads the trace."""
    from benchmark.core import readers, spans as sp, trace as tr, window as win
    from benchmark.core.spec import compositor_kernels

    ctx = types.SimpleNamespace(config=cell.config, traffic=cell.traffic, seed=int(seed),
                                device=device, window=None)
    state = cell.entry.prepare(ctx)
    tracer = tracer or sp.SpanTracer(device)
    ctx.window = win.Window(device, 0.0, cell.traffic["warmup_steps"], cell.traffic["trace_steps"],
                            on_open=tracer.start, on_close=tracer.stop, process_start=_T0)
    cell.entry.drive(ctx, state)
    w = ctx.window
    if w.t_close is None:
        raise RuntimeError("the program's loop ended before the window closed")
    trace = tracer.trace()
    if keep:
        with gzip.open(keep, "wt") as f:
            json.dump(trace, f)
    dev, host, span_ev = sp.parse(trace)
    names = compositor_kernels(cell.root)
    for e in dev:
        e["compositor"] = e["kernel"] and any(n in e["name"] for n in names)
    spans = sp.Spans(span_ev)
    sp.attribute(dev, host, spans)
    units = w.units
    m = dict(units=units, window_s=w.window_s, device_events=dev, busy_s=tr.busy_seconds(dev))
    syncs = sp.blocking_in_spans(host, spans)
    launched = {e["corr"] for e in host if e["corr"] is not None}
    per = 1e3 / max(units, 1)
    return {
        "units": units, "steps": w.window_steps, "window_s": w.window_s,
        "spans_recorded": len(span_ev),
        "device_ms_per_it": {s: sp.layer_ms_per_unit(dev, units, s) for s in LAYERS}
        | {"unspanned": sp.layer_ms_per_unit(dev, units, None)},
        "existing": {"compositor_ms_per_it": readers.device_ms_per_unit(m, True),
                     "torch_ops_ms_per_it": readers.device_ms_per_unit(m, False),
                     "launches_per_it": readers.launches_per_unit(m),
                     "device_idle_share": readers.idle_share(m)},
        "host_syncs_per_it": sum(sum(c.values()) for c in syncs.values()) / max(units, 1),
        "host_syncs_by_span": syncs,
        "device_ms_by_span": sp.device_ms_by_span(dev, units),
        "idle_ms_per_it_by_span": {k: v * per
                                   for k, v in sp.idle_gaps_by_span(dev, spans,
                                                                    tracer.thread).items()},
        "events_without_launch": sum(1 for e in dev if e["corr"] not in launched),
        "ops_ms_per_it_by_span": {k: {s: v * per for s, v in by.items()}
                                  for k, by in sp.ops_by_span(dev).items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--keep", default=None, help="write the raw Chrome trace here (gzipped)")
    args = ap.parse_args(argv)
    import torch

    from benchmark.core.spec import Cell
    from benchmark.run import power_limit

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.zeros((), device=device)
    out = span_readings(Cell(args.workload), args.seed, device, keep=args.keep)
    out["card"] = power_limit()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
