"""Runs one cell of the benchmark of the PyTorch and CUDA port once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's inputs on the device from the seed, warms up through the
program's own loop, measures for --seconds (or, with --trace 1, profiles a
fixed number of the window's steps), checks the answers of the timed path
against the plain reference, and prints one JSON line last on standard
output. Exits non-zero, printing no result, without enough CUDA devices,
when the program's loop ends before the window closes, or when JAX or the
JAX package has been loaded by the time the result would be printed.
"""
import time  # noqa: I001  (the process clock starts here)

_T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "egogaussian_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def quarter_rates(w):
    """Steps per second (host clock, unsynchronised) in each quarter of the
    window: a diagnostic of drift inside a run, not a metric."""
    marks = [w.t_open] + w.marks
    q = (marks[-1] - marks[0]) / 4
    out = []
    for i in range(4):
        lo, hi = marks[0] + i * q, marks[0] + (i + 1) * q
        out.append(round(sum(1 for t in marks[1:] if lo < t <= hi) / q, 3) if q > 0 else None)
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device, log=sys.stderr):
    """One run of `cell` (benchmark.core.spec.Cell) on `device`. Returns the
    result dict, or None when the run must print no result."""
    import torch

    from benchmark.core import compare, trace as tr, window as win
    from benchmark.core.peaks import FP32_FLOPS, HBM_BYTES_PER_S

    ctx = types.SimpleNamespace(config=cell.config, traffic=cell.traffic, seed=int(seed),
                                device=device, window=None)
    if device.type == "cuda":
        torch.zeros((), device=device)  # CUDA context
        torch.cuda.reset_peak_memory_stats(device)
    t_cuda = time.monotonic()
    state = cell.entry.prepare(ctx)
    t_inputs = time.monotonic()
    tracer = tr.Tracer(device) if trace else None
    ctx.window = win.Window(device, seconds, cell.traffic["warmup_steps"],
                            cell.traffic["trace_steps"] if trace else 0,
                            on_open=tracer.start if trace else None,
                            on_close=tracer.stop if trace else None, process_start=_T0)
    readings = cell.entry.drive(ctx, state)
    w = ctx.window
    if w.t_close is None:
        print("the program's loop ended before the window closed", file=log)
        return None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    parts = dict(cuda_init=t_cuda - _T0, inputs=t_inputs - t_cuda,
                 program_to_first_step=w.t_first - t_inputs, warmup=w.t_open - w.t_first)
    m = dict(units=w.units, window_s=w.window_s, setup_s=w.setup_s, steps=w.window_steps,
             peak_flops=FP32_FLOPS, peak_bytes_per_s=HBM_BYTES_PER_S)
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        dev_ev, host_ev = tracer.events()
        from benchmark.core.spec import compositor_kernels

        names = compositor_kernels(cell.root)
        for e in dev_ev:
            e["compositor"] = e["kernel"] and any(n in e["name"] for n in names)
        m.update(device_events=dev_ev, busy_s=tr.busy_seconds(dev_ev))
        dev_info.update(busy_s=m["busy_s"], window_s=w.window_s)
        breakdown = {"device_ops": tr.top_device_ops(dev_ev),
                     "idle_gaps": tr.idle_gaps(dev_ev, host_ev)}
    t_check = time.monotonic()
    numbers = cell.entry.check(ctx, state, readings)
    correct, checks = compare.decide(numbers, cell.limits)
    parts["check"] = time.monotonic() - t_check
    if trace:
        t_work = time.monotonic()
        m["work"] = cell.entry.work(ctx, state)
        parts["work_count"] = time.monotonic() - t_work
    metrics = {}
    for spec in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(spec["name"]).read(m)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    print(f"card: {power_limit() if device.type == 'cuda' else 'cpu'}", file=log)
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=log)
    out = {"correct": correct, "attempted": w.units,
           "failed": sum(1 for v in checks.values() if not (
               v["limit"] is not None and v["value"] <= v["limit"])),
           "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["seconds"] = {k: round(v, 3) for k, v in parts.items()}
    out["window_quarters"] = quarter_rates(w)
    out["checks"] = checks
    return out


def finish(result, log=sys.stderr, out=sys.stdout) -> int:
    """Prints the result as the last line of standard output and returns 0,
    or prints nothing and returns non-zero when there is no result or when
    JAX or the JAX package has been loaded by then (checked once the run's
    last module, the check and the metric readers included, is in)."""
    if result is None:
        return 3
    bad = forbidden_modules()
    if bad:
        print(f"modules loaded that the port must not use: {bad}", file=log)
        return 4
    out.flush()
    print(json.dumps(result), file=out)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from benchmark.core.spec import Cell

    cell = Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    return finish(run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0)))


if __name__ == "__main__":
    sys.exit(main())
