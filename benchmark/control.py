"""Readings that the limits of `correct` are set from.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]
        [--control-seeds <n> ...] [--fault-seeds <n> ...] [--faults <name> ...]
        [--seconds 1] [--out <file.jsonl>]

For each of --seeds, one run of the cell's timed path (set-up, warm-up
and a short window) and its comparison with the reference: the lower
readings. For each of --control-seeds, the control: the reference computed
in TF32 (the precision below the configuration's float32 with TF32 off)
put in the program's place: the upper readings. For each of --fault-seeds
and each fault the entry names (`FAULTS`, planted in the reference put in
the program's place; `PLANTED`, planted in the program under its timed
path), the same comparison of the faulty run. Every line is judged against
the cell's limits (`benchmark/limits/<cell>.json`) as a run's would be.
All in one process, one line of JSON per run. Exits 1 if a control or a
fault line comes out correct. The benchmark's own runs never run this.
"""
import argparse
import gc
import importlib
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def program_numbers(cell, ctx, state, seconds):
    from benchmark.core import window as win

    ctx.window = win.Window(ctx.device, seconds, cell.traffic["warmup_steps"])
    readings = cell.entry.drive(ctx, state)
    extra = {}
    if hasattr(cell.entry, "densify_counts"):
        extra["densify_counts"] = cell.entry.densify_counts(ctx, state, readings)
    return cell.entry.check(ctx, state, readings), extra


def planted(cell, ctx, state, seconds, name):
    mod_name, attr, wrap = cell.entry.PLANTED[name]
    mod = importlib.import_module(mod_name)
    orig = getattr(mod, attr)
    setattr(mod, attr, wrap(orig))
    try:
        return program_numbers(cell, ctx, state, seconds)[0]
    finally:
        setattr(mod, attr, orig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=None,
                    help="the faults to read (default: every fault the entry names)")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from benchmark.core import compare
    from benchmark.core.spec import Cell

    cell = Cell(args.workload)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    faults = getattr(cell.entry, "FAULTS", {})
    plants = getattr(cell.entry, "PLANTED", {})
    names = list(faults) + list(plants) if args.faults is None else args.faults
    out = open(args.out, "a") if args.out else None
    jobs = [("program", s) for s in args.seeds] + [("control", s) for s in args.control_seeds] \
        + [(f"fault:{n}", s) for s in args.fault_seeds for n in names]
    slipped = []
    for kind, seed in jobs:
        t = time.monotonic()
        ctx = types.SimpleNamespace(config=cell.config, traffic=cell.traffic, seed=seed,
                                    device=dev, window=None)
        state = cell.entry.prepare(ctx)
        extra = {}
        if kind == "program":
            numbers, extra = program_numbers(cell, ctx, state, args.seconds)
        elif kind == "control":
            numbers = cell.entry.control(ctx, state)
        elif kind[6:] in faults:
            numbers = faults[kind[6:]](ctx, state)
        else:
            numbers = planted(cell, ctx, state, args.seconds, kind[6:])
        correct, _ = compare.decide(numbers, cell.limits)
        if correct and kind != "program":
            slipped.append((kind, seed))
        line = json.dumps(dict(workload=args.workload, kind=kind, seed=seed, correct=correct,
                               seconds=round(time.monotonic() - t, 1), numbers=numbers,
                               **extra))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del state, ctx
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if slipped:
        print(f"control or fault lines that came out correct: {slipped}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
