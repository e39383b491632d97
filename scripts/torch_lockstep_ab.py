#!/usr/bin/env python3
"""Two videos through the training pipeline of the PyTorch port, one after
the other and in lockstep, at chip_smoke.py's path-5 flags, beside
another checkout's one-video run: chip_smoke.py's path 1 video (seed 0)
and path 8's second video (seed MULTI_SEED), both exported in the
reference's layout.

Run from the root of a checkout, on a machine with a CUDA card:
    python3 scripts/torch_lockstep_ab.py [--other DIR]
Runs, each as its own process:
  1. with --other (for example the parent commit unpacked from `git
     archive` into a gitignored directory): that checkout's cli.train on
     video 0;
  2. this checkout's cli.train_multi over both videos (--seed 0), the
     per-video loop;
  3. the same videos and flags in lockstep (cli/train.py's train_videos,
     through chip_smoke.py's path-10 child entry).
Prints one JSON object: each run's seconds; the files of run 1's tree
whose bytes differ in run 2's video 0 (cfg_args.json and the metrics log
aside); each video of run 3 against its run-2 tree (chip_smoke.compare_runs
and the differing files); per-stage seconds (run 2's two videos summed,
run 3's shared stages); then the card's name and power limit. The trees
are removed at the end.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", default=None, help="checkout whose cli.train runs video 0")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("torch_lockstep_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from egogaussian_tpu_torch.data import make_synthetic_video
    from egogaussian_tpu_torch.data.export_colmap import export_colmap_dataset
    from egogaussian_tpu_torch.eval.lpips import random_lpips_weights, save_lpips_weights

    dev = torch.device("cuda", 0)
    work = os.path.join(ROOT, "build", "lockstep_ab")
    shutil.rmtree(work, ignore_errors=True)
    srcs = [export_colmap_dataset(make_synthetic_video(dev, seed=s, **cs.SLICE_VIDEO),
                                  os.path.join(work, f"data{s}")) for s in (0, cs.MULTI_SEED)]
    weights = os.path.join(work, "lpips.npz")
    save_lpips_weights(random_lpips_weights(0), weights)
    flags = ["--device", "cuda", "--lpips_weights", weights] + cs.pipeline_flags()
    seconds = {}

    def run(tag, cwd, cmd):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable] + cmd, cwd=cwd, capture_output=True, text=True)
        seconds[tag] = time.perf_counter() - t0
        if p.returncode:
            raise RuntimeError(f"{tag} ended with {p.returncode}:\n{p.stderr[-3000:]}")

    out = {}
    per = [os.path.join(work, f"per_video{i}") for i in range(2)]
    lock = [os.path.join(work, f"lockstep{i}") for i in range(2)]
    if args.other:
        other = os.path.join(work, "other0")
        run("other_video0", os.path.abspath(args.other),
            ["-m", "egogaussian_tpu_torch.cli.train", "-s", srcs[0], "-m", other] + flags)
    multi = ["--videos", *srcs, "--seed", "0"] + flags
    run("per_video", ROOT, ["-m", "egogaussian_tpu_torch.cli.train_multi", "--outputs", *per]
        + multi)
    run("lockstep", ROOT, ["chip_smoke.py", "--train-lockstep-child",
                           os.path.join(work, "lockstep_launches.json"), "--", "--outputs", *lock]
        + multi)
    out["seconds"] = seconds
    if args.other:
        out["other_vs_this_video0_files_differ"] = cs.differing_files(other, per[0])
    for i in range(2):
        diff = cs.compare_runs(per[i], lock[i])
        diff.pop("handover")
        out[f"lockstep_vs_per_video{i}"] = dict(diff,
                                                files_differ=cs.differing_files(per[i], lock[i]))
    timed = [{r["name"]: r["seconds"] for r in cs.pipeline_records(o)
              if r.get("event") == "stage_time"} for o in (*per, lock[0])]
    out["stage_seconds"] = {k: {"per_video_sum": timed[0][k] + timed[1][k],
                                "lockstep": timed[2][k]} for k in timed[2]}
    print(json.dumps(out), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
