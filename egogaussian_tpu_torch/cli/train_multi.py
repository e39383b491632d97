"""Multi-video training CLI: several datasets in one process on the one
card.

Port of `egogaussian_tpu/cli/train_multi.py`. The reference trains V videos
as V jobs, one GPU each (train.sh:13-19); JAX's CLI trains them in one
process, stacked on a scene axis in lockstep. Here the videos train one
after the other, each through the six-stage pipeline of cli/train.py
(run_pipeline) with seed --seed + i, so video i's output tree is the one
`cli.train -s <dataset i> -m <output i> --seed <seed + i>` writes. Every
scene is stepped on the one card either way; a lockstep whose scenes share
one launch is ROADMAP.md §A's scene-batched launch, to be measured against
this loop.

  python -m egogaussian_tpu_torch.cli.train_multi --videos ds1 ds2 \\
      --outputs out1 out2 [--mesh 1x1] [--seed 0] [--stage1_only] \\
      [--through_coarse] [--resume] [--checkpoint_every N] \\
      [--fine_variant from-coarse] [--lpips_weights f.npz] [--device cuda]

Every dataset follows the reference layout (split/*.txt, as cli/train.py
reads it) and every config flag of cli/train.py applies to all videos.
--stage1_only stops each video after stage 1.2 and --through_coarse after
stage 2, where JAX's CLI stops; --resume skips every stage whose files
exist, per video; --checkpoint_every is run_pipeline's. Runs on the card
unless `--device cpu` is given. `--mesh SxD` with S·D > 1 is refused:
sharding videos or frames over devices is the distributed layer, not
ported yet (ROADMAP.md §A).
"""
from __future__ import annotations

import dataclasses
import os
from argparse import ArgumentParser

import torch

from egogaussian_tpu_torch.cli.train import train_video
from egogaussian_tpu_torch.config import add_config_args, extract_config
from egogaussian_tpu_torch.utils.console import CONSOLE


def _check_mesh(parser, text: str) -> None:
    """Refuse any --mesh but one device (1x1)."""
    try:
        n_scene, n_data = (int(x) for x in text.lower().split("x"))
    except ValueError:
        parser.error(f"--mesh {text}: expected SxD, e.g. 1x1")
    if n_scene * n_data != 1:
        parser.error(f"--mesh {text}: {n_scene * n_data} devices; sharding videos or frames "
                     "over devices is not ported yet (ROADMAP.md §A, the distributed slice); "
                     "--mesh 1x1 trains every video on the one card")


def main(argv=None) -> int:
    parser = ArgumentParser(description="EgoGaussian multi-video training (PyTorch port)")
    add_config_args(parser)
    parser.add_argument("--videos", nargs="+", required=True, metavar="DATASET_DIR")
    parser.add_argument("--outputs", nargs="*", default=[], metavar="OUTPUT_DIR",
                        help="default: <dataset>/output per video")
    parser.add_argument("--mesh", default="1x1", metavar="SxD",
                        help="scene x data mesh; only 1x1 (the one card) is ported")
    parser.add_argument("--seed", type=int, default=0, help="video i trains with seed + i")
    parser.add_argument("--stage1_only", action="store_true",
                        help="stop after stages 1.0-1.2")
    parser.add_argument("--through_coarse", action="store_true",
                        help="stop after stage 2")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--checkpoint_every", type=int, default=0,
                        help="mid-stage checkpoint interval in iterations (0 = off)")
    parser.add_argument("--fine_variant", default="from-coarse",
                        choices=("from-static", "from-coarse"),
                        help="which stage-3 variant feeds stage 5")
    parser.add_argument("--lpips_weights", default=None,
                        help=".npz LPIPS weights for stage 6 (eval/lpips.py)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train and evaluate on (default: cuda)")
    args = parser.parse_args(argv)
    _check_mesh(parser, args.mesh)
    cfg = extract_config(args)
    device = torch.device(args.device)

    srcs = [os.path.abspath(s) for s in args.videos]
    outs = [os.path.abspath(o) for o in args.outputs] or [os.path.join(s, "output")
                                                         for s in srcs]
    if len(outs) != len(srcs):
        parser.error(f"{len(srcs)} videos but {len(outs)} outputs")
    stop_after = "background" if args.stage1_only else "coarse" if args.through_coarse else None

    lpips_fn = None
    if args.lpips_weights:
        from egogaussian_tpu_torch.eval.lpips import LPIPS

        lpips_fn = LPIPS(weights_path=args.lpips_weights, device=device)
    for i, (src, out) in enumerate(zip(srcs, outs)):
        CONSOLE.print(f"[multi] video {i + 1} of {len(srcs)}: {src}")
        cfg_i = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, source_path=src, model_path=out))
        result = train_video(cfg_i, seed=args.seed + i, resume=args.resume, lpips_fn=lpips_fn,
                             checkpoint_every=args.checkpoint_every, device=device,
                             fine_variant=args.fine_variant, stop_after=stop_after)
        if result is not None:
            CONSOLE.print(f"{src}: final metrics {result.metrics}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
