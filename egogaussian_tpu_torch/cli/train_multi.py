"""Multi-video training CLI: several datasets trained in lockstep, on a
(scene, data) grid of ranks or in one process.

Port of `egogaussian_tpu/cli/train_multi.py`. The reference trains V videos
as V jobs, one GPU each (train.sh:13-19); JAX's CLI trains them in one
process, every stage stacked on a scene axis in lockstep. So does this
one: a scene row's videos go through cli/train.py:train_videos (the
pipeline's lockstep, pipeline.py:run_pipeline_scenes), every training
stage one batched step per iteration for all of them, with seed --seed +
i for video i:

  * --mesh 1x1 (the default): all videos in one lockstep in this process.
  * --mesh SxD with S·D > 1: S·D ranks started on this host
    (parallel/launch.py); scene row s trains videos s, s+S, ... in one
    lockstep, and its D data ranks run stages 1.0 and 1.2
    frame-data-parallel (stages 2-6 on the row's first rank).

Each lane of the lockstep is its own run bit for bit: every op that mixes
a scene's rows into a per-scene quantity runs on the scene's own rows
through its one-scene call (parallel/scene_trainer.py), and each scene
keeps its own random streams, capacities, crop window and files. So video
i's output tree is, file for file and byte for byte, the one
`cli.train -s <dataset i> -m <output i> --seed <seed + i>` writes (with
D = 1), but for cfg_args.json's paths and the metrics log's timings.
Videos whose frames differ in size cannot share a stack, as in JAX: such
a mix within one scene row is refused before anything is written, naming
each video's size (videos on different rows never share a stack).
Unlike JAX's CLI, stage 2 reads stage 1.0's object model back from its
file (ROADMAP.md §C), as the single-video pipeline does.

  python -m egogaussian_tpu_torch.cli.train_multi --videos ds1 ds2 \\
      --outputs out1 out2 [--mesh 1x1] [--dist_backend nccl] [--seed 0] \\
      [--stage1_only] [--through_coarse] [--resume] [--checkpoint_every N] \\
      [--fine_variant from-coarse] [--lpips_weights f.npz] [--device cuda]

Every dataset follows the reference layout (split/*.txt, as cli/train.py
reads it) and every config flag of cli/train.py applies to all videos.
--stage1_only stops each video after stage 1.2 and --through_coarse after
stage 2, where JAX's CLI stops; --resume skips every stage whose files
exist, per video; --checkpoint_every is run_pipeline's, and a rerun resumes
each video mid-stage from its own checkpoint files. Runs on the card
unless `--device cpu` is given. --dist_backend: nccl (the default on cuda,
one GPU per rank) or gloo (the default on cpu; on cuda, ranks may share a
card). A mesh that is not SxD with positive axes, or that has more ranks
than the backend can place, is refused before anything is written.
"""
from __future__ import annotations

import dataclasses
import os
from argparse import ArgumentParser

import torch

from egogaussian_tpu_torch.cli.train import frame_size_mix, train_videos
from egogaussian_tpu_torch.config import add_config_args, extract_config
from egogaussian_tpu_torch.parallel.launch import BACKENDS, default_backend, placeable, spawn
from egogaussian_tpu_torch.utils.console import CONSOLE


def _parse_mesh(parser, text: str, backend: str, device: torch.device):
    """(S, D) from --mesh SxD; refuses malformed text, an axis below 1 and
    more than one rank where the backend cannot place them all."""
    parts = text.lower().split("x")
    try:
        n_scene, n_data = (int(x) for x in parts)
    except ValueError:
        parser.error(f"--mesh {text}: expected SxD, e.g. 2x1")
    if n_scene < 1 or n_data < 1:
        parser.error(f"--mesh {text}: every axis needs at least one rank")
    n = n_scene * n_data
    if n > 1 and n > placeable(backend, device):
        parser.error(f"--mesh {text}: {n} ranks; the {backend} backend places "
                     f"{placeable(backend, device)} on {device.type}")
    return n_scene, n_data


def main(argv=None) -> int:
    parser = ArgumentParser(description="EgoGaussian multi-video training (PyTorch port)")
    add_config_args(parser)
    parser.add_argument("--videos", nargs="+", required=True, metavar="DATASET_DIR")
    parser.add_argument("--outputs", nargs="*", default=[], metavar="OUTPUT_DIR",
                        help="default: <dataset>/output per video")
    parser.add_argument("--mesh", default="1x1", metavar="SxD",
                        help="scene x data grid of ranks (1x1: one process)")
    parser.add_argument("--dist_backend", choices=BACKENDS, default=None,
                        help="backend of the mesh's collectives (default: nccl on cuda, "
                             "gloo on cpu)")
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
    device = torch.device(args.device)
    backend = args.dist_backend or default_backend(device)
    n_scene, n_data = _parse_mesh(parser, args.mesh, backend, device)
    cfg = extract_config(args)

    srcs = [os.path.abspath(s) for s in args.videos]
    outs = [os.path.abspath(o) for o in args.outputs] or [os.path.join(s, "output")
                                                         for s in srcs]
    if len(outs) != len(srcs):
        parser.error(f"{len(srcs)} videos but {len(outs)} outputs")
    for row in range(n_scene):  # videos row, row + S, ... share a stack
        mix = frame_size_mix([dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, source_path=src)) for src in srcs[row::n_scene]])
        if mix:
            parser.error(f"scene row {row}: {mix}" if n_scene > 1 else mix)
    stop_after = "background" if args.stage1_only else "coarse" if args.through_coarse else None
    run = (cfg, srcs, outs, args.seed, args.resume, args.lpips_weights, args.checkpoint_every,
           args.fine_variant, stop_after)
    if n_scene * n_data > 1:
        CONSOLE.print(f"[multi] mesh {n_scene}x{n_data} of {backend} ranks on {device.type}")
        spawn(_scene_row, n_scene, n_data, backend, device, args=run)
    else:
        _train_row(range(len(srcs)), device, None, *run)
    return 0


def _scene_row(mesh, *run):
    """One rank of --mesh SxD: scene row s trains videos s, s+S, ..."""
    _train_row(range(mesh.coords["scene"], len(run[1]), mesh.shape["scene"]), mesh.device,
               mesh, *run)


def _train_row(videos, device, mesh, cfg, srcs, outs, seed, resume, lpips_weights,
               checkpoint_every, fine_variant, stop_after):
    """Videos `videos` of the command line in one lockstep (train_videos)."""
    videos = list(videos)
    if not videos:
        return
    lpips_fn = None
    if lpips_weights:
        from egogaussian_tpu_torch.eval.lpips import LPIPS

        lpips_fn = LPIPS(weights_path=lpips_weights, device=device)
    CONSOLE.print(f"[multi] videos {[i + 1 for i in videos]} of {len(srcs)} in lockstep")
    cfgs = [dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, source_path=srcs[i], model_path=outs[i])) for i in videos]
    results = train_videos(cfgs, [seed + i for i in videos], resume, lpips_fn,
                           checkpoint_every, device, fine_variant=fine_variant,
                           stop_after=stop_after, mesh=mesh)
    for i, result in zip(videos, results):
        if result is not None:
            CONSOLE.print(f"{srcs[i]}: final metrics {result.metrics}")


if __name__ == "__main__":
    raise SystemExit(main())
