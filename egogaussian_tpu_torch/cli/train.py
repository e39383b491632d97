"""Training CLI: port of `egogaussian_tpu/cli/train.py` (the drop-in twin of
reference `train.py`).

  python -m egogaussian_tpu_torch.cli.train -s <dataset> -m <output_dir> \
      [--resume] [--checkpoint_every N] [--seed 0] [--lpips_weights f.npz] \
      [--device cuda]

Takes the JAX CLI's flags (stage prefixes --s_, --b_, --c_, --f_, --a_),
reads the same split files (reference train.py:53-65)

  <dataset>/split/training_frames.txt
  <dataset>/split/dynamic_eval_frames.txt
  <dataset>/split/static_eval_frames.txt
  <dataset>/split/phase_frame_index.txt   (alternating static/dynamic pairs)

and writes the same artifact tree under <output_dir>. Runs on the card
unless `--device cpu` is given. With --checkpoint_every N every trainer
saves its state every N iterations (stage 2 after every solved frame) to
static/ckpt_static_phase{p}.npz, background/ckpt_bg.npz,
coarse/ckpt_coarse.npz, fine_obj/<variant>/ckpt_fine_obj.npz and
fine_all/ckpt_fine_all.npz, and a rerun resumes mid-stage from them, with
or without --resume (which skips the stages whose files exist).

--mesh N (N > 1) trains on N ranks started on this host
(parallel/launch.py): stages 1.0 and 1.2 frame-data-parallel over them
(their frame batch raised to a multiple of N), stages 2-6 on rank 0, which
alone writes the tree. --dist_backend picks the collectives' backend:
nccl (the default on cuda) takes one GPU per rank; gloo (the default on
cpu) runs on the CPU with --device cpu, or lets several ranks share a
card. N beyond what the backend can place is refused, as JAX's CLI
refuses a mesh larger than its visible devices.
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

import torch

from egogaussian_tpu_torch.config import add_config_args, extract_config, save_config
from egogaussian_tpu_torch.data.readers import (
    colmap_frame_sizes,
    load_colmap_scene,
    read_phase_index,
    read_split_file,
    write_scene_artifacts,
)
from egogaussian_tpu_torch.parallel.launch import BACKENDS, default_backend, placeable, spawn
from egogaussian_tpu_torch.pipeline import VideoRun, run_pipeline_scenes
from egogaussian_tpu_torch.utils.console import CONSOLE


def main(argv=None):
    parser = ArgumentParser(description="EgoGaussian training pipeline (PyTorch port)")
    add_config_args(parser)
    parser.add_argument("--resume", action="store_true",
                        help="resume from existing stage artifacts")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--checkpoint_every", type=int, default=0,
                        help="mid-stage checkpoint interval in iterations (0 = off); a "
                             "stage whose ckpt_*.npz exists resumes from it, with or "
                             "without --resume")
    parser.add_argument("--lpips_weights", default=None,
                        help=".npz LPIPS weights (eval/lpips.py)")
    parser.add_argument("--mesh", type=int, default=0, metavar="N",
                        help="frame-data-parallel stages 1.0/1.2 over N ranks (0 or 1: "
                             "one process)")
    parser.add_argument("--dist_backend", choices=BACKENDS, default=None,
                        help="backend of a mesh's collectives (default: nccl on cuda, "
                             "gloo on cpu)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train and evaluate on (default: cuda)")
    args = parser.parse_args(argv)
    cfg = extract_config(args)
    device = torch.device(args.device)
    if args.mesh > 1:
        backend = args.dist_backend or default_backend(device)
        if args.mesh > placeable(backend, device):
            parser.error(f"--mesh {args.mesh}: the {backend} backend places "
                         f"{placeable(backend, device)} ranks on {device.type}")
        CONSOLE.print(f"Frame-data-parallel over {args.mesh} {backend} ranks on {device.type}")
        metrics = spawn(_train_rank, 1, args.mesh, backend, device,
                        args=(cfg, args.seed, args.resume, args.lpips_weights,
                              args.checkpoint_every))
        CONSOLE.print("Final metrics:", metrics[0])
        return metrics
    lpips_fn = None
    if args.lpips_weights:
        from egogaussian_tpu_torch.eval.lpips import LPIPS

        lpips_fn = LPIPS(weights_path=args.lpips_weights, device=device)
    result = train_video(cfg, seed=args.seed, resume=args.resume, lpips_fn=lpips_fn,
                         checkpoint_every=args.checkpoint_every, device=device)
    CONSOLE.print("Final metrics:", result.metrics)
    return result


def _train_rank(mesh, cfg, seed, resume, lpips_weights, checkpoint_every):
    """One rank of --mesh N: returns stage 6's metrics on rank 0, None on
    the others."""
    lpips_fn = None
    if lpips_weights:
        from egogaussian_tpu_torch.eval.lpips import LPIPS

        lpips_fn = LPIPS(weights_path=lpips_weights, device=mesh.device)
    result = train_video(cfg, seed=seed, resume=resume, lpips_fn=lpips_fn,
                         checkpoint_every=checkpoint_every, device=mesh.device, mesh=mesh)
    return None if result is None else result.metrics


def train_video(cfg, seed: int, resume: bool, lpips_fn, checkpoint_every: int,
                device: torch.device, fine_variant: str = "from-coarse", stop_after=None,
                mesh=None):
    """The pipeline on the dataset at cfg.model.source_path, its tree under
    cfg.model.model_path (default <dataset>/output): cfg_args.json, the
    scene's input.ply and cameras.json, then run_pipeline's files. Returns
    run_pipeline's result. On a mesh, rank (s, 0) writes the tree."""
    return train_videos([cfg], [seed], resume, lpips_fn, checkpoint_every, device,
                        fine_variant=fine_variant, stop_after=stop_after, mesh=mesh)[0]


def train_videos(cfgs, seeds, resume: bool, lpips_fn, checkpoint_every: int,
                 device: torch.device, fine_variant: str = "from-coarse", stop_after=None,
                 mesh=None):
    """train_video for several datasets in lockstep (cfgs[i] and seeds[i]
    per video, the other settings cfgs[0]'s): every training stage runs
    one batched step per iteration for all of them (run_pipeline_scenes),
    and each tree holds the files its own train_video writes, byte for
    byte. Videos whose frames differ in size raise ValueError before
    anything is written (they cannot share a stack). Returns the
    per-video results."""
    mix = frame_size_mix(cfgs)
    if mix:
        raise ValueError(mix)
    runs = [video_run(cfg, seed, lpips_fn, device, mesh) for cfg, seed in zip(cfgs, seeds)]
    return run_pipeline_scenes(runs, cfgs[0], backend=cfgs[0].render.backend, resume=resume,
                               fine_variant=fine_variant, checkpoint_every=checkpoint_every,
                               mesh=mesh, device=device, stop_after=stop_after)


def frame_size_mix(cfgs) -> str:
    """Why the datasets of `cfgs` cannot share a lockstep ("" when they
    can): their frames, read from the COLMAP files alone, differ in size.
    The message names each dataset's sizes. One dataset always can."""
    if len(cfgs) < 2:
        return ""
    sizes = [colmap_frame_sizes(c.model.source_path, c.model.images, c.model.resolution)
             for c in cfgs]
    if len({tuple(x) for x in sizes}) <= 1:
        return ""
    return ("videos whose frames differ in size cannot train in one lockstep: "
            + "; ".join(f"{c.model.source_path}: " + ", ".join(f"{w}x{h}" for w, h in x)
                        for c, x in zip(cfgs, sizes)))


def video_run(cfg, seed: int, lpips_fn, device: torch.device, mesh=None) -> VideoRun:
    """The dataset at cfg.model.source_path loaded for the pipeline, with
    the tree's first files written under cfg.model.model_path (default
    <dataset>/output): cfg_args.json, the scene's input.ply and
    cameras.json. Returns run_pipeline_scenes' VideoRun."""
    src = cfg.model.source_path
    out = cfg.model.model_path or os.path.join(src, "output")
    writes = mesh is None or mesh.writes
    if writes:
        os.makedirs(out, exist_ok=True)
        save_config(cfg, os.path.join(out, "cfg_args.json"))

    split_dir = os.path.join(src, "split")
    training_frames = read_split_file(os.path.join(split_dir, "training_frames.txt"))
    dynamic_eval = read_split_file(os.path.join(split_dir, "dynamic_eval_frames.txt"))
    static_eval = read_split_file(os.path.join(split_dir, "static_eval_frames.txt"))
    static_phases, dynamic_phases = read_phase_index(
        os.path.join(split_dir, "phase_frame_index.txt"))

    CONSOLE.print(f"Loading COLMAP scene from {src}")
    scene = load_colmap_scene(src, device, cfg.model.images, cfg.model.resolution)
    CONSOLE.print(f"{len(scene.cameras)} cameras, {len(scene.points)} init points, "
                  f"extent {scene.cameras_extent:.3f}")
    # input.ply + cameras.json for external viewers (reference
    # scene/__init__.py:79-91)
    if writes:
        write_scene_artifacts(scene, out)
    return VideoRun(scene, out, training_frames=training_frames,
                    dynamic_eval_frames=dynamic_eval, static_eval_frames=static_eval,
                    static_phases=static_phases, dynamic_phases=dynamic_phases, seed=seed,
                    lpips_fn=lpips_fn)


if __name__ == "__main__":
    main()
