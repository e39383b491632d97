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
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

import torch

from egogaussian_tpu_torch.config import add_config_args, extract_config, save_config
from egogaussian_tpu_torch.data.readers import (
    load_colmap_scene,
    read_phase_index,
    read_split_file,
    write_scene_artifacts,
)
from egogaussian_tpu_torch.pipeline import run_pipeline
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
                        help="frame-data-parallel training over N devices (not ported yet)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train and evaluate on (default: cuda)")
    args = parser.parse_args(argv)
    if args.mesh > 1:
        parser.error("--mesh > 1: frame-data-parallel training is not ported yet "
                     "(ROADMAP.md §A, the parallel layer)")
    cfg = extract_config(args)
    device = torch.device(args.device)
    lpips_fn = None
    if args.lpips_weights:
        from egogaussian_tpu_torch.eval.lpips import LPIPS

        lpips_fn = LPIPS(weights_path=args.lpips_weights, device=device)
    result = train_video(cfg, seed=args.seed, resume=args.resume, lpips_fn=lpips_fn,
                         checkpoint_every=args.checkpoint_every, device=device)
    CONSOLE.print("Final metrics:", result.metrics)
    return result


def train_video(cfg, seed: int, resume: bool, lpips_fn, checkpoint_every: int,
                device: torch.device, fine_variant: str = "from-coarse", stop_after=None):
    """The pipeline on the dataset at cfg.model.source_path, its tree under
    cfg.model.model_path (default <dataset>/output): cfg_args.json, the
    scene's input.ply and cameras.json, then run_pipeline's files. Returns
    run_pipeline's result."""
    src = cfg.model.source_path
    out = cfg.model.model_path or os.path.join(src, "output")
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
    write_scene_artifacts(scene, out)

    return run_pipeline(
        scene, cfg, out,
        training_frames=training_frames,
        dynamic_eval_frames=dynamic_eval,
        static_eval_frames=static_eval,
        static_phases=static_phases,
        dynamic_phases=dynamic_phases,
        seed=seed,
        backend=cfg.render.backend,
        resume=resume,
        lpips_fn=lpips_fn,
        fine_variant=fine_variant,
        checkpoint_every=checkpoint_every,
        device=device,
        stop_after=stop_after,
    )


if __name__ == "__main__":
    main()
