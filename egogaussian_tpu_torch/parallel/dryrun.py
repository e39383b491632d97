"""Single-device forward check and multi-rank dry run.

Port of the repository's `__graft_entry__.py` (`entry`, `dryrun_multichip`)
for the PyTorch package:

  * entry() -> (fn, example_args): a forward step (render + photometric
    loss) on a synthetic flagship model, on the card.
  * dryrun_multichip(n): n ranks on this host, each running one step of
    the frame-data-parallel paths on tiny shapes, rank 0 printing one line
    per check in JAX's form. With n or more CUDA devices the ranks are
    nccl ranks, one per card; with fewer they are gloo ranks on the CPU
    (JAX's re-exec on an n-device virtual CPU mesh). The checks:
      - the real static step (train/static.py:_dp_static_step), frames
        sharded over the data axis;
      - the dp step (make_dp_train_step on replicate / shard_batch inputs);
      - the memory-sharded render (make_memory_sharded_render);
      - for even n, on a second grid of 2 scene rows x n / 2 data ranks:
        the real static step with two scenes stacked on each rank's scene
        axis (multi_scene_static_step, per-scene xyz-rate factors, frames
        sharded over the row's data axis), then the coarse, fine_obj and
        fine_all steps on the scene axis with per-scene flags.

  python -m egogaussian_tpu_torch.parallel.dryrun [N]
"""
from __future__ import annotations

import sys

import numpy as np
import torch


def _flagship(device, n_gaussians=20_000, width=320, height=240, frames=8):
    """Synthetic flagship set-up: a mid-size scene and a frame batch."""
    from egogaussian_tpu_torch.data import make_synthetic_video, stack_cameras
    from egogaussian_tpu_torch.models import adam_init, from_points

    rng = np.random.RandomState(0)
    pts = rng.randn(n_gaussians // 2, 3).astype(np.float32)
    cols = rng.rand(n_gaussians // 2, 3).astype(np.float32)
    model = from_points(pts, cols, device, capacity=n_gaussians)
    vid = make_synthetic_video(device, width=width, height=height, n_bg=64, n_obj=16,
                               frames_static=max(2, frames // 2),
                               frames_dynamic=frames // 4 or 1)
    return model, adam_init(model.params), stack_cameras(vid.cameras[:frames], device)


def entry(device=None):
    """(fn, example_args): fn(model, batch, frame_idx) -> (loss, image), a
    forward step on the flagship model on `device` (None: the card)."""
    from egogaussian_tpu_torch.train.common import image_loss, render_gaussians

    device = torch.device("cuda") if device is None else device
    model, _, batch = _flagship(device, n_gaussians=8192, width=160, height=120, frames=4)

    def forward(model, batch, frame_idx):
        cam, gt, _, _ = batch.frame(frame_idx)
        res = render_gaussians(model, cam, torch.zeros(3, device=model.device))
        return image_loss(res.image, gt, 0.2), res.image

    return forward, (model, batch, 0)


def _dryrun_rank(mesh, n):
    """The checks on one rank; returns its lines (rank 0 prints them)."""
    from egogaussian_tpu_torch.config import Config
    from egogaussian_tpu_torch.models.optim import gaussian_lr_tree
    from egogaussian_tpu_torch.parallel import (
        make_dp_train_step,
        make_memory_sharded_render,
        replicate,
        shard_batch,
    )
    from egogaussian_tpu_torch.train.common import auto_tile_config, model_colors
    from egogaussian_tpu_torch.train.static import _dp_static_step

    dev = mesh.device
    model, opt_state, batch = _flagship(dev, n_gaussians=2048, width=64, height=48, frames=n)
    cfg = Config()
    lines = []

    tile_cfg = auto_tile_config(model, batch.camera(0))
    new_model, _, loss, _, drop = _dp_static_step(
        model, opt_state, batch, list(range(n)), batch.hand_masks, 100,
        torch.zeros((), dtype=torch.int64, device=dev), mesh=mesh, mode="std",
        backend="tiled", tile_config=tile_cfg, opt_cfg=cfg.opt)
    if not (torch.isfinite(loss) and torch.isfinite(new_model.aux.xyz_gradient_accum).all()):
        raise AssertionError(f"frame-DP static step: loss {float(loss)}")
    lines.append(f"dryrun_multichip({n}) REAL static step (frame-DP): "
                 f"loss={float(loss):.5f} dropped={int(drop)} OK")

    step = make_dp_train_step(mesh)
    lr = gaussian_lr_tree(1, cfg.opt, 1.0, label_lr=0.0)
    _, _, loss = step(replicate(mesh, model), replicate(mesh, opt_state), batch,
                      shard_batch(mesh, torch.arange(n, device=dev)).tolist(), lr)
    if not torch.isfinite(loss):
        raise AssertionError(f"dp step: loss {float(loss)}")
    lines.append(f"dryrun_multichip({n}) dp: loss={float(loss):.5f} OK")

    msr = make_memory_sharded_render(mesh, batch.camera(0), capacity_factor=3.0)
    out, dropped = msr(*shard_batch(mesh, (model.params.xyz, model.covariance(),
                                           model_colors(model), model.opacity,
                                           model.aux.alive)))
    if not torch.isfinite(out.image).all():
        raise AssertionError("memory-sharded render: non-finite image")
    lines.append(f"dryrun_multichip({n}) memory-sharded render: dropped={int(dropped)} OK")
    if mesh.rank == 0:
        print("\n".join(lines), flush=True)
    return lines


def _dryrun_scene_rank(mesh, n):
    """The scene-axis checks on one rank of a 2 x n / 2 grid: each rank
    stacks two scenes (its own scene row's) on its scene axis."""
    from egogaussian_tpu_torch.config import Config
    from egogaussian_tpu_torch.models import adam_init
    from egogaussian_tpu_torch.models.pose import empty_pose_sequence, identity_pose
    from egogaussian_tpu_torch.parallel.multi_scene import (
        multi_scene_coarse_step,
        multi_scene_fine_all_step,
        multi_scene_fine_step,
        multi_scene_static_step,
        stack_scenes,
    )
    from egogaussian_tpu_torch.train.common import auto_tile_config

    dev = mesh.device
    b = mesh.shape["data"]
    model, opt_state, batch = _flagship(dev, n_gaussians=2048, width=64, height=48,
                                        frames=max(b, 2))
    cfg = Config()
    tile_cfg = auto_tile_config(model, batch.camera(0))
    lines = []
    models = stack_scenes([model, model])
    opts = stack_scenes([opt_state, adam_init(model.params)])
    batches = stack_scenes([batch, batch])
    gmasks = stack_scenes([batch.hand_masks, batch.hand_masks])
    fidxs = torch.arange(b, device=dev)[None].repeat(2, 1)
    mult = torch.tensor([1.0, 1.3], device=dev)
    m2, o2, losses, _, drop2 = multi_scene_static_step(
        models, opts, batches, fidxs, gmasks, 100, xyz_lr_mult=mult, mesh=mesh, mode="std",
        backend="tiled", tile_config=tile_cfg, opt_cfg=cfg.opt)
    if not (torch.isfinite(losses).all() and torch.isfinite(m2.aux.xyz_gradient_accum).all()):
        raise AssertionError(f"scene x data static step: losses {losses.tolist()}")
    lines.append(f"dryrun_multichip({n}) REAL static step, scene x data 2x{b} "
                 f"(two scenes per rank): losses={np.round(losses.tolist(), 5).tolist()} "
                 f"dropped={drop2.tolist()} OK")

    pose = identity_pose(dev)
    poses = stack_scenes([pose, pose])
    pose_opts = stack_scenes([adam_init(pose), adam_init(pose)])
    f_n = batch.viewmats.shape[0]
    eye4 = torch.eye(4, device=dev).expand(2, f_n + 1, 4, 4)
    eye3 = torch.eye(3, device=dev).expand(2, f_n + 1, 3, 3)
    zero = torch.zeros((2,), dtype=torch.int64, device=dev)
    m3, o3, p3, po3, loss3, _, drop3, _ = multi_scene_coarse_step(
        m2, o2, poses, pose_opts, batches, [0, 0], eye4, eye3, [-1, -1], 100, zero,
        train_poses=[True, False], first_frames=[False, True], grad_params=True,
        xyz_lr_mult=mult, mesh=mesh, opt_cfg=cfg.opt, coarse_cfg=cfg.coarse,
        backend="tiled", tile_config=tile_cfg)
    if not torch.isfinite(loss3).all():
        raise AssertionError(f"scene-axis coarse step: losses {loss3.tolist()}")
    lines.append(f"dryrun_multichip({n}) REAL coarse step, scene axis: "
                 f"losses={np.round(loss3.tolist(), 5).tolist()} OK")

    seq = empty_pose_sequence(f_n, device=dev)
    seqs = stack_scenes([seq, seq])
    m4, o4, _, _, loss4, drop4, _ = multi_scene_fine_step(
        m3, o3, seqs, po3, batches, [0, 0], 100, zero, train_poses=[True, False],
        xyz_lr_mult=mult, mesh=mesh, opt_cfg=cfg.opt, fine_cfg=cfg.fine, backend="tiled",
        tile_config=tile_cfg)
    _, _, loss5, _ = multi_scene_fine_all_step(
        m4, o4, batches, [0, 0], eye4[:, :f_n], eye3[:, :f_n], 100, False, zero,
        xyz_lr_mult=mult, mesh=mesh, backend="tiled", tile_config=tile_cfg, opt_cfg=cfg.opt)
    if not (torch.isfinite(loss4).all() and torch.isfinite(loss5).all()):
        raise AssertionError(f"scene-axis fine steps: {loss4.tolist()} / {loss5.tolist()}")
    lines.append(f"dryrun_multichip({n}) REAL fine_obj + fine_all steps, scene axis: "
                 f"losses={np.round(loss4.tolist(), 5).tolist()} / "
                 f"{np.round(loss5.tolist(), 5).tolist()} OK")
    if mesh.rank == 0:
        print("\n".join(lines), flush=True)
    return lines


def dryrun_multichip(n_devices: int):
    """The dry run on n_devices ranks (see the module docstring). Returns
    rank 0's lines; raises on any rank's failure."""
    from egogaussian_tpu_torch.parallel.launch import spawn

    on_cards = torch.cuda.is_available() and torch.cuda.device_count() >= n_devices
    device = torch.device("cuda" if on_cards else "cpu")
    backend = "nccl" if on_cards else "gloo"
    lines = spawn(_dryrun_rank, 1, n_devices, backend, device, args=(n_devices,))[0]
    if n_devices >= 2 and n_devices % 2 == 0:
        lines = lines + spawn(_dryrun_scene_rank, 2, n_devices // 2, backend, device,
                              args=(n_devices,))[0]
    return lines


if __name__ == "__main__":
    fn, example = entry()
    print("entry loss:", float(fn(*example)[0]))
    dryrun_multichip(int(sys.argv[1]) if sys.argv[1:] else max(1, torch.cuda.device_count()))
