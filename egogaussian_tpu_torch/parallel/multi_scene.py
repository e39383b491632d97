"""Multi-scene lockstep training: several videos in one process, stacked on
a leading scene axis.

Port of `egogaussian_tpu/parallel/multi_scene.py`. JAX vmaps each stage's
step over the scene axis, which adds a batch axis to every op and to the
grid of every `pallas_call`. Here the step functions take scene-stacked
state and run each op once on [S, ...] tensors: projection, binning,
layouts, loss and Adam, and the compositor is one launch for every
scene's tiles (the scene axis of the kernels, render/cuda_raster.py and
render/window_raster.py). There is no Python loop over scenes inside a
step.

Scene-stacked state (`stack_scenes`): every tensor of a GaussianModel,
AdamState, FrameBatch, ObjectPose or PoseSequence gains a leading scene
axis. Unlike JAX's stack, scenes keep their own capacity and their own
spatial_lr_scale: a smaller model is padded with dead rows to the largest
capacity (`unstack_scenes` cuts them off again), and the stacked model's
spatial_lr_scale is the tuple of the scenes' own. One scene stacks and
unstacks as views, so a one-scene step runs the ops of the unbatched one.

The scene axis is the batch axis of one rank. With a `mesh`, each rank
stacks its own scenes (its scene row's videos) and the frame batch of
`multi_scene_static_step` is split over the mesh's data axis, reduced by
one rank-order all_gather (parallel/mesh.py), as `_dp_static_step`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence

import numpy as np
import torch

from egogaussian_tpu_torch.data.readers import FrameBatch
from egogaussian_tpu_torch.models.gaussians import GaussianAux, GaussianModel, GaussianParams
from egogaussian_tpu_torch.models.optim import AdamState, adam_update
from egogaussian_tpu_torch.models.pose import ObjectPose, PoseSequence
from egogaussian_tpu_torch.parallel.mesh import gather_blocks, max_blocks, sum_blocks
from egogaussian_tpu_torch.utils.logging import span


@dataclasses.dataclass(frozen=True)
class SceneCameras:
    """One camera per scene: viewmat [S, 4, 4], fx / fy / cx / cy [S, 1]
    (broadcast over each scene's Gaussians), a shared frame size."""

    viewmat: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))])


def _stack(xs: Sequence[torch.Tensor], rows: Optional[int] = None) -> torch.Tensor:
    """Stack on a new leading axis (padding dim 0 to `rows`); one tensor
    becomes a view."""
    if len(xs) == 1 and (rows is None or xs[0].shape[0] == rows):
        return xs[0][None]
    if rows is not None:
        xs = [_pad_rows(x, rows) for x in xs]
    return torch.stack(list(xs))


def _fields(x) -> List[str]:
    return [f.name for f in dataclasses.fields(x)]


def stack_scenes(items: Sequence):
    """Stack scenes' GaussianModels, AdamStates (of GaussianParams or
    ObjectPoses), FrameBatches, ObjectPoses, PoseSequences or tensors along
    a new leading scene axis. Models and their Adam states are padded with
    dead rows to the largest capacity; FrameBatches and PoseSequences
    with empty frames to the longest video."""
    first = items[0]
    if isinstance(first, torch.Tensor):  # frame-indexed: padded to the longest
        return _stack(items, max(x.shape[0] for x in items))
    if isinstance(first, GaussianModel):
        cap = max(m.capacity for m in items)
        if len({m.sh_degree for m in items}) != 1:
            raise ValueError("stacked scenes must share the SH degree")
        params = GaussianParams(**{k: _stack([getattr(m.params, k) for m in items], cap)
                                   for k in _fields(first.params)})
        aux = GaussianAux(**{k: _stack([getattr(m.aux, k) for m in items], cap)
                             for k in _fields(first.aux)})
        # each scene's own spatial_lr_scale object: its type sets the float
        # arithmetic of the scene's learning rates (a numpy float32 extent
        # multiplies in float32)
        return GaussianModel(params=params, aux=aux, sh_degree=first.sh_degree,
                             spatial_lr_scale=tuple(m.spatial_lr_scale for m in items),
                             scene_rows=tuple(m.capacity for m in items))
    if isinstance(first, AdamState):
        rows = None
        if isinstance(first.mu, GaussianParams):
            rows = max(getattr(s.mu, "xyz").shape[0] for s in items)
        cls = type(first.mu)

        def moments(which):
            return cls(**{k: _stack([getattr(getattr(s, which), k) for s in items], rows)
                          for k in _fields(first.mu)})

        return AdamState(mu=moments("mu"), nu=moments("nu"),
                         count=_stack([s.count.reshape(()) for s in items]))
    if isinstance(first, FrameBatch):
        if len({(b.width, b.height) for b in items}) != 1:
            raise ValueError("stacked scenes must share the frame size")
        n_f = max(b.viewmats.shape[0] for b in items)
        kw = {k: _stack([getattr(b, k) for b in items], n_f)
              for k in ("viewmats", "fx", "fy", "cx", "cy", "images", "hand_masks", "obj_masks")}
        valid = np.zeros((len(items), n_f), bool)
        for i, b in enumerate(items):
            valid[i, :len(b.obj_mask_valid)] = b.obj_mask_valid
        return FrameBatch(**kw, obj_mask_valid=valid, width=first.width, height=first.height)
    if isinstance(first, ObjectPose):
        return ObjectPose(translation=_stack([p.translation for p in items]),
                          rot6d=_stack([p.rot6d for p in items]))
    if isinstance(first, PoseSequence):
        n_f = max(p.num_frames for p in items)
        return PoseSequence(translations=_stack([p.translations for p in items], n_f),
                            rotations=_stack([_pad_eye(p.rotations, n_f) for p in items]),
                            solved=_stack([p.solved for p in items], n_f))
    raise TypeError(f"cannot stack {type(first).__name__}")


def _pad_eye(rot: torch.Tensor, n_f: int) -> torch.Tensor:
    if rot.shape[0] == n_f:
        return rot
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device).expand(n_f - rot.shape[0], 3, 3)
    return torch.cat([rot, eye])


def unstack_scenes(tree, n: int, capacities: Optional[Sequence[int]] = None,
                   frames: Optional[Sequence[int]] = None) -> list:
    """The n scenes of a stacked tree (views). `capacities` cuts each
    scene's model / Adam rows back to its own capacity, `frames` each
    scene's FrameBatch / PoseSequence to its own frame count."""
    out = []
    for i in range(n):
        cap = None if capacities is None else capacities[i]
        nf = None if frames is None else frames[i]
        out.append(_scene(tree, i, cap, nf))
    return out


def _scene(tree, i: int, cap, nf):
    def cut(x, rows):
        y = x[i]
        return y if rows is None else y[:rows]

    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, GaussianModel):
        return GaussianModel(
            params=GaussianParams(**{k: cut(v, cap) for k, v in tree.params.as_dict().items()}),
            aux=GaussianAux(**{k: cut(v, cap) for k, v in tree.aux.as_dict().items()}),
            sh_degree=tree.sh_degree, spatial_lr_scale=_scale_of(tree.spatial_lr_scale, i))
    if isinstance(tree, AdamState):
        rows = cap if isinstance(tree.mu, GaussianParams) else None
        cls = type(tree.mu)
        return AdamState(mu=cls(**{k: cut(getattr(tree.mu, k), rows) for k in _fields(tree.mu)}),
                         nu=cls(**{k: cut(getattr(tree.nu, k), rows) for k in _fields(tree.nu)}),
                         count=tree.count[i])
    if isinstance(tree, FrameBatch):
        kw = {k: cut(getattr(tree, k), nf) for k in
              ("viewmats", "fx", "fy", "cx", "cy", "images", "hand_masks", "obj_masks")}
        valid = tree.obj_mask_valid[i] if nf is None else tree.obj_mask_valid[i][:nf]
        return FrameBatch(**kw, obj_mask_valid=valid, width=tree.width, height=tree.height)
    if isinstance(tree, ObjectPose):
        return ObjectPose(translation=tree.translation[i], rot6d=tree.rot6d[i])
    if isinstance(tree, PoseSequence):
        return PoseSequence(translations=cut(tree.translations, nf),
                            rotations=cut(tree.rotations, nf), solved=cut(tree.solved, nf))
    raise TypeError(f"cannot unstack {type(tree).__name__}")


def _scale_of(scale, i: int) -> float:
    return scale[i] if isinstance(scale, tuple) else scale


def scene_frames(batch: FrameBatch, fidx: torch.Tensor, scenes: Optional[torch.Tensor] = None):
    """(SceneCameras, gt [S, 3, H, W], hand [S, 1, H, W], obj [S, 1, H, W])
    of frame fidx[s] of every scene of a stacked FrameBatch (or of scene
    scenes[s]), decoded (one gather per field, whatever S is)."""
    s = torch.arange(fidx.shape[0], device=fidx.device) if scenes is None else scenes
    cams = SceneCameras(batch.viewmats[s, fidx], batch.fx[s, fidx][:, None],
                        batch.fy[s, fidx][:, None], batch.cx[s, fidx][:, None],
                        batch.cy[s, fidx][:, None], batch.width, batch.height)
    return (cams, FrameBatch.decode_image(batch.images[s, fidx]),
            FrameBatch.decode_mask(batch.hand_masks[s, fidx]),
            FrameBatch.decode_mask(batch.obj_masks[s, fidx]))


def scene_lrs(trees: Sequence[dict]) -> dict:
    """Per-field learning rates of S scenes: a float where every scene has
    the same one (as the unbatched step takes it), else an [S] float32
    tensor on the host (placed by the caller)."""
    out = {}
    for k in trees[0]:
        vals = [t[k] for t in trees]
        if all(isinstance(v, float) for v in vals) and len(set(vals)) == 1:
            out[k] = vals[0]
        else:
            out[k] = torch.tensor([float(v) for v in vals], dtype=torch.float32)
    return out


def place_lrs(lrs: dict, device) -> dict:
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v for k, v in lrs.items()}


def as_caps(tile_config, models: GaussianModel, batches: FrameBatch):
    """A render/tiled.py SceneCaps as given, or one TileConfig (or None)
    shared by every scene, as JAX's steps take it, at the frame size."""
    from egogaussian_tpu_torch.render.tiled import SceneCaps, scene_caps

    if isinstance(tile_config, SceneCaps):
        return tile_config
    s_n, cap = models.params.xyz.shape[:2]
    return scene_caps([tile_config] * s_n, [(batches.width, batches.height)] * s_n,
                      models.device, cap)


def _leaf(x: torch.Tensor, grad: bool) -> torch.Tensor:
    return x.detach().requires_grad_(grad)


def _static_lrs(models: GaussianModel, it: int, opt_cfg, mode: str, label_lr: float,
                xyz_lr_mult=None):
    from egogaussian_tpu_torch.train.static import _static_lr_tree

    scales = models.spatial_lr_scale
    scales = scales if isinstance(scales, tuple) else (scales,)
    trees = [_static_lr_tree(dataclasses.replace(models, spatial_lr_scale=s), it, opt_cfg,
                             mode, label_lr) for s in scales]
    lrs = place_lrs(scene_lrs(trees), models.device)
    if xyz_lr_mult is not None:
        lrs["xyz"] = lrs["xyz"] * torch.as_tensor(xyz_lr_mult, dtype=torch.float32,
                                                  device=models.device)
    return lrs


def _frames_loss_grads(models, batches, fidxs, grad_masks, mode, lambda_dssim, backend,
                       caps, bg):
    """The gradient of each scene's MEAN loss over its frames fidxs[:, k]
    w.r.t. its params and per-frame means2d probes, for every scene at
    once. Returns (param grads [S, ...], probe grads [K, S, C, 2], losses
    [K, S], radii [K, S, C], dropped [K, S])."""
    from egogaussian_tpu_torch.ops.losses import bce_with_logits
    from egogaussian_tpu_torch.render.api import render_scenes
    from egogaussian_tpu_torch.train.common import (
        image_loss,
        mask_grad,
        model_colors,
        opacity_entropy,
    )

    s_n, cap = models.params.xyz.shape[:2]
    dev = models.device
    leaves = {k: _leaf(v, True) for k, v in models.params.as_dict().items()}
    m = dataclasses.replace(models, params=GaussianParams(**leaves))
    k_n = fidxs.shape[1]
    probes = [torch.zeros((s_n, cap, 2), device=dev, requires_grad=True) for _ in range(k_n)]
    s_idx = torch.arange(s_n, device=dev)
    losses, radii, dropped = [], [], []
    for k in range(k_n):
        f = fidxs[:, k]
        cams, gt, _, obj_mask = scene_frames(batches, f)
        grad_mask = FrameBatch.decode_mask(grad_masks[s_idx, f])
        if mode == "label":
            # one render: the label as the color channel with detached
            # geometry; its radii are the visibility filter
            res = render_scenes(
                cams, m.params.xyz.detach(), m.covariance().detach(), m.opacity.detach(),
                torch.zeros((s_n, 1), device=dev), m.params.label, caps,
                valid_mask=m.aux.alive, backend=backend)
            loss = bce_with_logits(mask_grad(res.image, grad_mask), obj_mask)
        else:
            res = render_scenes(
                cams, m.params.xyz, m.covariance(), m.opacity, bg, model_colors(m), caps,
                valid_mask=m.aux.alive, means2d_probe=probes[k], backend=backend)
            loss = image_loss(mask_grad(res.image, grad_mask), gt, lambda_dssim)
            if mode == "entropy":
                loss = loss + 0.1 * opacity_entropy(m.params.opacity_logit[..., 0],
                                                    res.radii > 0)
        losses.append(loss)
        radii.append(res.radii)
        dropped.append(res.dropped_pairs)
    losses = torch.stack(losses)
    inputs = list(leaves.values()) + (probes if mode != "label" else [])
    grads = torch.autograd.grad(torch.mean(losses, dim=0).sum(), inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
    param_grads = GaussianParams(**dict(zip(leaves, grads[:len(leaves)])))
    if mode == "label":
        probe_grads = torch.zeros((k_n, s_n, cap, 2), device=dev)
    else:
        probe_grads = torch.stack(grads[len(leaves):])
    return (param_grads, probe_grads, losses.detach(), torch.stack(radii),
            torch.stack(dropped))


def _probe_stats(batches, probe_grads, radii, undo_mean_k):
    """Densification statistics of a frame set, reduced over frames (dim
    0). The probe is in pixels and the reference accumulates NDC-scaled
    gradients (W/2, H/2); undo_mean_k undoes the 1/K of the mean loss so
    each frame contributes what a standalone reference iteration would."""
    ndc_scale = torch.tensor([batches.width * 0.5, batches.height * 0.5],
                             dtype=probe_grads.dtype, device=probe_grads.device)
    g = probe_grads * (ndc_scale * undo_mean_k)
    gnorm = torch.sqrt(torch.sum(g * g, dim=-1))  # [K, S, C]
    visible = radii > 0
    zero = torch.zeros_like(gnorm)
    gn_sum = torch.sum(torch.where(visible, gnorm, zero), dim=0)
    den_sum = torch.sum(visible.to(torch.float32), dim=0)
    rad_max = torch.amax(torch.where(visible, radii.to(torch.float32), zero), dim=0)
    return gn_sum, den_sum, rad_max


def _apply_step(models, opt_states, lr_tree, param_grads, gn, den, rmax):
    """Accumulate the densification statistics and take the Adam step."""
    aux = dataclasses.replace(
        models.aux,
        xyz_gradient_accum=models.aux.xyz_gradient_accum + gn,
        denom=models.aux.denom + den,
        max_radii2d=torch.maximum(models.aux.max_radii2d, rmax),
    )
    with torch.no_grad():
        new_params, new_opt = adam_update(models.params, param_grads, opt_states, lr_tree)
    return dataclasses.replace(models, params=new_params, aux=aux), new_opt


def _reduce_over_data(mesh, axis, param_grads, loss, gn, den, rmax, dropped):
    """The frame-data-parallel reduction of `_dp_static_step` on stacked
    tensors: gradients and losses the mean of the ranks' local means, the
    statistics summed, radii and drops max-reduced, all through one flat
    buffer and one all_gather, reduced in rank order on every rank."""
    n = mesh.shape[axis]
    grads = list(param_grads.as_dict().values())
    summed = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(-1), gn.reshape(-1),
                                                          den.reshape(-1)])
    drop_bits = dropped.to(torch.int32).reshape(-1).view(torch.float32)
    blocks = gather_blocks(mesh, torch.cat([summed, rmax.reshape(-1), drop_bits]), axis)
    n_sum, n_r = summed.numel(), rmax.numel()
    total = sum_blocks(blocks[:, :n_sum])
    rmax = max_blocks(blocks[:, n_sum:n_sum + n_r]).view_as(rmax)
    drop = max_blocks(blocks[:, n_sum + n_r:].contiguous().view(torch.int32)).to(dropped.dtype)
    n_grad = sum(g.numel() for g in grads)
    mean = total[:n_grad + loss.numel()] / n
    split = torch.split(mean[:n_grad], [g.numel() for g in grads])
    param_grads = GaussianParams(**{name: g.view_as(x) for (name, x), g in
                                    zip(param_grads.as_dict().items(), split)})
    loss = mean[n_grad:].view_as(loss)
    rest = total[n_grad + loss.numel():]
    gn, den = rest[:gn.numel()].view_as(gn), rest[gn.numel():].view_as(den)
    return param_grads, loss, gn, den, rmax, drop.view_as(dropped)


def multi_scene_static_step(
    models: GaussianModel,
    opt_states: AdamState,
    batches: FrameBatch,
    frame_idxs: torch.Tensor,
    grad_masks: torch.Tensor,
    it: int,
    drop_max: Optional[torch.Tensor] = None,
    xyz_lr_mult=None,
    mesh=None,
    mode: str = "std",
    lambda_dssim: float = 0.2,
    backend: str = "cuda",
    tile_config=None,
    opt_cfg=None,
    label_lr: float = 0.0,
    bg_colors: Optional[torch.Tensor] = None,
    axis: str = "data",
):
    """The static-stage step (stages 1.0 and 1.2) for S scenes at once:
    frame_idxs [S, K] (each scene's K frames; with a mesh the whole batch,
    K a multiple of the data axis, rank d taking block d), grad_masks the
    scene-stacked [S, F, 1, H, W] gradient masks, `it` the shared schedule
    position, drop_max [S] the running worst dropped-pair count.
    `tile_config` is a render/tiled.py SceneCaps (each scene's
    capacities). Each scene's learning rates come from its own
    spatial_lr_scale (times xyz_lr_mult [S] if given). bg_colors [S, 3]
    (the random background) or black. Returns (models, opt_states, loss
    [S], radii [K, S, C] of this rank's frames, drop_max [S])."""
    s_n = frame_idxs.shape[0]
    dev = models.device
    if drop_max is None:
        drop_max = torch.zeros((s_n,), dtype=torch.int64, device=dev)
    fidxs = torch.as_tensor(frame_idxs, dtype=torch.int64, device=dev)
    n = 1 if mesh is None else mesh.shape[axis]
    if fidxs.shape[1] % n:
        raise ValueError(f"frame batch {fidxs.shape[1]} not divisible by {axis}={n}")
    k = fidxs.shape[1] // n
    if n > 1:
        i = mesh.coords[axis]
        fidxs = fidxs[:, i * k:(i + 1) * k]
    lr_tree = _static_lrs(models, it, opt_cfg, mode, label_lr, xyz_lr_mult)
    tile_config = as_caps(tile_config, models, batches)
    bg = (torch.zeros((s_n, 3), device=dev) if bg_colors is None
          else torch.as_tensor(bg_colors, dtype=torch.float32, device=dev))
    param_grads, probe_grads, losses, radii, dropped = _frames_loss_grads(
        models, batches, fidxs, grad_masks, mode, lambda_dssim, backend, tile_config, bg)
    with span("adam"):
        gn, den, rmax = _probe_stats(batches, probe_grads, radii, k)
        loss = torch.mean(losses, dim=0)
        drop = torch.amax(dropped, dim=0)
        if n > 1:
            param_grads, loss, gn, den, rmax, drop = _reduce_over_data(
                mesh, axis, param_grads, loss, gn, den, rmax, drop)
        models, new_opt = _apply_step(models, opt_states, lr_tree, param_grads, gn, den, rmax)
    return models, new_opt, loss, radii, torch.maximum(drop_max, drop.to(drop_max.dtype))


def multi_scene_train_step(
    models: GaussianModel,
    opt_states: AdamState,
    batches: FrameBatch,
    frame_idxs: torch.Tensor,
    lr_trees,
    lambda_dssim: float = 0.2,
    backend: str = "tiled",
    tile_config=None,
    mesh=None,
    axis: str = "data",
):
    """One plain photometric step for S scenes x B frames each (JAX's
    multi_scene_train_step): each scene averages 0.8 L1 + 0.2 (1 - SSIM),
    hand-mask gated, over its frames frame_idxs[s] (with a mesh, this rank's block of them,
    the gradients then averaged over the data axis) and takes Adam at
    lr_trees (a per-field dict of floats or [S] tensors). `tile_config`: a
    SceneCaps, or None for the default capacities. Returns (models,
    opt_states, loss [S])."""
    from egogaussian_tpu_torch.render.tiled import scene_caps

    s_n = models.params.xyz.shape[0]
    dev = models.device
    fidxs = torch.as_tensor(frame_idxs, dtype=torch.int64, device=dev)
    caps = tile_config or scene_caps([None] * s_n, [(batches.width, batches.height)] * s_n,
                                     dev, models.params.xyz.shape[1])
    param_grads, _, losses, _, _ = _frames_loss_grads(
        models, batches, fidxs, batches.hand_masks, "std", lambda_dssim, backend, caps,
        torch.zeros((s_n, 3), device=dev))
    loss = torch.mean(losses, dim=0)
    if mesh is not None and mesh.shape[axis] > 1:
        flat = torch.cat([g.reshape(-1) for g in param_grads.as_dict().values()] + [loss])
        total = sum_blocks(gather_blocks(mesh, flat, axis)) / mesh.shape[axis]
        grads = list(torch.split(total[:-s_n], [g.numel() for g in
                                                 param_grads.as_dict().values()]))
        param_grads = GaussianParams(**{name: g.view_as(x) for (name, x), g in
                                        zip(param_grads.as_dict().items(), grads)})
        loss = total[-s_n:]
    with torch.no_grad():
        new_params, new_opt = adam_update(models.params, param_grads, opt_states,
                                          place_lrs(lr_trees, dev))
    return dataclasses.replace(models, params=new_params), new_opt, loss


def make_multi_scene_step(mesh=None, lambda_dssim: float = 0.2, backend: str = "tiled"):
    """multi_scene_train_step bound to `mesh` (each rank passes its scene
    row's stacked scenes and its block of every scene's frames)."""
    return functools.partial(multi_scene_train_step, lambda_dssim=lambda_dssim,
                             backend=backend, mesh=mesh)


def multi_scene_coarse_step(models, opt_states, poses, pose_opt_states, batches, cam_idxs,
                            table_Ts, table_Rs, fixed_idxs, it, drop_maxes, train_poses,
                            first_frames, grad_params: bool = True, xyz_lr_mult=None,
                            mesh=None, opt_cfg=None, coarse_cfg=None, backend: str = "cuda",
                            tile_config=None, crop: bool = False, crop_maxes=None,
                            count_advance=None, live=None):
    """The coarse-stage step (stage 2) for S scenes in lockstep: one frame
    per scene per iteration (cam_idxs [S]), each scene's pose at its own
    per-iteration flags train_poses / first_frames ([S] bool) and its
    fixed accumulated transform from its identity-prefixed tables
    (table_Ts [S, F+1, 4, 4], fixed_idxs [S]). `grad_params` (a Python
    bool) is the OR over the scenes; each scene whose own flag is off gets
    its parameter gradients zeroed inside the Adam update, so its moments
    and count match its single run. `live` [S] bool: a scene whose
    iteration is elided keeps its whole state bit for bit; count_advance
    [S] advances each live scene's Adam count first (its elided warm-up
    no-ops). Returns (models, opt_states, poses, pose_opt_states, loss
    [S], radii [S, C], drop_maxes [S], crop_maxes [S, 3] or 0)."""
    from egogaussian_tpu_torch.train.coarse_pose import coarse_scenes_step

    return coarse_scenes_step(
        models, opt_states, poses, pose_opt_states, batches, cam_idxs, table_Ts, table_Rs,
        fixed_idxs, int(it), drop_maxes, train_poses, first_frames, grad_params,
        xyz_lr_mult=xyz_lr_mult, opt_cfg=opt_cfg, coarse_cfg=coarse_cfg, backend=backend,
        tile_config=as_caps(tile_config, models, batches), crop=crop, crop_maxes=crop_maxes,
        count_advance=count_advance, live=live)


def multi_scene_fine_step(models, opt_states, pose_seqs, pose_opt_states, batches, cam_idxs,
                          it, drop_maxes, train_poses, xyz_lr_mult=None, mesh=None,
                          opt_cfg=None, fine_cfg=None, backend: str = "cuda",
                          tile_config=None, crop: bool = False, crop_maxes=None):
    """The fine_obj step (stage 3) for S lanes in lockstep; a lane is one
    (video, variant) pair, so two videos fill four lanes. Each lane renders
    its frame cam_idxs[s]; a lane whose train_poses[s] is set loads the
    frame's stored delta, trains it and writes it back once the pose
    learning rate is live, as the single run does. Returns (models,
    opt_states, pose_seqs, pose_opt_states, loss [S], drop_maxes [S],
    crop_maxes)."""
    from egogaussian_tpu_torch.train.fine_obj import fine_scenes_step

    out = fine_scenes_step(models, opt_states, pose_seqs, pose_opt_states, batches, cam_idxs,
                           int(it), drop_maxes, train_poses, xyz_lr_mult=xyz_lr_mult,
                           opt_cfg=opt_cfg, fine_cfg=fine_cfg, backend=backend,
                           tile_config=as_caps(tile_config, models, batches), crop=crop,
                           crop_maxes=crop_maxes)
    return out[:7]


def multi_scene_fine_all_step(models, opt_states, batches, cam_idxs, accum_Ts, accum_Rs, it,
                              clamp_opacity: bool, drop_maxes, xyz_lr_mult=None, mesh=None,
                              lambda_dssim: float = 0.2, backend: str = "cuda",
                              tile_config=None, opt_cfg=None):
    """The fine_all step (stage 5) for S scenes in lockstep: each scene's
    frame cam_idxs[s] at its frozen accumulated pose (accum_Ts [S, F, 4,
    4]), then the shared schedule's opacity clamp. Returns (models,
    opt_states, loss [S], drop_maxes [S])."""
    from egogaussian_tpu_torch.train.fine_all import fine_all_scenes_step

    return fine_all_scenes_step(models, opt_states, batches, cam_idxs, accum_Ts, accum_Rs,
                                int(it), bool(clamp_opacity), drop_maxes,
                                lambda_dssim=lambda_dssim, backend=backend,
                                tile_config=as_caps(tile_config, models, batches),
                                opt_cfg=opt_cfg, xyz_lr_mult=xyz_lr_mult)
