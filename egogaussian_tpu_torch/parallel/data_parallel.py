"""Frame-data-parallel training step.

Port of `egogaussian_tpu/parallel/data_parallel.py`. Each rank of a scene
row renders its own frames of the batch against replicated Gaussian
parameters; the photometric loss is the mean over the whole batch, so the
parameter gradient is the mean of the ranks' local means, reduced in rank
order over the row (parallel/mesh.py:gather_blocks, one collective per
step), and every rank then applies the same Adam update.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from egogaussian_tpu_torch.models.gaussians import GaussianModel, GaussianParams
from egogaussian_tpu_torch.models.optim import adam_update
from egogaussian_tpu_torch.parallel.mesh import Mesh, gather_blocks, sum_blocks
from egogaussian_tpu_torch.train.common import image_loss, mask_grad, render_gaussians


def _per_frame_loss(model, batch, f, lambda_dssim, backend):
    cam, gt, hand, _ = batch.frame(f)
    res = render_gaussians(model, cam, torch.zeros(3, device=model.device), backend=backend)
    return image_loss(mask_grad(res.image, hand), gt, lambda_dssim)


def data_parallel_train_step(
    model: GaussianModel,
    opt_state,
    batch,
    frame_idxs,
    lr_tree,
    lambda_dssim: float = 0.2,
    backend: str = "tiled",
    mesh: Mesh = None,
    axis: str = "data",
):
    """One step over a batch of frames. `frame_idxs`: this rank's frames
    (with a mesh, its block of the batch: shard_batch(mesh, idxs)); model,
    opt_state and lr_tree replicated. Returns (model, opt_state, loss),
    the loss the mean over the whole batch."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in model.params.as_dict().items()}
    m = dataclasses.replace(model, params=GaussianParams(**leaves))
    loss = torch.mean(torch.stack([_per_frame_loss(m, batch, f, lambda_dssim, backend)
                                   for f in frame_idxs]))
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves.values(), grads)]
    loss = loss.detach()
    if mesh is not None:
        # mean over every frame = mean of the ranks' local means
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss[None]])
        total = sum_blocks(gather_blocks(mesh, flat, axis)) / mesh.shape[axis]
        grads = list(torch.split(total[:-1], [g.numel() for g in grads]))
        grads = [g.view_as(x) for g, x in zip(grads, leaves.values())]
        loss = total[-1]
    with torch.no_grad():
        new_params, new_opt = adam_update(model.params, GaussianParams(**dict(zip(leaves, grads))),
                                          opt_state, lr_tree)
    return dataclasses.replace(model, params=new_params), new_opt, loss


def make_dp_train_step(mesh: Mesh, lambda_dssim: float = 0.2, backend: str = "tiled"):
    """The step bound to `mesh`: step(model, opt_state, batch, frame_idxs,
    lr_tree) with this rank's frames (shard_batch) and the rest
    replicated (replicate)."""
    return functools.partial(data_parallel_train_step, lambda_dssim=lambda_dssim,
                             backend=backend, mesh=mesh)
