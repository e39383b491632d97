"""The frozen reference against the port's `tiled` backend at a tiny size
on the CPU: a render forward and its gradients, the static loss and an
Adam step, the pose gradient, and one frame of the viewer path."""
import dataclasses

import numpy as np
import pytest
import torch

from benchmark.inputs import egovideo
from benchmark.reference import train as ref

W, H = 96, 64


@pytest.fixture(scope="module")
def scene():
    dev = torch.device("cpu")
    gen = egovideo.generator(3, 0, dev)
    xyz, cols = egovideo.init_point_cloud(3, 500, 0.2, dev)
    p = egovideo.splat_params(gen, xyz, cols, 0.03, 0.15, -1.0, 3.0)
    view = egovideo.camera_path(8, W, H)[1]
    return p, view, dev


def _port_camera(view, dev):
    from egogaussian_tpu_torch.render.camera import Camera

    return Camera.from_viewmat(view, 0.9 * W, 0.9 * W, W, H, dev, cx=W / 2, cy=H / 2)


def _port_model(p):
    from benchmark.core.program import gaussian_model

    n = p["xyz"].shape[0]
    return gaussian_model(p, torch.zeros(n, dtype=torch.bool), 1024)


@pytest.mark.parametrize("ts", [16, 32])
def test_render_forward_and_gradients(scene, ts):
    from egogaussian_tpu_torch.render.tiled import TileConfig
    from egogaussian_tpu_torch.train.common import render_gaussians

    p, view, dev = scene
    model = _port_model(p)
    leaves = {k: v.detach().requires_grad_(True) for k, v in model.params.as_dict().items()}
    model = dataclasses.replace(model, params=type(model.params)(**leaves))
    out = render_gaussians(model, _port_camera(view, dev), torch.zeros(3), backend="tiled",
                           tile_config=TileConfig(tile_size=ts))
    rl = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    img, acc, _, _ = ref._render_params(rl, egovideo.camera(view, W, H, dev), ts, torch.zeros(3))
    n = p["xyz"].shape[0]
    assert float((img - out.image).detach().abs().max()) < 1e-5
    assert float((acc - out.alpha).detach().abs().max()) < 1e-5
    wgt = torch.rand(img.shape, generator=torch.Generator().manual_seed(1))
    (out.image * wgt).sum().backward()
    (img * wgt).sum().backward()
    for k in ref.FIELDS:
        a, b = leaves[k].grad[:n], rl[k].grad
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) + 1e-7, k


def test_static_loss_and_adam_step(scene):
    from egogaussian_tpu_torch.models.optim import adam_init, adam_update, gaussian_lr_tree
    from egogaussian_tpu_torch.ops.losses import ssim as port_ssim
    from egogaussian_tpu_torch.train.common import image_loss, mask_grad, render_gaussians

    p, view, dev = scene
    gt = torch.rand((3, H, W), generator=torch.Generator().manual_seed(2))
    hand = torch.zeros((1, H, W))
    hand[:, 40:60, 10:30] = 1.0
    model = _port_model(p)
    leaves = {k: v.detach().requires_grad_(True) for k, v in model.params.as_dict().items()}
    model = dataclasses.replace(model, params=type(model.params)(**leaves))
    out = render_gaussians(model, _port_camera(view, dev), torch.zeros(3), backend="tiled")
    loss = image_loss(mask_grad(out.image, hand), gt, 0.2)
    loss.backward()
    loss = loss.detach()
    rloss, rgrads, _, _ = ref.static_loss_grads(p, egovideo.camera(view, W, H, dev), gt, hand,
                                                0.2, 16)
    assert abs(float(loss) - float(rloss)) <= 1e-6 * abs(float(rloss))
    assert abs(float(ref.ssim(gt, gt * 0.9)) - float(port_ssim(gt, gt * 0.9))) < 1e-6
    n = p["xyz"].shape[0]

    class O:
        position_lr_init, position_lr_final, position_lr_max_steps = 1.6e-4, 1.6e-6, 30000
        position_lr_delay_mult, feature_lr, opacity_lr = 0.01, 0.0025, 0.05
        scaling_lr, rotation_lr, label_lr = 0.005, 0.001, 0.0

    grads = type(model.params)(**{k: torch.zeros_like(v) if v.grad is None else v.grad
                                  for k, v in leaves.items()})
    new, _ = adam_update(model.params, grads, adam_init(model.params),
                         gaussian_lr_tree(1, O, 2.0, label_lr=0.0))
    opt = {k: getattr(O, k) for k in ("position_lr_init", "position_lr_final",
                                      "position_lr_max_steps", "feature_lr", "opacity_lr",
                                      "scaling_lr", "rotation_lr")}
    rnew, _ = ref.adam(p, rgrads, None, ref.static_lrs(1, opt, 2.0))
    for k in ref.FIELDS:
        step_p = (getattr(new, k)[:n] - p[k]).detach()
        step_r = rnew[k] - p[k]
        # Adam's step is lr * sign(g) where |g| is far above eps
        big = rgrads[k].abs() > 1e-3 * float(rgrads[k].abs().max())
        assert big.any() and float((step_p - step_r)[big].abs().max()) <= 1e-3 * float(
            step_r.abs().max()) + 1e-9, k


def test_pose_gradient(scene):
    from egogaussian_tpu_torch.models.pose import identity_pose
    from egogaussian_tpu_torch.train.coarse_pose import pose_loss_grads

    p, view, dev = scene
    gt = torch.rand((3, H, W), generator=torch.Generator().manual_seed(4))
    mask = (torch.rand((1, H, W), generator=torch.Generator().manual_seed(5)) > 0.5).float()
    hand = torch.zeros((1, H, W))
    from egogaussian_tpu_torch.data.readers import stack_cameras

    cam = dataclasses.replace(_port_camera(view, dev), gt_image=gt, hand_mask=hand,
                              obj_mask=mask)
    model = _port_model(p)
    model = dataclasses.replace(model, aux=dataclasses.replace(
        model.aux, is_object=torch.ones_like(model.aux.is_object)))
    pose = identity_pose()
    pose.translation = torch.tensor([0.02, -0.01, 0.03])
    g = pose_loss_grads(model, pose, stack_cameras([cam], dev), 0, torch.eye(4), torch.eye(3),
                        True, backend="tiled")
    cp = dict(lambda_image=1.0, lambda_dssim=0.1, lambda_Ll2_alpha=0.5)
    rloss, rgrads, rpose = ref.pose_loss_grads(
        p, dict(translation=pose.translation, rot6d=pose.rot6d), True,
        egovideo.camera(view, W, H, dev), gt, hand, mask, cp, 16)
    assert abs(float(g.loss) - float(rloss)) <= 1e-5 * abs(float(rloss))
    for k in ("translation", "rot6d"):
        a, b = getattr(g.pose, k), rpose[k]
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), k


def test_viewer_frame(scene):
    from egogaussian_tpu_torch.eval.render_results import render_novel_view

    from benchmark.core.program import gaussian_model
    from benchmark.reference.render import covariance, render, sh0_colors

    p, view, dev = scene
    n = p["xyz"].shape[0]
    is_obj = torch.arange(n) >= n - 100
    model = gaussian_model(p, is_obj, n)
    T = egovideo.object_poses(4, [1, 3], dev)[3]
    img = render_novel_view(model, _port_camera(view, dev), pose_T=T, pose_R=T[:3, :3])
    xyz = torch.where(is_obj[:, None], p["xyz"] @ T[:3, :3].T + T[:3, 3], p["xyz"])
    cov = covariance(p["log_scales"], p["quats"])
    cov = torch.where(is_obj[:, None, None], T[:3, :3] @ cov @ T[:3, :3].T, cov)
    r, _, _, _ = render(xyz, cov, torch.sigmoid(p["opacity_logit"][:, 0]),
                        sh0_colors(p["features_dc"]), egovideo.camera(view, W, H, dev),
                        torch.zeros(3), 16)
    assert np.isfinite(img).all()
    assert float((torch.as_tensor(img) - r).abs().max()) < 1e-5
