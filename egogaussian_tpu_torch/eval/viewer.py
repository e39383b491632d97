"""Novel-view and trajectory rendering.

Port of `egogaussian_tpu/eval/viewer.py` (the twins of the reference's
webpage helpers, trainers/eval_metric.py: render_multiview (:218),
render_freeiview (:296), render_trajectory (:417),
render_double_trajectory (:457)). Plain functions over (model, pose
sequence, cameras) that return frames as numpy arrays and save them as
PNGs named by the timeline frame's image name.

They render on the model's device through train/common.py:render_gaussians
with backend="tiled" by default, as in JAX: on the card that is the
chunked windowed forward kernel. Cameras and pose tensors are moved to
the model's device. `on_render(model, camera, kwargs, result)`, where
given, is called after every render with render_gaussians' keyword
arguments (bg, pose_T, extra_rot, backend) and its RenderResult, so a
caller can check a frame against another backend.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from egogaussian_tpu_torch.models.gaussians import (
    GaussianModel,
    combine_models,
    make_it_a_point,
)
from egogaussian_tpu_torch.models.pose import PoseSequence
from egogaussian_tpu_torch.ops.quaternion import quat_normalize, quat_to_rotmat, rotmat_to_quat
from egogaussian_tpu_torch.render.camera import Camera
from egogaussian_tpu_torch.train.common import render_gaussians
from egogaussian_tpu_torch.utils.visualize import make_montage, to_uint8_image

OnRender = Optional[Callable[[GaussianModel, Camera, dict, object], None]]


def _save(path: str, img) -> None:
    from PIL import Image

    Image.fromarray(to_uint8_image(img)).save(path)


def _camera_on(cam: Camera, device) -> Camera:
    """The camera's pose and intrinsics on `device` (the image planes stay)."""
    return dataclasses.replace(cam, viewmat=cam.viewmat.to(device), fx=cam.fx.to(device),
                               fy=cam.fy.to(device), cx=cam.cx.to(device),
                               cy=cam.cy.to(device))


def _render(model, cam, on_render: OnRender, **kwargs) -> np.ndarray:
    cam = _camera_on(cam, model.device)
    with torch.no_grad():
        res = render_gaussians(model, cam, **kwargs)
    if on_render is not None:
        on_render(model, cam, kwargs, res)
    return res.image.cpu().numpy()


def interpolate_cameras(cam_a: Camera, cam_b: Camera, n: int) -> List[Camera]:
    """n cameras between two views: quaternion nlerp on the rotation and a
    lerp of the position (reference interpolate_lists over the viewer's
    pose matrices, eval_metric.py)."""
    def quat(cam):
        return rotmat_to_quat(cam.viewmat[:3, :3].detach().cpu()).numpy()

    qa, qb = quat(cam_a), quat(cam_b)
    if np.dot(qa, qb) < 0:
        qb = -qb
    ca = cam_a.camera_center.detach().cpu().numpy()
    cb = cam_b.camera_center.detach().cpu().numpy()
    cams = []
    for t in np.linspace(0.0, 1.0, n):
        q = quat_normalize(torch.tensor((1 - t) * qa + t * qb, dtype=torch.float32))
        R = quat_to_rotmat(q).numpy()
        center = (1 - t) * ca + t * cb
        cams.append(cam_a.with_pose(R, -R @ center))
    return cams


def render_freeview(
    cameras: Sequence[Camera],
    model: GaussianModel,
    pose_seq: PoseSequence,
    view_start: Camera,
    view_end: Optional[Camera] = None,
    save_dir: Optional[str] = None,
    backend: str = "tiled",
    on_render: OnRender = None,
) -> List[np.ndarray]:
    """The dynamic scene's timeline from an interpolated novel camera path
    (render_freeiview twin): frame f at frame f's object pose, seen from
    the path's f-th camera."""
    dev = model.device
    view_end = view_end or cameras[len(cameras) // 2]
    path_cams = interpolate_cameras(view_start, view_end, len(cameras))
    accum_T, accum_R = pose_seq.accum_T().to(dev), pose_seq.accum_R().to(dev)
    bg = torch.zeros(3, device=dev)
    frames = []
    for f, (cam, vcam) in enumerate(zip(cameras, path_cams)):
        img = _render(model, vcam, on_render, bg=bg, pose_T=accum_T[f], extra_rot=accum_R[f],
                      backend=backend)
        frames.append(img)
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            _save(os.path.join(save_dir, f"{cam.image_name}.png"), img)
    return frames


def render_multiview(
    cameras: Sequence[Camera],
    model: GaussianModel,
    pose_seq: PoseSequence,
    view_cams: Sequence[Camera],
    save_dir: Optional[str] = None,
    backend: str = "tiled",
    on_render: OnRender = None,
) -> List[np.ndarray]:
    """Each timeline frame from several fixed novel views side by side
    (render_multiview twin); the frames are captioned uint8 montages."""
    dev = model.device
    accum_T, accum_R = pose_seq.accum_T().to(dev), pose_seq.accum_R().to(dev)
    bg = torch.zeros(3, device=dev)
    frames = []
    for f, cam in enumerate(cameras):
        panels = [_render(model, vc, on_render, bg=bg, pose_T=accum_T[f],
                          extra_rot=accum_R[f], backend=backend) for vc in view_cams]
        monty = make_montage(
            panels, captions=[f"view {i} | {cam.image_name}" for i in range(len(panels))],
            rows=1)
        frames.append(np.asarray(monty))
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            monty.save(os.path.join(save_dir, f"{cam.image_name}.png"))
    return frames


def render_trajectory(
    cameras: Sequence[Camera],
    bg_model: GaussianModel,
    obj_model: GaussianModel,
    pose_seq: PoseSequence,
    view_cam: Optional[Camera] = None,
    save_dir: Optional[str] = None,
    color: str = "red",
    start_frame: int = 0,
    backend: str = "tiled",
    on_render: OnRender = None,
) -> GaussianModel:
    """The object's trajectory as a trail of colored blobs over the
    background, one added per frame from `start_frame` on, each step
    rendered from `view_cam` on a white background (render_trajectory
    twin, eval_metric.py:417-455). Returns the final background + trail
    model, on the background model's device (combine_models moves the
    blobs there)."""
    point = make_it_a_point(obj_model, color=color)
    accum_T = pose_seq.accum_T().to(point.device)
    view_cam = view_cam or cameras[0]
    white = torch.ones(3, device=bg_model.device)
    scene = bg_model
    for f, cam in enumerate(cameras):
        moved = dataclasses.replace(point, params=dataclasses.replace(
            point.params, xyz=point.params.xyz @ accum_T[f][:3, :3].T + accum_T[f][:3, 3]))
        if f >= start_frame:
            scene = combine_models(scene, moved)
        img = _render(scene, view_cam, on_render, bg=white, backend=backend)
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            _save(os.path.join(save_dir, f"{cam.image_name}.png"), img)
    return scene


def render_double_trajectory(
    cameras: Sequence[Camera],
    bg_model: GaussianModel,
    obj_model: GaussianModel,
    pose_seq_1: PoseSequence,
    pose_seq_2: PoseSequence,
    view_cam: Optional[Camera] = None,
    save_dir: Optional[str] = None,
    backend: str = "tiled",
    on_render: OnRender = None,
) -> GaussianModel:
    """Two pose sequences as red and blue trails (render_double_trajectory
    twin, eval_metric.py:457-496), e.g. coarse against interpolated poses;
    the PNGs are the second trail's renders over the first's."""
    scene = render_trajectory(cameras, bg_model, obj_model, pose_seq_1, view_cam,
                              save_dir=None, color="red", backend=backend,
                              on_render=on_render)
    return render_trajectory(cameras, scene, obj_model, pose_seq_2, view_cam,
                             save_dir=save_dir, color="blue", backend=backend,
                             on_render=on_render)
