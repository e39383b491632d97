"""Scene loading, frame batches and phase splits.

Port of `egogaussian_tpu/data/readers.py`: split and phase files, COLMAP
scene loading (cameras built on the caller's device), and frames stacked
into one FrameBatch of [F, ...] tensors on the device, so a training step
picks a frame by index with no host-device copy. Image and mask planes that
are exactly 8-bit representable are stored as uint8 and decoded to float32
on use (img / 255), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from egogaussian_tpu_torch.data import colmap
from egogaussian_tpu_torch.render.camera import Camera


# ---------------------------------------------------------------------------
# Split / phase parsing (reference train.py:53-65)
# ---------------------------------------------------------------------------

def read_split_file(path: str) -> List[str]:
    """One frame name per line (split/{training,dynamic_eval,static_eval}_frames.txt)."""
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def read_phase_index(path: str) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """phase_frame_index.txt -> (static_phases, dynamic_phases): one
    "start,end" pair per line, even rows static, odd rows dynamic
    (reference train.py:60-65)."""
    pairs = []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            a, b = ln.replace(",", " ").split()[:2]
            pairs.append((int(a), int(b)))
    return pairs[0::2], pairs[1::2]


def phase_membership_mask(cameras: Sequence[Camera],
                          phases: Sequence[Tuple[int, int]]) -> np.ndarray:
    """[F] bool: the camera's frame number lies in one of the inclusive
    phase ranges, not filtered by the training frames (stage 4 fills every
    frame of a dynamic phase, held-out frames included)."""
    mask = np.zeros(len(cameras), bool)
    for i, cam in enumerate(cameras):
        num = frame_number(cam.image_name)
        if num is not None and any(start <= num <= end for start, end in phases):
            mask[i] = True
    return mask


def find_idx_by_image_name(cameras: Sequence[Camera], image_name: str) -> int:
    """Index of the camera with a given image name; -1 if absent (reference
    utils/dynamic_utils.py:10)."""
    for i, c in enumerate(cameras):
        if c.image_name == image_name:
            return i
    return -1


def frame_number(image_name: str) -> Optional[int]:
    """Frame index from an image name; handles the EK 'frame_0000000123'
    prefix and plain digits."""
    stem = image_name.split(".")[0]
    if stem.startswith("frame_"):
        stem = stem[len("frame_"):]
    digits = "".join(c for c in stem if c.isdigit())
    return int(digits) if digits else None


def split_viewpoints_by_phase(
    cameras: Sequence[Camera],
    phases: Sequence[Tuple[int, int]],
    training_frames: Optional[Sequence[str]] = None,
) -> List[List[int]]:
    """Partition the (sorted) camera list into per-phase index lists,
    filtered by the training-frame whitelist (reference get_viewpoint_split,
    utils/dynamic_utils.py:16-47). Phases are inclusive frame-number ranges."""
    train_set = set(training_frames) if training_frames is not None else None
    out: List[List[int]] = []
    for start, end in phases:
        idxs = []
        for i, cam in enumerate(cameras):
            num = frame_number(cam.image_name)
            if num is None:
                continue
            if start <= num <= end and (train_set is None or cam.image_name in train_set):
                idxs.append(i)
        out.append(idxs)
    return out


# ---------------------------------------------------------------------------
# Image / mask loading (reference utils/camera_utils.py, general_utils.py)
# ---------------------------------------------------------------------------

def compute_resolution(
    orig_w: int, orig_h: int, resolution: int = -1, resolution_scale: float = 1.0
) -> Tuple[int, int]:
    """Divisors {1, 2, 4, 8}, a target width, or -1 = cap the width at
    1600 px (reference loadCam, utils/camera_utils.py:24-41)."""
    if resolution in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution)),
                round(orig_h / (resolution_scale * resolution)))
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1.0
    else:
        global_down = orig_w / resolution
    scale = global_down * resolution_scale
    return int(orig_w / scale), int(orig_h / scale)


def load_image(path: str, size: Tuple[int, int]) -> np.ndarray:
    """RGB image -> [3, H, W] float32 in [0, 1]."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB").resize(size), np.float32) / 255.0
    return arr.transpose(2, 0, 1)


def binarize_mask(mask: np.ndarray) -> np.ndarray:
    """[C, H, W] -> [1, H, W] in {0, 1}: channels collapse by max, threshold
    0.5 (reference binarize_mask, utils/general_utils.py:41-60)."""
    if mask.shape[0] > 1:
        mask = mask.max(axis=0, keepdims=True)
    return (mask > 0.5).astype(np.float32)


def load_feature(dir_path: str, image_name: str, size: Tuple[int, int],
                 allow_npy: bool = False) -> Optional[np.ndarray]:
    """A mask or depth plane by the image's stem, png/jpg/npy (reference
    load_img_feature, dataset_readers.py:72-100). [1, H, W] or None."""
    from PIL import Image

    stem = image_name.split(".")[0]
    for ext in (".png", ".jpg", ".jpeg"):
        p = os.path.join(dir_path, stem + ext)
        if os.path.exists(p):
            with Image.open(p) as im:
                arr = np.asarray(im.resize(size), np.float32)
            arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
            return binarize_mask(arr / max(arr.max(), 1.0))
    if allow_npy:
        p = os.path.join(dir_path, stem + ".npy")
        if os.path.exists(p):
            arr = np.load(p).astype(np.float32)
            return arr[None] if arr.ndim == 2 else arr
    return None


def dilate_mask(mask: np.ndarray, iterations: int = 5) -> np.ndarray:
    """Binary dilation with a 3x3 kernel (reference train_static_bg.py:14-21).
    mask [1, H, W]."""
    m = mask[0] > 0.5
    for _ in range(iterations):
        p = np.pad(m, 1)
        m = (
            p[:-2, 1:-1] | p[2:, 1:-1] | p[1:-1, :-2] | p[1:-1, 2:]
            | p[1:-1, 1:-1] | p[:-2, :-2] | p[:-2, 2:] | p[2:, :-2] | p[2:, 2:]
        )
    return m[None].astype(np.float32)


@dataclasses.dataclass
class FrameBatch:
    """All frames of one scene stacked on the device. hand_mask 1 = hand
    pixel (excluded from the loss), obj_mask 1 = interacted-object pixel."""

    viewmats: torch.Tensor  # [F, 4, 4]
    fx: torch.Tensor  # [F]
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    images: torch.Tensor  # [F, 3, H, W] uint8 or float32
    hand_masks: torch.Tensor  # [F, 1, H, W] uint8 or float32
    obj_masks: torch.Tensor  # [F, 1, H, W] (zeros where missing)
    obj_mask_valid: np.ndarray  # [F] bool (host): obj mask actually present
    width: int = 0
    height: int = 0

    def camera(self, f: int) -> Camera:
        return Camera(
            viewmat=self.viewmats[f], fx=self.fx[f], fy=self.fy[f],
            cx=self.cx[f], cy=self.cy[f], width=self.width, height=self.height,
        )

    @staticmethod
    def decode_mask(m: torch.Tensor) -> torch.Tensor:
        """float32 view of a possibly uint8-stored binary mask plane."""
        return m.to(torch.float32) if m.dtype == torch.uint8 else m

    @staticmethod
    def decode_image(img: torch.Tensor) -> torch.Tensor:
        """float32 view of a possibly uint8-stored image plane: img / 255,
        exactly what the loader computed from the PNG."""
        if img.dtype == torch.uint8:
            return img.to(torch.float32) / 255.0
        return img

    def frame(self, f: int):
        """(camera, gt_image, hand_mask, obj_mask) of frame f, decoded."""
        return (
            self.camera(f),
            self.decode_image(self.images[f]),
            self.decode_mask(self.hand_masks[f]),
            self.decode_mask(self.obj_masks[f]),
        )


def _as_uint8_plane(x: np.ndarray, scale: float):
    """(uint8 array, True) when x*scale is exactly 8-bit representable
    (PNG-loaded images /255, binarized masks), else (x, False)."""
    if x.size == 0:
        return x, False
    s = x * scale
    q = np.round(s)
    if float(np.abs(s - q).max()) < 1e-4 and float(q.min()) >= 0.0 and float(q.max()) <= 255.0:
        return q.astype(np.uint8), True
    return x, False


def _host(x, shape) -> np.ndarray:
    if x is None:
        return np.zeros(shape, np.float32)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def stack_cameras(cameras: Sequence[Camera], device: torch.device) -> FrameBatch:
    """Stack per-frame cameras into one FrameBatch on `device` (set-up)."""
    if not cameras:
        raise ValueError("empty camera list")
    w, h = cameras[0].width, cameras[0].height
    for c in cameras:
        if (c.width, c.height) != (w, h):
            raise ValueError("mixed resolutions in one batch")
    images, _ = _as_uint8_plane(np.stack([_host(c.gt_image, (3, h, w)) for c in cameras]), 255.0)
    hand_m, _ = _as_uint8_plane(np.stack([_host(c.hand_mask, (1, h, w)) for c in cameras]), 1.0)
    obj_m, _ = _as_uint8_plane(np.stack([_host(c.obj_mask, (1, h, w)) for c in cameras]), 1.0)

    def stack(attr):
        return torch.stack([getattr(c, attr).to(device) for c in cameras])

    return FrameBatch(
        viewmats=stack("viewmat"), fx=stack("fx"), fy=stack("fy"),
        cx=stack("cx"), cy=stack("cy"),
        images=torch.as_tensor(images).to(device),
        hand_masks=torch.as_tensor(hand_m).to(device),
        obj_masks=torch.as_tensor(obj_m).to(device),
        obj_mask_valid=np.array([c.obj_mask is not None for c in cameras]),
        width=w, height=h,
    )


# ---------------------------------------------------------------------------
# Scene loading (reference Scene + readColmapSceneInfo)
# ---------------------------------------------------------------------------

def compute_nerfpp_norm(cameras: Sequence[Camera]) -> Dict[str, np.ndarray]:
    """Camera-center normalization (reference getNerfppNorm,
    dataset_readers.py:49-70): translate = -mean center, radius = 1.1 x the
    largest distance to it."""
    centers = np.stack([c.camera_center.detach().cpu().numpy() for c in cameras])
    avg = centers.mean(axis=0)
    radius = float(np.linalg.norm(centers - avg, axis=1).max()) * 1.1
    return {"translate": -avg, "radius": radius if radius > 0 else 1.0}


@dataclasses.dataclass
class SceneData:
    cameras: List[Camera]  # sorted by image name
    points: np.ndarray  # [N, 3] initial point cloud
    colors: np.ndarray  # [N, 3] in [0, 1]
    nerf_norm: Dict[str, np.ndarray]
    image_names: List[str]

    @property
    def cameras_extent(self) -> float:
        return float(self.nerf_norm["radius"])


def camera_to_json(idx: int, cam: Camera) -> dict:
    """Viewer cameras.json entry (reference camera_to_JSON,
    utils/camera_utils.py:104-124: position/rotation are camera-to-world)."""
    R_w2c = cam.viewmat[:3, :3].detach().cpu().numpy()
    return {
        "id": idx,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": cam.camera_center.detach().cpu().numpy().tolist(),
        "rotation": R_w2c.T.tolist(),
        "fx": float(cam.fx),
        "fy": float(cam.fy),
    }


def write_scene_artifacts(scene: SceneData, out_dir: str) -> None:
    """input.ply + cameras.json as the reference Scene writes them
    (scene/__init__.py:79-91)."""
    import json

    os.makedirs(out_dir, exist_ok=True)
    colmap.write_points3d_ply(os.path.join(out_dir, "input.ply"), scene.points, scene.colors)
    with open(os.path.join(out_dir, "cameras.json"), "w") as f:
        json.dump([camera_to_json(i, c) for i, c in enumerate(scene.cameras)], f)


def _colmap_views(source_path: str, images_dir: str):
    """(intrinsics, registered images with a file, pick(name) -> (path,
    is_binary)) of a COLMAP scene directory."""
    sparse = os.path.join(source_path, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(source_path, "sparse")
    img_dir = os.path.join(source_path, images_dir)
    present = sorted(os.listdir(img_dir)) if os.path.isdir(img_dir) else []

    def pick(name):
        b = os.path.join(sparse, name + ".bin")
        return (b, True) if os.path.exists(b) else (os.path.join(sparse, name + ".txt"), False)

    cam_path, is_bin = pick("cameras")
    intr = colmap.read_cameras_binary(cam_path) if is_bin else colmap.read_cameras_text(cam_path)
    img_path, is_bin = pick("images")
    extr = (colmap.read_images_binary(img_path, present) if is_bin
            else colmap.read_images_text(img_path, present))
    return intr, extr, pick


def colmap_frame_sizes(source_path: str, images_dir: str = "images",
                       resolution: int = -1) -> List[Tuple[int, int]]:
    """The distinct (width, height) that load_colmap_scene gives the
    scene's frames, sorted, from the COLMAP files alone (no image is
    read)."""
    intr, extr, _ = _colmap_views(source_path, images_dir)
    return sorted({compute_resolution(intr[im.camera_id].width, intr[im.camera_id].height,
                                      resolution) for im in extr.values()})


def load_colmap_scene(
    source_path: str,
    device: torch.device,
    images_dir: str = "images",
    resolution: int = -1,
    load_hand_masks: bool = True,
    load_obj_masks: bool = True,
    load_est_depths: bool = False,
    load_pred_cb: bool = False,
) -> SceneData:
    """Load a COLMAP scene directory in the reference's layout
    (readColmapSceneInfo, dataset_readers.py:213-296), cameras on `device`:

      source_path/
        sparse/0/{cameras,images,points3D}.{bin|txt}
        images/          (registered images without a file are skipped)
        hand_masks/  obj_masks/   (binary masks; obj optional)
        est_depths/  pred_cb/     (optional feature planes, loaded when
                                   asked and present; no loss reads them;
                                   est_depths also takes .npy)"""
    intr, extr, pick = _colmap_views(source_path, images_dir)
    img_dir = os.path.join(source_path, images_dir)
    pts_path, is_bin = pick("points3D")
    xyz, rgb, _ = (colmap.read_points3d_binary(pts_path) if is_bin
                   else colmap.read_points3d_text(pts_path))

    hand_dir = os.path.join(source_path, "hand_masks") if load_hand_masks else None
    obj_dir = os.path.join(source_path, "obj_masks") if load_obj_masks else None
    depth_dir = os.path.join(source_path, "est_depths") if load_est_depths else None
    cb_dir = os.path.join(source_path, "pred_cb") if load_pred_cb else None
    depth_dir = depth_dir if depth_dir and os.path.isdir(depth_dir) else None
    cb_dir = cb_dir if cb_dir and os.path.isdir(cb_dir) else None
    cameras: List[Camera] = []
    for im in sorted(extr.values(), key=lambda x: x.name):
        cam = intr[im.camera_id]
        if cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
            cx, cy = cam.params[1], cam.params[2]
        elif cam.model == "PINHOLE":
            fx, fy = cam.params[0], cam.params[1]
            cx, cy = cam.params[2], cam.params[3]
        else:
            raise ValueError(f"COLMAP camera model not handled: {cam.model} "
                             "(only PINHOLE/SIMPLE_PINHOLE, like the reference)")
        w, h = compute_resolution(cam.width, cam.height, resolution)
        sx, sy = w / cam.width, h / cam.height
        name = os.path.basename(im.name).split(".")[0]
        if name.startswith("frame_"):
            name = name[len("frame_"):]  # EK prefix strip (cameras.py:31-33)
        cameras.append(Camera.from_colmap(
            R_w2c=colmap.qvec2rotmat(im.qvec).astype(np.float32),
            t_w2c=im.tvec.astype(np.float32),
            fx=fx * sx, fy=fy * sy, width=w, height=h, device=device,
            image_name=name, cx=cx * sx, cy=cy * sy,
            gt_image=load_image(os.path.join(img_dir, os.path.basename(im.name)), (w, h)),
            hand_mask=load_feature(hand_dir, im.name, (w, h)) if hand_dir else None,
            obj_mask=load_feature(obj_dir, im.name, (w, h)) if obj_dir else None,
            est_depth=(load_feature(depth_dir, im.name, (w, h), allow_npy=True)
                       if depth_dir else None),
            pred_cb=load_feature(cb_dir, im.name, (w, h)) if cb_dir else None,
        ))
    return SceneData(cameras=cameras, points=xyz, colors=rgb,
                     nerf_norm=compute_nerfpp_norm(cameras),
                     image_names=[c.image_name for c in cameras])
