"""COLMAP sparse-model parsers (binary and text), host-side numpy.

PyTorch port: a copy of `egogaussian_tpu/data/colmap.py` (numpy only), with
points3D.bin through the native loader when it is built (as in JAX) and
the port's PLY helpers.

Functional twin of reference `scene/colmap_loader.py` (struct-based readers
for cameras.bin / images.bin / points3D.bin and their text variants). The
format is COLMAP's public serialization. Differences from the reference:
readers return plain dataclasses and vectorize with numpy where the format
allows (points3D is read in one `np.frombuffer` sweep rather than a python
loop — the reference loops per point, which takes seconds on 100k+ points).
"""
from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, List, Optional

import numpy as np

# COLMAP camera model table: model_id -> (name, num_params)
# (reference colmap_loader.py:24-36)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # [4] wxyz, world-to-camera rotation
    tvec: np.ndarray  # [3] world-to-camera translation
    camera_id: int
    name: str
    xys: np.ndarray  # [P, 2]
    point3d_ids: np.ndarray  # [P]


def qvec2rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP wxyz quaternion -> rotation matrix (colmap_loader.py:43-55)."""
    w, x, y, z = qvec
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
            [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
            [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def _read_next_bytes(f, num_bytes: int, fmt: str):
    return struct.unpack("<" + fmt, f.read(num_bytes))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    """cameras.bin (reference read_intrinsics_binary, colmap_loader.py:219)."""
    cameras = {}
    with open(path, "rb") as f:
        (num,) = _read_next_bytes(f, 8, "Q")
        for _ in range(num):
            cam_id, model_id, width, height = _read_next_bytes(f, 24, "iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read_next_bytes(f, 8 * num_params, "d" * num_params))
            cameras[cam_id] = ColmapCamera(
                id=cam_id, model=name, width=int(width), height=int(height), params=params
            )
    return cameras


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            cameras[cam_id] = ColmapCamera(
                id=cam_id,
                model=parts[1],
                width=int(parts[2]),
                height=int(parts[3]),
                params=np.array([float(x) for x in parts[4:]]),
            )
    return cameras


def read_images_binary(
    path: str, image_names: Optional[List[str]] = None
) -> Dict[int, ColmapImage]:
    """images.bin; optionally skip images not in `image_names` like the
    reference does (colmap_loader.py:180-217 — dataset dirs may contain more
    registered images than extracted frames)."""
    keep = set(image_names) if image_names is not None else None
    images = {}
    with open(path, "rb") as f:
        (num,) = _read_next_bytes(f, 8, "Q")
        for _ in range(num):
            vals = _read_next_bytes(f, 64, "idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name_bytes = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name_bytes += c
            name = name_bytes.decode("utf-8")
            (num_points,) = _read_next_bytes(f, 8, "Q")
            blob = f.read(24 * num_points)
            if keep is None or name in keep:
                arr = np.frombuffer(blob, dtype=np.float64).reshape(num_points, 3)
                xys = arr[:, :2].copy()
                ids = np.frombuffer(blob, dtype=np.int64).reshape(num_points, 3)[:, 2].copy()
                images[image_id] = ColmapImage(
                    id=image_id, qvec=qvec, tvec=tvec, camera_id=camera_id,
                    name=name, xys=xys, point3d_ids=ids,
                )
    return images


def read_images_text(
    path: str, image_names: Optional[List[str]] = None
) -> Dict[int, ColmapImage]:
    """images.txt: each image is a header line followed by ONE points line
    that may be EMPTY (zero observations). The points line must be consumed
    unconditionally — filtering blank lines first would shift the 2-line
    stride (the reference reads it with an unconditional readline,
    colmap_loader.py:248-270)."""
    keep = set(image_names) if image_names is not None else None
    images = {}
    with open(path) as f:
        while True:
            line = f.readline()
            if not line:
                break
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            pts = f.readline().split()  # points line, possibly empty
            name = parts[9]
            if keep is not None and name not in keep:
                continue
            arr = (
                np.array([float(x) for x in pts]).reshape(-1, 3)
                if pts else np.zeros((0, 3))
            )
            images[int(parts[0])] = ColmapImage(
                id=int(parts[0]),
                qvec=np.array([float(x) for x in parts[1:5]]),
                tvec=np.array([float(x) for x in parts[5:8]]),
                camera_id=int(parts[8]),
                name=name,
                xys=arr[:, :2],
                point3d_ids=arr[:, 2].astype(np.int64),
            )
    return images


def read_points3d_binary(path: str):
    """points3D.bin -> (xyz [N,3], rgb [N,3] in [0,1], errors [N]). Through
    the native library when it is built (utils/native_io.py), else one
    struct pass per point (reference colmap_loader.py:125-154); the values
    are the same either way."""
    from egogaussian_tpu_torch.utils.native_io import read_points3d_bin_native

    native = read_points3d_bin_native(path)
    if native is not None:
        return native
    with open(path, "rb") as f:
        (num,) = _read_next_bytes(f, 8, "Q")
        xyzs = np.empty((num, 3), np.float64)
        rgbs = np.empty((num, 3), np.uint8)
        errors = np.empty(num, np.float64)
        for i in range(num):
            head = f.read(43)
            x, y, z = struct.unpack("<ddd", head[8:32])
            rgbs[i] = np.frombuffer(head[32:35], np.uint8)
            (errors[i],) = struct.unpack("<d", head[35:43])
            xyzs[i] = (x, y, z)
            (track_len,) = _read_next_bytes(f, 8, "Q")
            f.seek(8 * track_len, os.SEEK_CUR)
    return xyzs.astype(np.float32), (rgbs.astype(np.float32) / 255.0), errors


def read_points3d_text(path: str):
    xyzs, rgbs, errors = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyzs.append([float(x) for x in parts[1:4]])
            rgbs.append([float(x) for x in parts[4:7]])
            errors.append(float(parts[7]))
    return (
        np.array(xyzs, np.float32),
        np.array(rgbs, np.float32) / 255.0,
        np.array(errors),
    )


def write_points3d_ply(path: str, xyz: np.ndarray, rgb01: np.ndarray) -> None:
    """Store points3D as a simple colored PLY (reference storePly,
    dataset_readers.py:276-282 writes one next to the bin once)."""
    from egogaussian_tpu_torch.utils.ply import write_ply

    normals = np.zeros_like(xyz)
    cols = np.concatenate([xyz, normals, rgb01 * 255.0], axis=1)
    names = ["x", "y", "z", "nx", "ny", "nz", "red", "green", "blue"]
    write_ply(path, names, cols)


def read_points_ply(path: str):
    """Read a colored point-cloud PLY -> (xyz, rgb in [0,1])."""
    from egogaussian_tpu_torch.utils.ply import read_ply

    props, _ = read_ply(path)
    xyz = np.stack([props["x"], props["y"], props["z"]], axis=1).astype(np.float32)
    rgb = np.stack([props["red"], props["green"], props["blue"]], axis=1).astype(
        np.float32
    )
    if rgb.max() > 1.5:
        rgb = rgb / 255.0
    return xyz, rgb
