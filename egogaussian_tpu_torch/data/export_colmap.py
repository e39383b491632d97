"""Export a SyntheticVideo as a reference-layout COLMAP dataset.

Produces exactly the directory structure the reference pipeline (and our
CLI twin) consumes — README.md "Dataset" layout:

  out/
    sparse/0/{cameras,images,points3D}.bin
    images/<name>.png
    hand_masks/<name>.png
    obj_masks/<name>.png
    split/{training_frames,dynamic_eval_frames,static_eval_frames,
           phase_frame_index}.txt

Used by the e2e CLI tests and as a fixture generator for benchmarks.

PyTorch port of `egogaussian_tpu/data/export_colmap.py`: the same files,
byte for byte, from the port's SyntheticVideo.
"""
from __future__ import annotations

import os
import struct

import numpy as np

from egogaussian_tpu_torch.data.colmap import CAMERA_MODEL_IDS
from egogaussian_tpu_torch.data.synthetic import SyntheticVideo
from egogaussian_tpu_torch.ops.quaternion import rotmat_to_quat


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def export_colmap_dataset(vid: SyntheticVideo, out_dir: str) -> str:
    from PIL import Image

    sparse = os.path.join(out_dir, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    for sub in ("images", "hand_masks", "obj_masks", "split"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    cam0 = vid.cameras[0]
    w, h = cam0.width, cam0.height
    fx, fy = float(cam0.fx), float(cam0.fy)
    cx, cy = float(cam0.cx), float(cam0.cy)

    # cameras.bin: one shared PINHOLE camera
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, CAMERA_MODEL_IDS["PINHOLE"], w, h))
        f.write(struct.pack("<dddd", fx, fy, cx, cy))

    # images.bin
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(vid.cameras)))
        for i, cam in enumerate(vid.cameras):
            R = cam.viewmat[:3, :3].detach().cpu()
            t = _host(cam.viewmat[:3, 3])
            q = rotmat_to_quat(R).numpy()
            f.write(struct.pack("<idddddddi", i + 1, *q, *t, 1))
            f.write(f"{cam.image_name}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 0))  # no 2D points

    # points3D.bin from the noisy init cloud
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(vid.points)))
        for i, (p, c) in enumerate(zip(vid.points, vid.colors)):
            f.write(struct.pack("<Q", i))
            f.write(struct.pack("<ddd", *p.astype(np.float64)))
            f.write(struct.pack("<BBB", *np.clip(c * 255, 0, 255).astype(np.uint8)))
            f.write(struct.pack("<d", 0.1))
            f.write(struct.pack("<Q", 0))  # empty track

    def save_img(path, arr_chw):
        arr = (np.clip(_host(arr_chw).transpose(1, 2, 0), 0, 1) * 255).astype(
            np.uint8
        )
        if arr.shape[-1] == 1:
            arr = arr[..., 0]
        Image.fromarray(arr).save(path)

    for cam in vid.cameras:
        name = cam.image_name
        save_img(os.path.join(out_dir, "images", f"{name}.png"), cam.gt_image)
        save_img(os.path.join(out_dir, "hand_masks", f"{name}.png"), cam.hand_mask)
        save_img(os.path.join(out_dir, "obj_masks", f"{name}.png"), cam.obj_mask)

    names = vid.image_names
    split = os.path.join(out_dir, "split")
    # Interior holdouts, excluded from training (reference protocol: the
    # shipped split files hold out interior frames and the trainers consume
    # ONLY training_frames — upstream EgoGaussian train.py:54-73). Two defects in
    # the old split here: (a) static_eval was the LAST video frame, i.e.
    # extrapolation past the camera-trajectory end (structurally ~22-24 dB
    # regardless of view density), and (b) the dynamic_eval frame stayed in
    # training_frames, so dynamic_eval scored a trained view. A held-out
    # interior dynamic frame gets its pose from stage-4 interpolation
    # (interpolate_pose_sequence splits the next solved delta by N-th root),
    # so it needs solved neighbors on BOTH sides -> only hold one out when
    # the dynamic phase has >= 3 frames. The two fallbacks are INDEPENDENT:
    # d<3 keeps dynamic_eval at the phase's first frame WITHOUT excluding it
    # (dynamic_eval then scores a trained view — defect (b) persists for
    # tiny dynamic phases, by necessity); s<3 falls back to the last static
    # frame (excluded, as the legacy split also did). Only when BOTH fall
    # back (d<3 AND s<3) is the legacy split reproduced byte-for-byte; a
    # mixed case (e.g. d<3, s>=3) yields a CHANGED split with an interior
    # static holdout while dynamic_eval still scores a trained view.
    d0, d1 = vid.dynamic_phases[0]
    s0, s1 = vid.static_phases[-1]
    excluded = set()
    if d1 - d0 + 1 >= 3:
        dyn_eval = d0 + (d1 - d0) // 2
        excluded.add(dyn_eval)
    else:
        dyn_eval = d0
    if s1 - s0 + 1 >= 3:
        stat_eval = s0 + (s1 - s0) // 2
    else:
        stat_eval = s1
    excluded.add(stat_eval)
    with open(os.path.join(split, "training_frames.txt"), "w") as f:
        f.write("\n".join(n for i, n in enumerate(names) if i not in excluded) + "\n")
    with open(os.path.join(split, "dynamic_eval_frames.txt"), "w") as f:
        f.write(names[dyn_eval] + "\n")
    with open(os.path.join(split, "static_eval_frames.txt"), "w") as f:
        f.write(names[stat_eval] + "\n")
    with open(os.path.join(split, "phase_frame_index.txt"), "w") as f:
        phases = []
        for s, d in zip(vid.static_phases, vid.dynamic_phases):
            phases.append(s)
            phases.append(d)
        phases.append(vid.static_phases[-1])
        # interleave: static, dynamic, static, ... (unique, ordered)
        seen = []
        for p in phases:
            if p not in seen:
                seen.append(p)
        for a, b in seen:
            f.write(f"{a},{b}\n")
    return out_dir
