"""Interactive network viewer server.

Port of `egogaussian_tpu/eval/network_viewer.py`, whose byte protocol
(which imports no JAX) is copied here unchanged; the render goes through
the port's render_gaussians on the model's device (backend "tiled": on
the card the chunked windowed forward kernel).

Functional twin of reference `gaussian_renderer/network_gui.py` (the SIBR
remote-viewer TCP protocol from vanilla 3DGS: a JSON header with camera
parameters + raw little-endian matrices, answered with raw RGB bytes).
The reference never imports it from the pipeline (vestigial); here it is a
working optional utility:

  python -m egogaussian_tpu_torch.eval.network_viewer \
      --ply out/fine_all/gaussians_all.ply [--device cuda]

Protocol per message (matching network_gui.py:18-86):
  recv: uint32 len + JSON {resolution_x, resolution_y, train, fov_y, fov_x,
        z_near, z_far, shs_python, rot_scale_python, keep_alive,
        scaling_modifier, view_matrix (16 floats), view_projection_matrix}
  send: H*W*3 uint8 RGB + uint32 len + verification string
"""
from __future__ import annotations

import json
import socket
import struct
import traceback
from typing import Optional

import numpy as np


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("client closed")
        buf += chunk
    return buf


def read_viewer_message(conn: socket.socket):
    """Parse one viewer message -> (custom_cam dict | None, flags dict)."""
    (msg_len,) = struct.unpack("<I", _recv_exact(conn, 4))
    msg = json.loads(_recv_exact(conn, msg_len).decode())
    width = msg["resolution_x"]
    height = msg["resolution_y"]
    flags = {
        "train": bool(msg.get("train", False)),
        "keep_alive": bool(msg.get("keep_alive", True)),
        "scaling_modifier": float(msg.get("scaling_modifier", 1.0)),
    }
    if width == 0 or height == 0:
        return None, flags
    view = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
    cam = {
        "width": int(width),
        "height": int(height),
        "fov_y": float(msg["fov_y"]),
        "fov_x": float(msg["fov_x"]),
        # SIBR sends the transposed world-to-view like the reference MiniCam
        "viewmat": view.T,
    }
    return cam, flags


def send_image(conn: socket.socket, image: Optional[np.ndarray], verify: str = "ok"):
    if image is not None:
        arr = (np.clip(image.transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
        conn.sendall(arr.tobytes())
    payload = verify.encode("ascii")
    conn.sendall(struct.pack("<I", len(payload)) + payload)


def serve(
    model,
    host: str = "127.0.0.1",
    port: int = 6009,
    backend: str = "tiled",
    max_messages: Optional[int] = None,
):
    """Blocking render server for a fixed model, rendering on the model's
    device. `max_messages` bounds the loop (tests, the card check).
    Returns the number of messages served."""
    import torch

    from egogaussian_tpu_torch.render.camera import Camera, fov_to_focal
    from egogaussian_tpu_torch.train.common import render_gaussians

    listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind((host, port))
    listener.listen(1)
    print(f"viewer listening on {host}:{listener.getsockname()[1]}")
    conn, addr = listener.accept()
    served = 0
    bg = torch.zeros(3, device=model.device)
    try:
        while max_messages is None or served < max_messages:
            try:
                cam_msg, flags = read_viewer_message(conn)
            except (ConnectionError, struct.error):
                break
            img = None
            if cam_msg is not None:
                w, h = cam_msg["width"], cam_msg["height"]
                cam = Camera.from_viewmat(
                    cam_msg["viewmat"], fov_to_focal(cam_msg["fov_x"], w),
                    fov_to_focal(cam_msg["fov_y"], h), w, h, model.device)
                with torch.no_grad():
                    img = render_gaussians(model, cam, bg, backend=backend).image.cpu().numpy()
            send_image(conn, img)
            served += 1
            if not flags["keep_alive"]:
                break
    except Exception:
        traceback.print_exc()
    finally:
        conn.close()
        listener.close()
    return served


def main(argv=None):
    from argparse import ArgumentParser

    import torch

    from egogaussian_tpu_torch.models.gaussians import load_ply

    parser = ArgumentParser(description="EgoGaussian network viewer (PyTorch port)")
    parser.add_argument("--ply", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--device", default="cuda",
                        help="torch device to render on (default: cuda)")
    args = parser.parse_args(argv)
    model = load_ply(args.ply, torch.device(args.device))
    serve(model, args.host, args.port)


if __name__ == "__main__":
    main()
