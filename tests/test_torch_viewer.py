"""The port's viewers (`eval/viewer.py`, `eval/network_viewer.py`) and
montage helpers (`utils/visualize.py`) against the JAX package's, on the
same 32x24 synthetic video and models made with numpy. JAX renders on the
CPU as its own tests do (tests/test_aux.py: backend "tiled"), the port
through its tiled backend's plain twins.

  * interpolate_cameras: the same viewmats (1e-5);
  * render_trajectory and render_double_trajectory: every frame (1e-5,
    caught where each package saves its PNG) and the trail model's alive
    count and centres;
  * render_freeview: every frame (1e-5); render_multiview: its montages
    hold the panels it rendered, within one 8-bit level of JAX's;
  * serve: one SIBR round trip each, the same message; the port's bytes
    are send_image's conversion of its own render, within one 8-bit level
    of JAX's, with the same length prefix and verify string;
  * make_montage and vis_input_and_render: the same uint8 arrays.
"""
import json
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from egogaussian_tpu.eval import viewer as j_viewer
from egogaussian_tpu.eval.network_viewer import serve as j_serve
from egogaussian_tpu.models import gaussians as j_g
from egogaussian_tpu.models.pose import PoseSequence as JPoseSequence
from egogaussian_tpu.utils import visualize as j_vis
from egogaussian_tpu_torch.data import make_synthetic_video
from egogaussian_tpu_torch.eval import viewer
from egogaussian_tpu_torch.eval.network_viewer import send_image, serve
from egogaussian_tpu_torch.models.pose import pose_sequence_from_jax_arrays
from egogaussian_tpu_torch.render.camera import Camera, fov_to_focal
from egogaussian_tpu_torch.train.common import render_gaussians
from egogaussian_tpu_torch.utils import visualize
from tests.test_torch_static import _jax_cameras
from tests.test_torch_tools import _port_model

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = 1e-5


@pytest.fixture(scope="module")
def video():
    return make_synthetic_video(CPU, width=32, height=24, n_bg=40, n_obj=12,
                                frames_static=2, frames_dynamic=2)


def _jax_model(n, seed, capacity=64):
    rng = np.random.RandomState(seed)
    return j_g.from_points(rng.randn(n, 3).astype(np.float32),
                           rng.rand(n, 3).astype(np.float32), capacity=capacity)


def _sequences(video):
    """(JAX, port) sequences of the video's ground-truth deltas, and a
    second pair with every translation moved by 0.05."""
    import jax.numpy as jnp

    d = video.gt_obj_deltas.astype(np.float32)
    solved = np.ones(len(d), bool)
    out = []
    for shift in (0.0, 0.05):
        tr = d[:, :3, 3] + shift
        out.append((JPoseSequence(jnp.asarray(tr), jnp.asarray(d[:, :3, :3]),
                                  jnp.asarray(solved)),
                    pose_sequence_from_jax_arrays(tr, d[:, :3, :3], solved, CPU)))
    return out


def _capture(monkeypatch, module):
    frames = []
    monkeypatch.setattr(module, "_save", lambda path, img: frames.append(np.asarray(img)))
    return frames


def test_interpolate_cameras_matches_jax(video):
    jc = _jax_cameras(video.cameras)
    jcams = j_viewer.interpolate_cameras(jc[0], jc[-1], 7)
    tcams = viewer.interpolate_cameras(video.cameras[0], video.cameras[-1], 7)
    assert len(tcams) == 7
    for t, j in zip(tcams, jcams):
        np.testing.assert_allclose(t.viewmat.numpy(), np.asarray(j.viewmat), atol=TOL, rtol=0)
        R = t.viewmat[:3, :3].numpy()
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    np.testing.assert_allclose(tcams[0].viewmat.numpy(), video.cameras[0].viewmat.numpy(),
                               atol=TOL)


@pytest.mark.parametrize("double", [False, True], ids=["single", "double"])
def test_render_trajectory_matches_jax(video, tmp_path, monkeypatch, double):
    jbg, jobj = _jax_model(30, 0), _jax_model(10, 1)
    (jseq, tseq), (jseq2, tseq2) = _sequences(video)
    jc = _jax_cameras(video.cameras)
    with monkeypatch.context() as m:
        jframes = _capture(m, j_viewer)
        tframes = _capture(m, viewer)
        renders = []
        if double:
            jout = j_viewer.render_double_trajectory(jc, jbg, jobj, jseq, jseq2,
                                                     save_dir=str(tmp_path / "j"))
            tout = viewer.render_double_trajectory(
                video.cameras, _port_model(jbg), _port_model(jobj), tseq, tseq2,
                save_dir=str(tmp_path / "t"), on_render=lambda *a: renders.append(a))
        else:
            jout = j_viewer.render_trajectory(jc, jbg, jobj, jseq, save_dir=str(tmp_path / "j"))
            tout = viewer.render_trajectory(
                video.cameras, _port_model(jbg), _port_model(jobj), tseq,
                save_dir=str(tmp_path / "t"), on_render=lambda *a: renders.append(a))
    n = len(video.cameras)
    assert len(tframes) == len(jframes) == n
    assert len(renders) == (2 if double else 1) * n
    for f, (t, j) in enumerate(zip(tframes, jframes)):
        np.testing.assert_allclose(t, j, atol=TOL, rtol=0, err_msg=f"frame {f}")
    assert int(tout.num_alive) == int(jout.num_alive) == 30 + (2 if double else 1) * n
    alive = tout.aux.alive.numpy()
    np.testing.assert_allclose(tout.params.xyz.numpy()[alive],
                               np.asarray(jout.params.xyz)[np.asarray(jout.aux.alive)],
                               atol=TOL, rtol=0)


def test_render_freeview_and_multiview_match_jax(video, tmp_path, monkeypatch):
    jm = _jax_model(40, 2)
    (jseq, tseq), _ = _sequences(video)
    jc = _jax_cameras(video.cameras)
    tm = _port_model(jm)
    with monkeypatch.context() as m:
        m.setattr(j_viewer, "_save", lambda path, img: None)
        jframes = j_viewer.render_freeview(jc, jm, jseq, jc[1], jc[-1])
        tframes = viewer.render_freeview(video.cameras, tm, tseq, video.cameras[1],
                                         video.cameras[-1], save_dir=str(tmp_path / "free"))
    assert len(tframes) == len(video.cameras)
    for f, (t, j) in enumerate(zip(tframes, jframes)):
        np.testing.assert_allclose(t, np.asarray(j), atol=TOL, rtol=0, err_msg=f"frame {f}")
    saved = sorted(p.name for p in (tmp_path / "free").iterdir())
    assert saved == sorted(f"{c.image_name}.png" for c in video.cameras)

    views = viewer.interpolate_cameras(video.cameras[0], video.cameras[-1], 3)
    panels = []
    tmv = viewer.render_multiview(video.cameras, tm, tseq, views,
                                  save_dir=str(tmp_path / "multi"),
                                  on_render=lambda *a: panels.append(a[3].image))
    jmv = j_viewer.render_multiview(jc, jm, jseq, j_viewer.interpolate_cameras(jc[0], jc[-1], 3))
    assert len(panels) == 3 * len(video.cameras)
    for f, (t, j) in enumerate(zip(tmv, jmv)):
        assert t.shape == j.shape == (24 + 14, 3 * 32, 3)
        assert np.abs(t.astype(int) - j.astype(int)).max() <= 1, f
        for i in range(3):  # the montage holds the panels rendered
            want = visualize.to_uint8_image(panels[3 * f + i])
            np.testing.assert_array_equal(t[14:, 32 * i:32 * (i + 1)], want)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _round_trip(serve_fn, model, msg):
    port = _free_port()
    result = {}
    th = threading.Thread(target=lambda: result.update(
        n=serve_fn(model, port=port, max_messages=1)))
    th.start()
    deadline = time.time() + 30
    while True:
        try:
            cli = socket.create_connection(("127.0.0.1", port), timeout=30)
            break
        except ConnectionRefusedError:
            if time.time() > deadline:
                raise
            time.sleep(0.05)
    payload = json.dumps(msg).encode()
    cli.sendall(struct.pack("<I", len(payload)) + payload)
    data = b""
    while True:
        chunk = cli.recv(65536)
        if not chunk:
            break
        data += chunk
    cli.close()
    th.join(timeout=30)
    assert result["n"] == 1
    return data


def test_serve_round_trip_matches_jax():
    jm = _jax_model(40, 3)
    tm = _port_model(jm)
    w, h = 32, 24
    view = np.eye(4, dtype=np.float32)
    view[:3, 3] = [0.1, -0.2, 4.0]
    msg = {"resolution_x": w, "resolution_y": h, "train": False, "fov_y": 0.8, "fov_x": 1.0,
           "z_near": 0.01, "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
           "keep_alive": False, "scaling_modifier": 1.0,
           "view_matrix": view.T.ravel().tolist(),
           "view_projection_matrix": np.eye(4, dtype=np.float32).ravel().tolist()}
    jbytes = _round_trip(j_serve, jm, msg)
    tbytes = _round_trip(serve, tm, msg)
    n_img = w * h * 3
    assert len(tbytes) == len(jbytes) == n_img + 4 + 2
    assert tbytes[n_img:] == jbytes[n_img:] == struct.pack("<I", 2) + b"ok"
    t_img = np.frombuffer(tbytes[:n_img], np.uint8)
    assert np.abs(t_img.astype(int) - np.frombuffer(jbytes[:n_img], np.uint8)).max() <= 1

    # the port's bytes are send_image's conversion of its own render
    cam = Camera.from_viewmat(view, fov_to_focal(1.0, w), fov_to_focal(0.8, h), w, h, CPU)
    img = render_gaussians(tm, cam, torch.zeros(3), backend="tiled").image.detach().numpy()

    class Sink:
        data = b""

        def sendall(self, b):
            Sink.data += b

    send_image(Sink(), img)
    assert Sink.data == tbytes
    assert t_img.max() > 0  # the model is in view


def test_montages_match_jax():
    rng = np.random.RandomState(7)
    imgs = [rng.rand(3, 24, 32).astype(np.float32), rng.rand(1, 24, 32).astype(np.float32),
            rng.rand(24, 32).astype(np.float32)]
    caps = ["a", "bb", "ccc"]
    np.testing.assert_array_equal(np.asarray(visualize.make_montage(imgs, caps, rows=2)),
                                  np.asarray(j_vis.make_montage(imgs, caps, rows=2)))
    np.testing.assert_array_equal(np.asarray(visualize.make_montage(imgs)),
                                  np.asarray(j_vis.make_montage(imgs)))
    planes = [rng.rand(3, 24, 32), rng.rand(1, 24, 32) > 0.5, rng.rand(1, 24, 32) > 0.5,
              rng.rand(1, 24, 32) * 7, rng.rand(3, 24, 32), rng.rand(1, 24, 32) * 3,
              rng.rand(1, 24, 32), rng.rand(1, 24, 32)]
    planes = [p.astype(np.float32) for p in planes]
    want = np.asarray(j_vis.vis_input_and_render(*planes, frame_name="00042"))
    got = visualize.vis_input_and_render(*[torch.tensor(p) for p in planes], frame_name="00042")
    np.testing.assert_array_equal(np.asarray(got), want)
    assert want.shape == (2 * (24 + 14), 4 * 32, 3)
