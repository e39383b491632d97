"""The port's small single-scene pieces against the JAX package's, on the
same inputs made with numpy:

  * `ops/losses.py:dice_loss`, `iou_loss`: values and gradients (1e-6);
  * `models/gaussians.py:make_it_a_point`: the blob, every field (1e-6);
  * `load_colmap_scene` with the est_depth (.npy) and pred_cb (.png)
    planes: equal to JAX's;
  * `cli/ply_tools.py recolor` (label, is_object, generation): the output
    PLY byte for byte; `info`: the same lines;
  * `utils/native_io.py` against the port's pure-Python PLY and
    points3D.bin readers and writer: the same values, the same bytes
    (skipped when the native library does not build, like
    tests/test_native_io.py).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egogaussian_tpu.cli import ply_tools as j_ply_tools
from egogaussian_tpu.data.readers import load_colmap_scene as j_load_colmap_scene
from egogaussian_tpu.models import gaussians as j_g
from egogaussian_tpu.ops.losses import dice_loss as j_dice_loss
from egogaussian_tpu.ops.losses import iou_loss as j_iou_loss
from egogaussian_tpu_torch.cli import ply_tools
from egogaussian_tpu_torch.data import make_synthetic_video
from egogaussian_tpu_torch.data.colmap import read_points3d_binary
from egogaussian_tpu_torch.data.export_colmap import export_colmap_dataset
from egogaussian_tpu_torch.data.readers import load_colmap_scene
from egogaussian_tpu_torch.models.gaussians import (
    from_jax_arrays,
    make_it_a_point,
    save_ply,
)
from egogaussian_tpu_torch.ops import dice_loss, iou_loss
from egogaussian_tpu_torch.utils import native_io
from egogaussian_tpu_torch.utils.ply import read_ply, write_ply

torch.set_num_threads(1)
CPU = torch.device("cpu")


def _fields(x):
    return {f.name: np.asarray(getattr(x, f.name)) for f in dataclasses.fields(x)}


def _jax_model(n=40, seed=0, capacity=128):
    rng = np.random.RandomState(seed)
    m = j_g.from_points(rng.randn(n, 3).astype(np.float32), rng.rand(n, 3).astype(np.float32),
                        capacity=capacity)
    gen = np.zeros(capacity, np.int32)
    gen[:n] = rng.randint(0, 11, n)
    label = np.full((capacity, 1), 0.01, np.float32)
    label[:n, 0] = rng.rand(n)
    is_obj = np.zeros(capacity, np.int32)
    is_obj[:n] = rng.rand(n) > 0.5
    alive = np.asarray(m.aux.alive).copy()
    alive[::7] = False  # dead rows among live ones
    return dataclasses.replace(
        m, params=dataclasses.replace(m.params, label=jnp.asarray(label)),
        aux=dataclasses.replace(m.aux, generation=jnp.asarray(gen),
                                is_object=jnp.asarray(is_obj), alive=jnp.asarray(alive)))


def _port_model(jm):
    return from_jax_arrays(_fields(jm.params), _fields(jm.aux), CPU,
                           spatial_lr_scale=jm.spatial_lr_scale)


@pytest.mark.parametrize("name", ["dice", "iou"])
def test_mask_losses_match_jax(name):
    rng = np.random.RandomState(4)
    pred = rng.rand(1, 24, 32).astype(np.float32)
    target = (rng.rand(1, 24, 32) > 0.6).astype(np.float32)
    j_fn, t_fn = {"dice": (j_dice_loss, dice_loss), "iou": (j_iou_loss, iou_loss)}[name]
    jv, jg = jax.value_and_grad(j_fn)(jnp.asarray(pred), jnp.asarray(target))
    p = torch.tensor(pred, requires_grad=True)
    tv = t_fn(p, torch.tensor(target))
    (tg,) = torch.autograd.grad(tv, p)
    np.testing.assert_allclose(float(tv.detach()), float(jv), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    # a perfect prediction costs ~0, a disjoint one ~1
    assert float(t_fn(torch.tensor(target), torch.tensor(target))) < 1e-6
    assert float(t_fn(torch.tensor(1 - target), torch.tensor(target))) > 0.99


@pytest.mark.parametrize("color", ["red", "blue", "green", "other"])
def test_make_it_a_point_matches_jax(color):
    jm = _jax_model()
    jp = j_g.make_it_a_point(jm, color=color, scale=0.03)
    tp = make_it_a_point(_port_model(jm), color=color, scale=0.03)
    assert tp.capacity == jp.capacity == 128 and int(tp.num_alive) == 1
    for name, v in _fields(jp.params).items():
        np.testing.assert_allclose(getattr(tp.params, name).numpy(), v, atol=1e-6, rtol=0,
                                   err_msg=name)
    for name, v in _fields(jp.aux).items():
        np.testing.assert_array_equal(getattr(tp.aux, name).numpy(), v, err_msg=name)


def test_load_colmap_scene_planes_match_jax(tmp_path):
    from PIL import Image

    vid = make_synthetic_video(CPU, width=32, height=24, n_bg=40, n_obj=10,
                               frames_static=2, frames_dynamic=1)
    src = export_colmap_dataset(vid, str(tmp_path / "data"))
    rng = np.random.RandomState(6)
    (tmp_path / "data" / "est_depths").mkdir()
    (tmp_path / "data" / "pred_cb").mkdir()
    for i, name in enumerate(vid.image_names):
        np.save(tmp_path / "data" / "est_depths" / f"{name}.npy",
                rng.rand(24, 32).astype(np.float32) * 5)
        if i % 2 == 0:  # a frame without a pred_cb file gets None
            Image.fromarray(((rng.rand(24, 32) > 0.5) * 255).astype(np.uint8)).save(
                tmp_path / "data" / "pred_cb" / f"{name}.png")
    js = j_load_colmap_scene(src, load_est_depths=True, load_pred_cb=True)
    ts = load_colmap_scene(src, CPU, load_est_depths=True, load_pred_cb=True)
    assert len(ts.cameras) == len(js.cameras)
    for tc, jc in zip(ts.cameras, js.cameras):
        for plane in ("est_depth", "pred_cb"):
            jv = getattr(jc, plane)
            if jv is None:
                assert getattr(tc, plane) is None
            else:
                np.testing.assert_array_equal(getattr(tc, plane).numpy(), np.asarray(jv))
    assert ts.cameras[0].est_depth.shape == (1, 24, 32)
    assert ts.cameras[1].pred_cb is None and ts.cameras[0].pred_cb is not None
    plain = load_colmap_scene(src, CPU)
    assert plain.cameras[0].est_depth is None and plain.cameras[0].pred_cb is None


@pytest.mark.parametrize("by", ["label", "is_object", "generation"])
def test_ply_tools_recolor_bytes_match_jax(tmp_path, by, capsys):
    jm = _jax_model(seed=1)
    src = str(tmp_path / "in.ply")
    j_g.save_ply(jm, src)
    j_out, t_out = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    j_ply_tools.main(["recolor", src, j_out, "--by", by])
    ply_tools.main(["recolor", src, t_out, "--by", by])
    with open(j_out, "rb") as fj, open(t_out, "rb") as ft:
        assert ft.read() == fj.read()
    capsys.readouterr()
    j_ply_tools.main(["info", t_out])
    j_info = capsys.readouterr().out
    ply_tools.main(["info", t_out])
    assert capsys.readouterr().out == j_info


# ---------------------------------------------------------------------------
# native I/O
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """build_native() on a private copy of native/ (another test file may
    build the shared library at the same time), loaded in its place."""
    import shutil

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
    own = tmp_path_factory.mktemp("native")
    for name in ("Makefile", "egogs_io.cpp"):
        shutil.copy(os.path.join(src, name), own / name)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(native_io, "_lib_path", lambda: str(own / "libegogs_io.so"))
        if not native_io.build_native(verbose=False) or native_io.load_native() is None:
            pytest.skip("native toolchain unavailable")
        yield True
    native_io._LIB, native_io._TRIED = None, False


def _python_only(monkeypatch):
    monkeypatch.setattr(native_io, "load_native", lambda: None)


def test_native_ply_matches_python(built, tmp_path, monkeypatch):
    jm = _jax_model(n=300, seed=2, capacity=1024)
    model = _port_model(jm)
    native_path, python_path = str(tmp_path / "n.ply"), str(tmp_path / "p.ply")
    save_ply(model, native_path)
    with monkeypatch.context() as m:
        _python_only(m)
        save_ply(model, python_path)
        py_props, py_n = read_ply(native_path)
    with open(native_path, "rb") as fn, open(python_path, "rb") as fp:
        assert fn.read() == fp.read()
    nat = native_io.read_ply_native(native_path)
    assert nat is not None
    props, n = nat
    assert n == py_n == int(model.num_alive)
    assert list(props) == list(py_props)
    for k in props:
        np.testing.assert_array_equal(props[k], py_props[k], err_msg=k)


def test_native_write_ply_bytes(built, tmp_path, monkeypatch):
    names = [f"p{i}" for i in range(5)]
    cols = np.random.RandomState(3).randn(64, 5).astype(np.float32)
    write_ply(str(tmp_path / "n.ply"), names, cols)
    with monkeypatch.context() as m:
        _python_only(m)
        write_ply(str(tmp_path / "p.ply"), names, cols)
    assert (tmp_path / "n.ply").read_bytes() == (tmp_path / "p.ply").read_bytes()
    assert native_io.write_ply_native(str(tmp_path / "w.ply"), names, cols)


def test_native_points3d_matches_python(built, tmp_path, monkeypatch):
    vid = make_synthetic_video(CPU, width=32, height=24, n_bg=200, n_obj=20,
                               frames_static=2, frames_dynamic=1)
    src = export_colmap_dataset(vid, str(tmp_path / "data"))
    path = str(tmp_path / "data" / "sparse" / "0" / "points3D.bin")
    nat = native_io.read_points3d_bin_native(path)
    assert nat is not None
    with monkeypatch.context() as m:
        _python_only(m)
        py = read_points3d_binary(path)
    for a, b in zip(nat, py):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(nat[0]) == len(vid.points)
    assert src
