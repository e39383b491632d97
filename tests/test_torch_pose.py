"""Pose algebra and crop windows of the port against the JAX package: SE(3)
ops, the 6D rotation, the rotated covariance, pose sequences (npz files
read across packages in both directions), the closed-form N-th root and
pose interpolation; mask boxes, crop-window placement and escape counts
(integers exact) and the crop slice.

Tolerances: the math is elementwise float32 in the same order in both
packages (atol 1e-6 on values of order 1), except the running products of
accumulated transforms (JAX: a log-depth associative scan; here a
sequential loop) and the linear solve of se3_nth_root, which differ by
float32 reassociation (atol 1e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egogaussian_tpu.models import pose as j_pose
from egogaussian_tpu.ops import covariance as j_covm
from egogaussian_tpu.ops import rotation6d as j_rot6d
from egogaussian_tpu.ops import se3 as j_se3
from egogaussian_tpu.render import crop as j_crop
from egogaussian_tpu.render.camera import Camera as JCamera
from egogaussian_tpu.render.project import project_gaussians as j_project
from egogaussian_tpu_torch.models import pose as t_pose
from egogaussian_tpu_torch.ops import covariance as t_covm
from egogaussian_tpu_torch.ops import rotation6d as t_rot6d
from egogaussian_tpu_torch.ops import se3 as t_se3
from egogaussian_tpu_torch.render import crop as t_crop
from egogaussian_tpu_torch.render.camera import Camera, look_at
from egogaussian_tpu_torch.render.project import project_gaussians as t_project

torch.set_num_threads(1)
CPU = torch.device("cpu")
T_ = torch.as_tensor


def _rotations(rng, n):
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], 1).astype(np.float32)


def _seq(rng, n=6):
    R = _rotations(rng, n)
    t = (rng.randn(n, 3) * 0.3).astype(np.float32)
    solved = np.array([True, False, True, True, False, True])[:n]
    return R, t, solved


def test_se3_ops_match_jax():
    rng = np.random.RandomState(0)
    R, t, _ = _seq(rng)
    xyz = rng.randn(5, 3).astype(np.float32)
    Tj = j_se3.make_se3(jnp.asarray(R), jnp.asarray(t))
    Tt = t_se3.make_se3(T_(R), T_(t))
    np.testing.assert_array_equal(Tt.numpy(), np.asarray(Tj))
    np.testing.assert_allclose(t_se3.se3_inverse(Tt).numpy(), np.asarray(j_se3.se3_inverse(Tj)),
                               atol=1e-6)
    np.testing.assert_allclose(t_se3.se3_apply(Tt[2], T_(xyz)).numpy(),
                               np.asarray(j_se3.se3_apply(Tj[2], jnp.asarray(xyz))), atol=1e-6)
    np.testing.assert_allclose(t_se3.se3_compose(Tt[0], Tt[1]).numpy(),
                               np.asarray(j_se3.se3_compose(Tj[0], Tj[1])), atol=1e-6)
    np.testing.assert_allclose(t_se3.accumulate_transforms(Tt).numpy(),
                               np.asarray(j_se3.accumulate_transforms(Tj)), atol=1e-5)
    np.testing.assert_allclose(t_se3.accumulate_rotations(T_(R)).numpy(),
                               np.asarray(j_se3.accumulate_rotations(jnp.asarray(R))), atol=1e-5)


def test_rotation6d_and_its_gradient_match_jax():
    import jax

    rng = np.random.RandomState(1)
    d6 = rng.randn(4, 3, 2).astype(np.float32)
    np.testing.assert_allclose(t_rot6d.rot6d_to_rotmat(T_(d6)).numpy(),
                               np.asarray(j_rot6d.rot6d_to_rotmat(jnp.asarray(d6))), atol=1e-6)
    np.testing.assert_allclose(t_rot6d.rot6d_to_rotmat(T_(d6.reshape(4, 6))).numpy(),
                               np.asarray(j_rot6d.rot6d_to_rotmat(jnp.asarray(d6.reshape(4, 6)))),
                               atol=1e-6)
    w = rng.randn(3, 3).astype(np.float32)
    gj = jax.grad(lambda x: jnp.sum(j_rot6d.rot6d_to_rotmat(x) * w))(jnp.asarray(d6[0]))
    x = T_(d6[0]).requires_grad_(True)
    (gt,) = torch.autograd.grad(torch.sum(t_rot6d.rot6d_to_rotmat(x) * T_(w)), x)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-6)
    R = _rotations(rng, 2)
    np.testing.assert_array_equal(t_rot6d.rotmat_to_rot6d(T_(R)).numpy(), R[:, :, :2])
    np.testing.assert_array_equal(t_rot6d.identity_rot6d().numpy(),
                                  np.asarray(j_rot6d.identity_rot6d()))


def test_covariance_rotated_matches_jax():
    rng = np.random.RandomState(2)
    n = 9
    scales = np.exp(rng.randn(n, 3) * 0.3 - 2).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    X = _rotations(rng, 1)[0]
    mask = np.arange(n) % 3 == 0
    cj = j_covm.covariance_from_scaling_rotation_rotated(
        jnp.asarray(scales), jnp.asarray(quats), jnp.asarray(X), jnp.asarray(mask))
    ct = t_covm.covariance_from_scaling_rotation_rotated(T_(scales), T_(quats), T_(X), T_(mask))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-7, rtol=1e-5)
    # unmasked rows keep the plain covariance, masked rows are X S X^T
    plain = t_covm.covariance_from_scaling_rotation(T_(scales), T_(quats))
    np.testing.assert_array_equal(ct[~T_(mask)].numpy(), plain[~T_(mask)].numpy())
    full = t_covm.unpack_symmetric(plain[0])
    np.testing.assert_allclose(t_covm.unpack_symmetric(ct[0]).numpy(),
                               (T_(X) @ full @ T_(X).T).numpy(), atol=1e-7)


def test_pose_and_sequence_match_jax():
    rng = np.random.RandomState(3)
    R, t, solved = _seq(rng)
    d6 = rng.randn(3, 2).astype(np.float32)
    tr = rng.randn(3).astype(np.float32)
    pj = j_pose.ObjectPose(translation=jnp.asarray(tr), rot6d=jnp.asarray(d6))
    pt = t_pose.pose_from_jax_arrays(tr, d6, CPU)
    np.testing.assert_allclose(t_pose.pose_to_se3(pt).numpy(), np.asarray(j_pose.pose_to_se3(pj)),
                               atol=1e-6)
    xyz = rng.randn(4, 3).astype(np.float32)
    np.testing.assert_allclose(t_pose.apply_pose(pt, T_(xyz)).numpy(),
                               np.asarray(j_pose.apply_pose(pj, jnp.asarray(xyz))), atol=1e-6)
    np.testing.assert_array_equal(t_pose.identity_pose().rot6d.numpy(),
                                  np.asarray(j_pose.identity_pose().rot6d))
    sj = j_pose.PoseSequence(translations=jnp.asarray(t), rotations=jnp.asarray(R),
                             solved=jnp.asarray(solved))
    st = t_pose.pose_sequence_from_jax_arrays(t, R, solved, CPU)
    np.testing.assert_array_equal(st.deltas().numpy(), np.asarray(sj.deltas()))
    np.testing.assert_allclose(st.accum_T().numpy(), np.asarray(sj.accum_T()), atol=1e-5)
    np.testing.assert_allclose(st.accum_R().numpy(), np.asarray(sj.accum_R()), atol=1e-5)
    uj = sj.update_frame(1, pj)
    ut = st.update_frame(1, pt)
    for f in ("translations", "rotations", "solved"):
        np.testing.assert_allclose(getattr(ut, f).numpy(), np.asarray(getattr(uj, f)), atol=1e-6)
    assert not st.solved[1]  # update_frame returns a new sequence
    e = t_pose.empty_pose_sequence(4)
    ej = j_pose.empty_pose_sequence(4)
    for f in ("translations", "rotations", "solved"):
        np.testing.assert_array_equal(getattr(e, f).numpy(), np.asarray(getattr(ej, f)))


def test_pose_npz_reads_across_packages(tmp_path):
    rng = np.random.RandomState(4)
    R, t, solved = _seq(rng)
    names = [f"{i:06d}" for i in range(len(t))]
    st = t_pose.pose_sequence_from_jax_arrays(t, R, solved, CPU)
    t_pose.save_pose_sequence(str(tmp_path / "a" / "port.npz"), st, names)
    sj, nj = j_pose.load_pose_sequence(str(tmp_path / "a" / "port.npz"))
    assert nj == names
    for f in ("translations", "rotations", "solved"):
        np.testing.assert_array_equal(np.asarray(getattr(sj, f)), getattr(st, f).numpy())
    j_pose.save_pose_sequence(str(tmp_path / "jax.npz"), sj, names)
    back, nt = t_pose.load_pose_sequence(str(tmp_path / "jax.npz"), CPU)
    assert nt == names and back.solved.dtype == torch.bool
    for f in ("translations", "rotations", "solved"):
        np.testing.assert_array_equal(getattr(back, f).numpy(), getattr(st, f).numpy())


@pytest.mark.parametrize("n", [1, 3, 5])
def test_se3_nth_root_matches_jax(n):
    rng = np.random.RandomState(10 + n)
    R = _rotations(rng, 1)[0]
    t = rng.randn(3).astype(np.float32)
    T = np.array(j_se3.make_se3(jnp.asarray(R), jnp.asarray(t)))
    Dj = np.asarray(j_pose.se3_nth_root(jnp.asarray(T), n))
    Dt = t_pose.se3_nth_root(T_(T), n)
    np.testing.assert_allclose(Dt.numpy(), Dj, atol=1e-5)
    P = torch.eye(4)
    for _ in range(n):
        P = Dt @ P
    np.testing.assert_allclose(P.numpy(), T, atol=1e-5)


def test_interpolate_pose_sequence_matches_jax():
    rng = np.random.RandomState(20)
    R, t, solved = _seq(rng)
    dyn = np.array([True, True, True, False, True, True])
    sj = j_pose.interpolate_pose_sequence(
        j_pose.PoseSequence(translations=jnp.asarray(t), rotations=jnp.asarray(R),
                            solved=jnp.asarray(solved)), dyn)
    st = t_pose.interpolate_pose_sequence(t_pose.pose_sequence_from_jax_arrays(t, R, solved, CPU),
                                          dyn)
    np.testing.assert_array_equal(st.solved.numpy(), np.asarray(sj.solved))
    np.testing.assert_allclose(st.translations.numpy(), np.asarray(sj.translations), atol=1e-5)
    np.testing.assert_allclose(st.rotations.numpy(), np.asarray(sj.rotations), atol=1e-5)


# ---------------------------------------------------------------------------
# crop windows
# ---------------------------------------------------------------------------

def _masks():
    m = np.zeros((4, 1, 30, 40), np.float32)
    m[0, 0, 5:12, 7:20] = 1
    m[2, 0, 0:30, 39:40] = 1
    m[3, 0, 29, 0] = 1
    return m  # frame 1 empty


def test_mask_rects_match_jax():
    m = _masks()
    np.testing.assert_array_equal(t_crop.mask_rect_table(T_(m)).numpy(),
                                  np.asarray(j_crop.mask_rect_table(jnp.asarray(m))))
    for f in range(len(m)):
        np.testing.assert_array_equal(t_crop.mask_rect(T_(m[f])).numpy(),
                                      np.asarray(j_crop.mask_rect(jnp.asarray(m[f]))))


def _projection(seed, n, w, h):
    rng = np.random.RandomState(seed)
    means = (rng.randn(n, 3) * 0.5).astype(np.float32)
    scales = np.exp(rng.randn(n, 3) * 0.3 - 2.5).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    ops = rng.uniform(0.002, 0.95, n).astype(np.float32)
    valid = rng.rand(n) > 0.1
    R, t = look_at(np.array([0.0, 0.0, -4.0]), np.zeros(3))
    jc = JCamera.from_colmap(R, t, 80.0, 80.0, w, h)
    tc = Camera.from_colmap(R, t, 80.0, 80.0, w, h, device=CPU)
    pj = j_project(jnp.asarray(means), j_covm.covariance_from_scaling_rotation(
        jnp.asarray(scales), jnp.asarray(quats)), jc.viewmat, jc.fx, jc.fy, jc.cx, jc.cy, w, h,
        valid_mask=jnp.asarray(valid))
    pt = t_project(T_(means), t_covm.covariance_from_scaling_rotation(T_(scales), T_(quats)),
                   tc.viewmat, tc.fx, tc.fy, tc.cx, tc.cy, w, h, valid_mask=T_(valid))
    return pj, pt, ops, valid


@pytest.mark.parametrize("crop,align,with_rect", [
    ((128, 96), 1, False), ((128, 96), 32, True), ((64, 40), 16, True), ((160, 120), 32, False)])
def test_crop_window_matches_jax(crop, align, with_rect):
    """Origins and the [escape count, need_w, need_h] stat are integers and
    must be EQUAL; the small windows make splats escape."""
    w, h = 160, 120
    pj, pt, ops, valid = _projection(30, 120, w, h)
    rect = np.array([20.0, 30.0, 90.0, 70.0], np.float32) if with_rect else None
    oj = j_crop.crop_window(pj, jnp.asarray(ops), jnp.asarray(valid),
                            None if rect is None else jnp.asarray(rect), *crop, w, h, align=align)
    ot = t_crop.crop_window(pt, T_(ops), T_(valid), None if rect is None else T_(rect), *crop,
                            w, h, align=align)
    for a, b in zip(ot, oj):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if crop == (64, 40):
        assert int(ot[2][0]) > 0  # escapes counted
    if crop == (160, 120):
        assert int(ot[2][0]) == 0 and int(ot[0]) == int(ot[1]) == 0


def test_crop_window_rejects_oversized_crop():
    _, pt, ops, valid = _projection(31, 10, 64, 48)
    with pytest.raises(ValueError):
        t_crop.crop_window(pt, T_(ops), T_(valid), None, 128, 48, 64, 48)


def test_crop_plane_matches_slice():
    x = torch.arange(2 * 30 * 40, dtype=torch.float32).reshape(2, 30, 40)
    out = t_crop.crop_plane(x, torch.tensor(8, dtype=torch.int32),
                            torch.tensor(5, dtype=torch.int32), 16, 10)
    np.testing.assert_array_equal(out.numpy(), x[:, 5:15, 8:24].numpy())
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(j_crop.crop_plane(jnp.asarray(x.numpy()), 8, 5, 16, 10)))
    # origins past the edge clamp like a dynamic slice
    np.testing.assert_array_equal(t_crop.crop_plane(x, 35, 28, 16, 10).numpy(),
                                  x[:, 20:30, 24:40].numpy())
