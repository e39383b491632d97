"""Port vs JAX: quaternion, covariance, SH, losses and kNN.

Inputs come from numpy with a fixed seed and go through both packages.
Tolerances: elementwise float32 math in the same operation order agrees to
a few ulp (rtol 1e-6 / atol 1e-6 on O(1) values); SSIM's blur is a
convolution whose summation order differs between XLA and PyTorch, so it
gets atol 1e-6 on values in [0, 1] and 1e-7 on its gradient (scale 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egogaussian_tpu.ops import covariance as j_cov
from egogaussian_tpu.ops import knn as j_knn
from egogaussian_tpu.ops import losses as j_losses
from egogaussian_tpu.ops import quaternion as j_quat
from egogaussian_tpu.ops import sh as j_sh
from egogaussian_tpu_torch.ops import covariance as t_cov
from egogaussian_tpu_torch.ops import knn as t_knn
from egogaussian_tpu_torch.ops import losses as t_losses
from egogaussian_tpu_torch.ops import quaternion as t_quat
from egogaussian_tpu_torch.ops import sh as t_sh

torch.set_num_threads(1)


def _both(x):
    return jnp.asarray(x), torch.as_tensor(x)


def _close(a, b, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=rtol, atol=atol)


@pytest.mark.parametrize("fn", ["quat_normalize", "quat_to_rotmat"])
def test_quaternion_unary(fn):
    q = np.random.RandomState(0).randn(64, 4).astype(np.float32)
    qj, qt = _both(q)
    _close(getattr(j_quat, fn)(qj), getattr(t_quat, fn)(qt))


def test_rotmat_to_quat_and_multiply():
    rng = np.random.RandomState(1)
    R = np.asarray(j_quat.quat_to_rotmat(jnp.asarray(rng.randn(64, 4).astype(np.float32))))
    Rj, Rt = _both(R)
    _close(j_quat.rotmat_to_quat(Rj), t_quat.rotmat_to_quat(Rt))
    a, b = rng.randn(2, 32, 4).astype(np.float32)
    _close(j_quat.quat_multiply(*_both(a)[:1], *_both(b)[:1]),
           t_quat.quat_multiply(torch.as_tensor(a), torch.as_tensor(b)))


def test_covariance_values_and_grads():
    rng = np.random.RandomState(2)
    s = np.exp(rng.randn(50, 3) * 0.3 - 1.5).astype(np.float32)
    q = rng.randn(50, 4).astype(np.float32)
    w = rng.randn(50, 6).astype(np.float32)
    cj = j_cov.covariance_from_scaling_rotation(jnp.asarray(s), jnp.asarray(q))
    st, qt = torch.tensor(s, requires_grad=True), torch.tensor(q, requires_grad=True)
    ct = t_cov.covariance_from_scaling_rotation(st, qt)
    _close(cj, ct.detach())
    gj = jax.grad(lambda a, b: jnp.sum(j_cov.covariance_from_scaling_rotation(a, b) * w),
                  argnums=(0, 1))(jnp.asarray(s), jnp.asarray(q))
    gt = torch.autograd.grad(torch.sum(ct * torch.as_tensor(w)), (st, qt))
    for a, b in zip(gj, gt):
        _close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh(deg):
    rng = np.random.RandomState(3 + deg)
    sh = rng.randn(40, 3, (deg + 1) ** 2).astype(np.float32)
    d = rng.randn(40, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    _close(j_sh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(d)),
           t_sh.eval_sh(deg, torch.as_tensor(sh), torch.as_tensor(d)), atol=2e-6)


def test_rgb_sh_roundtrip():
    rgb = np.random.RandomState(9).rand(20, 3).astype(np.float32)
    _close(j_sh.rgb_to_sh(jnp.asarray(rgb)), t_sh.rgb_to_sh(torch.as_tensor(rgb)))
    _close(j_sh.sh_to_rgb(jnp.asarray(rgb)), t_sh.sh_to_rgb(torch.as_tensor(rgb)))


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(4)
    a = rng.rand(3, 48, 64).astype(np.float32)
    b = np.clip(a + rng.randn(3, 48, 64).astype(np.float32) * 0.1, 0, 1)
    return a, b


@pytest.mark.parametrize("name", ["l1_loss", "l2_loss", "ssim", "psnr", "bce_with_logits"])
def test_losses(images, name):
    a, b = images
    if name == "bce_with_logits":
        a = (a - 0.5) * 8.0
        a[0, :4, :4] = 0.0  # exact-zero logits: uncovered label pixels
        b = (b > 0.5).astype(np.float32)
    vj = getattr(j_losses, name)(jnp.asarray(a), jnp.asarray(b))
    at = torch.tensor(a, requires_grad=True)
    vt = getattr(t_losses, name)(at, torch.as_tensor(b))
    _close(vj, vt.detach(), rtol=1e-5, atol=1e-6)
    if name != "psnr":
        gj = jax.grad(lambda x: getattr(j_losses, name)(x, jnp.asarray(b)))(jnp.asarray(a))
        (gt,) = torch.autograd.grad(vt, at)
        _close(gj, gt, rtol=1e-4, atol=1e-7)


def test_knn_matches_jax_and_exact():
    rng = np.random.RandomState(5)
    pts = (rng.randn(700, 3) * 1.5).astype(np.float32)
    dj = np.asarray(j_knn.mean_sq_dist_to_knn(jnp.asarray(pts), k=3, block_size=256))
    dt = t_knn.mean_sq_dist_to_knn(torch.as_tensor(pts), k=3, block_size=256).numpy()
    # same expansion |b|^2 - 2 b.p + |p|^2 in float32; JAX's approx_min_k
    # is an exact top-k on the CPU
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-6)
    # exact float64 k-NN: the expansion loses ~|p|^2 * 2^-23 absolutely
    p64 = pts.astype(np.float64)
    d2 = ((p64[:, None, :] - p64[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    exact = np.sort(d2, axis=1)[:, :3].mean(1)
    scale = (p64 ** 2).sum(1).max()
    np.testing.assert_allclose(dt, exact, rtol=1e-5, atol=8 * scale * 2.0**-23)
