"""Port vs JAX: Gaussian model init, Adam with moment surgery, LR
schedules, densify/prune/reset, capacity growth, compaction and PLY IO.

Both packages start from identical state (numpy inputs, or the JAX model's
arrays through from_jax_arrays). Tolerances: integer and boolean state must
be EQUAL; float state is elementwise float32 math in the same order
(rtol 1e-6, atol 1e-6), except kNN-seeded log-scales (a blockwise matmul
in each package: atol 1e-5); PLY files must be byte-identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egogaussian_tpu.config import OptimizationParams
from egogaussian_tpu.models import densify as j_densify
from egogaussian_tpu.models import gaussians as j_g
from egogaussian_tpu.models import optim as j_optim
from egogaussian_tpu_torch.models import densify as t_densify
from egogaussian_tpu_torch.models import gaussians as t_g
from egogaussian_tpu_torch.models import optim as t_optim

torch.set_num_threads(1)
CPU = torch.device("cpu")
FIELDS = t_g.PARAM_FIELDS


def _np(tree, names):
    return {k: np.asarray(getattr(tree, k)) for k in names}


def assert_model_equal(jm, tm, atol=1e-6):
    for k in FIELDS:
        np.testing.assert_allclose(getattr(tm.params, k).detach().numpy(),
                                   np.asarray(getattr(jm.params, k)), rtol=1e-6, atol=atol,
                                   err_msg=k)
    for k in t_g.AUX_FIELDS:
        a, b = np.asarray(getattr(jm.aux, k)), getattr(tm.aux, k).numpy()
        if a.dtype.kind in "bi":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=k)


def assert_opt_equal(jo, to):
    for k in FIELDS:
        for m in ("mu", "nu"):
            np.testing.assert_allclose(getattr(getattr(to, m), k).numpy(),
                                       np.asarray(getattr(getattr(jo, m), k)),
                                       rtol=1e-6, atol=1e-12, err_msg=f"{m}.{k}")
    assert int(to.count) == int(jo.count)


def cloud(n=300, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3) * 2).astype(np.float32), rng.rand(n, 3).astype(np.float32)


@pytest.mark.parametrize("rand_label_init", [False, True])
def test_from_points_matches_jax(rand_label_init):
    pts, cols = cloud()
    jm = j_g.from_points(pts, cols, spatial_lr_scale=2.5, seed=3,
                         rand_label_init=rand_label_init)
    tm = t_g.from_points(pts, cols, CPU, spatial_lr_scale=2.5, seed=3,
                         rand_label_init=rand_label_init)
    assert tm.capacity == jm.capacity and tm.spatial_lr_scale == jm.spatial_lr_scale
    assert_model_equal(jm, tm, atol=1e-5)


@pytest.fixture(scope="module")
def jax_model():
    """A JAX model with non-trivial state: random params for the alive rows,
    accumulated densification statistics and mixed opacities."""
    pts, cols = cloud(400, seed=1)
    m = j_g.from_points(pts, cols, capacity=1024, spatial_lr_scale=2.0)
    rng = np.random.RandomState(2)
    n, C = 400, 1024
    p = m.params
    params = dataclasses.replace(
        p,
        log_scales=p.log_scales.at[:n].set(rng.uniform(-4, -1, (n, 3)).astype(np.float32)),
        quats=p.quats.at[:n].set(rng.randn(n, 4).astype(np.float32)),
        opacity_logit=p.opacity_logit.at[:n].set(rng.randn(n, 1).astype(np.float32) * 3),
        label=p.label.at[:n].set(rng.rand(n, 1).astype(np.float32)),
    )
    aux = dataclasses.replace(
        m.aux,
        xyz_gradient_accum=jnp.asarray(rng.rand(C).astype(np.float32) * 1e-2),
        denom=jnp.asarray(rng.randint(0, 5, C).astype(np.float32)),
        max_radii2d=jnp.asarray(rng.uniform(0, 40, C).astype(np.float32)),
        generation=jnp.asarray(rng.randint(0, 3, C).astype(np.int32)),
        is_object=jnp.asarray(rng.randint(0, 2, C).astype(np.int32)),
    )
    return dataclasses.replace(m, params=params, aux=aux)


def port_of(jm):
    return t_g.from_jax_arrays(_np(jm.params, FIELDS), _np(jm.aux, t_g.AUX_FIELDS), CPU,
                               sh_degree=jm.sh_degree, spatial_lr_scale=jm.spatial_lr_scale)


def test_from_jax_arrays_is_exact(jax_model):
    tm = port_of(jax_model)
    assert_model_equal(jax_model, tm, atol=0.0)
    assert tm.aux.alive.dtype == torch.bool and tm.aux.generation.dtype == torch.int32


def test_add_densification_stats_matches_jax(jax_model):
    rng = np.random.RandomState(4)
    C = jax_model.capacity
    grad = rng.randn(C, 2).astype(np.float32) * 1e-3
    radii = np.where(rng.rand(C) < 0.6, rng.randint(1, 50, C), 0).astype(np.int32)
    jm = j_densify.add_densification_stats(jax_model, jnp.asarray(grad), jnp.asarray(radii))
    tm = t_densify.add_densification_stats(port_of(jax_model), torch.as_tensor(grad),
                                           torch.as_tensor(radii))
    assert_model_equal(jm, tm)


@pytest.mark.parametrize("step", [0, 1, 500, 7000, 30000, 40000])
def test_expon_lr_matches_jax(step):
    kw = dict(lr_init=1.6e-4 * 3.0, lr_final=1.6e-6 * 3.0, lr_delay_mult=0.01, max_steps=30000)
    j = float(j_optim.expon_lr(step, **kw))
    t = t_optim.expon_lr(step, **kw)
    np.testing.assert_allclose(t, j, rtol=2e-7)


def _grads(seed, like):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*np.asarray(getattr(like, k)).shape) * 1e-3).astype(np.float32)
            for k in FIELDS}


def test_adam_with_moment_surgery_matches_jax(jax_model):
    opt = OptimizationParams()
    jp, tp = jax_model.params, port_of(jax_model).params
    jo, to = j_optim.adam_init(jp), t_optim.adam_init(tp)
    alive = np.asarray(jax_model.aux.alive)
    for step in range(1, 5):
        g = _grads(step, jp)
        zero_g = step == 3  # label mode: every LR zero but the label's
        jl = j_optim.gaussian_lr_tree(jp, step, opt, 2.0, zero_gaussians=zero_g)
        tl = t_optim.gaussian_lr_tree(step, opt, 2.0, zero_gaussians=zero_g)
        jp, jo = j_optim.adam_update(jp, j_g.GaussianParams(**g), jo, jl)
        tp, to = t_optim.adam_update(
            tp, t_g.GaussianParams(**{k: torch.as_tensor(v) for k, v in g.items()}), to, tl)
        if step == 2:  # surgery: zero moments of some rows, then one field
            mask = alive & (np.arange(alive.size) % 3 == 0)
            jo = j_optim.zero_moments_where(jo, jnp.asarray(mask))
            to = t_optim.zero_moments_where(to, torch.as_tensor(mask))
            jo = j_optim.zero_moments_field(jo, "opacity_logit")
            to = t_optim.zero_moments_field(to, "opacity_logit")
    for k in FIELDS:
        np.testing.assert_allclose(getattr(tp, k).numpy(), np.asarray(getattr(jp, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert_opt_equal(jo, to)


def _jax_split_noise(key, capacity):
    """The JAX package's per-slot draw (models/densify.py:129-133)."""
    row_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(capacity, dtype=jnp.uint32))
    samples = jax.vmap(lambda k: jax.random.normal(k, (2, 3)))(row_keys)
    return np.asarray(samples.transpose(1, 0, 2))


@pytest.mark.parametrize("max_screen_size", [None, 20.0])
def test_densify_and_prune_matches_jax(jax_model, max_screen_size):
    key = jax.random.PRNGKey(7)
    jo = j_optim.adam_init(jax_model.params)
    jo = dataclasses.replace(jo, mu=jax.tree_util.tree_map(lambda x: x + 0.5, jo.mu),
                             nu=jax.tree_util.tree_map(lambda x: x + 0.25, jo.nu))
    kw = dict(max_grad=2e-3, min_opacity=0.05, extent=4.0, max_screen_size=max_screen_size,
              percent_dense=0.01)
    jr = j_densify.densify_and_prune(jax_model, jo, key, **kw)
    to = t_optim.adam_state_from_jax_arrays(_np(jo.mu, FIELDS), _np(jo.nu, FIELDS), 0, CPU)
    tr = t_densify.densify_and_prune(
        port_of(jax_model), to, seed=0, noise=torch.as_tensor(_jax_split_noise(key, 1024)), **kw)
    for f in ("num_cloned", "num_split", "num_pruned", "overflow"):
        assert int(getattr(tr, f)) == int(getattr(jr, f)), f
    assert int(jr.num_cloned) > 0 and int(jr.num_split) > 0 and int(jr.num_pruned) > 0
    assert_model_equal(jr.model, tr.model)
    assert_opt_equal(jr.opt_state, tr.opt_state)


def test_densify_overflow_counted(jax_model):
    """Capacity for only a few children: the rest are dropped and counted,
    the same way in both packages."""
    small = j_g.compact(jax_model, capacity=420)
    key = jax.random.PRNGKey(8)
    kw = dict(max_grad=1e-4, min_opacity=0.0, extent=4.0, max_screen_size=None)
    jr = j_densify.densify_and_prune(small, j_optim.adam_init(small.params), key, **kw)
    tm = port_of(small)
    tr = t_densify.densify_and_prune(tm, t_optim.adam_init(tm.params), seed=0,
                                     noise=torch.as_tensor(_jax_split_noise(key, 420)), **kw)
    assert int(tr.overflow) == int(jr.overflow) > 0
    assert_model_equal(jr.model, tr.model)


def test_reset_and_prune_by_opacity_match_jax(jax_model):
    jo = j_optim.adam_init(jax_model.params)
    jo = dataclasses.replace(jo, mu=jax.tree_util.tree_map(lambda x: x + 1.0, jo.mu))
    tm = port_of(jax_model)
    to = t_optim.adam_state_from_jax_arrays(_np(jo.mu, FIELDS), _np(jo.nu, FIELDS), 0, CPU)
    jm, jo = j_densify.reset_opacity(jax_model, jo)
    tm, to = t_densify.reset_opacity(tm, to)
    assert_model_equal(jm, tm)
    jm, jo, jn = j_densify.prune_by_opacity(jm, jo, min_opacity=0.005)
    tm, to, tn = t_densify.prune_by_opacity(tm, to, min_opacity=0.005)
    assert int(tn) == int(jn)
    assert_model_equal(jm, tm)
    assert_opt_equal(jo, to)


def test_ensure_capacity_and_compact_match_jax(jax_model):
    small = j_g.compact(jax_model, capacity=448)
    tm = port_of(small)
    jm2, jo2, jgrew = j_g.ensure_capacity(small, j_optim.adam_init(small.params))
    tm2, to2, tgrew = t_g.ensure_capacity(tm, t_optim.adam_init(tm.params))
    assert jgrew and tgrew and tm2.capacity == jm2.capacity == 896
    assert_model_equal(jm2, tm2, atol=0.0)
    assert_opt_equal(jo2, to2)
    assert_model_equal(j_g.compact(jax_model), t_g.compact(port_of(jax_model)), atol=0.0)


def test_split_noise_depends_on_slot_not_capacity():
    a = t_densify.split_noise(11, 3000, CPU)
    b = t_densify.split_noise(11, 1000, CPU)
    assert torch.equal(a[:, :1000], b)
    assert not torch.equal(t_densify.split_noise(12, 1000, CPU), b)
    z = a.flatten().double()
    assert abs(float(z.mean())) < 0.05 and abs(float(z.std()) - 1.0) < 0.05


def test_save_ply_byte_identical_and_roundtrip(jax_model, tmp_path):
    tm = port_of(jax_model)
    j_path, t_path = tmp_path / "jax.ply", tmp_path / "port.ply"
    j_g.save_ply(jax_model, str(j_path))
    t_g.save_ply(tm, str(t_path))
    assert j_path.read_bytes() == t_path.read_bytes()
    back = t_g.load_ply(str(t_path), CPU)
    idx = torch.nonzero(tm.aux.alive).flatten()
    for k in FIELDS:
        assert torch.equal(getattr(back.params, k)[:idx.numel()], getattr(tm.params, k)[idx]), k
    assert torch.equal(back.aux.is_object[:idx.numel()], tm.aux.is_object[idx])
    assert torch.equal(back.aux.generation[:idx.numel()], tm.aux.generation[idx])
