"""The port's depth-slab sharded renders (`parallel/shard_render.py`) on 2
and 4 gloo ranks on the CPU: tests/test_shard_render.py's four cases, each
held against the port's single-process oracle and against JAX's sharded
render at the same number of slabs (its 8-device virtual CPU mesh cut to
D), within that file's bounds (image and alpha 5e-4, depth 5e-3):

  * the replicated render of 120 Gaussians at 64x48;
  * the memory-sharded render of 256 Gaussians, 17 of them dead, with a
    background, at capacity factor 3: nothing dropped;
  * the memory-sharded render at capacity factor 0.25: the overflow is
    counted (> 0 in both packages), the image finite;
  * the replicated render of 64 Gaussians with 24 dead rows at 48x32.

Every case of a D runs in one spawn (rank bodies in
tests/_torch_dist_workers.py); every rank's image must equal rank 0's.
"""
import datetime
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egogaussian_tpu.parallel import make_mesh as j_make_mesh
from egogaussian_tpu.parallel.shard_render import (
    make_memory_sharded_render as j_make_memory_sharded_render,
)
from egogaussian_tpu.parallel.shard_render import make_sharded_render as j_make_sharded_render
from egogaussian_tpu_torch.parallel.launch import spawn
from egogaussian_tpu_torch.render.api import render
from egogaussian_tpu_torch.render.camera import Camera, look_at
from tests import _torch_dist_workers as workers
from tests.test_render import make_camera, random_scene

torch.set_num_threads(1)
CPU = torch.device("cpu")
TOL = {"image": 5e-4, "alpha": 5e-4, "depth": 5e-3}
BG = np.array([0.15, 0.3, 0.45], np.float32)
# name: (width, height, PRNG key, Gaussians, alive rows, bg, capacity factor
# of the memory-sharded render or None for the replicated one)
CASES = {
    "sharded_matches_oracle": (64, 48, 21, 120, 120, None, None),
    "memory_sharded_matches_oracle": (64, 48, 23, 256, 256 - 17, BG, 3.0),
    "memory_sharded_capacity_overflow_counted": (48, 32, 24, 256, 256, None, 0.25),
    "sharded_with_dead_rows": (48, 32, 22, 64, 40, None, None),
}


def _port_camera(width, height):
    R, t = look_at(np.array([0.0, 0.0, -4.0]), np.zeros(3))
    return Camera.from_colmap(R, t, 60.0, 60.0, width, height, device=CPU)


def _case(name):
    w, h, key, n, alive, bg, factor = CASES[name]
    scene = [np.asarray(x) for x in random_scene(jax.random.PRNGKey(key), n)]
    return w, h, scene + [np.arange(n) < alive], bg, factor


@pytest.fixture(scope="module", params=[2, 4])
def renders(request):
    """Every case on D gloo ranks, JAX's sharded render at D slabs and the
    port's oracle."""
    n_slabs = request.param
    cases, jax_out, oracle = [], {}, {}
    jmesh = j_make_mesh(n_data=n_slabs, devices=jax.devices()[:n_slabs])
    for name in CASES:
        w, h, scene, bg, factor = _case(name)
        cases.append(dict(cam=_port_camera(w, h), scene=scene, bg=bg, replicated=factor is None,
                          capacity_factor=factor))
        jcam = make_camera(width=w, height=h)
        jscene = [jnp.asarray(x) for x in scene]
        jbg = None if bg is None else jnp.asarray(bg)
        if factor is None:
            jax_out[name] = (j_make_sharded_render(jmesh, jcam)(*jscene, bg=jbg), 0)
        else:
            jax_out[name] = j_make_memory_sharded_render(jmesh, jcam, capacity_factor=factor)(
                *jscene, bg=jbg)
        t = [torch.as_tensor(x) for x in scene]
        oracle[name] = render(_port_camera(w, h), t[0], t[1], t[3],
                              torch.zeros(3) if bg is None else torch.as_tensor(bg),
                              colors_precomp=t[2], valid_mask=t[4], backend="oracle")
    # a rank that stops answering fails this test at the limit
    ranks = spawn(workers.sharded_render_cases, 1, n_slabs, "gloo", CPU, args=(cases,),
                  timeout=datetime.timedelta(minutes=5))
    return n_slabs, {name: [r[i] for r in ranks] for i, name in enumerate(CASES)}, jax_out, oracle


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_render_matches_oracle_and_jax(renders, name):
    n_slabs, ranks, jax_out, oracle = renders
    out = ranks[name][0]
    for other in ranks[name][1:]:
        for k in ("image", "alpha", "depth", "dropped", "dropped_pairs"):
            np.testing.assert_array_equal(other[k], out[k], err_msg=k)
    assert out["dropped_pairs"] == 0
    jres, jdropped = jax_out[name]
    if name == "memory_sharded_capacity_overflow_counted":
        assert out["dropped"] > 0 and int(jdropped) > 0
        assert np.isfinite(out["image"]).all()
        return
    assert out["dropped"] == int(jdropped) == 0
    for k, tol in TOL.items():
        np.testing.assert_allclose(out[k], getattr(oracle[name], k).numpy(), atol=tol, rtol=0,
                                   err_msg=f"D={n_slabs} {name}: {k} vs the oracle")
        np.testing.assert_allclose(out[k], np.asarray(getattr(jres, k)), atol=tol, rtol=0,
                                   err_msg=f"D={n_slabs} {name}: {k} vs JAX")
