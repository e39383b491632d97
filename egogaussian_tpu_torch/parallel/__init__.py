"""The distributed layer: a (scene, data) grid of torch.distributed ranks,
and the scene lockstep: S videos stacked on a scene axis, one batched step
(one compositor launch) per iteration for all of them.

Port of `egogaussian_tpu/parallel/`.
"""
from egogaussian_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate, shard_batch
from egogaussian_tpu_torch.parallel.data_parallel import (
    data_parallel_train_step,
    make_dp_train_step,
)
from egogaussian_tpu_torch.parallel.shard_render import (
    make_memory_sharded_render,
    make_sharded_render,
)
from egogaussian_tpu_torch.parallel.launch import spawn
from egogaussian_tpu_torch.parallel.multi_scene import (
    make_multi_scene_step,
    multi_scene_coarse_step,
    multi_scene_fine_all_step,
    multi_scene_fine_step,
    multi_scene_static_step,
    multi_scene_train_step,
    stack_scenes,
    unstack_scenes,
)
from egogaussian_tpu_torch.parallel.scene_trainer import (
    CoarseSceneInput,
    FineAllSceneInput,
    FineSceneInput,
    SceneInput,
    ensure_capacity_scenes,
    train_background_scenes,
    train_coarse_scenes,
    train_fine_all_scenes,
    train_fine_scenes,
    train_static_scenes,
)
