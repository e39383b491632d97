"""The distributed layer: a (scene, data) grid of torch.distributed ranks.

Port of `egogaussian_tpu/parallel/` without the scene lockstep
(`multi_scene_*`, `stack_scenes`, `unstack_scenes`, `SceneInput`,
`CoarseSceneInput`, `train_*_scenes`: ROADMAP.md §A item 11).
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
