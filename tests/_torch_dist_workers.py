"""Rank bodies for the port's multi-rank CPU tests (parallel/launch.py:spawn
runs each as fn(mesh, *args) in a fresh process). This module imports no
JAX, so the spawned ranks start fast and never load XLA."""
import os

import torch

from egogaussian_tpu_torch.parallel import make_dp_train_step, replicate, scene_trainer, shard_batch
from egogaussian_tpu_torch.parallel.mesh import gather_blocks
from egogaussian_tpu_torch.parallel.shard_render import (
    make_memory_sharded_render,
    make_sharded_render,
)
from egogaussian_tpu_torch.train import ckpt_hook, static
from egogaussian_tpu_torch.train.static import _dp_static_step


def _np_model(model):
    return {"params": {k: v.detach().numpy().copy() for k, v in model.params.as_dict().items()},
            "aux": {k: v.numpy().copy() for k, v in model.aux.as_dict().items()}}


def mesh_layout(mesh, blocks_of):
    """The rank's coordinates and axis ranks, what an all_gather along each
    axis returns (every rank contributes its global rank), the replica of
    the row's first rank's tensor and shard_batch's block of `blocks_of`."""
    seen = {a: gather_blocks(mesh, torch.tensor([mesh.rank]), a).flatten().tolist()
            for a in ("data", "scene")}
    mine = torch.full((3,), float(mesh.rank))
    tree = replicate(mesh, {"x": mine, "pair": (mine * 2, 7)})
    return dict(rank=mesh.rank, coords=mesh.coords, shape=mesh.shape, ranks=mesh.ranks,
                seen=seen, replica=tree["x"].tolist(), pair=tree["pair"][0].tolist(),
                untouched=tree["pair"][1], block=shard_batch(mesh, torch.as_tensor(blocks_of)).tolist())


def dp_static_steps(mesh, model, opt, batch, fidxs, tile_cfg, opt_cfg, modes):
    """_dp_static_step once per mode from the same state: per mode the
    loss, params, statistics, this rank's radii and the drop count."""
    out = {}
    for mode in modes:
        m, _, loss, radii, drop = _dp_static_step(
            model, opt, batch, fidxs, batch.hand_masks, 3,
            torch.zeros((), dtype=torch.int64), mesh=mesh, mode=mode, lambda_dssim=0.2,
            backend="tiled", tile_config=tile_cfg, opt_cfg=opt_cfg, label_lr=0.05)
        out[mode] = dict(loss=float(loss), model=_np_model(m), radii=radii.numpy(),
                         drop=int(drop))
    return out


def dp_train_step(mesh, model, opt, batch, frame_idxs, lr):
    step = make_dp_train_step(mesh)
    m, _, loss = step(replicate(mesh, model), replicate(mesh, opt), batch,
                      shard_batch(mesh, torch.as_tensor(frame_idxs)).tolist(), lr)
    return float(loss), m.params.xyz.detach().numpy()


class Stopped(RuntimeError):
    """Stands in for a killed run."""


def background_resume(mesh, cams, points, colors, cfg, out_a, out_b, stop_at):
    """train_background on the mesh twice: unbroken into out_a, then into
    out_b stopped by an exception right after the checkpoint of iteration
    `stop_at` and called again on out_b (resuming from it). Returns both
    models and, per run, how many files this rank wrote."""
    writes = {"ckpt": 0, "ply": 0}
    save_state, save_ply = ckpt_hook.save_train_state, scene_trainer.save_ply

    def count_state(*a, **k):
        writes["ckpt"] += 1
        return save_state(*a, **k)

    def count_ply(*a, **k):
        writes["ply"] += 1
        return save_ply(*a, **k)

    # the stage loop is the one-scene case of the lockstep driver, which saves
    ckpt_hook.save_train_state, scene_trainer.save_ply = count_state, count_ply
    maybe_save = ckpt_hook.StageCheckpointer.maybe_save
    idx = list(range(len(cams)))
    try:
        a = static.train_background(cams, points, colors, cfg, idx, 1.0, save_dir=out_a,
                                    backend="tiled", checkpoint_every=stop_at, mesh=mesh)
        first = dict(writes)

        def stop(self, it, *args, **kwargs):
            maybe_save(self, it, *args, **kwargs)
            if it == stop_at:
                raise Stopped

        ckpt_hook.StageCheckpointer.maybe_save = stop
        try:
            static.train_background(cams, points, colors, cfg, idx, 1.0, save_dir=out_b,
                                    backend="tiled", checkpoint_every=stop_at, mesh=mesh)
            raise AssertionError("the run was not stopped")
        except Stopped:
            pass
        ckpt_hook.StageCheckpointer.maybe_save = maybe_save
        b = static.train_background(cams, points, colors, cfg, idx, 1.0, save_dir=out_b,
                                    backend="tiled", checkpoint_every=stop_at, mesh=mesh)
    finally:
        ckpt_hook.save_train_state, scene_trainer.save_ply = save_state, save_ply
        ckpt_hook.StageCheckpointer.maybe_save = maybe_save
    return dict(unbroken=_np_model(a), resumed=_np_model(b), writes_unbroken=first,
                writes_all=dict(writes), files=sorted(os.listdir(out_b)))


def sharded_render_cases(mesh, cases):
    """Each case through make_sharded_render (every input) when
    case["replicated"], else make_memory_sharded_render (this rank's block
    of rows): the image, alpha and depth, and the Gaussians dropped."""
    out = []
    for c in cases:
        scene = [torch.as_tensor(x) for x in c["scene"]]
        bg = None if c["bg"] is None else torch.as_tensor(c["bg"])
        if c["replicated"]:
            res, dropped = make_sharded_render(mesh, c["cam"])(*scene, bg=bg), 0
        else:
            res, dropped = make_memory_sharded_render(
                mesh, c["cam"], capacity_factor=c["capacity_factor"])(
                *shard_batch(mesh, tuple(scene)), bg=bg)
        out.append(dict(image=res.image.numpy(), alpha=res.alpha.numpy(),
                        depth=res.depth.numpy(), dropped=int(dropped),
                        dropped_pairs=int(res.dropped_pairs)))
    return out


def stop_answering(mesh, where):
    """Rank 1 stops answering (sleeps far past any test's limit); rank 0
    returns at once (where="outside": no collective left to wait in) or
    waits for rank 1 at a barrier (where="barrier")."""
    import time

    if mesh.rank == 1:
        time.sleep(3600)
    elif where == "barrier":
        mesh.barrier()
    return mesh.rank
