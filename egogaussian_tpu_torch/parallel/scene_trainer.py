"""Multi-scene stage drivers: each training stage's loop for S videos in
lockstep, one batched step per iteration for all of them.

Port of `egogaussian_tpu/parallel/scene_trainer.py`. Each driver is THE
loop of its stage: the single-scene trainers (`train/static.py:
train_static` and `train_background`, `train/coarse_pose.py:
estimate_coarse_obj_pose`, `train/fine_obj.py:fine_tune_obj`,
`train/fine_all.py:fine_tune_all`) are its one-scene case, so no stage
loop exists twice.

Lockstep: the scenes share the schedule (Config) and the iteration
counter; each step is one call of a parallel/multi_scene.py step on the
scene-stacked state (one compositor launch for all scenes). Work done at
an interval (tile-capacity regrowth, densify, prune, opacity reset,
capacity growth, logging, checkpoints, saves) loops over the scenes on the
host on the unstacked views. Unlike JAX's drivers (ROADMAP §C), each scene
keeps what its single run has: its own RandomState stream (never
re-seeded at a phase), its own spatial_lr_scale and capacity, its own
binning capacities (the shared buffers take each field's max, the scene
drops only what its own capacities drop), its own regrowth from its own
re-estimate, its own crop window and its own stage-2 warm-up elision
(masks: an elided scene keeps its state bit for bit).

So each scene is its own run bit for bit: an op that mixes a scene's rows
into a per-scene quantity (the object's rigid move, the pose's 3x3 / 4x4
products, their gradients' sums over the Gaussians) runs per scene on
the scene's own rows through the one-scene call
(render/project.py:rigid_apply; a stacked model's `scene_rows` are the
scenes' own capacities); the
covariance's rotation, elementwise, runs once for all scenes and sums
each scene's rows of its gradient apart (ops/covariance.py); and scenes
whose crop windows differ take their losses over their own windows
(train/coarse_pose.py). Every other op is elementwise or per row, and
runs once on the [S, ...] tensors.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from egogaussian_tpu_torch.config import Config
from egogaussian_tpu_torch.data.readers import dilate_mask, stack_cameras
from egogaussian_tpu_torch.models.densify import densify_and_prune, prune_by_opacity, reset_opacity
from egogaussian_tpu_torch.models.gaussians import (
    combine_models,
    ensure_capacity,
    from_points,
    save_ply,
    split_by_is_object,
)
from egogaussian_tpu_torch.models.optim import adam_init
from egogaussian_tpu_torch.models.pose import (
    PoseSequence,
    empty_pose_sequence,
    identity_pose,
    save_pose_sequence,
)
from egogaussian_tpu_torch.parallel.multi_scene import (
    multi_scene_static_step,
    stack_scenes,
    unstack_scenes,
)
from egogaussian_tpu_torch.render.tiled import scene_caps
from egogaussian_tpu_torch.train.ckpt_hook import StageCheckpointer, grow_to_capacity, restore_loop
from egogaussian_tpu_torch.train.common import (
    auto_tile_config,
    crop_escape_count,
    maybe_grow_crop,
    maybe_regrow_tile_config,
    pick_backend,
    pose_crop_size,
    render_label_image,
)
from egogaussian_tpu_torch.utils.console import CONSOLE
from egogaussian_tpu_torch.utils.logging import log_metrics, use_logger


@dataclasses.dataclass
class SceneInput:
    """One video's static-stage inputs (the per-scene arguments of
    train_static / train_background)."""

    cameras: Sequence
    points: np.ndarray
    colors: np.ndarray
    static_phase_frames: List[List[int]]
    cameras_extent: float
    save_dir: Optional[str] = None
    seed: int = 0
    # stage 1.2 only: the training frames (all phases'), and the split noise
    # hook of train_background
    train_frame_idxs: Optional[List[int]] = None
    densify_noise: Optional[Callable[[int], torch.Tensor]] = None
    # the video's metrics logger (None: the active one)
    logger: Optional[object] = None


def _device(device, mesh):
    if device is None:
        device = mesh.device if mesh is not None else torch.device("cuda")
    # float32 throughout: cuDNN would run the SSIM convolutions in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device


def _one_backend(backends: Sequence[str]) -> str:
    if len(set(backends)) != 1:
        raise ValueError(f"scenes in lockstep resolve to different backends: {backends}")
    return backends[0]


def _log(logger, stage: str, step: int, **metrics) -> None:
    """log_metrics into a scene's own logger (the active one when None)."""
    with use_logger(logger):
        log_metrics(stage, step, **metrics)


def _restore(ln, *args):
    """The lane's checkpoint restore, its resume record in its own log."""
    with use_logger(ln["logger"]):
        return ln["ckpt"].try_restore(*args)


def ensure_capacity_scenes(models, opt_states, min_free: Optional[int] = None):
    """ensure_capacity per scene (host work at a densify interval): each
    scene grows exactly when and as its single run would. Returns (models,
    opt_states, grew) as lists."""
    out_m, out_o, grew = [], [], []
    for m, o in zip(models, opt_states):
        m, o, g = ensure_capacity(m, o, min_free)
        out_m.append(m)
        out_o.append(o)
        grew.append(g)
    return out_m, out_o, grew


def _select(live: torch.Tensor, new, old):
    """Per-scene choice between two stacked trees of one structure: scene s
    takes new where live[s], else old (bit for bit)."""
    if isinstance(new, torch.Tensor):
        m = live.reshape((-1,) + (1,) * (new.dim() - 1))
        return torch.where(m, new, old)
    if dataclasses.is_dataclass(new):
        kw = {}
        for f in dataclasses.fields(new):
            a, b = getattr(new, f.name), getattr(old, f.name)
            kw[f.name] = _select(live, a, b) if isinstance(a, torch.Tensor) or \
                dataclasses.is_dataclass(a) else a
        return type(new)(**kw)
    return new


class _Stack:
    """The stacked state of the scenes stepping together (`lanes`, indices
    into the driver's inputs) and its host-side unstacked views."""

    def __init__(self, models, opt_states):
        self.caps_n = [m.capacity for m in models]
        self.model = stack_scenes(models)
        self.opt = stack_scenes(opt_states)

    def views(self):
        n = len(self.caps_n)
        return unstack_scenes(self.model, n, self.caps_n), unstack_scenes(self.opt, n,
                                                                           self.caps_n)

    def restack(self, models, opt_states):
        self.__init__(models, opt_states)


def _static_loop(lanes, setup, total_iters: int, modes, cfg, mesh, on_step, stage: str,
                 densify_from: int, densify_until: int, after_iteration=None):
    """The loop shared by stages 1.0 and 1.2 over the lanes set up in
    `setup` (per lane: batch, model, opt_state, tile_cfg, gen, rng, ckpt,
    start_it, extent, grad_masks, frames(it) -> fidxs, bg(it), noise,
    drop_max, last_drop, log extra)."""
    opt_cfg = cfg.opt
    dev = setup[0]["model"].device
    st = _Stack([ln["model"] for ln in setup], [ln["opt"] for ln in setup])
    batches = stack_scenes([ln["batch"] for ln in setup])
    grad_masks = stack_scenes([ln["grad_masks"] for ln in setup])
    drop_max = torch.stack([ln["drop_max"].reshape(()) for ln in setup])
    backend = _one_backend([ln["backend"] for ln in setup])
    size = (setup[0]["batch"].width, setup[0]["batch"].height)

    def caps_of():
        return scene_caps([ln["tile_cfg"] for ln in setup], [size] * len(setup), dev,
                          max(st.caps_n))

    caps = caps_of()
    multi = len(setup) > 1
    start = min(ln["start_it"] for ln in setup)
    for it in range(start + 1, total_iters + 1):
        live = [ln["start_it"] < it for ln in setup]
        mode = modes(it)
        fidxs, bgs = [], []
        for ln, on in zip(setup, live):
            fidxs.append(ln["frames"](it) if on else [0] * ln["fb"])
            bgs.append(ln["bg"](it) if on else None)
        bg = None if all(b is None for b in bgs) else torch.as_tensor(
            np.stack([np.zeros(3, np.float32) if b is None else b for b in bgs]), device=dev)
        old = (st.model, st.opt, drop_max)
        st.model, st.opt, loss, _, drop_max = multi_scene_static_step(
            st.model, st.opt, batches, torch.as_tensor(fidxs, dtype=torch.int64), grad_masks,
            it, drop_max, mesh=mesh, mode=mode, lambda_dssim=opt_cfg.lambda_dssim,
            backend=backend, tile_config=caps, opt_cfg=opt_cfg, label_lr=cfg.static.label_lr)
        if not all(live):
            mask = torch.as_tensor(live, device=dev)
            st.model, st.opt, drop_max = (_select(mask, a, b) for a, b in
                                          zip((st.model, st.opt, drop_max), old))
        if on_step is not None:
            for j, ln in enumerate(setup):
                if live[j]:
                    on_step(ln["lane"], it, mode, loss[j])

        interval = it % opt_cfg.densification_interval == 0
        densify = it <= densify_until and it > densify_from and interval
        reset = it <= densify_until and it % opt_cfg.opacity_reset_interval == 0
        end_hook = after_iteration is not None and after_iteration(it, peek=True)
        saving = any(ln["ckpt"].every and it % ln["ckpt"].every == 0 for ln in setup)
        if not (interval or reset or end_hook or saving):
            continue
        models, opts = st.views()
        changed = False
        for j, ln in enumerate(setup):
            if not live[j]:
                continue
            m, o = models[j], opts[j]
            if interval:
                # drop-triggered capacity regrowth at the interval host sync
                ln["tile_cfg"], ln["last_drop"], grown = maybe_regrow_tile_config(
                    m, ln["batch"].camera(0), ln["tile_cfg"], drop_max[j], ln["last_drop"],
                    stage)
                if grown:  # new baseline: re-arm the running-max counter
                    drop_max = drop_max.clone()
                    drop_max[j] = 0
                    ln["last_drop"] = 0
                    changed = True
                scene = dict(scene=ln["lane"]) if multi else {}
                _log(ln["logger"], stage, it, **ln["log"], mode=mode, loss=loss[j],
                     alive=m.num_alive, capacity=m.capacity, dropped_pairs=drop_max[j], **scene)
            if densify:
                size_threshold = 20.0 if it > opt_cfg.opacity_reset_interval else None
                noise = None if ln["noise"] is None else ln["noise"](m.capacity)
                sub_seed = int(torch.randint(0, 2**31 - 1, (), generator=ln["gen"]))
                res = densify_and_prune(
                    m, o, sub_seed, max_grad=opt_cfg.densify_grad_threshold,
                    min_opacity=0.005, extent=ln["extent"], max_screen_size=size_threshold,
                    percent_dense=opt_cfg.percent_dense, noise=noise)
                m, o = res.model, res.opt_state
                overflow = int(res.overflow)
                if overflow:
                    CONSOLE.log(f"[{stage}] it {it}: densify overflow — {overflow} "
                                "candidates dropped (capacity grows next interval)")
                m, o, grew = ensure_capacity(m, o)
                if grew:
                    ln["tile_cfg"] = auto_tile_config(m, ln["batch"].camera(0),
                                                      tile_size=cfg.render.tile_size)
                changed = True
            if reset:
                m, o = reset_opacity(m, o)
                changed = True
            if end_hook:
                m, o = after_iteration(it, model=m, opt=o, lane=ln)
                changed = True
            # at the end of the iteration, so a checkpoint on the entropy-end
            # boundary holds the prune (the rewound stack is recomputed)
            ln["ckpt"].maybe_save(it, (m, o), ln["rng"], ln["gen"], extra=dict(
                tile_cfg=ln["tile_cfg"], drop_max=drop_max[j], last_drop=ln["last_drop"]))
            models[j], opts[j] = m, o
        if changed:
            st.restack(models, opts)
            caps = caps_of()
    models, _ = st.views()
    for j, ln in enumerate(setup):
        ln["model"], ln["drop_max"] = models[j], drop_max[j]


def train_static_scenes(
    scenes: Sequence[SceneInput],
    cfg: Config,
    backend: str = "auto",
    first_phase_only: bool = False,
    checkpoint_every: int = 0,
    mesh=None,
    device: Optional[torch.device] = None,
    on_step: Optional[Callable[[int, int, str, torch.Tensor], None]] = None,
):
    """Stage 1.0 for S videos in lockstep (train/static.py:train_static per
    scene). Each static phase stacks the scenes that have it (phases
    re-init from the points). Returns one list of StaticPhaseResult per
    scene. `on_step(scene, it, mode, loss)`: optional observer after every
    iteration of every scene. The per-scene files are those of each
    scene's single run under its save_dir."""
    from egogaussian_tpu_torch.train.static import (
        StaticPhaseResult,
        _dp_frame_batch,
        _label_stack,
        _log_dropped_pairs,
    )

    device = _device(device, mesh)
    sp = cfg.static
    opt_cfg = cfg.opt
    total_iters = sp.std_train_iter + sp.entropy_reg_iter + sp.label_train_iter
    rngs = [np.random.RandomState(sc.seed) for sc in scenes]
    results: List[List[StaticPhaseResult]] = [[] for _ in scenes]
    fb = _dp_frame_batch(sp.frame_batch, mesh)

    def modes(it):
        if it <= sp.std_train_iter:
            return "std"
        return "entropy" if it <= sp.std_train_iter + sp.entropy_reg_iter else "label"

    for phase in range(max(len(sc.static_phase_frames) for sc in scenes)):
        setup = []
        for i, sc in enumerate(scenes):
            if phase >= len(sc.static_phase_frames):
                continue
            n_phases = len(sc.static_phase_frames)
            phase_cams = [sc.cameras[k] for k in sc.static_phase_frames[phase]]
            batch = stack_cameras(phase_cams, device)
            model = from_points(sc.points, sc.colors, device, sh_degree=cfg.model.sh_degree,
                                spatial_lr_scale=sc.cameras_extent, seed=sc.seed)
            opt_state = adam_init(model.params)
            tile_cfg = auto_tile_config(model, batch.camera(0), tile_size=cfg.render.tile_size)
            ln = dict(lane=i, batch=batch, tile_cfg=tile_cfg, rng=rngs[i], fb=fb, logger=sc.logger,
                      gen=torch.Generator().manual_seed(sc.seed + phase),  # split seeds
                      drop_max=torch.zeros((), dtype=torch.int64, device=device),
                      last_drop=0, extent=sc.cameras_extent, noise=None,
                      grad_masks=batch.hand_masks, log=dict(phase=phase),
                      phase_cams=phase_cams, n_phases=n_phases)
            ln["ckpt"] = StageCheckpointer(
                os.path.join(sc.save_dir, f"ckpt_static_phase{phase}.npz")
                if sc.save_dir and checkpoint_every else None, checkpoint_every, mesh)
            start_it = 0
            if ln["ckpt"].exists():
                model, opt_state = grow_to_capacity(model, opt_state,
                                                    ln["ckpt"].peek_capacity())
                (model, opt_state), start_it = _restore(ln, 
                    (model, opt_state), rngs[i], ln["gen"], "static")
                loop = restore_loop(ln["ckpt"].extra, device)
                ln["tile_cfg"], ln["drop_max"], ln["last_drop"] = (
                    loop["tile_cfg"], loop["drop_max"], loop["last_drop"])
            ln.update(model=model, opt=opt_state, start_it=start_it,
                      backend=pick_backend(ln["tile_cfg"], backend))
            stack = list(range(len(phase_cams)))
            # >= : a checkpoint taken on the entropy-end boundary already
            # holds the prune, so the label-phase rewind applies too
            if start_it >= sp.std_train_iter + sp.entropy_reg_iter and start_it > 0:
                stack = _label_stack(stack, phase, n_phases, sp.rewind_frames,
                                     batch.obj_mask_valid)
            ln["stack"] = stack

            def frames(it, ln=ln, rng=rngs[i]):
                st = ln["stack"]
                if fb == 1:
                    return [st[rng.randint(len(st))]]
                return [st[k] for k in rng.randint(len(st), size=fb)]

            def bg(it, rng=rngs[i]):
                return rng.rand(3).astype(np.float32) if opt_cfg.random_background else None

            ln.update(frames=frames, bg=bg)
            setup.append(ln)
            CONSOLE.log(f"[static] phase {phase}: {len(phase_cams)} frames, "
                        f"{total_iters} iters, capacity {model.capacity}")

        end_it = sp.std_train_iter + sp.entropy_reg_iter

        def entropy_end(it, peek=False, model=None, opt=None, lane=None):
            # entropy-phase end: prune + rewind (train_static.py:146-162)
            if peek:
                return it == end_it
            model, opt, n_pruned = prune_by_opacity(model, opt, min_opacity=0.5)
            CONSOLE.log(f"[static] pruned {int(n_pruned)} low-opacity; "
                        f"alive {int(model.num_alive)}")
            lane["stack"] = _label_stack(lane["stack"], phase, lane["n_phases"],
                                         sp.rewind_frames, lane["batch"].obj_mask_valid)
            return model, opt

        _static_loop([ln["lane"] for ln in setup], setup, total_iters, modes, cfg, mesh,
                     on_step, "static", sp.densify_from_iter, sp.densify_until_iter,
                     after_iteration=entropy_end)

        for ln in setup:
            sc = scenes[ln["lane"]]
            _log_dropped_pairs("static", phase, ln["drop_max"])
            model = ln["model"].infer_is_object_from_label()
            obj_model, bg_model = split_by_is_object(model)
            pred_masks: Dict[str, np.ndarray] = {}
            with torch.no_grad():
                for j, cam_obj in enumerate(ln["phase_cams"]):
                    lbl = render_label_image(model, ln["batch"].camera(j), backend=ln["backend"],
                                             tile_config=ln["tile_cfg"])
                    pred_masks[cam_obj.image_name] = (lbl[0] > 0.5).to(
                        torch.float32).cpu().numpy()
            if sc.save_dir and (mesh is None or mesh.writes):
                ply_dir = os.path.join(sc.save_dir, "ply")
                save_ply(model, os.path.join(ply_dir, f"static_phase{phase}.ply"))
                save_ply(obj_model, os.path.join(ply_dir, f"static_phase{phase}_obj.ply"))
                save_ply(bg_model, os.path.join(ply_dir, f"static_phase{phase}_bg.ply"))
                mask_dir = os.path.join(sc.save_dir, "obj_masks")
                os.makedirs(mask_dir, exist_ok=True)
                try:
                    from PIL import Image
                except ImportError:
                    Image = None
                if Image is not None:
                    for name, msk in pred_masks.items():
                        Image.fromarray((msk * 255).astype(np.uint8)).save(
                            os.path.join(mask_dir, f"{name}.png"))
            if mesh is not None:
                mesh.barrier()
            results[ln["lane"]].append(StaticPhaseResult(
                model=model, obj_model=obj_model, bg_model=bg_model, pred_masks=pred_masks,
                dropped_pairs=int(ln["drop_max"])))
        if first_phase_only:
            break
    return results


def train_background_scenes(
    scenes: Sequence[SceneInput],
    cfg: Config,
    backend: str = "auto",
    dilate_size: int = 5,
    checkpoint_every: int = 0,
    mesh=None,
    device: Optional[torch.device] = None,
):
    """Stage 1.2 for S videos in lockstep (train/static.py:train_background
    per scene, each over its scene's `train_frame_idxs`). Returns the
    background model of every scene."""
    from egogaussian_tpu_torch.train.static import _dp_frame_batch, _log_dropped_pairs

    device = _device(device, mesh)
    bp = cfg.static_bg
    opt_cfg = cfg.opt
    total_iters = bp.std_train_iter + bp.entropy_reg_iter
    fb = _dp_frame_batch(bp.frame_batch, mesh)
    setup = []
    for i, sc in enumerate(scenes):
        rng = np.random.RandomState(sc.seed)
        train_cams = [sc.cameras[k] for k in sc.train_frame_idxs]
        batch = stack_cameras(train_cams, device)
        # the interaction mask needs both masks of every frame (JAX raises too)
        missing = [c.image_name for c in train_cams
                   if c.hand_mask is None or c.obj_mask is None]
        if missing:
            raise ValueError(f"train_background: {len(missing)} training frames have no hand "
                             f"or object mask: {missing[:5]}")
        # interaction masks, built once on the host; binary, so stored as uint8
        int_masks = np.stack([
            dilate_mask(np.maximum(c.hand_mask.detach().cpu().numpy(),
                                   c.obj_mask.detach().cpu().numpy()), iterations=dilate_size)
            for c in train_cams])
        int_masks = torch.as_tensor(int_masks.astype(np.uint8), device=device)
        model = from_points(sc.points, sc.colors, device, sh_degree=cfg.model.sh_degree,
                            spatial_lr_scale=sc.cameras_extent, seed=sc.seed)
        opt_state = adam_init(model.params)
        ln = dict(lane=i, batch=batch, rng=rng, fb=fb, grad_masks=int_masks, logger=sc.logger,
                  tile_cfg=auto_tile_config(model, batch.camera(0),
                                            tile_size=cfg.render.tile_size),
                  gen=torch.Generator().manual_seed(sc.seed),  # densify split seeds
                  drop_max=torch.zeros((), dtype=torch.int64, device=device), last_drop=0,
                  extent=sc.cameras_extent, noise=sc.densify_noise, log={})
        ln["ckpt"] = StageCheckpointer(
            os.path.join(sc.save_dir, "ckpt_bg.npz") if sc.save_dir and checkpoint_every
            else None, checkpoint_every, mesh)
        start_it = 0
        if ln["ckpt"].exists():
            model, opt_state = grow_to_capacity(model, opt_state, ln["ckpt"].peek_capacity())
            (model, opt_state), start_it = _restore(ln, (model, opt_state), rng,
                                                                  ln["gen"], "bg")
            loop = restore_loop(ln["ckpt"].extra, device)
            ln["tile_cfg"], ln["drop_max"], ln["last_drop"] = (
                loop["tile_cfg"], loop["drop_max"], loop["last_drop"])
        n_train = len(train_cams)

        def frames(it, rng=rng, n_train=n_train):
            if fb == 1:
                return [rng.randint(n_train)]
            return list(rng.randint(n_train, size=fb))

        ln.update(model=model, opt=opt_state, start_it=start_it, frames=frames,
                  bg=lambda it: None, backend=pick_backend(ln["tile_cfg"], backend))
        setup.append(ln)
        CONSOLE.log(f"[bg] {len(train_cams)} frames, {total_iters} iters")

    def final_prune(it, peek=False, model=None, opt=None, lane=None):
        if peek:
            return it == total_iters
        model, opt, n_pruned = prune_by_opacity(model, opt, min_opacity=0.5)
        CONSOLE.log(f"[bg] final prune: {int(n_pruned)} removed")
        return model, opt

    def modes(it):
        return "std" if it <= bp.std_train_iter else "entropy"

    # stage 1.2's densify noise is drawn per call by the lane's hook
    _static_loop([ln["lane"] for ln in setup], setup, total_iters, modes, cfg, mesh, None,
                 "bg", bp.densify_from_iter, bp.densify_until_iter, after_iteration=final_prune)
    out = []
    for ln in setup:
        sc = scenes[ln["lane"]]
        _log_dropped_pairs("bg", None, ln["drop_max"])
        _log(ln["logger"], "bg", total_iters, event="stage_end", steps=total_iters,
             dropped_pairs=ln["drop_max"])
        if sc.save_dir and (mesh is None or mesh.writes):
            save_ply(ln["model"], os.path.join(sc.save_dir, "static_bg.ply"))
        if mesh is not None:
            mesh.barrier()
        out.append(ln["model"])
    return out


@dataclasses.dataclass
class CoarseSceneInput:
    """One video's stage-2 inputs (the per-scene arguments of
    estimate_coarse_obj_pose)."""

    cameras: Sequence
    obj_model: object
    static_phase_frames: List[List[int]]
    dynamic_phase_frames: List[List[int]]
    cameras_extent: float
    save_dir: Optional[str] = None
    seed: int = 0
    densify_noise: Optional[Callable[[int, int], torch.Tensor]] = None
    # the video's metrics logger (None: the active one)
    logger: Optional[object] = None


def _coarse_frames(sc: CoarseSceneInput):
    """The scene's (phase, i, frame, frames of the phase) in solving order:
    each dynamic phase's frames, then the next static phase's first frame
    (coarse_obj_pose.py:137)."""
    out = []
    for phase, dyn in enumerate(sc.dynamic_phase_frames):
        frames = list(dyn) + [sc.static_phase_frames[phase + 1][0]]
        for i, f in enumerate(frames):
            out.append((phase, i, f, frames))
    return out


def train_coarse_scenes(
    scenes: Sequence[CoarseSceneInput],
    cfg: Config,
    backend: str = "auto",
    checkpoint_every: int = 0,
    skip_noop_warmup: bool = True,
    device: Optional[torch.device] = None,
    on_step: Optional[Callable[[int, int, int, torch.Tensor], None]] = None,
):
    """Stage 2 for S videos in lockstep (train/coarse_pose.py:
    estimate_coarse_obj_pose per scene). The scenes solve their frames
    slot by slot: slot k steps the k-th frame each scene has still to
    solve, every iteration one batched step for all of them. Each scene
    keeps its own frame choice, warm-up elision (an elided scene keeps its
    state that iteration; its Adam count is advanced at its next real
    step), crop window, capacities, densify window and files. Returns,
    per scene, (pose sequence, object model, {frame: image name}).
    `on_step(scene, frame, it, loss)` after every real step of a scene."""
    from egogaussian_tpu_torch.train.coarse_pose import (
        _accum_tables,
        _sampling_pool,
        coarse_scenes_step,
    )
    from egogaussian_tpu_torch.train.static import _log_dropped_pairs

    device = _device(device, None)
    cp = cfg.coarse
    lanes = []
    for i, sc in enumerate(scenes):
        batch = stack_cameras(list(sc.cameras), device)
        ln = dict(sc=sc, rng=np.random.RandomState(sc.seed), model=sc.obj_model, batch=batch,
                  logger=sc.logger)
        ln["tile_cfg"] = auto_tile_config(sc.obj_model, batch.camera(0),
                                          tile_size=cfg.render.tile_size)
        ln["backend"] = pick_backend(ln["tile_cfg"], backend)
        ln["crop_size"] = pose_crop_size(batch, cfg, "coarse")
        ln["crop0"] = ln["crop_size"]
        ln["pose_seq"] = empty_pose_sequence(batch.viewmats.shape[0], device=device)
        ln["solved"] = {}
        ln["drop_max"] = torch.zeros((), dtype=torch.int64, device=device)
        ln["last_drop"], ln["last_crop"], ln["steps"], ln["elided"] = 0, 0, 0, 0
        ln["crop_max"] = _zero_crop(ln["crop_size"], device)
        # any nonzero checkpoint_every saves after every solved frame; the
        # per-frame split generators are seeded afresh, so none is saved
        ln["ckpt"] = StageCheckpointer(
            os.path.join(sc.save_dir, "ckpt_coarse.npz")
            if sc.save_dir and checkpoint_every else None, 1 if checkpoint_every else 0)
        if ln["ckpt"].exists():
            model, _ = grow_to_capacity(ln["model"], adam_init(ln["model"].params),
                                        ln["ckpt"].peek_capacity())
            (ln["model"], ln["pose_seq"]), _ = _restore(ln, 
                (model, ln["pose_seq"]), ln["rng"], torch.Generator(), "coarse")
            loop = restore_loop(ln["ckpt"].extra, device)
            ln["solved"] = dict(loop["solved"])
            for k in ("tile_cfg", "drop_max", "last_drop", "crop_size", "crop_max",
                      "last_crop"):
                ln[k] = loop[k]
            ln["steps"], ln["elided"] = loop["steps"], loop["elided"]
            ln["backend"] = pick_backend(ln["tile_cfg"], backend)
            CONSOLE.log(f"[coarse] resume: {len(ln['solved'])} frames solved")
        ln["todo"] = [x for x in _coarse_frames(sc) if x[2] not in ln["solved"]]
        lanes.append(ln)
    multi = len(scenes) > 1
    batches = stack_scenes([ln["batch"] for ln in lanes])
    n_slots = max(len(ln["todo"]) for ln in lanes)
    for k in range(n_slots):
        act = [j for j, ln in enumerate(lanes) if k < len(lanes[j]["todo"])]
        group = [lanes[j] for j in act]
        for ln in group:
            sc = ln["sc"]
            phase, i, f_cur, frames = ln["todo"][k]
            if i == 0:
                CONSOLE.log(f"[coarse] phase {phase}: frames {frames[0]}..{frames[-1]} "
                            f"({len(frames)} incl. next-static anchor)")
            ln["cur"] = (phase, i, f_cur, frames)
            ln["tables"] = _accum_tables(ln["pose_seq"])
            ln["pool"], ln["weights"] = _sampling_pool(
                ln["batch"], sc.static_phase_frames[phase], sc.dynamic_phase_frames[phase],
                f_cur, ln["solved"])
            ln["pose"] = identity_pose(device)
            ln["pose_opt"] = adam_init(ln["pose"])
            ln["opt"] = adam_init(ln["model"].params)  # fresh Adam per frame
            ln["gen"] = torch.Generator().manual_seed(sc.seed * 1000 + f_cur)  # split seeds
            ln["pending"] = 0
            ln["loss"] = torch.full((), float("nan"), device=device)
        _coarse_slot(group, batches, torch.as_tensor(act, device=device), cfg, cp, multi,
                     skip_noop_warmup, on_step, [j for j in act])
        for ln in group:
            sc = ln["sc"]
            phase, i, f_cur, frames = ln["cur"]
            # write the solved delta back once per frame (a frame's trained
            # pose never feeds its own fixed prefix)
            ln["pose_seq"] = ln["pose_seq"].update_frame(f_cur, ln["pose"])
            ln["solved"][f_cur] = sc.cameras[f_cur].image_name
            # before the pose file: a kill in between redoes no frame
            ln["ckpt"].maybe_save(len(ln["solved"]), (ln["model"], ln["pose_seq"]), ln["rng"],
                                  torch.Generator(), extra=dict(
                                      solved=dict(ln["solved"]), tile_cfg=ln["tile_cfg"],
                                      drop_max=ln["drop_max"], last_drop=ln["last_drop"],
                                      crop_size=ln["crop_size"], crop_max=ln["crop_max"],
                                      last_crop=ln["last_crop"], steps=ln["steps"],
                                      elided=ln["elided"]))
            CONSOLE.log(f"[coarse] solved frame {sc.cameras[f_cur].image_name} "
                        f"({i + 1}/{len(frames)}), loss {float(ln['loss']):.4f}")
            if sc.save_dir:
                save_pose_sequence(os.path.join(sc.save_dir, "obj_pose_sequence.npz"),
                                   ln["pose_seq"], [c.image_name for c in sc.cameras])
                if (i + 1) % cp.save_ply_every == 0:
                    save_ply(ln["model"], os.path.join(sc.save_dir, "ply",
                                                       f"gaussians_frame{f_cur}.ply"))
    out = []
    for ln in lanes:
        sc = ln["sc"]
        _log_dropped_pairs("coarse", None, ln["drop_max"])
        escapes = crop_escape_count(ln["crop_max"]) if ln["crop_size"] is not None else 0
        if escapes:
            CONSOLE.log(f"[coarse] WARNING — up to {escapes} splats/render escaped the crop "
                        "window since the last growth (their out-of-window gradients were "
                        "lost; the window grows at the next densify-interval check)")
        if sc.save_dir:
            save_ply(ln["model"], os.path.join(sc.save_dir, "ply", "gaussians_final.ply"))
            save_pose_sequence(os.path.join(sc.save_dir, "obj_pose_sequence.npz"),
                               ln["pose_seq"], [c.image_name for c in sc.cameras])
        _log(ln["logger"], "coarse", ln["steps"] + ln["elided"], event="stage_end",
             steps=ln["steps"], elided=ln["elided"], crop_size_initial=ln["crop0"],
             crop_size=ln["crop_size"], crop_escapes=escapes, dropped_pairs=ln["drop_max"])
        out.append((ln["pose_seq"], ln["model"], ln["solved"]))
    return out


def _zero_crop(crop_size, device):
    return (torch.zeros((3,), dtype=torch.int32, device=device) if crop_size is not None
            else torch.zeros((), dtype=torch.int32, device=device))


def _coarse_slot(group, batches, scene_rows, cfg, cp, multi, skip_noop_warmup, on_step, ids):
    """One frame of each lane of `group`, cp.total_num_iter iterations in
    lockstep (estimate_coarse_obj_pose's inner loop)."""
    from egogaussian_tpu_torch.train.coarse_pose import coarse_scenes_step

    dev = group[0]["model"].device
    w, h = group[0]["batch"].width, group[0]["batch"].height

    def restack():
        st = _Stack([ln["model"] for ln in group], [ln["opt"] for ln in group])
        poses = stack_scenes([ln["pose"] for ln in group])
        popts = stack_scenes([ln["pose_opt"] for ln in group])
        return st, poses, popts

    def caps_of():
        sizes = [tuple(ln["crop_size"]) if ln["crop_size"] is not None else (w, h)
                 for ln in group]
        return scene_caps([ln["tile_cfg"] for ln in group], sizes, dev,
                          max(m.capacity for m in (ln["model"] for ln in group)))

    st, poses, popts = restack()
    caps = caps_of()
    t_T = stack_scenes([ln["tables"][0] for ln in group])
    t_R = stack_scenes([ln["tables"][1] for ln in group])
    drop = torch.stack([ln["drop_max"].reshape(()) for ln in group])
    crop = any(ln["crop_size"] is not None for ln in group)

    def crop_stats():
        return torch.stack([ln["crop_max"] if ln["crop_size"] is not None
                            else torch.zeros((3,), dtype=torch.int32, device=dev)
                            for ln in group]) if crop else None

    cmax = crop_stats()
    backend = _one_backend([ln["backend"] for ln in group])
    for it in range(1, cp.total_num_iter + 1):
        cams, fixed, tps, ffs, live, adv = [], [], [], [], [], []
        for ln in group:
            phase, i, f_cur, frames = ln["cur"]
            sc, rng = ln["sc"], ln["rng"]
            next_static = sc.static_phase_frames[phase + 1]
            # frame selection (coarse_obj_pose.py:196-222)
            if it == 1:
                cam_idx, train_p = sc.static_phase_frames[0][0], False
            elif rng.rand() <= cp.curr_vpt_prob:
                cam_idx = (next_static[rng.randint(len(next_static))]
                           if i == len(frames) - 1 else f_cur)
                train_p = True
            else:
                cam_idx = ln["pool"][rng.choice(len(ln["pool"]), p=ln["weights"])]
                train_p = False
            first = i == 0
            # warm-up previous-frame iterations of non-first frames are
            # exact no-ops but for the Adam count
            elide = skip_noop_warmup and not first and not train_p and it < cp.warm_up_iter
            if elide:
                ln["pending"] += 1
                ln["elided"] += 1
            cams.append(cam_idx)
            fixed.append((f_cur - 1) if train_p else cam_idx)
            tps.append(train_p and not elide)
            ffs.append(first)
            live.append(not elide)
            adv.append(0 if elide else ln["pending"])
        if not any(live):
            continue
        grad_params = any(f or it >= cp.warm_up_iter for f, on in zip(ffs, live) if on)
        (st.model, st.opt, poses, popts, loss, _, drop, cmax_new) = coarse_scenes_step(
            st.model, st.opt, poses, popts, batches, cams, t_T, t_R, fixed, it, drop, tps, ffs,
            grad_params, opt_cfg=cfg.opt, coarse_cfg=cp, backend=backend, tile_config=caps,
            crop=crop, crop_maxes=cmax, count_advance=adv, live=live, scenes=scene_rows)
        if crop:
            cmax = cmax_new
        for j, ln in enumerate(group):
            if live[j]:
                ln["pending"] = 0
                ln["steps"] += 1
                ln["loss"] = loss[j]
                if on_step is not None:
                    on_step(ids[j], ln["cur"][2], it, loss[j])
        interval = it % cp.densification_interval == 0
        window = cp.densify_from_iter < it < cp.densify_until_iter
        densify = window and interval
        reset = window and it % cp.opacity_reset_interval == 0
        if not (interval or reset):
            continue
        models, opts = st.views()
        for j, ln in enumerate(group):
            ln["drop_max"] = drop[j]
            if ln["crop_size"] is not None:
                ln["crop_max"] = cmax[j]
        changed = False
        for j, ln in enumerate(group):
            if not live[j]:
                continue
            m, o = models[j], opts[j]
            if interval:
                ln["tile_cfg"], ln["last_drop"], grown = maybe_regrow_tile_config(
                    m, ln["batch"].camera(0), ln["tile_cfg"], ln["drop_max"], ln["last_drop"],
                    "coarse")
                if grown:
                    ln["drop_max"], ln["last_drop"] = torch.zeros_like(ln["drop_max"]), 0
                    changed = True
                ln["crop_size"], ln["last_crop"], cchanged = maybe_grow_crop(
                    ln["crop_size"], ln["crop_max"], ln["last_crop"], ln["batch"], "coarse")
                if cchanged:
                    ln["crop_max"] = _zero_crop(ln["crop_size"], dev)
                    changed = True
                scene = dict(scene=ids[j]) if multi else {}
                _log(ln["logger"], "coarse", it, frame=ln["cur"][2], loss=loss[j],
                     alive=m.num_alive, capacity=m.capacity, dropped_pairs=ln["drop_max"],
                     crop_escapes=crop_escape_count(ln["crop_max"]), **scene)
            if densify:
                sc = ln["sc"]
                size_threshold = 20.0 if it > cp.opacity_reset_interval else None
                noise = None if sc.densify_noise is None else sc.densify_noise(
                    ln["cur"][2], m.capacity)
                sub_seed = int(torch.randint(0, 2**31 - 1, (), generator=ln["gen"]))
                res = densify_and_prune(
                    m, o, sub_seed, max_grad=cp.densify_grad_threshold,
                    min_opacity=cp.min_opacity, extent=sc.cameras_extent,
                    max_screen_size=size_threshold, percent_dense=cfg.opt.percent_dense,
                    which_object=1, noise=noise)
                m, o = res.model, res.opt_state
                overflow = int(res.overflow)
                if overflow:
                    CONSOLE.log(f"[coarse] it {it}: densify overflow — {overflow} "
                                "candidates dropped")
                m, o, grew = ensure_capacity(m, o)
                if grew:
                    ln["tile_cfg"] = auto_tile_config(m, ln["batch"].camera(0),
                                                      tile_size=cfg.render.tile_size)
                changed = True
            if reset:
                m, o = reset_opacity(m, o, which_object=1)
                changed = True
            models[j], opts[j] = m, o
        if changed:
            for j, ln in enumerate(group):
                ln["model"], ln["opt"] = models[j], opts[j]
                ln["pose"] = _scene_of(poses, j)
                ln["pose_opt"] = _scene_of(popts, j)
            st, poses, popts = restack()
            caps = caps_of()
            crop = any(ln["crop_size"] is not None for ln in group)
            cmax = crop_stats()
            drop = torch.stack([ln["drop_max"].reshape(()) for ln in group])
    models, opts = st.views()
    for j, ln in enumerate(group):
        ln["model"], ln["opt"] = models[j], opts[j]
        ln["pose"] = _scene_of(poses, j)
        ln["pose_opt"] = _scene_of(popts, j)
        ln["drop_max"] = drop[j]
        if ln["crop_size"] is not None and cmax is not None:
            ln["crop_max"] = cmax[j]


def _scene_of(tree, j: int):
    return unstack_scenes(tree, j + 1)[j]


@dataclasses.dataclass
class FineAllSceneInput:
    """One video's stage-5 inputs (the per-scene arguments of
    fine_tune_all)."""

    cameras: Sequence
    obj_model: object
    bg_model: object
    pose_seq: object
    static_phase_frames: List[List[int]]
    dynamic_phase_frames: List[List[int]]
    save_dir: Optional[str] = None
    seed: int = 0
    # the video's metrics logger (None: the active one)
    logger: Optional[object] = None


def train_fine_all_scenes(
    scenes: Sequence[FineAllSceneInput],
    cfg: Config,
    backend: str = "auto",
    checkpoint_every: int = 0,
    device: Optional[torch.device] = None,
):
    """Stage 5 for S videos in lockstep (train/fine_all.py:fine_tune_all per
    scene): each scene's combined model at its frozen poses, its own frame
    draws, one batched step per iteration; the opacity clamp on the shared
    schedule. Returns each scene's model; writes each gaussians_all.ply."""
    from egogaussian_tpu_torch.train.fine_all import fine_all_scenes_step
    from egogaussian_tpu_torch.train.static import _log_dropped_pairs

    device = _device(device, None)
    ap = cfg.fine_all
    lanes = []
    for i, sc in enumerate(scenes):
        model = combine_models(sc.obj_model, sc.bg_model)
        model = dataclasses.replace(model, spatial_lr_scale=sc.obj_model.spatial_lr_scale)
        batch = stack_cameras(list(sc.cameras), device)
        static_list = [f for ph in sc.static_phase_frames for f in ph]
        dynamic_list = [f for ph in sc.dynamic_phase_frames for f in ph]
        weights = np.array([1.0] * len(static_list) + [4.0] * len(dynamic_list))
        ln = dict(sc=sc, lane=i, batch=batch, frames=static_list + dynamic_list, logger=sc.logger,
                  weights=weights / weights.sum(), rng=np.random.RandomState(sc.seed),
                  opt=adam_init(model.params), model=model,
                  tile_cfg=auto_tile_config(model, batch.camera(0),
                                            tile_size=cfg.render.tile_size),
                  # the poses are frozen: accumulate once
                  accum=(sc.pose_seq.accum_T().to(device), sc.pose_seq.accum_R().to(device)),
                  drop_max=torch.zeros((), dtype=torch.int64, device=device), last_drop=0)
        ln["backend"] = pick_backend(ln["tile_cfg"], backend)
        CONSOLE.log(f"[fine_all] {int(model.num_alive)} gaussians, {len(ln['frames'])} frames, "
                    f"{ap.total_num_iter} iters")
        ln["ckpt"] = StageCheckpointer(
            os.path.join(sc.save_dir, "ckpt_fine_all.npz")
            if sc.save_dir and checkpoint_every else None, checkpoint_every)
        ln["start_it"] = 0
        if ln["ckpt"].exists():
            (ln["model"], ln["opt"]), ln["start_it"] = _restore(ln, 
                (ln["model"], ln["opt"]), ln["rng"], torch.Generator(), "fine_all")
            loop = restore_loop(ln["ckpt"].extra, device)
            ln["tile_cfg"], ln["drop_max"], ln["last_drop"] = (
                loop["tile_cfg"], loop["drop_max"], loop["last_drop"])
            ln["backend"] = pick_backend(ln["tile_cfg"], backend)
        lanes.append(ln)
    multi = len(lanes) > 1
    dev = device
    size = (lanes[0]["batch"].width, lanes[0]["batch"].height)
    st = _Stack([ln["model"] for ln in lanes], [ln["opt"] for ln in lanes])
    batches = stack_scenes([ln["batch"] for ln in lanes])
    acc_T = stack_scenes([ln["accum"][0] for ln in lanes])
    acc_R = stack_scenes([ln["accum"][1] for ln in lanes])
    drop = torch.stack([ln["drop_max"].reshape(()) for ln in lanes])
    backend = _one_backend([ln["backend"] for ln in lanes])

    def caps_of():
        return scene_caps([ln["tile_cfg"] for ln in lanes], [size] * len(lanes), dev,
                          max(st.caps_n))

    caps = caps_of()
    no_gen = torch.Generator()  # the stage draws no split noise
    for it in range(min(ln["start_it"] for ln in lanes) + 1, ap.total_num_iter + 1):
        live = [ln["start_it"] < it for ln in lanes]
        cams = []
        for ln, on in zip(lanes, live):
            if not on:
                cams.append(0)
            elif it == 1:
                cams.append(ln["sc"].static_phase_frames[0][0])
            else:
                cams.append(int(ln["frames"][ln["rng"].choice(len(ln["frames"]),
                                                               p=ln["weights"])]))
        clamp = (ap.densify_from_iter < it < ap.densify_until_iter
                 and bool(it % ap.opacity_reset_interval))
        old = (st.model, st.opt, drop)
        st.model, st.opt, loss, drop = fine_all_scenes_step(
            st.model, st.opt, batches, cams, acc_T, acc_R, it, clamp, drop,
            lambda_dssim=ap.lambda_dssim, backend=backend, tile_config=caps, opt_cfg=cfg.opt)
        if not all(live):
            mask = torch.as_tensor(live, device=dev)
            st.model, st.opt, drop = (_select(mask, a, b) for a, b in
                                      zip((st.model, st.opt, drop), old))
        interval = it % ap.opacity_reset_interval == 0
        saving = any(ln["ckpt"].every and it % ln["ckpt"].every == 0 for ln in lanes)
        if not (interval or saving):
            continue
        models, opts = st.views()
        changed = False
        for j, ln in enumerate(lanes):
            if not live[j]:
                continue
            if interval:
                ln["tile_cfg"], ln["last_drop"], grown = maybe_regrow_tile_config(
                    models[j], ln["batch"].camera(0), ln["tile_cfg"], drop[j], ln["last_drop"],
                    "fine_all")
                if grown:
                    drop = drop.clone()
                    drop[j] = 0
                    ln["last_drop"] = 0
                    changed = True
                scene = dict(scene=ln["lane"]) if multi else {}
                _log(ln["logger"], "fine_all", it, loss=loss[j], alive=models[j].num_alive,
                     capacity=models[j].capacity, dropped_pairs=drop[j], **scene)
            ln["ckpt"].maybe_save(it, (models[j], opts[j]), ln["rng"], no_gen, extra=dict(
                tile_cfg=ln["tile_cfg"], drop_max=drop[j], last_drop=ln["last_drop"]))
        if changed:
            caps = caps_of()
    models, _ = st.views()
    out = []
    for j, ln in enumerate(lanes):
        sc = ln["sc"]
        _log_dropped_pairs("fine_all", None, drop[j])
        _log(ln["logger"], "fine_all", ap.total_num_iter, event="stage_end",
             steps=ap.total_num_iter, dropped_pairs=drop[j])
        if sc.save_dir:
            save_ply(models[j], os.path.join(sc.save_dir, "gaussians_all.ply"))
        out.append(models[j])
    return out


@dataclasses.dataclass
class FineSceneInput:
    """One lane of stage 3: a video and one of its object PLY variants (the
    per-lane arguments of fine_tune_obj). The pipeline runs both variants
    of every video, so V videos fill 2V lanes."""

    cameras: Sequence
    obj_model: object
    pose_seq: object
    static_phase_frames: List[List[int]]
    dynamic_phase_frames: List[List[int]]
    cameras_extent: float
    save_dir: Optional[str] = None
    seed: int = 0
    densify_noise: Optional[Callable[[int], torch.Tensor]] = None
    # the video's metrics logger (None: the active one)
    logger: Optional[object] = None


def train_fine_scenes(
    scenes: Sequence[FineSceneInput],
    cfg: Config,
    backend: str = "auto",
    checkpoint_every: int = 0,
    device: Optional[torch.device] = None,
    on_step: Optional[Callable[[int, int, int, torch.Tensor], None]] = None,
):
    """Stage 3 for S lanes in lockstep (train/fine_obj.py:fine_tune_obj per
    lane): each lane's own frame draws (dynamic frames 5:1), pose sequence,
    shared-across-frames pose Adam state, crop window, densify window and
    files; one batched step per iteration. Returns (pose sequence, model)
    per lane. `on_step(lane, frame, it, loss)` after every step."""
    from egogaussian_tpu_torch.train.fine_obj import accum_tables, fine_scenes_step
    from egogaussian_tpu_torch.train.static import _log_dropped_pairs

    device = _device(device, None)
    fp = cfg.fine
    lanes = []
    for i, sc in enumerate(scenes):
        batch = stack_cameras(list(sc.cameras), device)
        seq = PoseSequence(translations=sc.pose_seq.translations.to(device),
                           rotations=sc.pose_seq.rotations.to(device),
                           solved=sc.pose_seq.solved.to(device))
        solved = seq.solved.cpu().numpy()
        static_list = [f for ph in sc.static_phase_frames for f in ph]
        dynamic_list = [f for ph in sc.dynamic_phase_frames for f in ph if solved[f]]
        weights = np.array([1.0] * len(static_list) + [5.0] * len(dynamic_list))
        CONSOLE.log(f"[fine_obj] {len(static_list)} static + {len(dynamic_list)} dynamic "
                    f"frames, {fp.total_num_iter} iters")
        model = sc.obj_model
        ln = dict(sc=sc, lane=i, batch=batch, seq=seq, frames=static_list + dynamic_list,
                  logger=sc.logger, n_frames=seq.num_frames,
                  dynamic=set(dynamic_list), weights=weights / weights.sum(),
                  rng=np.random.RandomState(sc.seed), model=model, opt=adam_init(model.params),
                  tile_cfg=auto_tile_config(model, batch.camera(0),
                                            tile_size=cfg.render.tile_size),
                  crop_size=pose_crop_size(batch, cfg, "fine_obj"),
                  pose_opt=adam_init(identity_pose(device)),  # shared by every frame
                  gen=torch.Generator().manual_seed(sc.seed),  # densify split seeds
                  drop_max=torch.zeros((), dtype=torch.int64, device=device), last_drop=0,
                  last_crop=0)
        ln["backend"] = pick_backend(ln["tile_cfg"], backend)
        ln["crop_max"] = _zero_crop(ln["crop_size"], device)
        ln["ckpt"] = StageCheckpointer(
            os.path.join(sc.save_dir, "ckpt_fine_obj.npz")
            if sc.save_dir and checkpoint_every else None, checkpoint_every)
        ln["start_it"] = 0
        if ln["ckpt"].exists():
            m, o = grow_to_capacity(ln["model"], ln["opt"], ln["ckpt"].peek_capacity())
            (ln["model"], ln["opt"], ln["pose_opt"], ln["seq"]), ln["start_it"] = \
                _restore(ln, (m, o, ln["pose_opt"], ln["seq"]), ln["rng"], ln["gen"],
                                       "fine_obj")
            loop = restore_loop(ln["ckpt"].extra, device)
            for k in ("tile_cfg", "drop_max", "last_drop", "crop_size", "crop_max",
                      "last_crop"):
                ln[k] = loop[k]
            ln["backend"] = pick_backend(ln["tile_cfg"], backend)
        lanes.append(ln)
    multi = len(lanes) > 1
    dev = device
    w, h = lanes[0]["batch"].width, lanes[0]["batch"].height
    batches = stack_scenes([ln["batch"] for ln in lanes])
    backend = _one_backend([ln["backend"] for ln in lanes])

    def restack():
        st = _Stack([ln["model"] for ln in lanes], [ln["opt"] for ln in lanes])
        seqs = stack_scenes([ln["seq"] for ln in lanes])
        popts = stack_scenes([ln["pose_opt"] for ln in lanes])
        sizes = [tuple(ln["crop_size"]) if ln["crop_size"] is not None else (w, h)
                 for ln in lanes]
        caps = scene_caps([ln["tile_cfg"] for ln in lanes], sizes, dev, max(st.caps_n))
        crop = any(ln["crop_size"] is not None for ln in lanes)
        cmax = torch.stack([ln["crop_max"] if ln["crop_size"] is not None
                            else torch.zeros((3,), dtype=torch.int32, device=dev)
                            for ln in lanes]) if crop else None
        drop = torch.stack([ln["drop_max"].reshape(()) for ln in lanes])
        return st, seqs, popts, caps, crop, cmax, drop

    def unstack(st, seqs, popts, cmax, drop):
        models, opts = st.views()
        for j, ln in enumerate(lanes):
            ln["model"], ln["opt"] = models[j], opts[j]
            ln["seq"] = unstack_scenes(seqs, j + 1, frames=[ln["n_frames"]] * (j + 1))[j]
            ln["pose_opt"] = _scene_of(popts, j)
            ln["drop_max"] = drop[j]
            if ln["crop_size"] is not None and cmax is not None:
                ln["crop_max"] = cmax[j]

    st, seqs, popts, caps, crop, cmax, drop = restack()
    accums = accum_tables(seqs)
    for it in range(min(ln["start_it"] for ln in lanes) + 1, fp.total_num_iter + 1):
        live = [ln["start_it"] < it for ln in lanes]
        cams, tps = [], []
        for ln, on in zip(lanes, live):
            if not on:
                cams.append(0)
                tps.append(False)
            elif it == 1:
                cams.append(ln["sc"].static_phase_frames[0][0])
                tps.append(False)
            else:
                c = int(ln["frames"][ln["rng"].choice(len(ln["frames"]), p=ln["weights"])])
                cams.append(c)
                tps.append(c in ln["dynamic"])
        old = (st.model, st.opt, seqs, popts, drop, cmax)
        st.model, st.opt, seqs, popts, loss, drop, cmax_new, wrote = fine_scenes_step(
            st.model, st.opt, seqs, popts, batches, cams, it, drop, tps, opt_cfg=cfg.opt,
            fine_cfg=fp, backend=backend, tile_config=caps, crop=crop, crop_maxes=cmax,
            accums=accums)
        if crop:
            cmax = cmax_new
        if not all(live):
            mask = torch.as_tensor(live, device=dev)
            st.model, st.opt, seqs, popts, drop = (
                _select(mask, a, b) for a, b in zip((st.model, st.opt, seqs, popts, drop),
                                                    old[:5]))
            if crop:
                cmax = _select(mask, cmax, old[5])
        if wrote:  # a written-back delta moves later frames
            accums = accum_tables(seqs)
        if on_step is not None:
            for j, ln in enumerate(lanes):
                if live[j]:
                    on_step(ln["lane"], cams[j], it, loss[j])
        interval = it % fp.densification_interval == 0
        window = fp.densify_from_iter < it < fp.densify_until_iter
        densify = window and interval
        reset = window and it % fp.opacity_reset_interval == 0
        saving = any(ln["ckpt"].every and it % ln["ckpt"].every == 0 for ln in lanes)
        if not (interval or reset or saving):
            continue
        unstack(st, seqs, popts, cmax, drop)
        for j, ln in enumerate(lanes):
            if not live[j]:
                continue
            sc, m, o = ln["sc"], ln["model"], ln["opt"]
            if interval:
                ln["tile_cfg"], ln["last_drop"], grown = maybe_regrow_tile_config(
                    m, ln["batch"].camera(0), ln["tile_cfg"], ln["drop_max"], ln["last_drop"],
                    "fine_obj")
                if grown:
                    ln["drop_max"], ln["last_drop"] = torch.zeros_like(ln["drop_max"]), 0
                ln["crop_size"], ln["last_crop"], cchanged = maybe_grow_crop(
                    ln["crop_size"], ln["crop_max"], ln["last_crop"], ln["batch"], "fine_obj")
                if cchanged:
                    ln["crop_max"] = _zero_crop(ln["crop_size"], dev)
                scene = dict(scene=ln["lane"]) if multi else {}
                _log(ln["logger"], "fine_obj", it, loss=loss[j], alive=m.num_alive,
                     capacity=m.capacity, dropped_pairs=ln["drop_max"],
                     crop_escapes=crop_escape_count(ln["crop_max"]), **scene)
            if densify:
                size_threshold = 20.0 if it > fp.opacity_reset_interval else None
                noise = None if sc.densify_noise is None else sc.densify_noise(m.capacity)
                sub_seed = int(torch.randint(0, 2**31 - 1, (), generator=ln["gen"]))
                res = densify_and_prune(
                    m, o, sub_seed, max_grad=fp.densify_grad_threshold,
                    min_opacity=fp.min_opacity, extent=sc.cameras_extent,
                    max_screen_size=size_threshold, percent_dense=cfg.opt.percent_dense,
                    which_object=1, noise=noise)
                m, o = res.model, res.opt_state
                overflow = int(res.overflow)
                if overflow:
                    CONSOLE.log(f"[fine_obj] it {it}: densify overflow — {overflow} "
                                "candidates dropped")
                m, o, grew = ensure_capacity(m, o)
                if grew:
                    ln["tile_cfg"] = auto_tile_config(m, ln["batch"].camera(0),
                                                      tile_size=cfg.render.tile_size)
            if reset:
                m, o = reset_opacity(m, o, which_object=1)
            ln["model"], ln["opt"] = m, o
            ln["ckpt"].maybe_save(it, (m, o, ln["pose_opt"], ln["seq"]), ln["rng"], ln["gen"],
                                  extra=dict(tile_cfg=ln["tile_cfg"], drop_max=ln["drop_max"],
                                             last_drop=ln["last_drop"],
                                             crop_size=ln["crop_size"],
                                             crop_max=ln["crop_max"],
                                             last_crop=ln["last_crop"]))
        st, seqs, popts, caps, crop, cmax, drop = restack()
    unstack(st, seqs, popts, cmax, drop)
    out = []
    for ln in lanes:
        sc = ln["sc"]
        _log_dropped_pairs("fine_obj", None, ln["drop_max"])
        _log(ln["logger"], "fine_obj", fp.total_num_iter, event="stage_end",
             steps=fp.total_num_iter, crop_size=ln["crop_size"], dropped_pairs=ln["drop_max"],
             crop_escapes=crop_escape_count(ln["crop_max"])
             if ln["crop_size"] is not None else 0)
        if sc.save_dir:
            save_pose_sequence(os.path.join(sc.save_dir, "obj_pose_sequence.npz"), ln["seq"],
                               [c.image_name for c in sc.cameras])
            save_ply(ln["model"], os.path.join(sc.save_dir, "gaussians_fine.ply"))
        out.append((ln["seq"], ln["model"]))
    return out
