"""The program's spans (`utils/logging.py:span`, `spanned`): what a CPU
profiler recording the program's ranges (and the autograd nodes) sees of
one training step, forward and backward; that with no profiler the step
is the same, bit for bit, with no marker in its graph; and that the stage
loop still calls its step and its densification through the module."""
import dataclasses
import glob
import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
from torch._C._profiler import (
    ProfilerActivity,
    ProfilerConfig,
    ProfilerState,
    RecordScope,
    _ExperimentalConfig,
)

from egogaussian_tpu_torch.config import Config
from egogaussian_tpu_torch.data import make_synthetic_video, split_viewpoints_by_phase, stack_cameras
from egogaussian_tpu_torch.models import adam_init, from_points
from egogaussian_tpu_torch.models.pose import identity_pose
from egogaussian_tpu_torch.parallel import multi_scene as ms
from egogaussian_tpu_torch.parallel import scene_trainer
from egogaussian_tpu_torch.render.api import render_scenes
from egogaussian_tpu_torch.render.tiled import scene_caps
from egogaussian_tpu_torch.train.common import auto_tile_config, image_loss, model_colors
from egogaussian_tpu_torch.train.static import train_static
from egogaussian_tpu_torch.utils import logging as L

CPU = torch.device("cpu")
W, H = 64, 48
RENDER = ("project", "bin", "layout", "composite", "loss")
# forward ranges per step, outermost of each name: the projection's span
# covers the covariance and the EWA projection, the loss's the hand-mask
# gating and L1 + SSIM, each a function of its own
FORWARD = dict(project=2, bin=1, layout=1, composite=1, loss=2, adam=1)
BACKWARD = dict(project=2, layout=1, composite=1, loss=2)


def _recorded(fn, tmp_path, nodes=True):
    """(fn(), spans, autograd nodes) under a CPU profiler recording the
    program's ranges and, with `nodes`, the autograd nodes' ranges: spans
    as (name, t0, t1, tid), nodes as (name, t0, tid)."""
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                         _ExperimentalConfig())
    acts = {ProfilerActivity.CPU}
    scopes = {RecordScope.USER_SCOPE} | ({RecordScope.BACKWARD_FUNCTION} if nodes else set())
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts, scopes)
    try:
        out = fn()
    finally:
        res = _disable_profiler()
    path = str(tmp_path / "trace.json")
    res.save(path)
    with open(path) as f:
        evs = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = [(e["name"][len(L.SPAN_PREFIX):], e["ts"], e["ts"] + e["dur"], e["tid"])
             for e in evs if e.get("cat") == "user_annotation"
             and e["name"].startswith(L.SPAN_PREFIX)]
    marks = [(e["name"], e["ts"], e["tid"]) for e in evs if e.get("cat") == "cpu_op"]
    return out, spans, marks


def _innermost(spans, t, tid):
    inside = [s for s in spans if s[3] == tid and s[1] <= t <= s[2]]
    return max(inside, key=lambda s: s[1])[0] if inside else None


def _outermost(spans):
    """Ranges not nested in a range of the same name."""
    return [s for s in spans if not any(o is not s and o[0] == s[0] and o[3] == s[3]
                                        and o[1] <= s[1] and s[2] <= o[2] for o in spans)]


def _split(spans, nodes):
    """(forward ranges, backward ranges) by name: a backward range holds an
    autograd node."""
    fwd, bwd = Counter(), Counter()
    for s in _outermost(spans):
        held = any(s[3] == tid and s[1] <= t <= s[2] for _, t, tid in nodes)
        (bwd if held else fwd)[s[0]] += 1
    return dict(fwd), dict(bwd)


@pytest.fixture(scope="module")
def scene():
    """One scene at 64x48, 80 Gaussians in a capacity of 128, stacked."""
    vid = make_synthetic_video(CPU, width=W, height=H, n_bg=60, n_obj=12, frames_static=2,
                               frames_dynamic=2, seed=0)
    rng = np.random.RandomState(0)
    m = from_points(rng.randn(80, 3).astype(np.float32), rng.rand(80, 3).astype(np.float32),
                    CPU, capacity=128)
    b = stack_cameras(vid.cameras[:4], CPU)
    tile = auto_tile_config(m, b.camera(0))
    return dict(m=ms.stack_scenes([m]), o=ms.stack_scenes([adam_init(m.params)]),
                b=ms.stack_scenes([b]), caps=scene_caps([tile], [(W, H)], CPU, 128))


def _static_step(p):
    return ms.multi_scene_static_step(
        p["m"], p["o"], p["b"], torch.tensor([[1]]), p["b"].hand_masks, 120,
        backend="cuda", tile_config=p["caps"], opt_cfg=Config().opt)


def _coarse_step(p):
    f = p["b"].viewmats.shape[1]
    pose = identity_pose(CPU)
    pose = dataclasses.replace(pose, translation=torch.tensor([0.05, -0.02, 0.01]))
    return ms.multi_scene_coarse_step(
        p["m"], p["o"], ms.stack_scenes([pose]), ms.stack_scenes([adam_init(pose)]), p["b"],
        [1], torch.eye(4).expand(1, f + 1, 4, 4), torch.eye(3).expand(1, f + 1, 3, 3), [0],
        100, torch.zeros(1, dtype=torch.int64), train_poses=[True], first_frames=[False],
        grad_params=True, opt_cfg=Config().opt, coarse_cfg=Config().coarse, backend="cuda",
        tile_config=p["caps"])


def test_static_step_records_each_layer_forward_and_backward(scene, tmp_path):
    """One static step: each layer's ranges in the forward and, for the
    layers with a gradient, in the backward; the pair gather's index
    backward runs in `layout`, the compositor's backward in `composite`,
    SSIM's convolution backward in `loss`, the covariance's in `project`."""
    _, spans, nodes = _recorded(lambda: _static_step(scene), tmp_path)
    fwd, bwd = _split(spans, nodes)
    assert fwd == FORWARD and bwd == BACKWARD
    where = {name: {_innermost(spans, t, tid) for n, t, tid in nodes if n == name}
             for name in ("IndexBackward0", "TileGridCompositorBackward",
                          "ConvolutionBackward0", "ExpBackward0", "PowBackward0")}
    assert where == {"IndexBackward0": {"layout"}, "TileGridCompositorBackward": {"composite"},
                     "ConvolutionBackward0": {"loss"}, "ExpBackward0": {"project"},
                     "PowBackward0": {"project"}}


def test_coarse_step_records_the_render_layers(scene, tmp_path):
    """The pose stage's step renders through the same spans."""
    _, spans, nodes = _recorded(lambda: _coarse_step(scene), tmp_path)
    fwd, bwd = _split(spans, nodes)
    assert all(fwd.get(k, 0) >= 1 for k in RENDER), fwd
    assert all(bwd.get(k, 0) >= 1 for k in RENDER if k != "bin"), bwd
    assert "bin" not in bwd
    where = {_innermost(spans, t, tid) for n, t, tid in nodes if n == "IndexBackward0"}
    assert where == {"layout"}


@pytest.mark.parametrize("step", [_static_step, _coarse_step], ids=["static", "coarse"])
def test_step_without_a_profiler_equals_the_traced_step(scene, tmp_path, step):
    """The same step traced and not: every output equal bit for bit."""
    plain = step(scene)
    traced, spans, _ = _recorded(lambda: step(scene), tmp_path, nodes=False)
    assert spans
    flat = [torch.utils._pytree.tree_leaves(
        [dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x for x in out])
        for out in (plain, traced)]
    assert len(flat[0]) == len(flat[1]) > 0
    for a, b in zip(*flat):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


def _graph(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return {type(fn).__name__ for fn in seen}


def test_no_marker_without_a_profiler(scene, tmp_path):
    """A render and its loss build no marker node unless a profiler records
    (then they do, so the check can fail)."""
    m, b, caps = scene["m"], scene["b"], scene["caps"]
    m = dataclasses.replace(m, params=dataclasses.replace(
        m.params, xyz=m.params.xyz.detach().requires_grad_(True)))

    def loss():
        cams, gt, _, _ = ms.scene_frames(b, torch.tensor([1]))
        res = render_scenes(cams, m.params.xyz, m.covariance(), m.opacity, torch.zeros((1, 3)),
                            model_colors(m), caps, valid_mask=m.aux.alive, backend="cuda")
        return image_loss(res.image, gt, 0.2)

    assert L.span("x") is L.span("y")  # the shared no-op
    assert "_MarkerBackward" not in _graph(loss())
    traced, _, _ = _recorded(loss, tmp_path, nodes=False)
    assert "_MarkerBackward" in _graph(traced)


def test_static_loop_spans_and_module_calls(monkeypatch, tmp_path):
    """train_static's loop (10 std, 1 entropy, 1 label iteration; densify
    at 5 and 10) calls multi_scene_static_step and densify_and_prune
    through parallel/scene_trainer.py's module names (a wrapper set there
    sees every call), and records one `step` range per iteration and an
    `interval` range at each densify interval, with the densification
    inside it."""
    calls = Counter()
    for name in ("multi_scene_static_step", "densify_and_prune"):
        orig = getattr(scene_trainer, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(scene_trainer, name, counted)
    vid = make_synthetic_video(CPU, width=W, height=H, n_bg=60, n_obj=12, frames_static=3,
                               frames_dynamic=1)
    cfg = Config()
    cfg.static = dataclasses.replace(cfg.static, std_train_iter=10, entropy_reg_iter=1,
                                     label_train_iter=1, densify_from_iter=2,
                                     densify_until_iter=10)
    cfg.opt = dataclasses.replace(cfg.opt, densification_interval=5,
                                  opacity_reset_interval=1000)
    groups = split_viewpoints_by_phase(vid.cameras, vid.static_phases)

    def run():
        return train_static(vid.cameras, vid.points, vid.colors, cfg, groups, 4.0,
                            first_phase_only=True, device=CPU, backend="cuda")

    _, spans, _ = _recorded(run, tmp_path, nodes=False)
    names = Counter(s[0] for s in spans)
    assert calls == {"multi_scene_static_step": 12, "densify_and_prune": 2}
    assert names["step"] == 12 and names["interval"] >= 2 and names["densify"] == 2
    intervals = [s for s in spans if s[0] == "interval"]
    assert all(any(i[1] <= d[1] and d[2] <= i[2] for i in intervals)
               for d in spans if d[0] == "densify")


def test_trace_shows_the_spans(tmp_path):
    """An operator's `trace(dir)` holds the spans, forward and backward."""
    @L.spanned("loss")
    def f(x):
        return (x * x).sum()

    x = torch.ones(3, requires_grad=True)
    with L.trace(str(tmp_path)):
        f(x).backward()
    (path,) = glob.glob(str(tmp_path / "*.json"))
    with open(path) as fh:
        names = [e.get("name") for e in json.load(fh)["traceEvents"]]
    assert names.count("egogs.loss") == 2
    assert torch.equal(x.grad, 2 * torch.ones(3))
