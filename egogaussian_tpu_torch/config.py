"""Configuration system.

Dataclass redesign of reference `arguments/__init__.py` (reflection-based
argparse ParamGroups). All default values are kept EXACTLY — they encode the
paper's training schedule (SURVEY.md §5). Differences by design:
  * per-stage prefix stripping (`s_`/`b_`/`c_`/`f_`/`a_`) is replaced by
    plain nested dataclasses;
  * the eval()-based cfg_args merge (arguments/__init__.py:217-237, a
    security smell) is replaced by JSON save/load.

Argparse flags are auto-generated from dataclass fields like the reference's
ParamGroup, including shorthand flags for the fields the reference marks
with a leading underscore.

PyTorch port: a copy of `egogaussian_tpu/config.py` (it imports no JAX),
with `data_device` set back to the reference default "cuda" and the render
backend names of the port (auto | oracle | tiled | cuda).
"""
from __future__ import annotations

import dataclasses
import json
import os
from argparse import ArgumentParser
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelParams:
    """reference ModelParams (arguments/__init__.py:47-62)"""

    sh_degree: int = 0
    source_path: str = ""  # shorthand -s
    model_path: str = ""  # shorthand -m
    images: str = "images"  # shorthand -i
    resolution: int = -1  # shorthand -r
    white_background: bool = False  # shorthand -w
    data_device: str = "cuda"  # reference default
    eval: bool = False

    _shorthand = ("source_path", "model_path", "images", "resolution", "white_background")


@dataclasses.dataclass(frozen=True)
class PipelineParams:
    """reference PipelineParams (:64-69). compute_cov3D_python is vestigial
    here: our rasterizer always consumes python-side covariance (the pipeline
    hardwires it True anyway, train.py:49)."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = True
    debug: bool = False


@dataclasses.dataclass(frozen=True)
class OptimizationParams:
    """reference OptimizationParams (:71-115)"""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False
    # static training
    std_train_iter: int = 20_000
    entropy_reg_iter: int = 5000
    label_train_iter: int = 5000
    label_lr: float = 0.001
    # coarse object pose estimation
    obj_translation_lr: float = 0.0001
    obj_rotation_lr: float = 0.0001
    pose_opt_iterations: int = 9000
    # loss combination
    lambda_Ll1_image: float = 1.0
    lambda_Ll1_alpha: float = 0.0
    lambda_Ll2_alpha: float = 0.5
    lambda_Ldice_alpha: float = 0.0
    # fine object pose densification
    obj_densify_from_iter: int = 500
    obj_densify_until_iter: int = 15_000
    obj_densification_interval: int = 100
    obj_opacity_reset_interval: int = 3000
    fine_obj_opt_iterations: int = 10000
    cb_train_iter: int = 30000


@dataclasses.dataclass(frozen=True)
class StaticParams:
    """reference StaticParams (:117-132), prefix `s_` stripped"""

    std_train_iter: int = 50_000
    densify_from_iter: int = 500
    densify_until_iter: int = 40_000
    entropy_reg_iter: int = 10_000
    label_train_iter: int = 30_000
    label_lr: float = 0.001
    rewind_frames: int = 15
    # TPU extension (no reference twin): frames rendered per optimizer
    # update. >1 averages the photometric gradient over a minibatch of
    # frames in ONE jitted step (variance-reduced update, amortized
    # dispatch); densification statistics stay exact per frame.
    frame_batch: int = 1


@dataclasses.dataclass(frozen=True)
class StaticBgParams:
    """reference StaticBgParams (:134-146), prefix `b_` stripped"""

    std_train_iter: int = 80_000
    densify_from_iter: int = 500
    densify_until_iter: int = 60_000
    entropy_reg_iter: int = 10_000
    # TPU extension: frames per optimizer update (see StaticParams)
    frame_batch: int = 1


@dataclasses.dataclass(frozen=True)
class CoarseParams:
    """reference CoarseParams (:148-175), prefix `c_` stripped"""

    warm_up_iter: int = 20_000  # pose-only warm-up
    total_num_iter: int = 30_000
    densify_from_iter: int = 20_500
    densify_until_iter: int = 25_500
    opacity_reset_interval: int = 2500
    densification_interval: int = 500
    lambda_dssim: float = 0.1
    lambda_image: float = 1.0
    lambda_Ll1_alpha: float = 0.0
    lambda_Ll2_alpha: float = 0.5
    curr_vpt_prob: float = 0.4
    densify_grad_threshold: float = 0.001
    min_opacity: float = 0.0025
    save_ply_every: int = 6


@dataclasses.dataclass(frozen=True)
class FineParams:
    """reference FineParams (:177-197), prefix `f_` stripped"""

    total_num_iter: int = 70_000
    densify_from_iter: int = 500
    densify_until_iter: int = 45_000
    opacity_reset_interval: int = 3000
    densification_interval: int = 50
    lambda_dssim: float = 0.2
    lambda_Ll1_image: float = 1.0
    lambda_Ll1_alpha: float = 0.0
    lambda_Ll2_alpha: float = 0.2
    densify_grad_threshold: float = 0.1 / 100 / 3
    min_opacity: float = 0.003


@dataclasses.dataclass(frozen=True)
class FineAllParams:
    """reference FineAllParams (:199-215), prefix `a_` stripped"""

    total_num_iter: int = 40_000
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 5_000
    lambda_dssim: float = 0.2
    lambda_opa_entropy: float = 0.01
    densify_grad_threshold: float = 0.001


@dataclasses.dataclass(frozen=True)
class RenderParams:
    """Build additions: rasterizer backend + capacity knobs (no reference
    twin — the reference CUDA rasterizer had no exposed tuning)."""

    backend: str = "auto"  # auto | oracle | tiled | cuda
    tile_size: int = 32
    max_per_tile: int = 1024
    pairs_per_gaussian: int = 16
    # Crop-window rendering for the masked-object stages (coarse + fine_obj):
    # render only a window covering (object splats ∪ mask), with sum-
    # normalized losses — provably loss-identical while coverage holds, and
    # coverage is COUNTED on device every step (render/crop.py). Margin is
    # the per-side slack beyond the data-derived window size.
    pose_crop: bool = True
    pose_crop_margin: int = 64


@dataclasses.dataclass(frozen=True)
class LogParams:
    """TPU-build additions: experiment-metrics sinks. The reference logs to
    wandb unconditionally from every trainer (trainers/train_static.py:54,
    112); here the JSONL MetricsLogger is always on (under
    <model_path>/logs) and wandb is an optional mirror — enable with
    --use_wandb when the package + credentials are available."""

    use_wandb: bool = False
    wandb_project: str = "egogaussian_tpu"


@dataclasses.dataclass
class Config:
    model: ModelParams = dataclasses.field(default_factory=ModelParams)
    pipeline: PipelineParams = dataclasses.field(default_factory=PipelineParams)
    opt: OptimizationParams = dataclasses.field(default_factory=OptimizationParams)
    static: StaticParams = dataclasses.field(default_factory=StaticParams)
    static_bg: StaticBgParams = dataclasses.field(default_factory=StaticBgParams)
    coarse: CoarseParams = dataclasses.field(default_factory=CoarseParams)
    fine: FineParams = dataclasses.field(default_factory=FineParams)
    fine_all: FineAllParams = dataclasses.field(default_factory=FineAllParams)
    render: RenderParams = dataclasses.field(default_factory=RenderParams)
    log: LogParams = dataclasses.field(default_factory=LogParams)


_GROUP_PREFIX = {
    "static": "s_",
    "static_bg": "b_",
    "coarse": "c_",
    "fine": "f_",
    "fine_all": "a_",
}


def add_config_args(parser: ArgumentParser, config: Optional[Config] = None) -> Config:
    """Auto-generate flags from the dataclass fields (ParamGroup twin).
    Stage groups get their reference prefixes back on the CLI (e.g.
    --s_std_train_iter) for drop-in compatibility."""
    config = config or Config()
    for group_name, group in vars(config).items():
        prefix = _GROUP_PREFIX.get(group_name, "")
        short = getattr(type(group), "_shorthand", ())
        for f in dataclasses.fields(group):
            flag = f"--{prefix}{f.name}"
            default = getattr(group, f.name)
            names = [flag]
            if f.name in short:
                names.append(f"-{f.name[0]}")
            if f.type == "bool" or isinstance(default, bool):
                parser.add_argument(*names, default=default, action="store_true")
            else:
                parser.add_argument(*names, default=default, type=type(default))
    return config


def extract_config(args, config: Optional[Config] = None) -> Config:
    """Fill a Config from parsed argparse args."""
    config = config or Config()
    for group_name, group in vars(config).items():
        prefix = _GROUP_PREFIX.get(group_name, "")
        updates = {}
        for f in dataclasses.fields(group):
            key = f"{prefix}{f.name}"
            if hasattr(args, key):
                updates[f.name] = getattr(args, key)
        setattr(config, group_name, dataclasses.replace(group, **updates))
    config.model = dataclasses.replace(
        config.model, source_path=os.path.abspath(config.model.source_path)
    )
    return config


def save_config(config: Config, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(config), f, indent=2)


def load_config(path: str) -> Config:
    """JSON replacement for the eval()-based cfg_args merge."""
    with open(path) as f:
        raw = json.load(f)
    config = Config()
    for group_name, group in vars(config).items():
        if group_name in raw:
            known = {f.name for f in dataclasses.fields(group)}
            updates = {k: v for k, v in raw[group_name].items() if k in known}
            setattr(config, group_name, dataclasses.replace(group, **updates))
    return config
