from egogaussian_tpu_torch.render.api import render, render_label, RenderResult
from egogaussian_tpu_torch.render.camera import Camera, look_at
from egogaussian_tpu_torch.render.project import project_gaussians, ProjectedGaussians
from egogaussian_tpu_torch.render.tiled import TileConfig
