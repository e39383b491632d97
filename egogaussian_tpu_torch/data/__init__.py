from egogaussian_tpu_torch.data.readers import (
    FrameBatch,
    stack_cameras,
    split_viewpoints_by_phase,
    dilate_mask,
)
from egogaussian_tpu_torch.data.synthetic import make_synthetic_video
