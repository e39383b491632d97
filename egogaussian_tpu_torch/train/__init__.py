from egogaussian_tpu_torch.train.common import (
    TrainState,
    render_gaussians,
    mask_grad,
    image_loss,
    opacity_entropy,
)
from egogaussian_tpu_torch.train.static import train_static, train_background
from egogaussian_tpu_torch.train.coarse_pose import estimate_coarse_obj_pose, pose_step
from egogaussian_tpu_torch.train.fine_obj import fine_tune_obj
from egogaussian_tpu_torch.train.fine_all import fine_tune_all
