from egogaussian_tpu_torch.train.common import (
    render_gaussians,
    mask_grad,
    image_loss,
    opacity_entropy,
)
from egogaussian_tpu_torch.train.static import train_static
