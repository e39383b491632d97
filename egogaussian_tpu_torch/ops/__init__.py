from egogaussian_tpu_torch.ops.quaternion import (
    quat_normalize,
    quat_to_rotmat,
    rotmat_to_quat,
    quat_multiply,
)
from egogaussian_tpu_torch.ops.covariance import (
    build_scaling_rotation,
    strip_symmetric,
    covariance_from_scaling_rotation,
    unpack_symmetric,
)
from egogaussian_tpu_torch.ops.sh import eval_sh, rgb_to_sh, sh_to_rgb
from egogaussian_tpu_torch.ops.losses import (
    l1_loss,
    l2_loss,
    ssim,
    psnr,
    bce_with_logits,
)
from egogaussian_tpu_torch.ops.knn import mean_sq_dist_to_knn
