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
    covariance_from_scaling_rotation_rotated,
    congruence_transform,
    unpack_symmetric,
)
from egogaussian_tpu_torch.ops.rotation6d import rot6d_to_rotmat, rotmat_to_rot6d
from egogaussian_tpu_torch.ops.se3 import (
    make_se3,
    se3_compose,
    se3_inverse,
    se3_apply,
    accumulate_transforms,
    accumulate_rotations,
)
from egogaussian_tpu_torch.ops.sh import eval_sh, rgb_to_sh, sh_to_rgb
from egogaussian_tpu_torch.ops.losses import (
    l1_loss,
    l2_loss,
    ssim,
    psnr,
    bce_with_logits,
    dice_loss,
    iou_loss,
)
from egogaussian_tpu_torch.ops.knn import mean_sq_dist_to_knn
