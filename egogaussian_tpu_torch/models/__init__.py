from egogaussian_tpu_torch.models.gaussians import (
    GaussianParams,
    GaussianAux,
    GaussianModel,
    from_points,
    from_jax_arrays,
    combine_models,
    compact,
    ensure_capacity,
    save_ply,
    load_ply,
    make_it_a_point,
)
from egogaussian_tpu_torch.models.optim import (
    AdamState,
    adam_init,
    adam_update,
    adam_state_from_jax_arrays,
)
from egogaussian_tpu_torch.models.pose import (
    ObjectPose,
    PoseSequence,
    identity_pose,
    empty_pose_sequence,
    pose_to_se3,
    apply_pose,
    save_pose_sequence,
    load_pose_sequence,
    se3_nth_root,
    interpolate_pose_sequence,
)
from egogaussian_tpu_torch.models.densify import (
    add_densification_stats,
    densify_and_prune,
    reset_opacity,
    prune_by_opacity,
)
