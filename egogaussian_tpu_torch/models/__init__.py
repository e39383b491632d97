from egogaussian_tpu_torch.models.gaussians import (
    GaussianParams,
    GaussianAux,
    GaussianModel,
    from_points,
    from_jax_arrays,
    compact,
    ensure_capacity,
    save_ply,
    load_ply,
)
from egogaussian_tpu_torch.models.optim import (
    AdamState,
    adam_init,
    adam_update,
    adam_state_from_jax_arrays,
)
from egogaussian_tpu_torch.models.densify import (
    add_densification_stats,
    densify_and_prune,
    reset_opacity,
    prune_by_opacity,
)
