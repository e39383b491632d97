from egogaussian_tpu_torch.data.colmap import (
    read_cameras_binary,
    read_cameras_text,
    read_images_binary,
    read_images_text,
    read_points3d_binary,
    read_points3d_text,
)
from egogaussian_tpu_torch.data.readers import (
    SceneData,
    FrameBatch,
    load_colmap_scene,
    stack_cameras,
    compute_nerfpp_norm,
    read_split_file,
    read_phase_index,
    split_viewpoints_by_phase,
    dilate_mask,
)
from egogaussian_tpu_torch.data.synthetic import make_synthetic_video
