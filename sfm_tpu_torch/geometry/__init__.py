"""Camera models, SO(3), projection and robust losses (port of sfm_tpu/geometry),
with sfm_tpu.geometry's public names re-exported."""

from sfm_tpu_torch.geometry.rotations import (  # noqa: F401
    aa_to_matrix,
    matrix_to_aa,
    quat_to_matrix,
    matrix_to_quat,
    quat_mul,
    so3_exp,
    so3_log,
    so3_hat,
)
from sfm_tpu_torch.geometry.cameras import (  # noqa: F401
    CAM_FX, CAM_FY, CAM_CX, CAM_CY, CAM_K1, CAM_K2, NUM_INTRINSICS,
    make_intrinsics,
    distort,
    undistort,
    camera_to_pixel,
    pixel_to_camera,
)
from sfm_tpu_torch.geometry.projection import (  # noqa: F401
    world_to_camera,
    camera_to_world,
    project,
    reprojection_residual,
    compose_poses,
    invert_pose,
)
from sfm_tpu_torch.geometry.losses import huber, cauchy, robust_weight  # noqa: F401
