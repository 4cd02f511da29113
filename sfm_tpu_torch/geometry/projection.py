"""World->pixel projection and reprojection residuals.

Port of sfm_tpu/geometry/projection.py. Pose convention (COLMAP): a camera
pose (rvec, t) maps x_cam = R(rvec) @ x_world + t; the centre is -R^T t.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.geometry.cameras import camera_to_pixel
from sfm_tpu_torch.geometry.rotations import so3_exp, so3_log


def world_to_camera(x_world: torch.Tensor, rvec: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    R = so3_exp(rvec)
    return torch.einsum("...ij,...j->...i", R, x_world) + t


def camera_center(rvec: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    R = so3_exp(rvec)
    return -torch.einsum("...ji,...j->...i", R, t)


def project(x_world, rvec, t, intr) -> torch.Tensor:
    """World point -> pixel."""
    return camera_to_pixel(world_to_camera(x_world, rvec, t), intr)


def point_depth(x_world, rvec, t) -> torch.Tensor:
    """Camera-frame z of a world point; positive => in front of the camera."""
    return world_to_camera(x_world, rvec, t)[..., 2]


def compose_poses(rvec_a, t_a, rvec_b, t_b):
    """x -> A(B(x)): R = Ra Rb, t = Ra tb + ta."""
    Ra = so3_exp(rvec_a)
    Rb = so3_exp(rvec_b)
    t = torch.einsum("...ij,...j->...i", Ra, t_b) + t_a
    return so3_log(Ra @ Rb), t


def invert_pose(rvec, t):
    """R' = R^T, t' = -R^T t."""
    Rt = so3_exp(rvec).transpose(-1, -2)
    return so3_log(Rt), -torch.einsum("...ij,...j->...i", Rt, t)


def relative_pose(rvec_i, t_i, rvec_j, t_j):
    """Pose of camera j relative to camera i: x_j = R_rel x_i + t_rel."""
    rv_i_inv, t_i_inv = invert_pose(rvec_i, t_i)
    return compose_poses(rvec_j, t_j, rv_i_inv, t_i_inv)
