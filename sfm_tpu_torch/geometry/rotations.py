"""SO(3) parametrizations: angle-axis (exp/log), quaternions, matrices.

Port of sfm_tpu/geometry/rotations.py: branchless (torch.where instead of
data-dependent branches), batched over arbitrary leading dimensions, with
small-angle Taylor fallbacks so forward-mode derivatives stay finite at
theta == 0. Rotations are world->camera unless stated otherwise.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """[w]_x with hat(w) @ v == cross(w, v). (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w.unbind(-1)
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: angle-axis (..., 3) -> rotation matrix (..., 3, 3)."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2.clamp_min(_EPS**2))
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2.clamp_min(_EPS**2))
    K = so3_hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian Jr(w) of so3_exp, (..., 3) -> (..., 3, 3):
    so3_exp(w + d) ~= so3_exp(w) so3_exp(Jr(w) d), i.e. d so3_exp / d w_k =
    so3_exp(w) [Jr(w) e_k]x. Jr = I - (1-cos t)/t^2 [w]x + (t-sin t)/t^3 [w]x^2,
    with Taylor values for small angles."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2.clamp_min(_EPS**2))
    small = theta2 < _EPS
    t2 = theta2.clamp_min(_EPS**2)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (t2 * theta))
    K = so3_hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye - b[..., None, None] * K + c[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> angle-axis (..., 3), via quaternions
    (stable across the full angle range, including near pi)."""
    return quat_to_aa(matrix_to_quat(R))


def matrix_to_aa(R: torch.Tensor) -> torch.Tensor:
    return so3_log(R)


def quat_to_aa(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> angle-axis. Branchless."""
    w0 = q[..., :1]
    q = q * torch.sign(torch.where(w0 == 0, torch.ones_like(w0), w0))
    w = q[..., 0]
    v = q[..., 1:]
    vnorm = torch.linalg.vector_norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vnorm, w)
    small = vnorm < _EPS
    scale = torch.where(small, 2.0 / w.clamp_min(_EPS), theta / vnorm.clamp_min(_EPS))
    return v * scale[..., None]


def aa_to_quat(w: torch.Tensor) -> torch.Tensor:
    """Angle-axis -> unit quaternion (w, x, y, z). Branchless small-angle."""
    theta2 = (w * w).sum(-1)
    theta = torch.sqrt(theta2.clamp_min(_EPS**2))
    half = 0.5 * theta
    small = theta2 < _EPS
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    return torch.cat([torch.cos(half)[..., None], k[..., None] * w], dim=-1)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (w, x, y, z) quaternions."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), branchless Shepperd:
    the candidate with the largest pivot is taken."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw0 = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx0 = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy0 = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz0 = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)

    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                          1.0 - m00 - m11 + m22], dim=-1)
    choice = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw0, qx0, qy0, qz0], dim=-2)   # (..., 4 candidates, 4)
    q = torch.gather(cands, -2, choice[..., None, None].expand(*choice.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)
