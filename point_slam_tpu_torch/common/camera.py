"""Camera model, ray generation and quaternion/pose math (torch + numpy host).

Conventions as ``point_slam_tpu.common.camera``: camera space is x right,
y up, z backwards; pixel (i, j) maps to the camera-space direction
[(i-cx)/fx, -(j-cy)/fy, -1], rotated by c2w[:3,:3]. Quaternions are
(w, x, y, z); ``quat_to_rotation`` normalises via 2/|q|^2, so it is
scale-invariant and differentiable through unnormalised quaternions.
"""

from __future__ import annotations

import numpy as np
import torch


def ray_dirs_cam(i: torch.Tensor, j: torch.Tensor, fx, fy, cx, cy
                 ) -> torch.Tensor:
    """Camera-space ray directions for pixel columns i, rows j. (..., 3)."""
    return torch.stack([(i - cx) / fx, -(j - cy) / fy, -torch.ones_like(i)],
                       dim=-1)


def rays_from_uv(i, j, c2w, fx, fy, cx, cy):
    """World-space rays for flattened pixel coords; differentiable in c2w.

    Returns (rays_o (N,3), rays_d (N,3)); rays_d = R @ dir_cam, unnormalised.
    """
    dirs = ray_dirs_cam(i.float(), j.float(), fx, fy, cx, cy)
    rays_d = dirs @ c2w[:3, :3].T
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def rays_full_image(h: int, w: int, fx, fy, cx, cy, c2w):
    """Rays for every pixel of an image. Returns ((H,W,3), (H,W,3))."""
    jj, ii = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=c2w.device),
        torch.arange(w, dtype=torch.float32, device=c2w.device),
        indexing="ij")
    dirs = ray_dirs_cam(ii, jj, fx, fy, cx, cy)
    rays_d = dirs @ c2w[:3, :3].T
    return c2w[:3, 3].expand(rays_d.shape), rays_d


def quat_to_rotation(quad: torch.Tensor) -> torch.Tensor:
    """Batched (w,x,y,z) quaternion -> (N,3,3) rotation, scale-invariant."""
    quad = torch.atleast_2d(quad)
    qr, qi, qj, qk = quad[:, 0], quad[:, 1], quad[:, 2], quad[:, 3]
    two_s = 2.0 / torch.sum(quad * quad, dim=-1)
    r00 = 1 - two_s * (qj ** 2 + qk ** 2)
    r01 = two_s * (qi * qj - qk * qr)
    r02 = two_s * (qi * qk + qj * qr)
    r10 = two_s * (qi * qj + qk * qr)
    r11 = 1 - two_s * (qi ** 2 + qk ** 2)
    r12 = two_s * (qj * qk - qi * qr)
    r20 = two_s * (qi * qk - qj * qr)
    r21 = two_s * (qj * qk + qi * qr)
    r22 = 1 - two_s * (qi ** 2 + qj ** 2)
    return torch.stack([
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ], dim=-2)


def pose_matrix_from_tensor(inputs: torch.Tensor) -> torch.Tensor:
    """(w,x,y,z,tx,ty,tz) camera tensor -> 3x4 (or N,3,4) pose matrix."""
    single = inputs.dim() == 1
    inputs = torch.atleast_2d(inputs)
    rot = quat_to_rotation(inputs[:, :4])
    rt = torch.cat([rot, inputs[:, 4:, None]], dim=2)
    return rt[0] if single else rt


def pose_matrix_from_tensor_np(cam: np.ndarray) -> np.ndarray:
    """(w,x,y,z,tx,ty,tz) -> 4x4 f32 pose matrix, host-side (the f32
    arithmetic of ``pose_matrix_from_tensor``)."""
    rt = pose_matrix_from_tensor(torch.as_tensor(np.asarray(cam, np.float32)))
    out = np.eye(4, dtype=np.float32)
    out[:3, :4] = rt.numpy()
    return out


def rotation_to_quat_np(rot: np.ndarray) -> np.ndarray:
    """Single rotation matrix -> (x,y,z,w) quaternion, scipy-compatible
    branch choice (as ``point_slam_tpu.common.camera``)."""
    m = np.asarray(rot, dtype=np.float64)
    decision = np.array([m[0, 0], m[1, 1], m[2, 2],
                         m[0, 0] + m[1, 1] + m[2, 2]])
    choice = int(np.argmax(decision))
    q = np.empty(4)
    if choice != 3:
        i = choice
        j = (i + 1) % 3
        k = (j + 1) % 3
        q[i] = 1 - decision[3] + 2 * m[i, i]
        q[j] = m[j, i] + m[i, j]
        q[k] = m[k, i] + m[i, k]
        q[3] = m[k, j] - m[j, k]
    else:
        q[0] = m[2, 1] - m[1, 2]
        q[1] = m[0, 2] - m[2, 0]
        q[2] = m[1, 0] - m[0, 1]
        q[3] = 1 + decision[3]
    return q / np.linalg.norm(q)


def tensor_from_pose_matrix(rt: np.ndarray, t_first: bool = False
                            ) -> np.ndarray:
    """3x4/4x4 pose -> 7-vector (w,x,y,z,tx,ty,tz), or (tx,ty,tz,w,x,y,z)
    with ``t_first``; host-side."""
    rt = np.asarray(rt)
    quad = np.roll(rotation_to_quat_np(rt[:3, :3]), 1)  # xyzw -> wxyz
    if t_first:
        return np.concatenate([rt[:3, 3], quad], 0).astype(np.float32)
    return np.concatenate([quad, rt[:3, 3]], 0).astype(np.float32)


def project_points(points: torch.Tensor, w2c: torch.Tensor, fx, fy, cx, cy):
    """Project world points into a camera; returns (u, v, z_cam).

    The x-axis is flipped before applying K so that u runs left to right;
    z_cam is negative in front of the camera.
    """
    ones = torch.ones_like(points[:, :1])
    cam = (torch.cat([points, ones], dim=1) @ w2c.T)[:, :3]
    x = -cam[:, 0]
    y = cam[:, 1]
    z_raw = cam[:, 2]
    z = z_raw + 1e-5
    u = (fx * x + cx * z_raw) / z
    v = (fy * y + cy * z_raw) / z
    return u, v, z
