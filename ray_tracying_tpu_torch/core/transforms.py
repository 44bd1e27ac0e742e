"""Affine TRS transforms: built on the host with numpy at scene-load time,
applied to batches of tensors inside the renderer.

Matrices are stored as 3x4 (rotation+scale block | translation column);
the projective bottom row of the reference's 4x4s is always (0,0,0,1) for
TRS so it is dropped.

Semantics mirrored:
  - object_to_world = T @ Rz @ Ry @ Rx @ S  (Code/shapes.cpp:92-118)
  - world_to_object = S^-1 @ R^T @ T^-1 (analytic inverse, :120-138)
  - normals transform by world_to_object^T then renormalize (:167-187)

On the device every 3-wide contraction is written as explicit
multiply-adds on float32 tensors, never as a matmul: geometry must not
see TF32 (see the package docstring).
"""

from __future__ import annotations

import numpy as np
import torch


def euler_xyz_rotation(r: np.ndarray) -> np.ndarray:
    """Rotation matrix Rz(rz) @ Ry(ry) @ Rx(rx) (the reference's Euler X-Y-Z
    composition, Code/shapes.cpp:100-110).  r: (...,3) radians -> (...,3,3)."""
    r = np.asarray(r, dtype=np.float32)
    cx, sx = np.cos(r[..., 0]), np.sin(r[..., 0])
    cy, sy = np.cos(r[..., 1]), np.sin(r[..., 1])
    cz, sz = np.cos(r[..., 2]), np.sin(r[..., 2])
    rot = np.stack(
        [
            np.stack([cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz], -1),
            np.stack([cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz], -1),
            np.stack([-sy, sx * cy, cx * cy], -1),
        ],
        axis=-2,
    )
    return rot.astype(np.float32)


def build_trs(translation, rotation, scale):
    """Build (object_to_world, world_to_object), each (...,3,4) float32.

    world_to_object uses the analytic inverse S^-1 R^T T^-1, matching the
    reference rather than a generic matrix inverse.
    """
    t = np.asarray(translation, dtype=np.float32)
    s = np.asarray(scale, dtype=np.float32)
    rot = euler_xyz_rotation(np.asarray(rotation, dtype=np.float32))

    # o2w linear block: R @ diag(s)  (scale columns of R)
    lin = rot * s[..., None, :]
    o2w = np.concatenate([lin, t[..., :, None]], axis=-1)

    # w2o linear block: diag(1/s) @ R^T  (scale rows of R^T)
    lin_inv = np.swapaxes(rot, -1, -2) / s[..., :, None]
    # translation column: -(diag(1/s) @ R^T) @ t
    t_inv = -np.einsum("...ij,...j->...i", lin_inv, t)
    w2o = np.concatenate([lin_inv, t_inv[..., :, None]], axis=-1)
    return o2w.astype(np.float32), w2o.astype(np.float32)


# ---------------------------------------------------------------------------
# Batched application on tensors.  m: (..., 3, 4), p / v / n: (..., 3).
# Explicit multiply-adds, left to right, never matmul or einsum.
# ---------------------------------------------------------------------------

def apply_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return (
        m[..., :, 0] * p[..., 0:1]
        + m[..., :, 1] * p[..., 1:2]
        + m[..., :, 2] * p[..., 2:3]
        + m[..., :, 3]
    )


def apply_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (
        m[..., :, 0] * v[..., 0:1]
        + m[..., :, 1] * v[..., 1:2]
        + m[..., :, 2] * v[..., 2:3]
    )


def apply_normal(w2o: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """World normal = normalize(w2o^T @ n_local) (Code/shapes.cpp:178-187)."""
    res = (
        w2o[..., 0, :3] * n[..., 0:1]
        + w2o[..., 1, :3] * n[..., 1:2]
        + w2o[..., 2, :3] * n[..., 2:3]
    )
    mag2 = torch.sum(res * res, dim=-1, keepdim=True)
    # Double-where keeps the gradient finite at mag 0 (see vecmath.safe_sqrt).
    one = torch.ones_like(mag2)
    mag = torch.sqrt(torch.where(mag2 > 0.0, mag2, one))
    return torch.where(mag2 > 1e-12, res / torch.where(mag2 > 0.0, mag, one), res)
