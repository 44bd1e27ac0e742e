"""Batched vector math over trailing-axis-3 tensors.

Float32 throughout.  Reference semantics mirrored: normalize returns zero
for zero vectors (Code/raytracer.cpp:75-79).
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product; keeps no trailing axis."""
    return torch.sum(a * b, dim=-1)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Safe normalize: zero vectors map to zero."""
    mag2 = dot(v, v)[..., None]
    mag = torch.sqrt(torch.where(mag2 > 0.0, mag2, torch.ones_like(mag2)))
    return torch.where(mag2 > 0.0, v / mag, torch.zeros_like(v))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )
