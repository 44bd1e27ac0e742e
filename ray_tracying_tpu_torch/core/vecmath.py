"""Batched vector math over trailing-axis-3 tensors.

Float32 throughout.  Reference semantics mirrored: normalize returns zero
for zero vectors (Code/raytracer.cpp:75-79).
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product; keeps no trailing axis."""
    return torch.sum(a * b, dim=-1)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)) with a zero (not infinite) gradient at x <= 0."""
    pos = x > 0.0
    return torch.where(
        pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
        torch.zeros_like(x),
    )


def norm(v: torch.Tensor) -> torch.Tensor:
    return safe_sqrt(dot(v, v))


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


class _SafeArcsin(torch.autograd.Function):
    """arcsin with the exact forward value and a derivative clamped at
    |x| = 1, where the bare one is infinite (pole hits on spheres would
    put NaN into a texture-uv gradient)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.arcsin(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad / torch.sqrt(torch.clamp(1.0 - x * x, min=1e-12))


def safe_arcsin(x: torch.Tensor) -> torch.Tensor:
    return _SafeArcsin.apply(x)


def reflect(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """R = I - 2 (I.N) N.  Incident is assumed unit length, so R is unit.
    (semantics of Code/raytracer.cpp:101-115)"""
    return incident - 2.0 * dot(incident, normal)[..., None] * normal


def refract(incident: torch.Tensor, normal: torch.Tensor, n_out: torch.Tensor):
    """Snell refraction with the reference's conventions.

    The external medium is always n=1 (Code/raytracer.cpp:121); when the ray
    exits (cos_i > 0) indices swap and the normal flips
    (Code/raytracer.cpp:126-129).  Total internal reflection yields a zero
    direction (Code/raytracer.cpp:136-139).

    Returns (direction, flipped_normal) where direction is normalized or
    zero on TIR, and flipped_normal is the normal actually used (needed by
    the caller for the -1e-4 origin offset, Code/raytracer.cpp:147).
    """
    cos_i = dot(incident, normal)
    exiting = cos_i > 0.0
    one = torch.ones_like(n_out)
    n_in_eff = torch.where(exiting, n_out, one)
    n_out_eff = torch.where(exiting, one, n_out)
    n_eff = torch.where(exiting[..., None], -normal, normal)
    eta = n_in_eff / n_out_eff
    cos_abs = torch.abs(cos_i)
    disc = 1.0 - eta * eta * (1.0 - cos_abs * cos_abs)
    tir = disc < 0.0
    # safe_sqrt: the same values; a lane in total internal reflection
    # (disc < 0) gets a zero gradient, not sqrt'(0) = inf times its zero
    # cotangent (a NaN in the differentiable path)
    cos_t = safe_sqrt(disc)
    t_dir = incident * eta[..., None] + n_eff * (eta * cos_abs - cos_t)[..., None]
    t_dir = normalize(t_dir)
    t_dir = torch.where(tir[..., None], torch.zeros_like(t_dir), t_dir)
    return t_dir, n_eff
