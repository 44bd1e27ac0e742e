"""Random sampling from an explicit torch.Generator.

The reference threads one global mt19937 through every sampling site and
uses rejection loops (Code/raytracer.cpp:152-171, camera.cpp:90-96).  The
port draws from the same distributions analytically, from a
torch.Generator that lives on the device of the draws.  Torch's generator
reproduces neither mt19937 nor the threefry stream of the JAX package:
a documented, controlled deviation that only perturbs stochastic effects
within the statistical parity contract.  Every consumer of randomness also
accepts its draws as tensors, so a test can feed both packages the same
numbers.
"""

from __future__ import annotations

import math

import torch


def uniform_in_unit_sphere(
    generator: torch.Generator, shape: tuple, device=None
) -> torch.Tensor:
    """Uniform inside the unit ball (target of the rejection sampler,
    Code/raytracer.cpp:152-171).  Direction from a normalized gaussian;
    radius = U^(1/3).  Returns shape + (3,)."""
    device = generator.device if device is None else device
    shape = tuple(shape)
    g = torch.randn(
        shape + (3,), generator=generator, device=device, dtype=torch.float32
    )
    mag = torch.sqrt(torch.sum(g * g, dim=-1, keepdim=True))
    d = g / torch.clamp(mag, min=1e-12)
    u = torch.rand(
        shape + (1,), generator=generator, device=device, dtype=torch.float32
    )
    return d * torch.pow(u, 1.0 / 3.0)


def uniform_in_unit_disk(
    generator: torch.Generator, shape: tuple, device=None
) -> torch.Tensor:
    """Uniform on the unit disk (target of Code/camera.cpp:90-96).  Polar
    method: r = sqrt(U), theta = 2 pi V.  Returns shape + (2,)."""
    device = generator.device if device is None else device
    shape = tuple(shape)
    u = torch.rand(
        (2,) + shape + (1,), generator=generator, device=device,
        dtype=torch.float32,
    )
    r = torch.sqrt(u[0])
    theta = (2.0 * math.pi) * u[1]
    return torch.cat([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
