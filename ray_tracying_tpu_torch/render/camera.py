"""Camera ray generation (pinhole + thin lens), fully batched.

Reproduces the reference math exactly (Code/camera.cpp:98-236):
  - NDC flips BOTH axes: n = 1 - 2*(pixel/res)  (camera.cpp:104-105,187-188)
  - basis: z = ||gaze||, x = ||up x z||, y = ||z x x||  (:110-116)
  - dir_cam = (nx*sensor_w/2, ny*sensor_h/2, focal_length), normalized in
    world space (:119-133)
  - thin lens: aperture<=0 degrades to pinhole (:138-140); else the origin
    jitters on a disk of radius aperture/2 in the camera x/y plane and the
    direction re-aims at origin + dir*focus_dist (:144-178)
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tracying_tpu_torch.core.sampling import uniform_in_unit_disk
from ray_tracying_tpu_torch.core.vecmath import cross, normalize
from ray_tracying_tpu_torch.scene.types import Camera


def camera_basis(cam: Camera):
    """Right-handed-ish basis exactly as the reference builds it."""
    z = normalize(cam.gaze)
    x = normalize(cross(cam.up, z))
    y = normalize(cross(z, x))
    return x, y, z


def pixel_rays(
    cam: Camera,
    px: torch.Tensor,
    py: torch.Tensor,
    lens: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Generate world-space rays for pixel sample positions.

    px, py: (...,) float pixel coordinates (fractional: x + sub_x), on the
    camera's device.  lens: (..., 2) unit-disk samples; drawn from
    `generator` when not given.  Returns (origins, directions), each
    (..., 3).  With aperture <= 0 the pinhole result is selected, matching
    the reference's explicit branch (camera.cpp:138-140); the select runs
    on the device, so no host read of the aperture is needed.
    """
    res_x, res_y = cam.resolution
    nx = 1.0 - (px / float(res_x)) * 2.0
    ny = 1.0 - (py / float(res_y)) * 2.0
    nx_r = nx * (cam.sensor_wh[0] / 2.0)
    ny_r = ny * (cam.sensor_wh[1] / 2.0)

    x_dir, y_dir, z_dir = camera_basis(cam)
    d_world = (
        nx_r[..., None] * x_dir + ny_r[..., None] * y_dir
        + cam.focal_length * z_dir
    )
    d_world = normalize(d_world)

    pinhole_o = cam.location.expand(d_world.shape)

    # Thin lens: jitter origin on the aperture disk, re-aim at focus point.
    focus_point = cam.location + d_world * cam.focus_dist
    if lens is None:
        lens = uniform_in_unit_disk(generator, px.shape, device=px.device)
    lens_radius = cam.aperture / 2.0
    offset = (lens[..., 0:1] * x_dir + lens[..., 1:2] * y_dir) * lens_radius
    lens_o = cam.location + offset
    lens_d = normalize(focus_point - lens_o)

    use_lens = cam.aperture > 0.0
    origins = torch.where(use_lens, lens_o, pinhole_o)
    directions = torch.where(use_lens, lens_d, d_world)
    return origins, directions
