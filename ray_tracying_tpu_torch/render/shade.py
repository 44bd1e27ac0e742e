"""Local Blinn-Phong shading with stochastic soft shadows, batched over a
ray wavefront.

Reproduces `shade` (Code/raytracer.cpp:180-274) exactly:
  - ambient = diffuse * k_ambient (:194)
  - per light: `light_samples` shadow rays toward points jittered uniformly
    in a sphere of the light's radius; radius == 0 -> exactly 1 hard-shadow
    sample (:207)
  - shadow origin offset +1e-4 * N (:227); visible iff no hit or closest
    hit beyond the sampled light distance (:233-235)
  - Blinn-Phong terms evaluated from the light CENTER even for area lights;
    only visibility is stochastic (:244-259)
  - attenuation 10*I / (25 + 10*d + 150*d^2) (:262)

Texture sampling matches Material::getDiffuseColor (Code/material.hpp:99-134):
nearest-neighbor, v flipped, multiplied by the base diffuse tint.

Visibility goes through the shadow any-hit kernel (render/intersect.py::
occluded), one launch per light.  For inference a lane whose Blinn-Phong
term is exactly zero casts no shadow ray (its visibility cannot change the
image); differentiable rendering casts every active lane's ray and uses the
raw geometric visibility, so that such a term still gets its gradient (a
diffuse albedo of 0 on a lit surface has a non-zero derivative).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ray_tracying_tpu_torch.core import constants as C
from ray_tracying_tpu_torch.core.sampling import uniform_in_unit_sphere
from ray_tracying_tpu_torch.core.vecmath import dot, normalize, safe_sqrt
from ray_tracying_tpu_torch.render.intersect import Hit, occluded
from ray_tracying_tpu_torch.render.materials import MatRec, gather_materials
from ray_tracying_tpu_torch.scene.types import Scene


def safe_pow(base: torch.Tensor, exp: torch.Tensor) -> torch.Tensor:
    """pow with well-defined value AND gradient at base == 0.

    C++ pow(0, s) = 0 for s > 0; the gradient of a bare pow there is NaN.
    The base is clamped away from zero inside the power and the exact 0 is
    selected outside."""
    safe = torch.pow(torch.clamp(base, min=1e-12), exp)
    return torch.where(base > 0.0, safe, torch.zeros_like(safe))


def sample_diffuse_color(scene: Scene, mrec: MatRec, uv: torch.Tensor):
    """Per-ray textured diffuse color (Code/material.hpp:99-134)."""
    base = mrec.diffuse
    if not scene.has_textures:
        return base
    tid = mrec.tex_id
    tid_safe = torch.clamp(tid, min=0).to(torch.int64)
    wh = scene.tex_wh[tid_safe]  # (R, 2) = (w, h)
    w = wh[:, 0].to(torch.float32)
    h = wh[:, 1].to(torch.float32)
    # x = int(u * (w-1)), y = int((1-v) * (h-1)): C-style truncation; uv is
    # in [0,1] for every primitive so truncation == floor.
    x = torch.minimum(
        torch.clamp(torch.floor(uv[:, 0] * (w - 1.0)), min=0.0), w - 1.0
    ).to(torch.int64)
    y = torch.minimum(
        torch.clamp(torch.floor((1.0 - uv[:, 1]) * (h - 1.0)), min=0.0), h - 1.0
    ).to(torch.int64)
    texel = scene.tex_atlas[tid_safe, y, x]  # (R, 3)
    return torch.where((tid >= 0)[:, None], texel * base, base)


def shade(
    scene: Scene,
    hit: Hit,
    view_origin: torch.Tensor,
    generator: Optional[torch.Generator],
    light_samples: int,
    mrec: Optional[MatRec] = None,
    active=None,
    use_bvh: bool = False,
    *,
    jitter: Optional[Sequence[Optional[torch.Tensor]]] = None,
    differentiable: bool = False,
) -> torch.Tensor:
    """Local color for each hit ray.  view_origin: (R, 3) ray origins
    (the reference builds V from the ray ORIGIN, not -direction, :197).
    active: optional (R,) mask forwarded to the shadow kernel, whose dead
    lanes cost no test.  Returns (R, 3); garbage where hit.valid is False
    (callers mask).

    Randomness: each area light consumes one (R, light_samples, 3)
    unit-ball tensor.  `jitter` supplies them (a sequence indexed by light;
    entries of point lights are ignored); otherwise they are drawn from
    `generator`, on the rays' device.

    differentiable: every active lane casts its shadow rays (raw geometric
    visibility, module docstring); the image is the same."""
    if mrec is None:
        mrec = gather_materials(scene, hit.geom_id)
    base_diffuse = sample_diffuse_color(scene, mrec, hit.uv)

    final = base_diffuse * mrec.k_ambient[:, None]
    v_dir = normalize(view_origin - hit.point)
    n = hit.normal
    p = hit.point
    shadow_o = p + n * C.EPS_NORMAL_OFFSET

    r = p.shape[0]
    for li in range(scene.n_lights):
        l_pos = scene.lights.position[li]
        l_color = scene.lights.color[li]
        l_intensity = scene.lights.intensity[li]
        l_radius = scene.lights.radius[li]
        # Static per-light sample count: 1 hard-shadow sample for point
        # lights (Code/raytracer.cpp:207).
        is_area = scene.lights.is_area[li]
        s = light_samples if is_area else 1

        # Blinn-Phong from the light center (:244-259), computed BEFORE the
        # shadow pass so lanes whose contribution is exactly zero (e.g.
        # surface facing away with no specular lobe) can skip visibility —
        # their shadow result multiplies into zero either way.
        lv_c = l_pos - p
        dist_sq = dot(lv_c, lv_c)
        l_distance = safe_sqrt(dist_sq)
        l_c = normalize(lv_c)
        n_dot_l = torch.clamp(dot(n, l_c), min=0.0)
        diffuse = base_diffuse * n_dot_l[:, None]
        h_vec = normalize(l_c + v_dir)
        n_dot_h = torch.clamp(dot(n, h_vec), min=0.0)
        spec_i = safe_pow(n_dot_h, mrec.shininess)
        specular = mrec.specular * spec_i[:, None]
        atten = (
            C.ATTEN_NUM * l_intensity
            / (C.ATTEN_C0 + C.ATTEN_C1 * l_distance + C.ATTEN_C2 * dist_sq)
        )
        contribution = (
            l_color
            * (
                diffuse * mrec.k_diffuse[:, None]
                + specular * mrec.k_specular[:, None]
            )
            * atten[:, None]
        )
        needs_vis = torch.any(contribution != 0.0, dim=1)  # (R,)

        if is_area:
            if jitter is not None:
                ball = jitter[li]
            else:
                ball = uniform_in_unit_sphere(generator, (r, s), device=p.device)
            targets = l_pos + ball * l_radius  # (R, S, 3)
        else:
            targets = l_pos.expand(r, s, 3)

        lv = targets - p[:, None, :]                    # (R, S, 3)
        l_dist = safe_sqrt(dot(lv, lv))                 # (R, S)
        l_dir = normalize(lv)
        so = shadow_o[:, None, :].expand(r, s, 3).reshape(r * s, 3)
        sd = l_dir.reshape(r * s, 3)
        if differentiable:
            s_act = torch.ones_like(needs_vis) if active is None else active
        else:
            s_act = needs_vis if active is None else (active & needs_vis)
        s_act = s_act[:, None].expand(r, s).reshape(r * s)
        # Shadow rays carry time = 0 (Ray default member init,
        # Code/shapes.hpp:28) — motion blur does NOT apply to them.
        # Visibility via the any-hit kernel: visible iff NO blocker at
        # t <= light_dist == shadow_hit.t > light_dist.
        blocked = occluded(
            scene, so, sd, l_dist.reshape(r * s), s_act, use_bvh
        ).reshape(r, s)
        visibility = torch.mean(1.0 - blocked.to(torch.float32), dim=1)  # (R,)
        final = final + contribution * visibility[:, None]

    return final
