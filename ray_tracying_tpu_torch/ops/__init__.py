"""Stable op-level API: the batched primitives the renderer is built from.

Each op takes tensors on one device: on the card the closest-hit, any-hit,
BVH-traversal, chunk-sweep and fused-level searches run the hand-written
CUDA kernels, on the CPU their plain PyTorch versions.  Hit DECISIONS are
piecewise-constant and carry no gradient; hit ATTRIBUTES (pass 2 of
`closest_hit`) and shading are plain differentiable tensor code.  This is
the surface to target when composing a custom integrator instead of
render/pipeline's Whitted one.

The names are the JAX package's.
"""

from ray_tracying_tpu_torch.accel.lbvh import build_lbvh, with_bvh
from ray_tracying_tpu_torch.core.sampling import (
    uniform_in_unit_disk,
    uniform_in_unit_sphere,
)
from ray_tracying_tpu_torch.core.transforms import (
    apply_normal,
    apply_point,
    apply_vector,
    build_trs,
)
from ray_tracying_tpu_torch.core.vecmath import dot, normalize, reflect, refract
from ray_tracying_tpu_torch.render.camera import pixel_rays
from ray_tracying_tpu_torch.render.integrator import trace_wavefront
from ray_tracying_tpu_torch.render.intersect import (
    Hit,
    all_hit_t,
    closest_hit,
    min_hit_t,
    occluded,
)
from ray_tracying_tpu_torch.render.materials import gather_materials
from ray_tracying_tpu_torch.render.shade import shade

__all__ = [
    "Hit",
    "all_hit_t",
    "apply_normal",
    "apply_point",
    "apply_vector",
    "build_lbvh",
    "build_trs",
    "closest_hit",
    "dot",
    "gather_materials",
    "min_hit_t",
    "normalize",
    "occluded",
    "pixel_rays",
    "reflect",
    "refract",
    "shade",
    "trace_wavefront",
    "uniform_in_unit_disk",
    "uniform_in_unit_sphere",
    "with_bvh",
]
