"""ray_tracying_tpu_torch — the PyTorch/CUDA port of ray_tracying_tpu (the JAX package).

A Whitted ray tracer with the capabilities of the reference C++ renderer
(EricZhang12138/Ray_Tracying), loaded from the same scene.json schema.
Plain tensor code is PyTorch; the hot loops — one fused bounce level per
launch, the brute-force closest-hit, fused-normal and shadow any-hit
searches of the general path, the BVH traversal of `use_bvh`, and the
chunk sweeps of scenes whose geom table does not fit a block's shared
memory — are CUDA C++ kernels written for Hopper (sm_90a), built with
nvcc at first use and loaded with ctypes.  The package imports torch and
numpy only.

Layout (the same names as the JAX package):
  - scene/   : scene.json -> frozen dataclasses of tensors
  - core/    : constants, vec math, transforms, sampling (torch.Generator)
  - accel/   : LBVH and Morton-ordered chunks, built on the host in numpy
  - kernels/ : table packing, the plain PyTorch versions of the kernels,
               their wrappers, and the build step; csrc/ holds the CUDA
  - render/  : camera ray gen, intersect (two-pass closest hit), materials,
               shade, wavefront integrator (fused and general paths), tiled
               pipeline
  - diff/    : differentiable rendering: render_linear, mse losses (whole
               frame and tiled), parameter plumbing, Adam fitting, checkpoints
  - ops/     : the stable op-level API the renderer is built from
  - io/      : PPM P3 codec (byte-compatible with the reference)
  - models/  : the named demo scenes and the procedural large ones
  - parallel/: multi-device rendering on torch.distributed: rays sharded over
               the ranks, the scene replicated, gradients all-reduced
  - entry.py : the entry points entry() and dryrun_multichip(n)

Entry points run on the card: `device=None` means "cuda" and raises
without one; pass `device="cpu"` to run the plain versions on the host.
"""

import torch

# Geometry must not see TF32: a slab test or a 3x4 transform rounded to
# ten mantissa bits moves hit points by whole texels and flips first-wins
# ties.  Nothing in the package needs a matmul or a convolution, but a
# caller's might share the process — keep both switches off (the torch
# form of "no K=3 contractions on the matrix unit").
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from ray_tracying_tpu_torch.scene.types import (  # noqa: E402
    Scene,
    Camera,
    Lights,
    Materials,
    Primitives,
    Planes,
    KIND_SPHERE,
    KIND_CUBE,
    KIND_RECT,
)
from ray_tracying_tpu_torch.scene.loader import (  # noqa: E402
    load_scene,
    load_scene_dict,
)
from ray_tracying_tpu_torch.render.pipeline import (  # noqa: E402
    RenderOptions,
    render_image,
    render_to_srgb_u8,
    render_with_stats,
)
from ray_tracying_tpu_torch.io.ppm import read_ppm, write_ppm  # noqa: E402
# render_with_stats and differentiable rendering, as attributes of the
# package (the JAX package's render.pipeline and diff/ entry points;
# __all__ stays the JAX package's list).
from ray_tracying_tpu_torch.diff.render import mse_loss, render_linear  # noqa: E402,F401
from ray_tracying_tpu_torch.diff.optimize import fit  # noqa: E402,F401

__version__ = "0.1.0"

__all__ = [
    "Scene",
    "Camera",
    "Lights",
    "Materials",
    "Primitives",
    "Planes",
    "KIND_SPHERE",
    "KIND_CUBE",
    "KIND_RECT",
    "load_scene",
    "load_scene_dict",
    "RenderOptions",
    "render_image",
    "render_to_srgb_u8",
    "read_ppm",
    "write_ppm",
]
