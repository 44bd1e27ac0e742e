"""Per-ray material record fetch.

One packed (M, 15) table and a single indexed row load, `packed[gid]`,
fetch the whole record of each ray's hit geom.  The record is fetched once
per bounce level and shared by shading and child-ray spawning.  When the
table carries a graph (differentiable rendering) the load is
core/segment.py::gather_columns, the same values with a backward that adds
each material's lanes up without atomics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ray_tracying_tpu_torch.core.segment import gather_columns
from ray_tracying_tpu_torch.scene.types import Scene


class MatRec(NamedTuple):
    diffuse: torch.Tensor       # (R, 3)
    specular: torch.Tensor      # (R, 3)
    k_ambient: torch.Tensor     # (R,)
    k_diffuse: torch.Tensor     # (R,)
    k_specular: torch.Tensor    # (R,)
    shininess: torch.Tensor     # (R,)
    roughness: torch.Tensor     # (R,)
    reflectivity: torch.Tensor  # (R,)
    transparency: torch.Tensor  # (R,)
    ior: torch.Tensor           # (R,)
    tex_id: torch.Tensor        # (R,) int32


def gather_materials(scene: Scene, gid: torch.Tensor) -> MatRec:
    """gid: (R,) geom ids; out-of-range ids (-1 for a miss) produce zero
    records, fine for masked slots."""
    m = scene.materials
    packed = torch.cat(
        [
            m.diffuse,
            m.specular,
            m.k_ambient[:, None],
            m.k_diffuse[:, None],
            m.k_specular[:, None],
            m.shininess[:, None],
            m.roughness[:, None],
            m.reflectivity[:, None],
            m.transparency[:, None],
            m.ior[:, None],
            m.tex_id[:, None].to(torch.float32),
        ],
        dim=1,
    )  # (M, 15): 3 diffuse + 3 specular + 9 scalar columns (tex_id is col 14)
    n = packed.shape[0]
    gid = gid.to(torch.int64)
    in_range = (gid >= 0) & (gid < n)
    idx = torch.clamp(gid, 0, n - 1)
    rec = gather_columns(packed.T, idx).T if packed.requires_grad else packed[idx]
    rec = torch.where(in_range[:, None], rec, torch.zeros_like(rec))
    return MatRec(
        diffuse=rec[:, 0:3],
        specular=rec[:, 3:6],
        k_ambient=rec[:, 6],
        k_diffuse=rec[:, 7],
        k_specular=rec[:, 8],
        shininess=rec[:, 9],
        roughness=rec[:, 10],
        reflectivity=rec[:, 11],
        transparency=rec[:, 12],
        ior=rec[:, 13],
        tex_id=torch.round(rec[:, 14]).to(torch.int32),
    )
