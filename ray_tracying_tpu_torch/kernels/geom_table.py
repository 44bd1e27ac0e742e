"""Packed geometry table shared by the intersection kernels.

One row per geom, 17 f32 columns:

  cols 0..11 : transformed prims -> world->object 3x4 row-major
               legacy planes     -> the 4 corners (x,y,z interleaved)
  cols 12..14: velocity (prims; zero for planes)
  col  15    : kind (0 sphere, 1 cube, 2 rect, 3 plane)
  col  16    : original geom id (material-table index)

The id column makes row order irrelevant: rows are sorted by kind while
the reported ids stay the reference's load-order ids.
"""

from __future__ import annotations

import torch

from ray_tracying_tpu_torch.scene.types import Scene

KIND_PLANE = 3
GEOM_COLS = 17
# Material columns appended by pack_geom_table_shaded (cols 17..30):
# diffuse rgb, specular rgb, k_ambient, k_diffuse, k_specular, shininess,
# roughness, reflectivity, transparency, refractive index.  Textured
# scenes append one more column, the texture atlas slot (col 31; -1 = no
# texture).
MAT_COLS = 14
SHADED_COLS = GEOM_COLS + MAT_COLS


def pack_geom_table(scene: Scene) -> torch.Tensor:
    """(G, 17) table in load order (prims then planes)."""
    dev = scene.device
    f32 = dict(dtype=torch.float32, device=dev)
    rows = []
    if scene.n_prims:
        p = scene.n_prims
        rows.append(
            torch.cat(
                [
                    scene.prims.w2o.reshape(p, 12),
                    scene.prims.velocity,
                    scene.prims.kind[:, None].to(torch.float32),
                    torch.arange(p, **f32)[:, None],
                ],
                dim=1,
            )
        )
    if scene.n_planes:
        q = scene.n_planes
        rows.append(
            torch.cat(
                [
                    scene.planes.corners.reshape(q, 12),
                    torch.zeros((q, 3), **f32),
                    torch.full((q, 1), float(KIND_PLANE), **f32),
                    (scene.n_prims + torch.arange(q, **f32))[:, None],
                ],
                dim=1,
            )
        )
    if not rows:
        return torch.zeros((1, GEOM_COLS), **f32)
    return torch.cat(rows, dim=0)


def pack_geom_table_sorted(scene: Scene):
    """Kind-sorted geom table + static per-kind loop ranges.

    Returns (table, ranges) where table is the (G, 17) table with rows
    stably sorted by kind (spheres, cubes, rects, planes) and ranges is a
    static tuple of (kind_code, start, end) for each nonempty kind.  The
    kernels run one kind-specialized inner loop per range.  Row order is
    id-tagged (col 16), so the reported winner ids are unchanged; only
    exact-t ties BETWEEN kinds can break differently from load order — a
    measure-zero deviation from min_element first-wins
    (Code/acceleration.cpp:112).

    The JAX package can pad every kind segment to a multiple of 8 rows
    with never-hit rows of id -2, for a TPU loop unroll; the CUDA kernels
    need no such alignment, so this table holds the real rows only.

    The scene's kind_counts name the ranges; a hand-built scene whose
    counts do not cover its prims has them recounted from the kind column
    (a host read of three integers), so every table is kind-sorted.
    """
    table = pack_geom_table(scene)
    ns, nc, nr = scene.kind_counts
    if ns + nc + nr != scene.n_prims:
        ns, nc, nr = torch.bincount(
            scene.prims.kind.to(torch.int64), minlength=3
        )[:3].tolist()
    table = table[torch.argsort(table[:, 15], stable=True)]
    bounds = [0]
    for c in (ns, nc, nr, scene.n_planes):
        bounds.append(bounds[-1] + c)
    ranges = tuple(
        (kind, bounds[kind], bounds[kind + 1])
        for kind in (0, 1, 2, KIND_PLANE)
        if bounds[kind + 1] > bounds[kind]
    )
    return table, ranges


def pack_geom_table_shaded(scene: Scene, with_tex: bool = False):
    """Kind-sorted geom table with the per-geom material record appended
    (SHADED_COLS columns; +1 texture-slot column when with_tex) for the
    fused level kernel (kernels/wavefront.py).  Material rows follow the
    table's id column."""
    table, ranges = pack_geom_table_sorted(scene)
    ids = torch.round(table[:, 16]).to(torch.int64)
    m = scene.materials
    cols = [
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
    ]
    if with_tex:
        cols.append(m.tex_id.to(torch.float32)[:, None])
    mat = torch.cat(cols, dim=1)  # (M, MAT_COLS [+1])
    return torch.cat([table, mat[ids]], dim=1), ranges


def pack_light_table(scene: Scene) -> torch.Tensor:
    """(8, L) light table: [px py pz | r g b | intensity | radius] per
    column (Code/light.hpp:5-14)."""
    li = scene.lights
    return torch.stack(
        [
            li.position[:, 0], li.position[:, 1], li.position[:, 2],
            li.color[:, 0], li.color[:, 1], li.color[:, 2],
            li.intensity, li.radius,
        ],
        dim=0,
    ).to(torch.float32)
