"""LBVH and chunk construction, on the host in numpy.

Replaces the reference's pointer-based recursive median-split BVH
(Code/acceleration.cpp:20-64) with flat arrays a kernel can walk:

  - per-geom AABBs with the reference's exact semantics (sphere boxes
    include the velocity-displaced time-1 extent, Code/shapes.cpp:264-287;
    plane boxes padded 1e-4, :496-503; node box = merge of member boxes,
    acceleration.cpp:21-25)
  - geoms sorted by 30-bit Morton code of their AABB centroids
  - balanced median split over the sorted order, leaves hold <= 4 geoms
    like the reference (acceleration.cpp:30)
  - flat arrays: boxes (M, 6) f32 [min|max], topo (M, 4) int32
    [left, right, first, count] with left = -1 marking a leaf, and the
    sorted geom order for reordering the packed geom table.

Traversal order never affects the image: the closest hit is a min over
the full hit set, so this build does not reproduce the reference's
in-place sort topology.

The arrays equal the JAX package's bit for bit for the same scene and the
same `chunk`; only the default `CHUNK` differs (see below).  `with_bvh`
builds its tree with the native builder (native/src/lbvh.cpp); the numpy
`build_lbvh` is that builder's plain version.  Beside the arrays the port
keeps, per chunk and per node, the slack its f32 box test gives that box
(`chunk_graze`, `node_graze`): the boxes themselves stay exact.
The build runs at scene-load time; the finished arrays are attached to the
scene as tensors on its device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ray_tracying_tpu_torch import native, spans
from ray_tracying_tpu_torch.kernels import closest_hit as CH
from ray_tracying_tpu_torch.kernels.geom_table import pack_geom_table
from ray_tracying_tpu_torch.scene.types import KIND_RECT, KIND_SPHERE, Scene

LEAF_SIZE = 4  # reference: acceleration.cpp:30

# Entries of a thread's traversal stack (csrc/bvh_traverse.cu::kBvhStackMax).
# A depth-first walk holds at most depth + 1 nodes; a median-split tree over
# G geoms with leaves of 4 is about log2(G / 4) + 1 deep.
BVH_STACK_MAX = 64

# The sphere test's cancellation at a distance, as a factor on
# coef * distance^2 (csrc/geom.cuh::box_hit): K * u / 2 with u = 6e-8 and K
# about 4, checked on the card against the unculled sweep, not proved.
GRAZE_SLACK = 1.2e-7


def _np(x: torch.Tensor, what: str) -> np.ndarray:
    """x on the host: one device-to-host read, named `what` (spans.read)."""
    with spans.read(what):
        return x.detach().cpu().numpy()


def geom_aabbs(scene: Scene) -> np.ndarray:
    """(G, 6) [min xyz | max xyz] with reference AABB semantics."""
    boxes = []
    if scene.n_prims:
        o2w = _np(scene.prims.o2w, "prim transforms")   # (P, 3, 4)
        kind = _np(scene.prims.kind, "prim kinds")
        vel = _np(scene.prims.velocity, "prim velocities")
        # Unit-cube corners; spheres use +-1 (shapes.cpp:267-270), cubes and
        # rects +-0.5 (rects flat in z, shapes.cpp:337-340,427-430).
        signs = np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
            np.float32,
        )  # (8, 3)
        half = np.where(kind[:, None] == KIND_SPHERE, 1.0, 0.5)  # (P, 1)
        corners = signs[None, :, :] * half[:, None, :]           # (P, 8, 3)
        corners[kind == KIND_RECT, :, 2] = 0.0
        world = (
            np.einsum("pij,pcj->pci", o2w[:, :, :3], corners) + o2w[:, None, :, 3]
        )  # (P, 8, 3)
        # Sphere motion extent: also merge corners displaced by velocity
        # (shapes.cpp:272-285).
        moved = world + vel[:, None, :]
        allc = np.concatenate([world, moved], axis=1)  # (P, 16, 3)
        boxes.append(
            np.concatenate([allc.min(axis=1), allc.max(axis=1)], axis=1)
        )
    if scene.n_planes:
        c = _np(scene.planes.corners, "plane corners")  # (Q, 4, 3)
        pad = 1e-4  # shapes.cpp:498
        boxes.append(
            np.concatenate([c.min(axis=1) - pad, c.max(axis=1) + pad], axis=1)
        )
    if not boxes:
        return np.zeros((0, 6), np.float32)
    return np.concatenate(boxes, axis=0).astype(np.float32)


def morton_codes(centroids: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of normalized centroids."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    q = np.clip(((centroids - lo) / span * 1023.0), 0, 1023).astype(np.uint32)

    def spread(v):
        v = (v | (v << 16)) & np.uint32(0x030000FF)
        v = (v | (v << 8)) & np.uint32(0x0300F00F)
        v = (v | (v << 4)) & np.uint32(0x030C30C3)
        v = (v | (v << 2)) & np.uint32(0x09249249)
        return v

    return (
        (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    ).astype(np.uint64)


def _morton_order(aabbs: np.ndarray) -> np.ndarray:
    centroids = (aabbs[:, :3] + aabbs[:, 3:]) * 0.5
    return np.argsort(morton_codes(centroids), kind="stable")


def build_lbvh(
    aabbs: np.ndarray, leaf_size: int = LEAF_SIZE
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (boxes (M, 6), topo (M, 4) int32, order (G,) int64).

    topo rows: [left, right, first, count]; left == -1 marks a leaf whose
    geoms are order[first : first+count]."""
    g = aabbs.shape[0]
    if g == 0:
        return (
            np.zeros((1, 6), np.float32),
            np.array([[-1, -1, 0, 0]], np.int32),
            np.zeros(0, np.int64),
        )
    order = _morton_order(aabbs)
    sorted_boxes = aabbs[order]

    boxes: list = []
    topo: list = []

    # Iterative preorder build over [start, end) ranges of the sorted list.
    # Children are emitted depth-first so left == parent+1 always; both
    # child ids are still stored, for the kernel's simplicity.
    def alloc():
        boxes.append(None)
        topo.append(None)
        return len(boxes) - 1

    stack = [(alloc(), 0, g)]
    while stack:
        node, start, end = stack.pop()
        seg = sorted_boxes[start:end]
        bmin = seg[:, :3].min(axis=0)
        bmax = seg[:, 3:].max(axis=0)
        boxes[node] = np.concatenate([bmin, bmax])
        if end - start <= leaf_size:
            topo[node] = [-1, -1, start, end - start]
            continue
        mid = (start + end) // 2
        left = alloc()
        right = alloc()
        topo[node] = [left, right, 0, 0]
        # Push right first so left is processed next (preorder).
        stack.append((right, mid, end))
        stack.append((left, start, mid))

    return (
        np.stack(boxes).astype(np.float32),
        np.array(topo, np.int32),
        order,
    )


def tree_depth(topo: np.ndarray) -> int:
    """Edges on the longest root-to-leaf path of a (M, 4) topo array.  A
    depth-first traversal that pushes both children of a node holds at
    most depth + 1 nodes on its stack."""
    depth = 0
    frontier = np.zeros(1, np.int64)
    while True:
        left = topo[frontier, 0]
        inner = frontier[left >= 0]
        if inner.size == 0:
            return depth
        frontier = np.concatenate([topo[inner, 0], topo[inner, 1]]).astype(np.int64)
        depth += 1
        if depth > topo.shape[0]:
            raise ValueError("the topo array is not a tree (a cycle)")


def check_depth(topo: np.ndarray) -> int:
    """The tree's depth; a tree too deep for the traversal kernel's stack
    is refused here, where it is attached to a scene, never truncated."""
    depth = tree_depth(topo)
    if depth + 1 > BVH_STACK_MAX:
        raise ValueError(
            f"a tree {depth} deep needs a stack of {depth + 1}; the traversal "
            f"kernel's holds {BVH_STACK_MAX}"
        )
    return depth


def row_graze(table: np.ndarray) -> np.ndarray:
    """(rows,) f32: the distance-squared slack each row of a (rows, 17) geom
    table asks of a box that holds it (csrc/geom.cuh::box_hit): GRAZE_SLACK
    * |w2o|_F^4 / |det w2o| for a sphere row (9 / r for a sphere of radius
    r), 0 for every other kind and for all-zero padding rows."""
    t = table.astype(np.float64)
    a, b, c = t[:, 0:3], t[:, 4:7], t[:, 8:11]
    det = np.abs((a * np.cross(b, c)).sum(axis=1))
    f2 = (a * a + b * b + c * c).sum(axis=1)
    sphere = (np.rint(t[:, 15]) == KIND_SPHERE) & (det > 0.0)
    coef = np.where(sphere, f2 * f2 / np.where(sphere, det, 1.0), 0.0)
    return (GRAZE_SLACK * coef).astype(np.float32)


def chunk_graze(table: np.ndarray, chunk: int) -> np.ndarray:
    """(NC,) f32: per chunk of a (NC * chunk, 17) chunk table, the largest
    `row_graze` of its rows."""
    return row_graze(table).reshape(-1, chunk).max(axis=1)


def node_graze(table: np.ndarray, topo: np.ndarray) -> np.ndarray:
    """(M,) f32: per node of the tree `topo` over the Morton-ordered (G, 17)
    table, the largest `row_graze` of the rows in its subtree.  Children
    carry higher indices than their parent (a preorder build), so one pass
    from the last node to the root folds them in."""
    rows = row_graze(table)
    out = np.zeros(topo.shape[0], np.float32)
    for node in range(topo.shape[0] - 1, -1, -1):
        left, right, first, count = topo[node].tolist()
        if left < 0:
            out[node] = rows[first : first + count].max(initial=0.0)
        elif left <= node or right <= node:
            raise ValueError("the topo array is not in preorder (a child before its parent)")
        else:
            out[node] = max(out[left], out[right])
    return out


# Geoms per chunk of the streaming kernels.  The JAX package sizes its
# chunk (2048) to a TPU core's scalar memory; here a chunk is what a block
# stages in shared memory (68 bytes a geom: 17 KB for 256) and what one
# AABB test culls, so a smaller chunk both leaves room for several blocks
# on an SM and culls finer.
CHUNK = 256


def build_chunks(scene: Scene, chunk: Optional[int] = None):
    """Morton-ordered geom chunks for the streaming kernels; chunk: geoms
    per chunk, `CHUNK` (read at call time) when not given.

    Returns (table (NC*chunk, 17), boxes (NC, 6)): the packed geom table
    sorted by centroid Morton code (so consecutive rows are spatially
    local and the per-chunk AABB stays tight), padded to a chunk multiple
    with all-zero rows (the JAX package's layout; the CUDA kernels stop at
    the last real row and never read them); boxes[c] bounds chunk c's real
    members with the reference AABB semantics (incl. motion extent)."""
    chunk = CHUNK if chunk is None else chunk
    aabbs = geom_aabbs(scene)
    order = _morton_order(aabbs)
    table = _np(pack_geom_table(scene), "geom table")[order]
    sb = aabbs[order]
    g = table.shape[0]
    nc = -(-g // chunk)
    pad = nc * chunk - g
    if pad:
        table = np.concatenate(
            [table, np.zeros((pad, table.shape[1]), table.dtype)], axis=0
        )
    boxes = np.empty((nc, 6), np.float32)
    for c in range(nc):
        seg = sb[c * chunk : min((c + 1) * chunk, g)]
        boxes[c, :3] = seg[:, :3].min(axis=0)
        boxes[c, 3:] = seg[:, 3:].max(axis=0)
    return table.astype(np.float32), boxes


def with_chunks(scene: Scene, chunk: Optional[int] = None) -> Scene:
    """Attach the chunked-stream acceleration arrays (host build) and each
    chunk's box-test slack."""
    if scene.n_geoms == 0 or scene.chunk_geoms is not None:
        return scene
    table, boxes = build_chunks(scene, chunk)
    dev = scene.device
    return dataclasses.replace(
        scene,
        chunk_geoms=torch.from_numpy(table).to(dev),
        chunk_boxes=torch.from_numpy(boxes).to(dev),
        chunk_graze=torch.from_numpy(
            chunk_graze(table, table.shape[0] // boxes.shape[0])).to(dev),
    )


# The traversal kernel's own copy of the tree (csrc/bvh_traverse.cu): one
# 64-byte record per inner node holding what a visit needs of both children,
# and the Morton-ordered table as 64-byte rows.  A child reference is an
# inner node's record index (>= 0) or a leaf's ~(first << 3 | count) (< 0).
# A row keeps columns 0-14 and, in slot 15, id * 4 + kind: exact in f32
# below 2^24, so for tables of at most BVH_MAX_GEOMS geoms (load-order ids).
LEAF_COUNT_BITS = 3
BVH_MAX_GEOMS = 1 << 22


def leaf_ref(first, count):
    """The reference of a leaf of `count` rows from `first` (int or array)."""
    return ~((np.asarray(first, np.int64) << LEAF_COUNT_BITS) | count)


def pack_bvh(table: np.ndarray, boxes: np.ndarray, topo: np.ndarray,
             graze: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """-> (inner (N, 16) f32, rows (G, 16) f32), the traversal kernel's
    operands for the tree (boxes, topo, graze) over the Morton-ordered
    (G, 17) `table`.  inner[k], for the k-th inner node in index order (the
    root first): the left child's box (6), the right child's (6), their
    slacks (2), their references (2, int32 bits).  rows[g]: columns 0-14 of
    table[g], then id * 4 + kind."""
    g = table.shape[0]
    if g > BVH_MAX_GEOMS:
        raise ValueError(f"a BVH over {g} geoms: the traversal kernel takes at most "
                         f"{BVH_MAX_GEOMS}")
    left, right, first, count = (topo[:, k].astype(np.int64) for k in range(4))
    if (count[left < 0] >= 1 << LEAF_COUNT_BITS).any():
        raise ValueError(f"a leaf of {int(count.max())} rows: a reference holds at most "
                         f"{(1 << LEAF_COUNT_BITS) - 1}")
    inner = np.nonzero(left >= 0)[0]
    index = np.full(topo.shape[0], -1, np.int64)
    index[inner] = np.arange(inner.size)
    ref = np.where(left < 0, leaf_ref(first, count), index).astype(np.int32)
    nodes = np.zeros((inner.size, 16), np.float32)
    for col, child in ((0, left[inner]), (1, right[inner])):
        nodes[:, 6 * col:6 * col + 6] = boxes[child]
        nodes[:, 12 + col] = graze[child]
        nodes[:, 14 + col] = ref[child].view(np.float32)
    ids = np.rint(table[:, 16]).astype(np.int64)
    kinds = np.rint(table[:, 15]).astype(np.int64)
    if ids.size and not (0 <= ids.min() and ids.max() < BVH_MAX_GEOMS):
        raise ValueError("geom ids outside [0, BVH_MAX_GEOMS)")
    rows = np.concatenate([table[:, :15], (ids * 4 + kinds)[:, None]], axis=1)
    return nodes, np.ascontiguousarray(rows, dtype=np.float32)


def bvh_fields(table: np.ndarray, boxes: np.ndarray, topo: np.ndarray, dev) -> dict:
    """What the port keeps beside a tree's arrays, as Scene fields: each
    node's slack and the traversal kernel's packed copy.  A tree deeper than
    the kernel's stack is refused here."""
    check_depth(topo)
    graze = node_graze(table, topo)
    nodes, rows = pack_bvh(table, boxes, topo, graze)
    return dict(
        bvh_nodes_graze=torch.from_numpy(graze).to(dev),
        bvh_inner=torch.from_numpy(nodes).to(dev),
        bvh_rows=torch.from_numpy(rows).to(dev),
    )


def with_bvh(scene: Scene) -> Scene:
    """Attach LBVH arrays, each node's box-test slack and the traversal
    kernel's packed copy to the scene (host build by the native builder,
    native/src/lbvh.cpp, whose plain version is `build_lbvh`; device
    upload).  A scene whose table does not fit a block's shared memory also
    gets the chunked-stream structures."""
    if scene.n_geoms == 0:
        return scene
    boxes, topo, order = native.lbvh_build(geom_aabbs(scene), LEAF_SIZE)
    table = np.ascontiguousarray(_np(pack_geom_table(scene), "geom table")[order])
    dev = scene.device
    scene = dataclasses.replace(
        scene,
        bvh_nodes_box=torch.from_numpy(boxes).to(dev),
        bvh_nodes_topo=torch.from_numpy(topo).to(dev),
        bvh_geoms=torch.from_numpy(table).to(dev),
        **bvh_fields(table, boxes, topo, dev),
    )
    if scene.n_geoms > CH.BRUTE_SMEM_MAX_GEOMS:
        scene = with_chunks(scene)
    return scene
