"""BVH traversal closest hit: the `use_bvh` kernel for scenes whose table
fits the brute kernels' cap.

`bvh_closest` and `bvh_closest_n` (csrc/bvh_traverse.cu) replace
`_bvh_kernel` of the JAX package's kernels/bvh_traverse.py.  That kernel shares one scalar stack
among a block of 2048 rays and orders children by the block's mean
direction, because a stack per lane does not vectorize on a TPU.  On a GPU
a stack per thread is the natural form: each thread walks the flat LBVH
(accel/lbvh.py) for its own ray with a short stack in local memory, slab
tests each node's box against its own best t (`t_near * |d| <= best_t`, so
that ties are still visited), takes the child whose centre lies nearer
along its own direction first, and runs the <= 4 geoms of a leaf through
the mixed-kind test.  Each node's box test gets the node's own slack
(`graze`, (M,): accel/lbvh.py::node_graze).  Nodes and rows are read from
global memory through L1/L2, so the kernel has no shared-memory cap of its
own; its stack holds accel.lbvh.BVH_STACK_MAX nodes, and a deeper tree is
refused where it is attached to a scene (`with_bvh`, `scene_from_numpy`),
so the operands here are taken as checked.  What bounds it
on an H100: operations (the box and geom tests a ray cannot prune) on
coherent rays, memory latency on incoherent ones.

A traversal visits geoms in a per-ray order, so the winner is made
order-free: a hit replaces the best when `t < best_t`, or `t == best_t`
and its table row is lower.  The result then equals the plain sweep of the
Morton-ordered table in row order (`mixed_closest_plain`), which is the
plain version here: no tree.  With `stats` it also counts the box and geom
tests no traversal can avoid.

`bvh_closest_n` also carries the winner's unit normal, as
`brute_closest_n` does, for inference on untextured scenes.  The JAX
package has no such form: under `use_bvh` it rebuilds the normal in pass 2,
whose last bits differ from the fused-normal brute kernel's, so its images
with and without `use_bvh` differ in a few bytes.  With this kernel the
port's are byte-equal, which is the reference's contract for `-bvh`.

For CUDA tensors the wrapper launches the kernel (built at first use by
kernels/_build.py) or raises; only CPU tensors take the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tracying_tpu_torch.kernels import _build
from ray_tracying_tpu_torch.kernels.chunk_stream import box_hit
from ray_tracying_tpu_torch.kernels.closest_hit import (
    BRUTE_THREADS,
    RayBlock,
    _raise_on,
    check_rays,
    check_rows_table,
    mixed_closest_plain,
    pack_rays,
)
from ray_tracying_tpu_torch.kernels.ray_sort import sorted_closest_hit
from ray_tracying_tpu_torch.scene.types import Scene

def _check(rays, table, boxes, topo, graze):
    check_rays(rays, table=table, boxes=boxes, topo=topo, graze=graze)
    check_rows_table(table, table.shape[0])
    m = boxes.shape[0]
    if boxes.dtype != torch.float32 or boxes.dim() != 2 or boxes.shape[1] != 6:
        raise TypeError("boxes must be an (M, 6) float32 tensor")
    if topo.dtype != torch.int32 or topo.shape != (m, 4):
        raise TypeError("topo must be an (M, 4) int32 tensor beside the boxes")
    if graze.dtype != torch.float32 or graze.shape != (m,):
        raise TypeError("graze must be an (M,) float32 tensor beside the boxes")


def bvh_closest_plain(rays, table, boxes, topo, graze, motion: bool = False,
                      stats: Optional[dict] = None):
    """(t, id) of the closest hit over the Morton-ordered (G, 17) table;
    see `mixed_closest_plain`.  The plain versions sweep every row: they
    take the tree only to check and to count.

    stats: optional dict that receives what no traversal of this tree can
    avoid, given the final t: the nodes whose exact box a live ray can hit
    no farther than its closest hit (it must test them), and the geoms of
    the leaves among them."""
    _check(rays, table, boxes, topo, graze)
    t, pid = mixed_closest_plain(rays, table, table.shape[0], motion)
    if stats is not None:
        rb = RayBlock(rays)
        live = rays[7] > 0.0
        tests = box_tests = 0
        for box, (left, _, _, count) in zip(boxes.tolist(), topo.tolist()):
            need = int((live & box_hit(rb, box, t, None)).sum())
            box_tests += need
            if left < 0:
                tests += need * count
        stats.update(lanes=rays.shape[1], live=int(live.sum()), tests=tests,
                     box_tests=box_tests)
    return t, pid


def bvh_closest_n_plain(rays, table, boxes, topo, graze, motion: bool = False):
    """(t, id, unit normal (3, R)); see `mixed_closest_plain`."""
    _check(rays, table, boxes, topo, graze)
    return mixed_closest_plain(rays, table, table.shape[0], motion, want_n=True)


def _launch(rays, table, boxes, topo, graze, motion, want_n):
    _check(rays, table, boxes, topo, graze)
    lib = _build.load()
    r = rays.shape[1]
    outs = [torch.empty((r,), dtype=torch.float32, device=rays.device),
            torch.empty((r,), dtype=torch.int32, device=rays.device)]
    if want_n:
        outs.append(torch.empty((3, r), dtype=torch.float32, device=rays.device))
    fn = lib.bvh_closest_n_launch if want_n else lib.bvh_closest_launch
    with torch.cuda.device(rays.device):
        err = fn(
            rays.data_ptr(), table.data_ptr(), boxes.data_ptr(), topo.data_ptr(),
            graze.data_ptr(), *(x.data_ptr() for x in outs), r, table.shape[0], boxes.shape[0],
            int(bool(motion)), BRUTE_THREADS,
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, lib, "bvh_closest_n" if want_n else "bvh_closest")
    return tuple(outs)


def bvh_closest(rays, table, boxes, topo, graze, motion: bool = False):
    """(t, id) of the closest hit by LBVH traversal; see
    `bvh_closest_plain`."""
    if not rays.is_cuda:
        return bvh_closest_plain(rays, table, boxes, topo, graze, motion)
    out = _launch(rays, table, boxes, topo, graze, motion, want_n=False)
    bvh_closest.launches += 1
    return out


def bvh_closest_n(rays, table, boxes, topo, graze, motion: bool = False):
    """(t, id, unit normal (3, R)) by LBVH traversal; see
    `bvh_closest_n_plain` and `bvh_closest`."""
    if not rays.is_cuda:
        return bvh_closest_n_plain(rays, table, boxes, topo, graze, motion)
    out = _launch(rays, table, boxes, topo, graze, motion, want_n=True)
    bvh_closest_n.launches += 1
    return out


bvh_closest.launches = 0
bvh_closest_n.launches = 0


def closest_hit_tid_bvh(scene: Scene, o, d, time, active=None, sort_rays=False):
    """BVH-accelerated closest hit: (t, geom_id), the hit set of the brute
    kernels.  Requires accel.lbvh.with_bvh(scene).

    sort_rays: sort the wavefront for coherence first
    (kernels/ray_sort.py); the results are slot for slot the same."""
    operands = _operands(scene, o, d, time, active)
    if sort_rays:
        boxes = operands[2]
        return sorted_closest_hit(
            closest_hit_tid_bvh, scene, o, d, time, active,
            boxes[0, :3], boxes[0, 3:],
        )
    return bvh_closest(*operands)


def closest_hit_tid_n_bvh(scene: Scene, o, d, time, active=None):
    """BVH-accelerated closest hit with fused world normals (inference
    path): (t, geom_id, normal (R, 3))."""
    t, pid, n = bvh_closest_n(*_operands(scene, o, d, time, active))
    return t, pid, n.T


def _operands(scene: Scene, o, d, time, active):
    if scene.bvh_geoms is None or scene.bvh_nodes_graze is None:
        raise ValueError("the scene carries no BVH: call accel.lbvh.with_bvh first")
    return (
        pack_rays(o, d, time, active), scene.bvh_geoms.detach().contiguous(),
        scene.bvh_nodes_box.detach().contiguous(), scene.bvh_nodes_topo.contiguous(),
        scene.bvh_nodes_graze, scene.has_motion,
    )
