"""BVH traversal closest hit: the `use_bvh` kernel for scenes whose table
fits the brute kernels' cap.

`bvh_closest` and `bvh_closest_n` (csrc/bvh_traverse.cu) replace
`_bvh_kernel` of the JAX package's kernels/bvh_traverse.py.  That kernel shares one scalar stack
among a block of 2048 rays and orders children by the block's mean
direction, because a stack per lane does not vectorize on a TPU.  On a GPU
a stack per lane is the natural form.  What bounds it on an H100:
operations (the box and geom tests a ray cannot prune) on coherent rays,
memory latency on incoherent ones.

The kernel is one cooperative launch of persistent blocks: a scan writes
the dead lanes' misses and lists the live ones, and warps take 32 listed
lanes at a time, neighbours in the tile.  Each lane walks the flat LBVH
(accel/lbvh.py) with a stack of (node, entry distance) pairs in a
speculative while-while loop: a lane that comes to a leaf holds it back and
walks on until every lane of its warp holds one, then the warp runs its
leaves together.  It reads the tree as `accel.lbvh.pack_bvh` packs it once
on the host (`scene.bvh_inner`, `scene.bvh_rows`): one 64-byte record per
inner node with both children's boxes, their slacks (`graze`,
accel/lbvh.py::node_graze) and their references, so a visit tests both
children (`t_near * |d| <= best_t`, so that ties are still visited), goes
on into the one it enters first and pushes the other; and the table as
64-byte rows.  A popped entry beyond best t is dropped unread.  Its stack
holds accel.lbvh.BVH_STACK_MAX nodes, and a deeper tree is refused where it
is attached to a scene (`with_bvh`, `scene_from_numpy`), so the operands
here are taken as checked.  `bvh_closest_variant` reaches, by name, the
one-thread-per-lane kernel it replaced (every lane launched, nodes read as
(M, 6) boxes and (M, 4) topo, children ordered by their centres) and the
counting build, for the measurement that compares them; the package never
calls it.

A traversal visits geoms in a per-ray order, so the winner is made
order-free: a hit replaces the best when `t < best_t`, or `t == best_t`
and its table row is lower.  The result then equals the plain sweep of the
Morton-ordered table in row order (`mixed_closest_plain`), which is the
plain version here: no tree.  With `stats` it also counts the box and geom
tests no traversal can avoid.

`bvh_closest_n` also gives the winner's unit normal, as
`brute_closest_n` does, for inference on untextured scenes: the winner's
geom test run once more.  The JAX package has no such form: under
`use_bvh` it rebuilds the normal in pass 2, whose last bits differ from the
fused-normal brute kernel's, so its images with and without `use_bvh`
differ in a few bytes.  With this kernel the port's are byte-equal, which
is the reference's contract for `-bvh`.

For CUDA tensors the wrapper launches the kernel (built at first use by
kernels/_build.py) or raises; only CPU tensors take the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tracying_tpu_torch.kernels import _build, _coop
from ray_tracying_tpu_torch.kernels.chunk_stream import box_hit
from ray_tracying_tpu_torch.kernels.closest_hit import (
    BRUTE_THREADS,
    RayBlock,
    _plan,
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


def _packed(rays, table, boxes, topo, graze, packed):
    """(inner, rows) of the tree as `accel.lbvh.pack_bvh` packs it, the
    caller's (a scene's `bvh_inner`, `bvh_rows`), checked against the tree."""
    if packed is None:
        raise ValueError("the warp kernel reads the packed tree: pass packed=(scene.bvh_inner, "
                         "scene.bvh_rows), which accel.lbvh.with_bvh attaches")
    inner, rows = packed
    check_rays(rays, inner=inner, rows=rows)
    if inner.dtype != torch.float32 or inner.shape != ((boxes.shape[0] - 1) // 2, 16):
        raise TypeError("inner must be a float32 tensor of one 16-float record per inner node")
    if rows.dtype != torch.float32 or rows.shape != (table.shape[0], 16):
        raise TypeError("rows must be a (G, 16) float32 tensor beside the table")
    if inner.data_ptr() % 16 or rows.data_ptr() % 16:
        raise ValueError("inner and rows must be 16-byte aligned")
    return inner, rows


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


def _launch(rays, table, boxes, topo, graze, motion, want_n, schedule="warp", work=None,
            packed=None):
    """Launch a closest hit on the current stream: the warp kernel (work: an
    int64 (4,) tensor on the rays' device, zero, to count into: the counting
    build) or, schedule="lane", the one-thread-per-lane kernel it replaced.
    Returns (t, id[, n]); the caller counts the launch."""
    _check(rays, table, boxes, topo, graze)
    lib = _build.load()
    r, g = rays.shape[1], table.shape[0]
    dev = rays.device
    outs = [torch.empty((r,), dtype=torch.float32, device=dev),
            torch.empty((r,), dtype=torch.int32, device=dev)]
    if want_n:
        outs.append(torch.empty((3, r), dtype=torch.float32, device=dev))
    name = "bvh_closest_n" if want_n else "bvh_closest"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if schedule == "lane":
            err = getattr(lib, f"{name}_lane_launch")(
                rays.data_ptr(), table.data_ptr(), boxes.data_ptr(), topo.data_ptr(),
                graze.data_ptr(), *(x.data_ptr() for x in outs), r, g, boxes.shape[0],
                int(bool(motion)), BRUTE_THREADS, stream)
        else:
            inner, rows = _packed(rays, table, boxes, topo, graze, packed)
            ctr = _coop.work_counters(dev, stream)
            # the launch's list of live lanes (scratch, no initial value)
            live = torch.empty(r, dtype=torch.int32, device=dev)
            err = getattr(lib, f"{name}_launch")(
                rays.data_ptr(), boxes.data_ptr(), topo.data_ptr(), graze.data_ptr(),
                inner.data_ptr(), rows.data_ptr(), *(x.data_ptr() for x in outs), r, g,
                int(bool(motion)), None if work is None else work.data_ptr(),
                ctr.data_ptr(), live.data_ptr(), stream)
    _raise_on(err, lib, name)
    return tuple(outs)


def bvh_closest(rays, table, boxes, topo, graze, motion: bool = False, packed=None):
    """(t, id) of the closest hit by LBVH traversal; see
    `bvh_closest_plain`.  packed: the tree's (inner, rows) as the scene
    carries them (`bvh_inner`, `bvh_rows`); on the card the kernel reads
    them, and a launch without them raises."""
    if not rays.is_cuda:
        return bvh_closest_plain(rays, table, boxes, topo, graze, motion)
    out = _launch(rays, table, boxes, topo, graze, motion, want_n=False, packed=packed)
    bvh_closest.launches += 1
    return out


def bvh_closest_n(rays, table, boxes, topo, graze, motion: bool = False, packed=None):
    """(t, id, unit normal (3, R)) by LBVH traversal; see
    `bvh_closest_n_plain` and `bvh_closest`."""
    if not rays.is_cuda:
        return bvh_closest_n_plain(rays, table, boxes, topo, graze, motion)
    out = _launch(rays, table, boxes, topo, graze, motion, want_n=True, packed=packed)
    bvh_closest_n.launches += 1
    return out


def bvh_closest_variant(rays, table, boxes, topo, graze, motion: bool = False,
                        want_n: bool = False, schedule: str = "warp", work=None, packed=None):
    """`bvh_closest` (or, want_n, `bvh_closest_n`) by the package's warp
    kernel, its counting build (work: an int64 (4,) tensor, zero, that
    receives the inner nodes visited, box tests, geom tests and warp lane
    slots), or by the one-thread-per-lane kernel it replaced
    (schedule="lane").  Only for measuring the one against the other
    (chip_smoke.py); CUDA tensors only.  Its launches count in
    `bvh_closest_variant.launches`, apart from the package's."""
    if not rays.is_cuda:
        raise ValueError("bvh_closest_variant runs on the card only")
    if schedule not in ("warp", "lane") or (work is not None and schedule == "lane"):
        raise ValueError(f"no variant {schedule!r} of bvh_closest with these operands")
    if work is not None and (work.dtype != torch.int64 or work.shape != (4,)
                             or work.device != rays.device):
        raise TypeError("work must be an int64 (4,) tensor on the rays' device")
    out = _launch(rays, table, boxes, topo, graze, motion, want_n, schedule, work, packed)
    bvh_closest_variant.launches += 1
    return out


def bvh_closest_plan(want_n: bool = False, device=None) -> dict:
    """What `bvh_closest` (want_n: `bvh_closest_n`) launches with on the
    current card: shared memory bytes of a block, resident blocks per SM,
    SMs, threads per block."""
    return _plan("bvh_closest", int(bool(want_n)), device=device)


bvh_closest.launches = 0
bvh_closest_n.launches = 0
bvh_closest_variant.launches = 0


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
    if scene.bvh_geoms is None or scene.bvh_inner is None:
        raise ValueError("the scene carries no BVH: call accel.lbvh.with_bvh first")
    return (
        pack_rays(o, d, time, active), scene.bvh_geoms.detach().contiguous(),
        scene.bvh_nodes_box.detach().contiguous(), scene.bvh_nodes_topo.contiguous(),
        scene.bvh_nodes_graze, scene.has_motion, (scene.bvh_inner, scene.bvh_rows),
    )
