"""Coherence-restoring ray sort for the accelerated closest-hit kernels.

A wavefront after the first bounce is incoherent: neighbouring lanes aim
anywhere.  The chunk sweep stages a chunk for a block as soon as one of its
rays wants it, and the threads of a warp walking different parts of a tree
serialize, so both kernels feed on neighbours that are alike.  Sorting the
wavefront restores that: key = direction octant (3 bits) | Morton code of
the origin within the scene bounds, one stable `torch.sort`, the kernel on
the sorted wavefront, then the (t, id) results scattered back to their
original slots.  The kernels are order-invariant per ray, so the results
are slot for slot those of the unsorted call.
"""

from __future__ import annotations

import torch


def _spread10(v: torch.Tensor) -> torch.Tensor:
    """Interleave 10 bits with two zero bits each (Morton spread), int32."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def ray_sort_key(o: torch.Tensor, d: torch.Tensor, lo, hi) -> torch.Tensor:
    """(R,) int32 coherence key: direction octant then origin Morton.

    lo, hi: scene bounds (3,) — callers pass the BVH root box so that keys
    are consistent with the tree layout."""
    span = torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp((o - lo) / span * 1023.0, 0.0, 1023.0).to(torch.int32)
    morton = (
        (_spread10(q[:, 0]) << 2)
        | (_spread10(q[:, 1]) << 1)
        | _spread10(q[:, 2])
    )
    octant = (
        ((d[:, 0] < 0).to(torch.int32) << 2)
        | ((d[:, 1] < 0).to(torch.int32) << 1)
        | (d[:, 2] < 0).to(torch.int32)
    )
    # Octant is the major key (bits 28-30), origin Morton the minor
    # (morton >> 2 keeps its top 28 bits); the total stays below 2^31, so
    # the int32 key is positive.  Only its order matters.
    return (octant << 28) | (morton >> 2)


def sorted_closest_hit(kernel_tid, scene, o, d, time, active, lo, hi):
    """Run a (scene, o, d, time, active) -> (t, id) kernel on the
    coherence-sorted wavefront and put the results back in their slots.
    The sort is stable, so two runs permute alike."""
    key = ray_sort_key(o, d, lo, hi)
    _, perm = torch.sort(key, stable=True)
    t_s, id_s = kernel_tid(
        scene, o[perm], d[perm], time[perm],
        None if active is None else active[perm],
    )
    t = torch.empty_like(t_s)
    pid = torch.empty_like(id_s)
    t[perm] = t_s
    pid[perm] = id_s
    return t, pid
