"""Iterative wavefront Whitted integrator (fused-level path).

The reference's recursive `Trace` (Code/raytracer.cpp:280-351) runs to
depth 11.  Here the recursion is flattened into 11 bounce passes: a Python
loop that calls the fused level (kernels/wavefront.py) once per level and
adds the level's contribution rows.  Every ray has at most one
continuation (no material both reflects and refracts on this path), which
overwrites its own queue slot: the IN-SLOT discipline.  No compaction, no
scatters; a dead lane costs the level one load and thirteen stores.

Level semantics (all cited):
  - miss -> background 0.1 gray weighted by path throughput
    (Code/raytracer.cpp:296-298)
  - local shading weighted by throughput * max(0, 1 - refl - trans)
    (Code/raytracer.cpp:346-350)
  - children spawned at the depth-10 level are never traced: at depth 11
    the reference returns black (raytracer.cpp:290-292).

Not here yet: queue shrinking between levels (the image is the same
without it and no ray can be dropped; dead levels just cost more), the
compacted two-way discipline, BVH traversal, differentiable rendering.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ray_tracying_tpu_torch.core import constants as C
from ray_tracying_tpu_torch.core.sampling import uniform_in_unit_sphere
from ray_tracying_tpu_torch.kernels.wavefront import (
    C_BASE,
    HIT_ROW,
    WaveTables,
    wave_level,
    wave_supported,
    wave_tables,
)
from ray_tracying_tpu_torch.scene.types import Scene


class TraceStats(NamedTuple):
    """Per-level integrator counters (one entry per bounce level)."""

    live: torch.Tensor     # (L,) int32 — active queue slots entering the level
    hits: torch.Tensor     # (L,) int32 — rays that hit geometry this level
    spawned: torch.Tensor  # (L,) int32 — continuations emitted by this level
    dropped: torch.Tensor  # (L,) int32 — always 0: the in-slot queue drops none


def level_fuzz(
    tables: WaveTables, generator: torch.Generator, width: int, device
) -> Optional[torch.Tensor]:
    """Unit-ball rows for one level, sampled outside the kernel: (3, width)
    glossy fuzz, or None for a scene without glossy materials."""
    if not tables.glossy:
        return None
    return uniform_in_unit_sphere(generator, (width,), device=device).T.contiguous()


def _trace_wave(
    tables: WaveTables, o, d, times, generator, fuzz, min_tp, return_stats,
    levels, level_fn, return_levels,
):
    """Fused-level path, in-slot, full width on every level."""
    r = o.shape[0]
    dev = o.device
    prev = torch.cat(
        [
            o.T, d.T, times[None, :],
            torch.ones((2, r), dtype=torch.float32, device=dev),  # act, tp
        ],
        dim=0,
    ).contiguous()
    accum = torch.zeros((3, r), dtype=torch.float32, device=dev)
    stat_rows = []
    outs = []
    for depth in range(levels):
        if fuzz is not None:
            fz = fuzz[depth]
        else:
            fz = level_fuzz(tables, generator, r, dev)
        out = level_fn(prev, fz, tables, min_tp)
        accum += out[C_BASE : C_BASE + 3]
        if return_stats:
            stat_rows.append(
                torch.stack(
                    [
                        (prev[7] > 0).sum(),
                        (out[HIT_ROW] > 0).sum(),
                        (out[7] > 0).sum(),
                    ]
                )
            )
        if return_levels:
            outs.append(out)
        prev = out
    radiance = accum.T.contiguous()
    result = (radiance,)
    if return_stats:
        st = torch.stack(stat_rows, dim=1).to(torch.int32)  # (3, L)
        result += (
            TraceStats(st[0], st[1], st[2], torch.zeros_like(st[0])),
        )
    if return_levels:
        result += (outs,)
    return result[0] if len(result) == 1 else result


def trace_wavefront(
    scene: Scene,
    origins: torch.Tensor,     # (R, 3)
    directions: torch.Tensor,  # (R, 3) unit
    times: torch.Tensor,       # (R,)
    light_samples: int = 1,
    *,
    generator: Optional[torch.Generator] = None,
    fuzz: Optional[Sequence[torch.Tensor]] = None,
    use_bvh: bool = False,
    min_throughput: float = 0.0,
    differentiable: bool = False,
    return_stats: bool = False,
    max_depth: Optional[int] = None,
    device=None,
    tables: Optional[WaveTables] = None,
    level_fn=wave_level,
    return_levels: bool = False,
):
    """Trace R primary rays to completion.  Returns (R, 3) radiance; with
    return_stats also a TraceStats of per-level live/hit/spawn counters;
    with return_levels also the list of every level's (13, R) output.

    device: None = "cuda" (raises without a card); "cpu" runs the plain
    versions on the host.  The scene and the rays are moved there.

    light_samples: shadow rays per area light (the reference's
    -light_sample); point lights always take one, and area lights are
    refused by the gate for now, so nothing consumes it yet.

    Randomness: a glossy scene consumes one (3, R) unit-ball tensor per
    level.  `fuzz` supplies them (a sequence indexed by level); otherwise
    they are drawn from `generator`, which must live on the device.

    min_throughput: kill continuation rays whose path throughput falls at
    or below this value.  0.0 (default) = the reference's exact semantics.

    max_depth: recursion depth cutoff; None = the reference's
    MAX_RECURSION_DEPTH (10 -> 11 levels, Code/raytracer.hpp:11).

    tables: the scene's packed `wave_tables`, for a caller that traces many
    tiles of one scene.  level_fn: the level implementation, `wave_level`
    unless a check wants `wave_level_plain` on the same device.

    Scenes outside the fused level's scope raise NotImplementedError (see
    kernels/wavefront.py::wave_supported); there is no other path yet."""
    dev = torch.device("cuda" if device is None else device)
    origins = origins.to(dev, torch.float32)
    directions = directions.to(dev, torch.float32)
    times = times.to(dev, torch.float32)
    r = origins.shape[0]
    if max_depth is None:
        max_depth = C.MAX_RECURSION_DEPTH

    if scene.n_geoms == 0:
        # Nothing can be hit: every ray takes the background path.
        bg = torch.tensor(C.BACKGROUND_RGB, dtype=torch.float32, device=dev)
        result = (bg.expand(r, 3),)
        if return_stats:
            z = torch.zeros(1, dtype=torch.int32, device=dev)
            result += (
                TraceStats(live=torch.full_like(z, r), hits=z, spawned=z, dropped=z),
            )
        if return_levels:
            result += ([],)
        return result[0] if len(result) == 1 else result

    wave_supported(scene, use_bvh, differentiable)
    if tables is None:
        tables = wave_tables(scene.to(dev))
    if tables.glossy and fuzz is None and generator is None:
        raise ValueError("a glossy scene needs `fuzz` draws or a `generator`")
    levels = (max_depth + 1) if scene.has_reflection else 1
    return _trace_wave(
        tables, origins, directions, times, generator, fuzz, min_throughput,
        return_stats, levels, level_fn, return_levels,
    )
