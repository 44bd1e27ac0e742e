"""Iterative wavefront Whitted integrator.

The reference's recursive `Trace` (Code/raytracer.cpp:280-351) is a binary
recursion (reflection + refraction children) to depth 11.  Here the
recursion is flattened into 11 bounce passes, a Python loop over levels.

Two paths:

  FUSED (`_trace_wave`): one launch of the fused level kernel
    (kernels/wavefront.py) per level plus one accumulate.  It takes the
    scenes `wave_refusal` lets through (one-way refraction, motion blur,
    legacy planes, area lights and textured spheres among them); every ray
    has at most one continuation, which overwrites its own queue slot.

  GENERAL (`_trace_general`): each level is closest hit (brute-force
    kernel, render/intersect.py) -> material fetch -> Blinn-Phong with one
    shadow any-hit launch per light (render/shade.py) -> continuation
    spawn.  It takes every scene, two-way materials and use_bvh too.
    `fused=False` forces it.

The general path has two queue disciplines, chosen statically:

  IN-SLOT (branching factor 1 — no material both reflects and refracts):
    each ray has at most one continuation, which overwrites its own queue
    slot (`dest`, its primary sample).  At full width radiance accumulates
    elementwise into accum[slot]; a narrowed level (below) adds at `dest`.

  COMPACTED (some material reflects AND refracts, or compact="always"):
    slots carry an explicit dest index; both children are emitted and
    stream-compacted (a stable sort on the dead flag, which keeps order)
    into a queue of capacity R * queue_mult; radiance is folded back per
    dest in a fixed order (`_accumulate_by_dest`), so two renders give the
    same bits.  Overflow beyond capacity is dropped in compaction order —
    a documented deviation that only triggers on mirror+glass scenes
    deeper than log2(queue_mult) simultaneous branchings — and counted in
    TraceStats.dropped.

Live width (general path, whenever `shrink` is not empty): after each
level but the last, one host read finds the live lanes, and the next level
runs over them alone, so pass 2, materials, shading, the shadow launches
and spawn cost what the rays cost, not what the queue holds.  In-slot the
live lanes are gathered in slot order and keep `dest`, unique within a
level, so the adds by `dest` give every slot what it got at full width.
Compacted, `_compact` leaves them as the queue's first lanes: the level
takes that prefix, its candidates number twice the live count, and
overflow and `dropped` are what they were.  Draws from a generator are
still made at the full width and each lane takes its full-width slot's row
(`dest` in-slot, its queue position compacted), as do draws given as
tensors: one seed gives the same image bytes narrowed or not.  A queue
with no live lane ends the loop (the rest of TraceStats is zero; the levels
left still make their draws, so the generator ends where it would).  No lane
is ever dropped by it: the shrink pairs' levels and factors are the fused
path's and mean nothing here, and `shrink=()` keeps every level at full
width.

Level semantics (identical in all paths, all cited):
  - miss -> background 0.1 gray weighted by path throughput
    (Code/raytracer.cpp:296-298)
  - local shading weighted by throughput * max(0, 1 - refl - trans)
    (Code/raytracer.cpp:346-350)
  - children spawned at the depth-10 level are never traced: at depth 11
    the reference returns black (raytracer.cpp:290-292).

Differentiable rendering (`differentiable=True`) takes the same two
paths.  Fused: every level is `kernels/wavefront.py::WaveLevelFn` (the
kernel in record mode forward, the level rebuilt as tensor code from the
recorded decisions backward), and the bootstrap queue keeps its graph to
the origins and directions.  General: pass 2 of the closest hit, the
materials, shading (with the raw geometric visibility) and the spawn are
tensor code around the discrete kernels, each level under
`torch.utils.checkpoint`, so that autograd keeps a level's inputs, not its
intermediates; the level's random draws are made before it, so that the
recompute sees the same ones.  Hit decisions and visibility carry no
gradient on either path.

Queue shrink (fused path, the JAX package's `shrink`): bounce levels go
dead fast (the flagship is 6.3 % live entering level 2), so at the levels
of a schedule of (level, factor) pairs the queue is compacted into a
narrower width and the deeper levels run there.  The widths are the JAX
package's (each stage divides the last by its factor, rounded up to
WAVE_BLOCK lanes).  The compaction is per lane, in slot order (neighbouring
rays stay in one warp): the live lanes' nine queue rows are gathered, and
each kept lane carries `dest`, its slot in the full-width queue, composed
across stages.  Each shrunk level's contribution is added into the
full-width accumulator at `dest` on that level; `dest` is unique within a
stage, so every slot adds its contributions in the unshrunk order and the
radiance is bit for bit the unshrunk one whenever nothing is dropped (draws
given as tensors are gathered by `dest`; draws from a generator are made at
the stage's width, as the JAX package makes them).  A stage whose live
lanes overflow its width keeps the brightest (by throughput; ties by
slot), still in slot order, and counts the rest in TraceStats.dropped at
that level.  One host read of the live count a shrink point.

Not ported: the JAX package's group-granular shrink (`WAVE_SHRINK_GROUP`,
which exists because TPU scatters serialize) and its `segments` gating
(measured slower there and off by default).  `use_bvh` belongs to the
general path: it sends a scene off the fused path, whose level searches
its own table.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.utils.checkpoint

from ray_tracying_tpu_torch import spans
from ray_tracying_tpu_torch.core import constants as C
from ray_tracying_tpu_torch.core.sampling import uniform_in_unit_sphere
from ray_tracying_tpu_torch.core.vecmath import dot, normalize, reflect, refract
from ray_tracying_tpu_torch.kernels.wavefront import (
    C_BASE,
    HIT_ROW,
    Q_ROWS,
    WaveLevelFn,
    WaveTables,
    wave_level,
    wave_refusal,
    wave_supported,
    wave_tables,
)
from ray_tracying_tpu_torch.render.intersect import closest_hit
from ray_tracying_tpu_torch.render.materials import gather_materials
from ray_tracying_tpu_torch.render.shade import shade
from ray_tracying_tpu_torch.scene.types import Scene


class _Queue(NamedTuple):
    o: torch.Tensor       # (Cap, 3)
    d: torch.Tensor       # (Cap, 3)
    time: torch.Tensor    # (Cap,)
    tp: torch.Tensor      # (Cap,) scalar throughput
    dest: torch.Tensor    # (Cap,) int64 primary-sample index
    active: torch.Tensor  # (Cap,) bool


class TraceStats(NamedTuple):
    """Per-level integrator counters (one entry per bounce level)."""

    live: torch.Tensor     # (L,) int32 — active queue slots entering the level
    hits: torch.Tensor     # (L,) int32 — rays that hit geometry this level
    spawned: torch.Tensor  # (L,) int32 — continuations emitted by this level
    dropped: torch.Tensor  # (L,) int32 — continuations lost to queue overflow


def _pack_result(radiance, stats, dropped, levels, return_stats,
                 return_dropped, return_levels):
    """(radiance[, TraceStats | dropped count][, level outputs])."""
    result = (radiance,)
    if return_stats:
        result += (stats,)
    elif return_dropped:
        result += (dropped,)
    if return_levels:
        result += (levels,)
    return result[0] if len(result) == 1 else result


# ---------------------------------------------------------------------------
# Fused-level path
# ---------------------------------------------------------------------------

def level_fuzz(
    tables: WaveTables, generator: Optional[torch.Generator], width: int, device,
    glossy: Optional[torch.Tensor] = None,
    jitter: Optional[Sequence[Optional[torch.Tensor]]] = None,
) -> Optional[torch.Tensor]:
    """The unit-ball rows of one level, sampled outside the kernel, in the
    kernel's layout (kernels/wavefront.py): (3, width) glossy fuzz when the
    scene is glossy, then 3 * nss rows per area light in light order (rows
    3k..3k+2 its sample k); None for a scene with neither.

    glossy: the (3, width) glossy draws, jitter[light]: an area light's
    (width, nss, 3) draws, when given; the rest comes from `generator`, in
    the general path's order (each area light's jitter in light order,
    then the glossy fuzz), so that one seed gives both paths the same
    draws."""
    if not (tables.glossy or any(tables.area)):
        return None
    area_rows = []
    for li, is_area in enumerate(tables.area):
        if not is_area:
            continue
        ball = jitter[li] if jitter is not None else uniform_in_unit_sphere(
            generator, (width, tables.nss), device=device)
        area_rows.append(ball.permute(1, 2, 0).reshape(3 * tables.nss, width))
    if tables.glossy and glossy is None:
        glossy = uniform_in_unit_sphere(generator, (width,), device=device).T
    return torch.cat(([glossy] if tables.glossy else []) + area_rows).contiguous()


# The fused path's queue-shrink schedules, the JAX package's
# (render/integrator.py): (level, factor) pairs applied cumulatively.
# AUTO: levels 0-1 at full width, 2-3 at 1/4, 4 and deeper at 1/8.
# SPARSE, for low sample counts: 1/2 at level 2, 1/4 at 4, 1/8 at 6.
WAVE_SHRINK_AUTO = ((2, 4), (4, 2))
WAVE_SHRINK_SPARSE = ((2, 2), (4, 2), (6, 2))
# A stage's width is a multiple of this many lanes (the JAX kernel's
# block), so that the port's widths are the JAX package's.
WAVE_BLOCK = 2048


def shrink_schedule(shrink):
    """The (level, factor) pairs of a `shrink` argument: "auto" is
    WAVE_SHRINK_AUTO, () or None no shrink."""
    if isinstance(shrink, str):
        if shrink != "auto":
            raise ValueError(f"shrink must be 'auto', () or (level, factor) pairs, not {shrink!r}")
        return WAVE_SHRINK_AUTO
    return tuple(shrink or ())


def shrink_plan(r: int, levels: int, shrink):
    """(bounds, widths) of the stages of a fused trace of r rays: stage s
    runs levels bounds[s] .. bounds[s + 1] - 1 at widths[s] lanes (stage 0
    at the full width, for which widths[0] is r rounded up to WAVE_BLOCK).
    A pair that cannot narrow the WAVE_BLOCK-rounded width, or lies outside
    levels 1 .. levels - 1, is left out (the JAX package's plan)."""
    sched = sorted((lv, f) for lv, f in shrink_schedule(shrink) if 0 < lv < levels and f > 1)
    bounds = [0]
    widths = [-(-r // WAVE_BLOCK) * WAVE_BLOCK]
    for lv, f in sched:
        w = max(WAVE_BLOCK, -(-(widths[-1] // f) // WAVE_BLOCK) * WAVE_BLOCK)
        if w < widths[-1] and lv > bounds[-1]:
            bounds.append(lv)
            widths.append(w)
    bounds.append(levels)
    return bounds, widths


class Levels(list):
    """The level outputs of a fused trace (`return_levels`), each at the
    width it ran.  dest[lv]: None for a full-width level; for a shrunk
    one, an int64 tensor of its width holding each lane's slot in the
    full-width queue (-1 for a lane that carries no ray)."""

    def __init__(self, outs=(), dest=()):
        super().__init__(outs)
        self.dest = list(dest)


def _shrink(prev, capacity: int, dest):
    """Compact the live lanes of `prev` (a level's output) into a queue of
    `capacity` lanes, per lane in slot order.  On overflow the `capacity`
    brightest by throughput (ties by slot) are kept, still in slot order.
    Returns (queue (9, capacity), kept slots' dest, dropped count); one
    host read."""
    live = prev[7] > 0
    with spans.read("shrink live lanes"):
        idx = torch.nonzero(live).squeeze(1)
    dropped = max(0, idx.numel() - capacity)
    if dropped:
        key = torch.where(live, -prev[8].detach(), torch.inf)
        idx = torch.sort(torch.sort(key, stable=True).indices[:capacity]).values
    q = prev[:Q_ROWS].index_select(1, idx)
    pad = torch.zeros((Q_ROWS, capacity - idx.numel()), dtype=q.dtype, device=q.device)
    return torch.cat([q, pad], dim=1), (idx if dest is None else dest[idx]), dropped


def _gather_draws(x, dest, width: int, dim: int):
    """The full-width draws `x` of the lanes `dest`, along `dim`, padded
    with zeros to `width`."""
    if x is None or dest is None:
        return x
    g = x.index_select(dim, dest)
    shape = list(g.shape)
    shape[dim] = width - dest.numel()
    return torch.cat([g, g.new_zeros(shape)], dim=dim)


def _trace_wave(
    tables: WaveTables, o, d, times, generator, fuzz, light_jitter, min_tp,
    return_stats, levels, level_fn, return_levels, return_dropped,
    differentiable=False, shrink=(),
):
    """Fused-level path, in-slot, shrunk at the levels of `shrink` (module
    docstring).  differentiable: every level is a `WaveLevelFn` (record
    mode), the radiance is summed out of place (the gathers and the adds by
    dest keep the graph), and the bootstrap queue keeps its graph."""
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
    bounds, widths = shrink_plan(r, levels, shrink)
    stage_of = {lv: w for lv, w in zip(bounds[1:-1], widths[1:])}
    dest = None        # kept lanes' full-width slots (None at full width)
    stat_rows = []
    drops = [0] * levels
    outs = Levels()
    for depth in range(levels):
        if depth in stage_of:
            with spans.span("rtt.shrink") as sp:
                prev, dest, drops[depth] = _shrink(prev, stage_of[depth], dest)
                sp.add(kept=dest.numel(), dropped=drops[depth])
        width = prev.shape[1]
        kept = None if dest is None else dest.numel()
        with spans.span("rtt.level", depth=depth, lanes=width):
            jitter = None
            if light_jitter is not None:
                jitter = [_gather_draws(j, dest, width, 0) for j in light_jitter[depth]]
            with spans.span("rtt.fuzz"):
                fz = level_fuzz(
                    tables, generator, width, dev,
                    glossy=None if fuzz is None else _gather_draws(fuzz[depth], dest, width, 1),
                    jitter=jitter,
                )
            if differentiable:
                out = WaveLevelFn.apply(prev, fz, tables.table, tables.lights, tables, min_tp)
                contrib = out[C_BASE : C_BASE + 3]
                accum = (accum + contrib if dest is None
                         else accum.index_add(1, dest, contrib[:, :kept]))
            else:
                out = level_fn(prev, fz, tables, min_tp)
                if dest is None:
                    accum += out[C_BASE : C_BASE + 3]
                else:
                    accum.index_add_(1, dest, out[C_BASE : C_BASE + 3, :kept])
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
            outs.dest.append(None if dest is None else torch.cat(
                [dest, dest.new_full((width - kept,), -1)]))
        prev = out
    stats = None
    drop_t = torch.tensor(drops, dtype=torch.int32, device=dev)
    if return_stats:
        st = torch.stack(stat_rows, dim=1).to(torch.int32)  # (3, L)
        stats = TraceStats(st[0], st[1], st[2], drop_t)
    return _pack_result(
        accum.T.contiguous(), stats, drop_t.sum(dtype=torch.int32), outs, return_stats,
        return_dropped, return_levels,
    )


# ---------------------------------------------------------------------------
# General path
# ---------------------------------------------------------------------------

def _compact(cands: _Queue, keep: torch.Tensor, capacity: int):
    """Stream-compact candidate slots where keep is True into a queue of
    `capacity` slots (fewer when there are fewer candidates), keeping their
    order; overflow beyond capacity is dropped in order.  Returns (queue,
    dropped) where dropped counts the lost continuations (always surfaced
    through TraceStats so the loss cannot be silent).  One stable sort on
    the dead flag; no host read."""
    n_keep = keep.sum()
    count = torch.clamp(n_keep, max=capacity)
    dropped = n_keep - count
    order = torch.sort((~keep).to(torch.uint8), stable=True).indices[:capacity]
    q = _Queue(
        o=cands.o[order],
        d=cands.d[order],
        time=cands.time[order],
        tp=cands.tp[order],
        dest=cands.dest[order],
        active=torch.arange(order.numel(), device=keep.device) < count,
    )
    return q, dropped


def _cat(queues) -> _Queue:
    return _Queue(*(torch.cat(f, dim=0) for f in zip(*queues)))


def _live_lanes(q: _Queue, prefix: bool) -> _Queue:
    """The queue narrowed to its live lanes, in slot order.  prefix: they
    are its first lanes (a compacted queue), read their count and slice;
    else read their slots and gather.  One host read."""
    with spans.read("general live lanes"):
        if prefix:
            n = int(q.active.sum())
        else:
            idx = torch.nonzero(q.active).squeeze(1)
    return _Queue(*(f[:n] if prefix else f.index_select(0, idx) for f in q))


def _take(x, slots):
    """The rows `slots` of the full-width draws x (x itself at full width)."""
    return x if x is None or slots is None else x.index_select(0, slots)


def _accumulate_by_dest(accum, contrib, dest, active, max_run: int):
    """accum[dest] += contrib over the active slots, in an order that is
    the same on every run: an atomic scatter-add would add a dest's several
    contributions in whatever order the blocks retire, and two renders of
    one scene could differ in the last bit.

    accum: (R + 1, 3), row R is the sink of inactive slots.  max_run: the
    most slots one dest can hold (1 on level 0, doubling per level of a
    two-way scene).  The slots are stable-sorted by dest; a segmented
    suffix sum in ceil(log2(max_run)) doubling steps leaves each dest's
    total in the first slot of its run; every other slot then adds an exact
    0.0, so the scatter's order no longer matters."""
    sink = accum.shape[0] - 1
    dd, order = torch.sort(torch.where(active, dest, sink), stable=True)
    v = contrib[order]
    step = 1
    while step < max_run:
        same = (dd[step:] == dd[:-step])[:, None]
        v = torch.cat([v[:-step] + torch.where(same, v[step:], 0.0), v[-step:]])
        step *= 2
    first = torch.ones_like(dd, dtype=torch.bool)
    first[1:] = dd[1:] != dd[:-1]
    return accum.index_add(0, dd, torch.where(first[:, None], v, 0.0))


def _spawn_reflection(scene, q, hit, mrec, act, fuzz, min_tp):
    """Reflection continuation (Code/raytracer.cpp:307-333).  fuzz: (Cap, 3)
    unit-ball draws when the scene is glossy."""
    rdir = reflect(q.d, hit.normal)
    if scene.has_glossy:
        # Glossy fuzz: normalize(R + roughness * unit_sphere); rays
        # perturbed below the surface are absorbed (raytracer.cpp:312-327).
        pert = normalize(rdir + mrec.roughness[:, None] * fuzz)
        pert = torch.where(
            (dot(pert, hit.normal) < 0.0)[:, None], torch.zeros_like(pert), pert
        )
        rdir = torch.where((mrec.roughness > 0.0)[:, None], pert, rdir)
    tp = q.tp * mrec.reflectivity
    ok = act & (mrec.reflectivity > 0.0) & (dot(rdir, rdir) > C.EPS_GLOSSY_DIR2)
    if min_tp > 0.0:
        ok = ok & (tp > min_tp)
    return _Queue(
        o=hit.point + hit.normal * C.EPS_NORMAL_OFFSET,
        d=rdir,
        # Secondary rays carry time = 0 (Ray default, Code/shapes.hpp:28).
        time=torch.zeros_like(q.time),
        tp=tp,
        dest=q.dest,
        active=ok,
    )


def _spawn_refraction(scene, q, hit, mrec, act, min_tp):
    """Refraction continuation (Code/raytracer.cpp:335-344).  Lanes whose
    material does not refract (their continuation is dropped below) take
    index 1: a miss's index of 0 would give an infinite direction, whose
    zero cotangent turns the differentiable path's gradients into NaN."""
    ior = torch.where(mrec.transparency > 0.0, mrec.ior, 1.0)
    tdir, n_eff = refract(q.d, hit.normal, ior)
    tp = q.tp * mrec.transparency
    ok = act & (mrec.transparency > 0.0) & (dot(tdir, tdir) > C.EPS_REFRACT_DIR2)
    if min_tp > 0.0:
        ok = ok & (tp > min_tp)
    return _Queue(
        o=hit.point - n_eff * C.EPS_NORMAL_OFFSET,
        d=tdir,
        time=torch.zeros_like(q.time),
        tp=tp,
        dest=q.dest,
        active=ok,
    )


def _spawn_one_way(scene, q, hit, mrec, act, fuzz, min_tp):
    """At-most-one continuation per ray: reflection-only and
    refraction-only scenes spawn their single kind; MIXED one-way scenes
    (mirrors and glass on DIFFERENT materials, scene.has_two_way False)
    pick per lane by the hit material — transparency > 0 takes the
    refraction branch, else reflectivity > 0 the reflection branch.  Both
    stay in-slot because no lane ever emits two children."""
    if scene.has_reflection and not scene.has_refraction:
        return _spawn_reflection(scene, q, hit, mrec, act, fuzz, min_tp)
    if scene.has_refraction and not scene.has_reflection:
        return _spawn_refraction(scene, q, hit, mrec, act, min_tp)
    q_refl = _spawn_reflection(scene, q, hit, mrec, act, fuzz, min_tp)
    q_refr = _spawn_refraction(scene, q, hit, mrec, act, min_tp)
    use_refr = mrec.transparency > 0.0
    return _Queue(
        *(
            torch.where(use_refr[:, None] if a.dim() == 2 else use_refr, a, b)
            for a, b in zip(q_refr, q_refl)
        )
    )


def _trace_general(
    scene: Scene, o, d, times, generator, fuzz, light_jitter, light_samples,
    queue_mult, do_compact, min_tp, max_depth, return_stats, return_dropped,
    use_bvh=False, differentiable=False, narrow=False,
):
    """General path: closest hit -> materials -> shade -> spawn, level by
    level, in-slot or compacted (module docstring).  narrow: every level
    after the first runs at its live width (module docstring), one host read
    before it; else no host read inside the level loop.  differentiable:
    pass 2 and shading keep their graph, each level runs under
    torch.utils.checkpoint, and its draws are made before it (area-light
    jitter in light order, then the glossy fuzz: the order in which the
    inference level draws them)."""
    r = o.shape[0]
    dev = o.device
    f32 = dict(dtype=torch.float32, device=dev)
    two_way = scene.has_two_way
    spawn = scene.has_reflection or scene.has_refraction
    capacity = r * queue_mult if two_way else r
    bg = torch.tensor(C.BACKGROUND_RGB, **f32)

    pad = capacity - r
    q = _Queue(
        o=torch.cat([o, torch.zeros((pad, 3), **f32)]),
        d=torch.cat([d, torch.zeros((pad, 3), **f32)]),
        time=torch.cat([times, torch.zeros(pad, **f32)]),
        tp=torch.cat([torch.ones(r, **f32), torch.zeros(pad, **f32)]),
        dest=torch.cat(
            [torch.arange(r, device=dev), torch.zeros(pad, dtype=torch.int64, device=dev)]
        ),
        active=torch.arange(capacity, device=dev) < r,
    )
    # Row r of the compacted accumulator is the sink of inactive slots.
    accum = torch.zeros((r + 1 if do_compact else r, 3), **f32)
    zero_count = torch.zeros((), dtype=torch.int64, device=dev)

    def level(depth, jitter, fz, narrowed, accum, *fields):
        q = _Queue(*fields)
        with spans.span("rtt.hit"):
            hit = closest_hit(
                scene, q.o, q.d, q.time, q.active, use_bvh, differentiable=differentiable
            )
        act = q.active & hit.valid
        missed = q.active & ~hit.valid
        with spans.span("rtt.materials"):
            mrec = gather_materials(scene, hit.geom_id)
        with spans.span("rtt.shade"):
            local = shade(
                scene, hit, q.o, generator, light_samples, mrec, act, use_bvh,
                jitter=jitter, differentiable=differentiable,
            )
        local_w = torch.clamp(1.0 - mrec.reflectivity - mrec.transparency, min=0.0)
        w_miss = torch.where(missed, q.tp, 0.0)[:, None]
        w_local = torch.where(act, q.tp * local_w, 0.0)[:, None]
        contrib = w_miss * bg + w_local * torch.where(
            act[:, None], local, torch.zeros_like(local)
        )
        if do_compact:
            max_run = min(2 ** depth, capacity) if two_way else 1
            accum = _accumulate_by_dest(accum, contrib, q.dest, q.active, max_run)
        elif narrowed:
            # In-slot, each dest once a level: every slot adds what it
            # added at full width.
            accum = accum.index_add(0, q.dest, contrib)
        else:
            accum = accum + contrib
        live_in = q.active.sum()
        n_hit = act.sum()

        with spans.span("rtt.spawn"):
            if spawn and scene.has_glossy and fz is None:
                fz = uniform_in_unit_sphere(generator, (capacity,), device=dev)
            dropped = zero_count
            if not spawn:
                spawned = zero_count
            elif do_compact and two_way:
                cand = _cat(
                    [
                        _spawn_reflection(scene, q, hit, mrec, act, fz, min_tp),
                        _spawn_refraction(scene, q, hit, mrec, act, min_tp),
                    ]
                )
                spawned = cand.active.sum()
                q, dropped = _compact(cand, cand.active, capacity)
            else:
                q = _spawn_one_way(scene, q, hit, mrec, act, fz, min_tp)
                spawned = q.active.sum()
                if do_compact:
                    q, dropped = _compact(q, q.active, capacity)
        return (accum, torch.stack([live_in, n_hit, spawned, dropped])) + tuple(q)

    levels = (max_depth + 1) if spawn else 1
    is_area = scene.lights.is_area

    def generator_draws(slots):
        """(area-light jitter, glossy fuzz) of a level that `generator`
        supplies, made at the full width in the order in which the level
        makes them, each lane taking the rows `slots`."""
        jitter = fz = None
        if light_jitter is None and any(is_area):
            jitter = [
                _take(uniform_in_unit_sphere(
                    generator, (capacity, light_samples), device=dev), slots)
                if area else None
                for area in is_area
            ]
        if spawn and scene.has_glossy and fuzz is None:
            fz = _take(uniform_in_unit_sphere(generator, (capacity,), device=dev), slots)
        return jitter, fz

    rows = []
    slots = None  # each lane's row of the full-width draws; None at full width
    for depth in range(levels):
        if depth and narrow:
            q = _live_lanes(q, do_compact)
            if q.o.shape[0] == 0:
                # The levels left still draw, so that the generator ends
                # where a full-width trace leaves it (a frame's next tile
                # draws on from there).
                for _ in range(depth, levels):
                    generator_draws(None)
                rows += [torch.zeros(4, dtype=torch.int64, device=dev)] * (levels - depth)
                break
            slots = torch.arange(q.o.shape[0], device=dev) if do_compact else q.dest
        jitter = None
        if light_jitter is not None:
            jitter = [_take(j, slots) if a else None for j, a in zip(light_jitter[depth], is_area)]
        fz = None
        if spawn and scene.has_glossy and fuzz is not None:
            fz = _take(fuzz[depth].T, slots)
        with spans.span("rtt.level", depth=depth, lanes=q.o.shape[0]):
            if differentiable or slots is not None:
                # Draws made before the level: the recompute of a
                # checkpointed level sees the same ones, and a narrowed
                # level takes its lanes' rows.
                drawn = generator_draws(slots)
                jitter = drawn[0] if jitter is None else jitter
                fz = drawn[1] if fz is None else fz
            if differentiable:
                res = torch.utils.checkpoint.checkpoint(
                    level, depth, jitter, fz, slots is not None, accum, *q,
                    use_reentrant=False,
                )
            else:
                res = level(depth, jitter, fz, slots is not None, accum, *q)
        accum, row, q = res[0], res[1], _Queue(*res[2:])
        del res  # else the full-width queue outlives its narrowing
        rows.append(row)

    st = torch.stack(rows, dim=1).to(torch.int32)  # (4, L)
    return _pack_result(
        accum[:r], TraceStats(st[0], st[1], st[2], st[3]), st[3].sum(), None,
        return_stats, return_dropped, False,
    )


def trace_wavefront(
    scene: Scene,
    origins: torch.Tensor,     # (R, 3)
    directions: torch.Tensor,  # (R, 3) unit
    times: torch.Tensor,       # (R,)
    light_samples: int = 1,
    queue_mult: int = 2,
    *,
    generator: Optional[torch.Generator] = None,
    fuzz: Optional[Sequence[torch.Tensor]] = None,
    light_jitter: Optional[Sequence[Sequence[Optional[torch.Tensor]]]] = None,
    use_bvh: bool = False,
    min_throughput: float = 0.0,
    compact: str = "auto",
    differentiable: bool = False,
    return_stats: bool = False,
    max_depth: Optional[int] = None,
    return_dropped: bool = False,
    fused: Optional[bool] = None,
    device=None,
    tables: Optional[WaveTables] = None,
    level_fn=wave_level,
    return_levels: bool = False,
    shrink="auto",
):
    """Trace R primary rays to completion.  Returns (R, 3) radiance; with
    return_stats also a TraceStats of per-level live/hit/spawn/drop
    counters; with return_dropped (and no stats) also the count of dropped
    continuations as a 0-d tensor; with return_levels (fused path only)
    also a `Levels` list of every level's (13, width) output (with the
    record rows when differentiable), each at the width it ran, and its
    `dest` (the lanes' full-width slots on a shrunk level).

    device: None = "cuda" (raises without a card); "cpu" runs the plain
    versions on the host.  The scene and the rays are moved there.

    fused: None = the fused level path when `wave_refusal` lets the scene
    through, else the general path; False forces the general path; True
    forces the fused path and raises NotImplementedError, naming the
    feature, for a scene it does not take.

    light_samples: shadow rays per area light (the reference's
    -light_sample); point lights always take one.

    queue_mult: capacity of the compacted queue of a two-way scene, in
    multiples of R.  compact: "always" stream-compacts the continuation
    queue of the general path every level; "auto"/"never" keep one-way
    continuations in their own slots.  Two-way (mirror+glass on one
    material) scenes always compact: the queue physically grows.
    Compaction only permutes queue slots, so deterministic scenes give the
    same image either way.

    Randomness goes in as tensors or comes from `generator`, which must
    live on the device.  A glossy scene consumes one unit-ball tensor per
    level: `fuzz` is a sequence indexed by level of (3, width) tensors,
    width = R (or R * queue_mult on a two-way scene).  An area light
    consumes one (width, light_samples, 3) unit-ball tensor per level:
    `light_jitter[level][light]`.  Both paths take the same tensors (the
    fused one lays them out as its fuzz rows, `level_fuzz`), and from one
    generator both draw them in the same order.

    min_throughput: kill continuation rays whose path throughput falls at
    or below this value.  0.0 (default) = the reference's exact semantics.

    shrink: the fused path's queue-shrink schedule (module docstring):
    "auto" (default) is WAVE_SHRINK_AUTO, () turns it off, or explicit
    ((level, factor), ...) pairs.  With nothing dropped the radiance is the
    unshrunk one bit for bit (draws given as tensors; from a generator the
    shrunk levels draw at their width); a live lane past a stage's width is
    dropped dimmest first and counted in TraceStats.dropped.  On the
    general path any non-empty schedule runs every level after the first
    at its live width, losing nothing, and () keeps the full width: the
    same image either way, for one seed too (module docstring).

    max_depth: recursion depth cutoff; None = the reference's
    MAX_RECURSION_DEPTH (10 -> 11 levels, Code/raytracer.hpp:11).

    tables: the scene's packed `wave_tables`, for a caller that traces many
    tiles of one scene down the fused path.  level_fn: the fused level
    implementation, `wave_level` unless a check wants `wave_level_plain`
    on the same device (differentiable mode always runs `WaveLevelFn`).

    use_bvh: closest hits of the general path go through the LBVH
    traversal kernel when the scene carries a BVH (accel.lbvh.with_bvh)
    and fits the brute kernels' cap; the same hit set.  It sends the scene
    off the fused path; with fused=True it raises by name.

    differentiable: the radiance keeps its autograd graph to the scene's
    tensors (materials, transforms, lights) and to the origins and
    directions (module docstring).  The fused path takes every scene
    `wave_refusal` lets through (its level in record mode, `tables` packed
    with their graph when not given), with the inference image bit for
    bit; the general path the rest, its hits rebuilt by pass 2."""
    dev = torch.device("cuda" if device is None else device)
    origins = origins.to(dev, torch.float32)
    directions = directions.to(dev, torch.float32)
    times = times.to(dev, torch.float32)
    r = origins.shape[0]
    if max_depth is None:
        max_depth = C.MAX_RECURSION_DEPTH
    if compact not in ("auto", "never", "always"):
        raise ValueError(f"compact must be auto, never or always, not {compact!r}")
    shrink = shrink_schedule(shrink)

    if scene.n_geoms == 0:
        # Nothing can be hit: every ray takes the background path.
        bg = torch.tensor(C.BACKGROUND_RGB, dtype=torch.float32, device=dev)
        z = torch.zeros(1, dtype=torch.int32, device=dev)
        stats = TraceStats(live=torch.full_like(z, r), hits=z, spawned=z, dropped=z)
        return _pack_result(
            bg.expand(r, 3), stats, z[0], [], return_stats, return_dropped,
            return_levels,
        )

    if fused is True:
        # A forced fused path raises for what it does not take.
        wave_supported(scene, use_bvh, light_samples)
    if fused is True and compact == "always":
        raise ValueError("compact='always' belongs to the general path, not to fused=True")
    spawn = scene.has_reflection or scene.has_refraction
    if generator is None:
        if scene.has_glossy and spawn and fuzz is None:
            raise ValueError("a glossy scene needs `fuzz` draws or a `generator`")
        if any(scene.lights.is_area) and light_jitter is None:
            raise ValueError("an area light needs `light_jitter` draws or a `generator`")

    if (
        fused is not False
        and compact != "always"
        and wave_refusal(scene, use_bvh, light_samples) is None
    ):
        if tables is None:
            with spans.span("rtt.prep"):
                tables = wave_tables(scene.to(dev), differentiable=differentiable,
                                     light_samples=light_samples)
        elif any(tables.area) and tables.nss != light_samples:
            raise ValueError(
                f"tables packed for {tables.nss} samples an area light, "
                f"traced with light_samples={light_samples}"
            )
        levels = (max_depth + 1) if spawn else 1
        return _trace_wave(
            tables, origins, directions, times, generator, fuzz, light_jitter,
            min_throughput, return_stats, levels, level_fn, return_levels,
            return_dropped, differentiable, shrink,
        )

    if return_levels:
        raise ValueError(
            "return_levels belongs to the fused path; the general path has no level tensor"
        )
    do_compact = (compact == "always" or scene.has_two_way) and spawn
    return _trace_general(
        scene.to(dev), origins, directions, times, generator, fuzz,
        light_jitter, light_samples, queue_mult, do_compact, min_throughput,
        max_depth, return_stats, return_dropped, use_bvh, differentiable, bool(shrink),
    )
