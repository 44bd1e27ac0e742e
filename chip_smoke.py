#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Drives the port's main paths through the public entry points: the flagship
render (golden/ASCII/scene.json at 1920x1080 with 4x4 samples per pixel, 11
bounce levels) down the fused level path and, forced with fused=False, down
the general path (closest hit, pass 2, materials, shading with one shadow
any-hit launch per light, spawn), and the general path's other branches on
their own scenes (the two-way queue; area lights in cornell's general frame),
and the acceleration
path: a 20,001-geom procedural scene whose table does not fit a block's
shared memory (chunk kernels) and a 2,049-geom one rendered with and
without `use_bvh` (BVH traversal) and down the fused level's wide build (the
routing of a table over what a block stages, up to 6,144 geoms), all at
1920x1080.  It builds the CUDA
kernels from the sources of this checkout, holds each kernel against its
plain PyTorch version on the card (the fused level bit for bit on every
level of a full-width flagship tile), measures the fused level's kernel
against the one-thread-per-lane schedule of the same stages in turns
(phase wave_redesign_ab: per level, and one flagship frame each, byte-equal),
the package's route (a window cull over the staged table, windows and
rows) against the staged build, which every culled build is held to, and
against the two wide builds on the flagship's table (phase
wave_build_ab: per level, bit-equal, record mode too), every fused golden
and the flagship tile traced by both (phase staged_goldens, tile_breakdown:
radiance torch.equal), the flagship frame by the route before the window
cull in turns (main_path), each table's window cull against the staged
build (or, past what it takes, the unculled one) on every lane of every
level (phase wide_window_ab: torch.equal, record mode too, in turns, with
the tests a lane its counting build ran),
the warp schedule of the three chunk kernels against the one-thread-per-lane
sweep it replaced (phase sweep_redesign_ab: level-0, level-1 and shadow rays
of the 20,001-geom scene, plain and textured, bit-equal) and the shadow
any-hit's persistent warps against its one-thread-per-lane kernel (phase
anyhit_redesign_ab: the 2,049-geom scene's level-0 and level-1 shadow rays
and the flagship tile's, bit-equal), the same for the two brute closest hits
(phase brute_redesign_ab: the flagship tile's level-0 rays and the 2,049-geom
scene's level-0 and level-1 rays, bit-equal), and times every closest-hit and
any-hit launch of one frame of each large scene by each schedule (phase
accel_tile_breakdown, the frames byte-equal); it
checks twelve images against the reference renderer's goldens, each down
the path the routing must take.  Phase fused_widened drives the fused
level's specialisations at 1920x1080 (cornell: legacy planes, one-way glass,
an area light at 4 samples; the motion demo; a textured 1,501-geom
sphere_field: spherical UV; the wide build on cube_city's 2,049 geoms and a
textured 3,001-geom sphere_field): the kernel against its plain version on
every level of a full-width tile (the wide tables on one live lane in 64),
level 0 against its bound, and one frame down each path; phase wide_edge
runs levels 0 and 1 of a 6,144-geom table, the gate's edge.  The
differentiable path (diff/): the level kernel in record mode on every level
of a full-width flagship tile (rows 0..12 equal to the inference launch, the
record rows to the plain version; phase diff_record), fused against general
gradients on a strip (the flagship, cornell, motion), the whole frame at 1 spp and the 4x4-spp frame in
tiles forward and backward, and three steps of fit with a checkpoint resumed
(phase diff_path).  Phase shrink takes the fused path's queue shrink apart
on a full-width flagship tile (the radiance torch.equal with and without it,
each level's launch at its width against full width, the compactions, the
frame both ways in turns); phase cli runs `python -m
ray_tracying_tpu_torch.cli` in a subprocess (its PPM the API's bytes), and
phase native times the host LBVH build and PPM writer against their plain
versions.  Phase sharded drives parallel/ and entry.py: a flagship tile traced
sharded over NCCL at world size 1 and over two gloo ranks sharing the card
(spawned processes), each torch.equal to the unsharded trace, the sharded
record-mode step's all-reduced gradients against one process, entry() and
dryrun_multichip(1).  It prints one JSON line per phase, each with the script's
seconds so far (t_s).  Any failure exits non-zero; nothing is caught.

    python3 chip_smoke.py

Needs one CUDA device, nvcc, and no network.  Without a device it exits 1
and prints no result.  The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import ctypes
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# Published peaks of one H100 SXM (NVIDIA data sheet): f32 outside the
# tensor cores, and HBM3 bandwidth.  The roofline bound is stated against
# these whatever the card's power limit, which is printed beside it.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# f32 operations (add, sub, mul, div, sqrt, compare, min, max, abs; selects
# and mask logic excluded) of ONE geom test in the plain version, kernels/closest_hit.py:
# the world->object transform (18 + 15) plus the kind's own test; the
# legacy plane (kind 3) has no transform, and its per-row normal is scalar
# work that is not counted.
FLOPS_PER_TEST = {0: 33 + 38, 1: 33 + 45, 2: 33 + 15, 3: 133}
# The acceleration path's sizes: a procedural scene over the shared-memory
# cap and one under it, at the flagship's resolution; the plain versions
# run on every 64th ray of a full-width tile.
ACCEL_SIZES = dict(spheres=20000, cubes=2048, res=(1920, 1080), stride=64, strip_rows=32)

# f32 operations of one bare AABB slab test, which is all the function
# needs: per axis two subtractions, two scalings by 1 / d, min, max and the
# two running bounds (8), then the three final compares and one multiply.
# The slack with which the kernels grow a box (csrc/geom.cuh::box_hit) is
# their own guard and no part of the bound; the needed box tests are counted
# against the exact boxes.
FLOPS_PER_BOX_TEST = 28
# f32 operations of the shading of one hit lane, besides its geom tests
# (normalize, per light Blinn-Phong + attenuation, UV, texel, spawn).
FLOPS_PER_HIT_LANE = 300

# Tolerances of kernel against plain version, both on the card, built with
# --fmad=false so that both do the same f32 operations in the same order.
# Float rows (rtol/atol, the bar the JAX package holds its own fused path
# to): what is left is the device math library inside PyTorch's own
# kernels against the kernel's (exp, log) and cascaded last-bit effects
# over 11 levels.  A lane whose decisions (act, act_hit) flip, or whose
# float rows leave the tolerance, disagrees; the share of lanes allowed to
# is stated and printed.  Measured (phase fma_variant below, H100): the
# --fmad=false build equals the plain version bit for bit on 8.4M lanes;
# an FMA build puts 7e-6 of the lanes on another winner, which this share
# refuses.
RTOL, ATOL = 2e-5, 2e-6
MAX_FLIP_SHARE = 1e-6


_T0 = time.time()


def say(phase, **kw):
    """One JSON line of a phase; t_s is the script's seconds so far."""
    print(json.dumps({"phase": phase, "t_s": round(time.time() - _T0, 1), **kw}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_level(a, b, tainted=None):
    """Kernel output a against plain output b, (13, R) each.  A lane
    disagrees when its act or act_hit differ (a flipped decision) or a
    float row is out of tolerance; once it has, it stays `tainted` for the
    deeper levels of the same trace, where it carries another ray.  Errors
    are taken over the lanes not tainted before and not flipped now.
    Returns (result dict, tainted mask); the count of tainted lanes is
    what MAX_FLIP_SHARE bounds."""
    if tainted is None:
        tainted = torch.zeros(a.shape[1], dtype=torch.bool, device=a.device)
    flip = (a[7] != b[7]) | (a[12] != b[12])
    keep = ~(flip | tainted)
    diff = (a - b).abs()
    bad = (diff > (ATOL + RTOL * b.abs())).any(dim=0)
    diff = diff[:, keep]
    ref = b.abs()[:, keep]
    new_tainted = tainted | flip | bad
    n_tainted = int(new_tainted.sum())
    return dict(
        max_abs_err=float(diff.max()) if diff.numel() else 0.0,
        max_rel_err=float((diff / ref.clamp(min=1e-6)).max()) if diff.numel() else 0.0,
        flipped_lanes=int((flip & ~tainted).sum()),
        out_of_tol_lanes=int((bad & keep).sum()),
        disagreeing_lanes_so_far=n_tainted,
        bitwise_equal=bool(torch.equal(a, b)),
        ok=n_tainted <= MAX_FLIP_SHARE * a.shape[1],
    ), new_tainted


def load_demo(rt, name, device="cuda"):
    return rt.load_scene(
        os.path.join(REPO, "scenes", f"{name}.json"),
        textures_dir=os.path.join(REPO, "golden", "Textures"), device=device,
    )


def srgb_frame(rt, scene, opts, generator, device="cuda"):
    """One frame through render_to_srgb_u8 in its stats mode -> (image,
    stats["total_dropped"]): the continuations the pipeline lost to queue
    shrink or compacted-queue overflow.  The stats mode synchronizes once
    a tile and adds three counts a level."""
    img, stats = rt.render_to_srgb_u8(scene, dataclasses.replace(opts, stats=True),
                                      generator, device=device)
    return img, stats["total_dropped"]


def witness_check(shrunk, unshrunk, witness):
    """A frame drawn with the pipeline's queue shrink against the frame
    drawn without it from the same seed: a shrunk level draws its fuzz and
    area-light jitter at its width, so the two are two estimates that share
    only the draws made before the first shrink point.  The limit comes
    from `witness`, the unshrunk frame from another seed (two independent
    estimates): mean |diff| at most 1.1 times the witness's and p99 at
    most one step above it.  -> the readings, ok."""
    a, b, c = (x.astype(np.float32) for x in (shrunk, unshrunk, witness))
    d, dw = np.abs(a - b), np.abs(c - b)
    res = dict(shrunk_vs_unshrunk_bytes_equal=bool(d.max() == 0),
               shrunk_vs_unshrunk_mean_diff=float(d.mean()),
               shrunk_vs_unshrunk_signed_mean=float((a - b).mean()),
               shrunk_vs_unshrunk_p99=float(np.percentile(d, 99)),
               shrunk_vs_unshrunk_off_share=float((d > 0).mean()),
               witness_mean_diff=float(dw.mean()), witness_signed_mean=float((c - b).mean()),
               witness_p99=float(np.percentile(dw, 99)),
               witness_off_share=float((dw > 0).mean()))
    res.update(limit_mean_diff=1.1 * res["witness_mean_diff"],
               limit_p99=res["witness_p99"] + 1)
    ok = (res["shrunk_vs_unshrunk_mean_diff"] <= res["limit_mean_diff"]
          and res["shrunk_vs_unshrunk_p99"] <= res["limit_p99"])
    return res, ok


def golden_diff(rt, img, golden):
    gold = rt.read_ppm(os.path.join(REPO, "golden", "Output", golden))
    return np.abs(img.astype(np.float32) - gold.astype(np.float32))


def golden_check(rt, name, golden, samples_sqrt, contract, seed, light_samples=1,
                 use_bvh=False, device="cuda", expect_path=None):
    """Render scenes/<name>.json through the pipeline's own routing and
    hold it against the reference renderer's golden.  expect_path: "fused"
    or "general", the path the routing must take (for "fused" the level
    kernel must also have launched)."""
    from ray_tracying_tpu_torch.kernels import wavefront as W

    scene = load_demo(rt, name, device)
    path = "general" if W.wave_refusal(scene, use_bvh, light_samples) else "fused"
    gen = torch.Generator(device=device).manual_seed(seed)
    before = W.wave_level.launches
    img, dropped = srgb_frame(
        rt, scene,
        rt.RenderOptions(samples_sqrt=samples_sqrt, light_samples=light_samples,
                         use_bvh=use_bvh),
        gen, device=device,
    )
    diff = golden_diff(rt, img, golden)
    if contract == "deterministic":
        # max diff <= 1 uint8 step, < 1 % of values off by one
        res = dict(max_diff=float(diff.max()), off_share=float((diff > 0).mean()))
        ok = res["max_diff"] <= 1 and res["off_share"] < 0.01
    else:
        # two Monte-Carlo estimates: mean diff < 1, p99 <= 8
        res = dict(mean_diff=float(diff.mean()), p99=float(np.percentile(diff, 99)))
        ok = res["mean_diff"] < 1.0 and res["p99"] <= 8
    launched = W.wave_level.launches - before
    say("golden", scene=name, golden=golden, samples_sqrt=samples_sqrt,
        light_samples=light_samples, contract=contract, use_bvh=use_bvh,
        path=path, wave_level_launches=launched, dropped=dropped, ok=ok, **res)
    if not ok:
        fail(f"{name} is outside the {contract} contract against {golden}")
    if dropped:
        fail(f"{name} dropped {dropped} continuations")
    if expect_path is not None and path != expect_path:
        fail(f"{name} took the {path} path, not the {expect_path} one")
    if (path == "fused") != (launched > 0):
        fail(f"{name} on the {path} path launched the level kernel {launched} times")


def brute_bound(n, live, tests, ranges, g, rows_in, bytes_out):
    """Least time for one brute-kernel call: bytes = the act row of every
    lane, `rows_in` more rows of the live lanes, `bytes_out` per lane
    written, the table once; operations = the geom tests this call's data
    needed, at the table's mean cost of a test."""
    n_bytes = 4 * n + 4 * rows_in * live + bytes_out * n + 4 * 17 * g
    per_test = sum(FLOPS_PER_TEST[k] * (e - s) for k, s, e in ranges) / g
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = per_test * tests / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_ms=bytes_ms, operations_ms=ops_ms, needed_bytes=n_bytes,
                needed_tests=tests)


def brute_vs_plain(CH, case, rays, maxt, table, ranges, motion, timed=False):
    """The three brute kernels against their plain versions on the same
    tensors on the card: every output must be bit-equal.  rays: (8, R) for
    the closest-hit kernels; the any-hit kernel gets them with time 0 (or,
    with `maxt` a pair, its own (rays, maxt)).  Returns one result dict per
    kernel; with `timed`, also the kernel's and the plain version's ms and
    the roofline bound."""
    n, g = rays.shape[1], table.shape[1]
    live = int((rays[7] > 0).sum())
    out = {}
    for name, fn, plain in (
        ("brute_closest", CH.brute_closest, CH.brute_closest_plain),
        ("brute_closest_n", CH.brute_closest_n, CH.brute_closest_n_plain),
    ):
        a = fn(rays, table, ranges, motion)
        torch.cuda.synchronize()
        t0 = time.time()
        b = plain(rays, table, ranges, motion)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        equal = [bool(torch.equal(x, y)) for x, y in zip(a, b)]
        fin = torch.isfinite(b[0])
        err = [float((x[..., fin] - y[..., fin]).abs().max()) if fin.any() else 0.0
               for x, y in zip(a[::2], b[::2])]   # t [, normal]
        res = dict(case=case, kernel=name, lanes=n, live=live, geoms=g,
                   hits=int((b[1] >= 0).sum()),
                   other_winner_lanes=int((a[1] != b[1]).sum()),
                   bitwise_equal=all(equal), max_abs_err=max(err))
        if timed:
            res.update(ms=cuda_ms(lambda: fn(rays, table, ranges, motion), 5),
                       plain_ms=plain_ms,
                       **brute_bound(n, live, live * g, ranges, g, 7,
                                     8 if name == "brute_closest" else 20))
        del a, b
        out[name] = res
    if isinstance(maxt, tuple):
        s_rays, maxt = maxt
    else:
        s_rays = rays.clone()
        s_rays[6] = 0.0
    a = CH.occlusion_any(s_rays, maxt, table, ranges)
    need = {}
    torch.cuda.synchronize()
    t0 = time.time()
    b = CH.occlusion_plain(s_rays, maxt, table, ranges, stats=need)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    res = dict(case=case, kernel="occlusion_any", lanes=n, live=need["live"],
               geoms=g, blocked=int(b.sum()),
               disagreeing_lanes=int((a != b).sum()),
               bitwise_equal=bool(torch.equal(a, b)),
               max_abs_err=float((a != b).sum() > 0))
    if timed:
        res.update(ms=cuda_ms(lambda: CH.occlusion_any(s_rays, maxt, table, ranges), 5),
                   plain_ms=plain_ms,
                   **brute_bound(n, need["live"], need["tests"], ranges, g, 7, 1))
    out["occlusion_any"] = res
    for res in out.values():
        say("brute_at_width" if timed else "brute_vs_plain", **res)
        if not res["bitwise_equal"]:
            fail(f"{res['kernel']} and its plain version disagree on {case}")
    return out


def all_kinds_scene(rt):
    """Every kind (a legacy plane too), rotated and scaled prims, a moving
    sphere: the scene of tests/test_intersect.py."""
    return rt.load_scene_dict({
        "cameras": [{"location": [0, 0, 0], "gaze_vector": [0, 1, 0],
                     "up_vector": [0, 0, 1], "focal_length": 20.0,
                     "sensor_width": 36, "sensor_height": 24}],
        "render": {"resolution_x": 8, "resolution_y": 6},
        "spheres": [
            {"location": [0, 5, 0], "radius": 1.0},
            {"location": [2, 6, 0.5], "rotation": [0.3, 0.2, 0.7],
             "scale": [0.8, 0.5, 1.2], "velocity": [1.0, 0.0, 0.0]},
        ],
        "cubes": [{"translation": [-2, 7, 0], "rotation": [0.1, 0.9, 0.4],
                   "scale": [0.7, 1.1, 0.6]}],
        "rectangles": [{"translation": [0, 9, 0], "rotation": [1.0, 0.2, 0.0],
                        "scale": [6.0, 6.0, 1.0]}],
        "planes": [{"corners": [[-9, 12, -9], [9, 12, -9], [9, 12, 9], [-9, 12, 9]]}],
    })


def accel_kernels(CH, CS, BT, scene):
    """The six kernels of the acceleration path on `scene` (which carries
    chunks and a BVH), each as (kernel call, plain call[, the kernel by the
    one-thread-per-lane schedule it replaced]): all take the (8, R) rays, or
    ((8, R) shadow rays, maxt) for the any-hit, and the plain call also a
    dict for its counts of needed tests."""
    g = scene.n_geoms
    chunks = (scene.chunk_boxes, scene.chunk_graze, scene.chunk_geoms, g)
    bvh, packed = bvh_ops(scene)
    ltab = CH.pack_geom_table(scene).contiguous()
    mo = scene.has_motion

    def chunked_plain(r, need):
        need.update(live=int((r[7] > 0).sum()), box_tests=0)
        need["tests"] = need["live"] * g
        return CH.brute_closest_chunked_plain(r, ltab, mo)

    def bvh_n_plain(r, need):
        # The traversal's needed tests are those of bvh_closest.
        return BT.bvh_closest_n_plain(r, *bvh, mo)

    return {
        "brute_closest_chunked": (
            lambda r: CH.brute_closest_chunked(r, ltab, mo), chunked_plain,
            lambda r: CH.brute_closest_chunked_variant(r, ltab, mo, schedule="lane")),
        "chunk_closest": (
            lambda r: CS.chunk_closest(r, *chunks, mo),
            lambda r, need: CS.chunk_closest_plain(r, *chunks, mo, stats=need)),
        "chunk_closest_n": (
            lambda r: CS.chunk_closest_n(r, *chunks, mo),
            lambda r, need: CS.chunk_closest_n_plain(r, *chunks, mo, stats=need),
            lambda r: CS.chunk_sweep_variant("chunk_closest_n", r, None, *chunks, mo,
                                             schedule="lane")),
        "chunk_occlusion": (
            lambda rm: CS.chunk_occlusion(rm[0], rm[1], *chunks),
            lambda rm, need: CS.chunk_occlusion_plain(rm[0], rm[1], *chunks, stats=need),
            lambda rm: CS.chunk_sweep_variant("chunk_occlusion", rm[0], rm[1], *chunks,
                                              schedule="lane")),
        "bvh_closest": (
            lambda r: BT.bvh_closest(r, *bvh, mo, packed=packed),
            lambda r, need: BT.bvh_closest_plain(r, *bvh, mo, stats=need),
            lambda r: BT.bvh_closest_variant(r, *bvh, mo, schedule="lane")),
        "bvh_closest_n": (
            lambda r: BT.bvh_closest_n(r, *bvh, mo, packed=packed), bvh_n_plain,
            lambda r: BT.bvh_closest_variant(r, *bvh, mo, want_n=True, schedule="lane")),
    }


def bvh_ops(scene):
    """The traversal's operands of `scene`: the tree's (table, boxes, topo,
    graze) and the kernel's packed copy (inner records, rows)."""
    return ((scene.bvh_geoms, scene.bvh_nodes_box, scene.bvh_nodes_topo,
             scene.bvh_nodes_graze), (scene.bvh_inner, scene.bvh_rows))


def flops_per_test(scene):
    """f32 operations of the mean geom test of `scene`'s table."""
    counts = (*scene.kind_counts, scene.n_planes)
    return sum(FLOPS_PER_TEST[k] * c for k, c in enumerate(counts)) / scene.n_geoms


def struct_bytes(scene, family):
    """Bytes of the structure a kernel of `family` reads besides the rays,
    each once: the chunk table and its boxes; the traversal's inner records,
    rows and the root's box, topo and slack; the brute's (17, G) table."""
    g = scene.n_geoms
    if family == "chunk":
        return 4 * 17 * g + 4 * scene.chunk_boxes.numel()
    if family == "bvh":
        return 4 * (scene.bvh_inner.numel() + scene.bvh_rows.numel()) + 24 + 16 + 4
    return 4 * 17 * g


def accel_vs_plain(kernels, case, rays, shadow, names=None):
    """Each kernel against its plain version on the same tensors on the
    card: every output bit-equal (torch.equal on t, id, normal rows,
    blocked).  Returns {name: result dict with the plain version's ms and
    its counts of needed tests}."""
    out = {}
    for name, (fn, plain, *lane) in kernels.items():
        if names is not None and name not in names:
            continue
        arg = shadow if name == "chunk_occlusion" else rays
        lanes = arg[0].shape[1] if name == "chunk_occlusion" else arg.shape[1]
        a = fn(arg)
        a = a if isinstance(a, tuple) else (a,)
        need = {}
        torch.cuda.synchronize()
        t0 = time.time()
        b = plain(arg, need)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        b = b if isinstance(b, tuple) else (b,)
        equal = [bool(torch.equal(x, y)) for x, y in zip(a, b)]
        if lane:
            # the schedule it replaced, on the same rays: new = old = plain
            c = lane[0](arg)
            c = c if isinstance(c, tuple) else (c,)
            equal += [bool(torch.equal(x, y)) for x, y in zip(c, b)]
            del c
        if name == "chunk_occlusion":
            err = float((a[0] != b[0]).sum() > 0)
            found = dict(blocked=int(b[0].sum()),
                         disagreeing_lanes=int((a[0] != b[0]).sum()))
        else:
            fin = torch.isfinite(b[0])
            err = max(float((x[..., fin] - y[..., fin]).abs().max()) if fin.any() else 0.0
                      for x, y in zip(a[::2], b[::2]))   # t [, normal]
            found = dict(hits=int((b[1] >= 0).sum()),
                         other_winner_lanes=int((a[1] != b[1]).sum()))
        out[name] = dict(case=case, kernel=name, lanes=lanes, bitwise_equal=all(equal),
                         old_schedule_checked=bool(lane),
                         max_abs_err=err, plain_ms=plain_ms, needed=need, **found)
        say("accel_vs_plain", **out[name])
        if not all(equal):
            fail(f"{name} and its plain version disagree on {case}")
        del a, b
    if "bvh_closest" in out and "bvh_closest_n" in out:
        out["bvh_closest_n"]["needed"] = out["bvh_closest"]["needed"]
    return out


def same_hit_set(case, a, b, name_a, name_b):
    """Two kernels on the same rays: equal t everywhere; ids may differ
    only where two geoms tie exactly (each kernel names the first of its
    own table order)."""
    other = int((a[1] != b[1]).sum())
    ok = bool(torch.equal(a[0], b[0]))
    say("accel_vs_plain", case=case, kernels=[name_a, name_b], lanes=a[0].shape[0],
        t_bitwise_equal=ok, other_id_lanes=other)
    if not ok:
        fail(f"{name_a} and {name_b} report different distances on {case}")


def accel_bound(n, live, need, sample_live, per_test, rows_in, bytes_out, structure):
    """Least time of one launch at this width.  Bytes: the act row of every
    lane, `rows_in` more rows of the live lanes, the outputs, and the
    `structure` bytes the kernel reads besides (struct_bytes) once.
    Operations: the geom and box tests a per-ray cull or traversal cannot
    avoid, counted by the plain version on a strided sample of these rays
    (`need`, over `sample_live` live lanes) and scaled to this launch's live
    lanes."""
    scale = live / max(sample_live, 1)
    tests, box_tests = need["tests"] * scale, need.get("box_tests", 0) * scale
    n_bytes = 4 * n + 4 * rows_in * live + bytes_out * n + structure
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = (per_test * tests + FLOPS_PER_BOX_TEST * box_tests) / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_ms=bytes_ms, operations_ms=ops_ms, needed_bytes=n_bytes,
                needed_tests=tests, needed_box_tests=box_tests,
                tests_per_live_lane=tests / max(live, 1))


def accel_at_width(kernels, checked, scene, case, rays, shadow, names):
    """ms by CUDA events of each named kernel at full width, beside its
    bound; `checked` holds the plain version's time and counts on the
    strided sample of the same rays."""
    g = scene.n_geoms
    per_test = flops_per_test(scene)
    out = {}
    for name in names:
        fn = kernels[name][0]
        arg = shadow if name == "chunk_occlusion" else rays
        r = arg[0] if name == "chunk_occlusion" else arg
        n, live = r.shape[1], int((r[7] > 0).sum())
        fn(arg)
        ms = cuda_ms(lambda: fn(arg), 2)
        need = checked[name]["needed"]
        out[name] = dict(
            case=case, kernel=name, lanes=n, live=live, geoms=g, ms=ms,
            plain_ms=checked[name]["plain_ms"], plain_lanes=checked[name]["lanes"],
            max_abs_err=checked[name]["max_abs_err"],
            **accel_bound(n, live, need, need["live"], per_test,
                          7, {"chunk_occlusion": 1, "chunk_closest_n": 20,
                           "bvh_closest_n": 20}.get(name, 8),
                          struct_bytes(scene, name.split("_")[0])))
        say("accel_at_width", **out[name])
    return out


def level1_rays(G, I, CH, scene, o, d, tm):
    """The rays the general path spawns from the level-0 hits of (o, d,
    tm): the incoherent wavefront of level 1, as (o, d, time, active)."""
    from ray_tracying_tpu_torch.render.materials import gather_materials

    n = o.shape[0]
    act = torch.ones(n, dtype=torch.bool, device=o.device)
    hit = I.closest_hit(scene, o, d, tm, act, differentiable=False)
    mrec = gather_materials(scene, hit.geom_id)
    q0 = G._Queue(o, d, tm, torch.ones(n, device=o.device),
                  torch.arange(n, device=o.device), act)
    q1 = G._spawn_one_way(scene, q0, hit, mrec, hit.valid, None, 0.0)
    return q1.o.contiguous(), q1.d.contiguous(), q1.time, q1.active


def with_texture(scene, donor):
    """`scene` with the texture atlas of `donor` (a scene loaded with
    textures from golden/Textures) and texture 0 on every third material
    and on the last (the floor's): a large scene whose closest hit takes
    the (t, id) search and then pass 2."""
    m = scene.materials.tex_id.shape[0]
    ids = torch.arange(m, device=scene.device)
    tex_id = torch.where((ids % 3 == 0) | (ids == m - 1), 0, -1).to(torch.int32)
    return dataclasses.replace(
        scene, tex_atlas=donor.tex_atlas, tex_wh=donor.tex_wh, has_textures=True,
        materials=dataclasses.replace(scene.materials, tex_id=tex_id),
    )


@contextlib.contextmanager
def general_routing():
    """The pipeline's tile loop with trace_wavefront(..., fused=False) in
    place of its routing: render_to_srgb_u8 and render_image down the
    general path for a scene the fused gate takes (the path a scene it
    refuses takes)."""
    from ray_tracying_tpu_torch.render import pipeline as PL

    real = PL.trace_wavefront
    PL.trace_wavefront = functools.partial(real, fused=False)
    try:
        yield
    finally:
        PL.trace_wavefront = real


@contextlib.contextmanager
def level_marks():
    """Each `rtt.level` span the program opens meanwhile timed by CUDA
    events, whether or not a profiler records: yields a list that gets a
    (lanes, start event, end event) per level; `marks_ms` reads it."""
    from ray_tracying_tpu_torch import spans as S

    real = S.span
    marks = []

    class Timed:
        def __init__(self, lanes):
            self.lanes = lanes
            self.ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

        def add(self, **counts):
            pass

        def __enter__(self):
            self.ev[0].record()
            return self

        def __exit__(self, *exc):
            self.ev[1].record()
            marks.append((self.lanes, *self.ev))
            return False

    S.span = lambda name, **counts: Timed(counts["lanes"]) if name == "rtt.level" \
        else real(name, **counts)
    try:
        yield marks
    finally:
        S.span = real


def marks_ms(marks):
    """[[lanes, ms], ...] of `level_marks`' levels."""
    torch.cuda.synchronize()
    return [[lanes, a.elapsed_time(b)] for lanes, a, b in marks]


@contextlib.contextmanager
def parent_route(W):
    """The routing before every table was culled by window, for main_path's
    frames: the unculled staged build for a table it takes
    (`W.stages_table`), without windows (`wave_tables` built them only for
    a wider table), and the package's route above that.  `W.package_build`
    and `W.with_windows` are swapped while it lasts (the launches are
    counted as the package's); the run fails if the package never asked
    them, as it would if a caller held its own reference to either."""
    build, windows = W.package_build, W.with_windows
    asked = []

    def parent_build(tables):
        asked.append("build")
        return "staged" if W.stages_table(tables) else build(tables)

    def parent_windows(tables, scene):
        asked.append("windows")
        return tables if W.stages_table(tables) else windows(tables, scene)

    W.package_build, W.with_windows = parent_build, parent_windows
    try:
        yield
    finally:
        W.package_build, W.with_windows = build, windows
    if set(asked) != {"build", "windows"}:
        fail("the route before the window cull was not taken: the package did not ask "
             "the swapped package_build and with_windows")


def staged_level(W):
    """A level_fn for trace_wavefront: the staged build (the reference the
    package's window-culled builds are held to), uncounted."""
    def level(out_prev, fuzz, tables, min_tp=0.0):
        return W.wave_level_build(out_prev, fuzz, tables, "staged", min_tp)
    return level


# The goldens that take the fused level (phase 4), each traced once more
# by the staged build (`staged_golden_traces`): (scene, samples a side,
# light samples).
FUSED_GOLDENS = (("bvh_det", 1, 1), ("bvh_glossy", 8, 1), ("det_basic", 1, 1),
                 ("det_mirrors", 1, 1), ("texture", 1, 1), ("dof", 6, 1), ("motion", 6, 1),
                 ("glossy", 6, 1), ("softshadow", 4, 16))


def staged_golden_traces(rt, W, dev):
    """Phase staged_goldens: every golden the fused level takes, its whole
    image traced twice from one seed, through the package's route (the
    window cull) and through the staged build (`staged_level`): the
    radiance torch.equal, or the run fails.  The draws come from one
    generator in the same order both times, the queue shrink is the
    default.  Returns the rows."""
    from ray_tracying_tpu_torch.render.integrator import trace_wavefront
    from ray_tracying_tpu_torch.render.pipeline import tile_rays

    rows = []
    for name, sqrt_spp, samples in FUSED_GOLDENS:
        scene = load_demo(rt, name, dev)
        if W.wave_refusal(scene, False, samples) is not None:
            fail(f"{name} no longer takes the fused level")
        tables = W.wave_tables(scene, light_samples=samples)
        width, height = scene.camera.resolution
        o, d, tm = tile_rays(scene.camera, 0, height, width, sqrt_spp,
                             generator=torch.Generator(device=dev).manual_seed(17))
        rad = {}
        for build, level_fn in (("route", W.wave_level), ("staged", staged_level(W))):
            rad[build] = trace_wavefront(scene, o, d, tm, samples, tables=tables,
                                         level_fn=level_fn,
                                         generator=torch.Generator(device=dev).manual_seed(18))
        row = dict(scene=name, lanes=o.shape[0], geoms=scene.n_geoms,
                   route=W.package_build(tables), windows=tables.windows.shape[0],
                   radiance_equal=bool(torch.equal(rad["route"], rad["staged"])))
        say("staged_goldens", **row)
        rows.append(row)
        if not row["radiance_equal"]:
            fail(f"{name}: the window-culled route and the staged build trace other radiance")
    return rows


def accel_frame(rt, scene, opts, seed, dev):
    """One frame through render_to_srgb_u8: (image, seconds); the run fails
    if the frame dropped a continuation."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.time()
    img, dropped = srgb_frame(rt, scene, opts, gen, device=dev)
    torch.cuda.synchronize()
    if dropped:
        fail(f"a frame of {scene.n_geoms} geoms dropped {dropped} continuations")
    return img, time.time() - t0



def ptxas_report(_build, needle):
    """The -Xptxas -v lines of the last build for the entry functions whose
    mangled names hold `needle`."""
    report, inside = [], False
    for ln in _build.last_build["log"].splitlines():
        if "entry function" in ln:
            inside = needle in ln
        if inside:
            report.append(ln.strip())
    return report


def anyhit_redesign_ab(CH, _build, case, rays, maxt, table, ranges, idx):
    """Phase anyhit_redesign_ab: occlusion_any by the package's kernel
    (persistent warps over a live-lane list, the 12-column shadow table
    staged once a block) against the one-thread-per-lane kernel it replaced,
    on the same full-width shadow rays: both torch.equal at full width, and
    the package's equal to occlusion_plain on the strided sample `idx`
    (whose counts of tests to each ray's first blocker, scaled to the live
    lanes, give the bound); ms of each by CUDA events in turns (lane, warp,
    warp, lane); the launch plan and the ptxas report of both kernels.
    Returns the row."""
    new = CH.occlusion_any(rays, maxt, table, ranges)
    old = CH.occlusion_any_variant(rays, maxt, table, ranges, schedule="lane")
    equal = bool(torch.equal(new, old))
    sub = (rays[:, idx].contiguous(), maxt[idx].contiguous())
    need = {}
    torch.cuda.synchronize()
    t0 = time.time()
    b = CH.occlusion_plain(*sub, table, ranges, stats=need)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    plain_equal = bool(torch.equal(new[idx], b))
    del old
    t = {}
    for turn, sched in (("lane", "lane"), ("warp", "warp"), ("warp_again", "warp"),
                        ("lane_again", "lane")):
        t[turn] = cuda_ms(lambda: CH.occlusion_any_variant(rays, maxt, table, ranges,
                                                           schedule=sched), 3)
    n, g = rays.shape[1], table.shape[1]
    live = int((rays[7] > 0).sum())
    row = dict(case=case, kernel="occlusion_any", lanes=n, live=live, geoms=g,
               ms=(t["warp"] + t["warp_again"]) / 2,
               warp_ms=[t["warp"], t["warp_again"]], lane_ms=[t["lane"], t["lane_again"]],
               old_schedule_ms=(t["lane"] + t["lane_again"]) / 2,
               plain_ms=plain_ms, plain_lanes=sub[0].shape[1], blocked_in_sample=int(b.sum()),
               warp_equals_lane=equal, equals_plain_on_sample=plain_equal,
               max_abs_err=0.0 if plain_equal else 1.0,
               **CH.occlusion_any_plan(g),
               ptxas=ptxas_report(_build, "occlusion_warp_kernel"),
               old_schedule_ptxas=ptxas_report(_build, "occlusion_any_kernel"),
               **brute_bound(n, live, need["tests"] * live / max(need["live"], 1), ranges, g,
                             7, 1))
    row["tests_per_live_lane"] = row["needed_tests"] / max(live, 1)
    say("anyhit_redesign_ab", **row)
    if not equal:
        fail(f"the two schedules of occlusion_any differ on {case}")
    if not plain_equal:
        fail(f"occlusion_any and its plain version disagree on {case}")
    return row


def brute_redesign_ab(CH, _build, case, rays, table, ranges, motion, idx):
    """Phase brute_redesign_ab: brute_closest and brute_closest_n by the
    package's kernel (persistent warps over a live-lane list, the table
    staged once a block as 64-byte rows, the winner's normal off the loop)
    against the one-thread-per-lane kernels they replaced, on the same
    full-width rays: both torch.equal at full width, and the package's equal
    to the plain version on the strided sample `idx`; ms of each by CUDA
    events in turns (lane, warp, warp, lane); the bound (every live ray runs
    every geom test), the launch plan and the ptxas report of both kernels.
    Returns {kernel name: row}."""
    n, g = rays.shape[1], table.shape[1]
    live = int((rays[7] > 0).sum())
    sub = rays[:, idx].contiguous()
    rows = {}
    for name, want_n, plain in (("brute_closest", False, CH.brute_closest_plain),
                                ("brute_closest_n", True, CH.brute_closest_n_plain)):
        def call(sched):
            return CH.brute_closest_variant(rays, table, ranges, motion, want_n, schedule=sched)

        new, old = call("warp"), call("lane")
        equal = all(bool(torch.equal(x, y)) for x, y in zip(new, old))
        del old
        torch.cuda.synchronize()
        t0 = time.time()
        b = plain(sub, table, ranges, motion)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        plain_equal = all(bool(torch.equal(x[..., idx], y)) for x, y in zip(new, b))
        del new
        t = {}
        for turn, sched in (("lane", "lane"), ("warp", "warp"), ("warp_again", "warp"),
                            ("lane_again", "lane")):
            t[turn] = cuda_ms(lambda: call(sched), 3)
        row = dict(case=case, kernel=name, lanes=n, live=live, geoms=g,
                   ms=(t["warp"] + t["warp_again"]) / 2,
                   warp_ms=[t["warp"], t["warp_again"]], lane_ms=[t["lane"], t["lane_again"]],
                   old_schedule_ms=(t["lane"] + t["lane_again"]) / 2,
                   plain_ms=plain_ms, plain_lanes=sub.shape[1],
                   hits_in_sample=int((b[1] >= 0).sum()),
                   warp_equals_lane=equal, equals_plain_on_sample=plain_equal,
                   max_abs_err=0.0 if plain_equal else float("inf"),
                   **CH.brute_closest_plan(g, want_n),
                   ptxas=ptxas_report(_build, f"brute_warp_kernelILb{int(want_n)}E"),
                   old_schedule_ptxas=ptxas_report(_build, f"{name}_kernel"),
                   **brute_bound(n, live, live * g, ranges, g, 7, 20 if want_n else 8))
        say("brute_redesign_ab", **row)
        if _build.last_build["compiled"] and not (row["ptxas"] and row["old_schedule_ptxas"]):
            fail(f"ptxas reported nothing for the two kernels of {name}")
        if not equal:
            fail(f"the two schedules of {name} differ on {case}")
        if not plain_equal:
            fail(f"{name} and its plain version disagree on {case}")
        rows[name] = row
        del b
    return rows


def sweep_plan_phase(CS, _build, scene):
    """Phase sweep_plan: what ptxas reports for the warp schedule's kernels
    and the plan each launches with on this card for `scene`'s chunk table."""
    report = ptxas_report(_build, "sweep_warp_kernel")
    g, chunk = scene.n_geoms, scene.chunk_geoms.shape[0] // scene.chunk_boxes.shape[0]
    plans = {name: CS.chunk_sweep_plan(name, g, chunk)
             for name in ("chunk_closest", "chunk_closest_n", "chunk_occlusion")}
    say("sweep_plan", kernel="sweep_warp_kernel", ptxas=report, geoms=g, chunk=chunk,
        chunks=scene.chunk_boxes.shape[0], **plans)
    if _build.last_build["compiled"] and not report:
        fail("ptxas reported nothing for sweep_warp_kernel")
    return plans


def sweep_redesign_ab(CS, scene, sets):
    """Phase sweep_redesign_ab: the three chunk kernels by the package's
    warp schedule against the one-thread-per-lane schedule they replaced,
    on the same full-width inputs: sets = {label: (kernel name,
    rays, maxt or None)}.  Outputs torch.equal; ms by CUDA events in turns
    (lane, warp, warp, lane); what each schedule ran, from its counting
    build (geom and box tests a live lane, and the share of the warps' lane
    slots that ran a test).  Returns the rows by label."""
    chunks = (scene.chunk_boxes, scene.chunk_graze, scene.chunk_geoms, scene.n_geoms)
    rows = {}
    for label, (name, rays, maxt) in sets.items():
        mo = scene.has_motion if maxt is None else False

        def call(schedule="warp", work=None):
            return CS.chunk_sweep_variant(name, rays, maxt, *chunks, mo, schedule=schedule,
                                          work=work)

        outs = [call(), call(schedule="lane")]
        outs = [o if isinstance(o, tuple) else (o,) for o in outs]
        equal = all(bool(torch.equal(x, y)) for x, y in zip(*outs))
        del outs
        t = {}
        for turn, sched in (("lane", "lane"), ("warp", "warp"), ("warp_again", "warp"),
                            ("lane_again", "lane")):
            t[turn] = cuda_ms(lambda: call(sched), 2)
        live = int((rays[7] > 0).sum())
        ran = {}
        for sched in ("warp", "lane"):
            work = torch.zeros(3, dtype=torch.int64, device=rays.device)
            call(schedule=sched, work=work)
            tests, boxes, slots = work.tolist()
            ran[sched] = dict(tests_per_live_lane=tests / max(live, 1),
                              box_tests_per_live_lane=boxes / max(live, 1),
                              lane_slots_used=tests / max(slots, 1))
        rows[label] = dict(case=label, kernel=name, lanes=rays.shape[1], live=live,
                           lane_ms=[t["lane"], t["lane_again"]],
                           warp_ms=[t["warp"], t["warp_again"]],
                           ran=ran, warp_equals_lane=equal)
        say("sweep_redesign_ab", **rows[label])
        if not equal:
            fail(f"the schedules of {name} differ on {label}")
    return rows


def in_turns(calls, reps):
    """ms of each of calls ({label: fn}) by CUDA events, in turns: each once
    in the order given, then once in the reverse order.  {label: [ms, ms]}."""
    out = {k: [] for k in calls}
    for order in (list(calls), list(calls)[::-1]):
        for k in order:
            out[k].append(cuda_ms(calls[k], reps))
    return out


def bvh_plan_phase(BT, _build):
    """Phase bvh_plan: what ptxas reports for the traversal's warp kernel (the
    shipped build's record) and the plan it launches with on this card."""
    report = ptxas_report(_build, "bvh_warp_kernel")
    plans = {name: BT.bvh_closest_plan(want_n) for name, want_n in
             (("bvh_closest", False), ("bvh_closest_n", True))}
    say("bvh_plan", kernel="bvh_warp_kernel", ptxas=report, **plans)
    if _build.last_build["compiled"] and not report:
        fail("ptxas reported nothing for bvh_warp_kernel")
    return plans


def bvh_redesign_ab(BT, case, scene, rays, checked, plans):
    """Phase bvh_redesign_ab: bvh_closest and bvh_closest_n by the package's
    warp kernel (live-lane list, both children's boxes in the parent's
    record, order by entry distance, while-while) against the
    one-thread-per-lane kernel they replaced, on the same full-width rays:
    torch.equal at full width (the sample against the plain version is
    `checked`, accel_vs_plain's rows); ms of each by CUDA events in turns
    (lane, warp, warp, lane); what the counting build ran a live lane (inner
    nodes visited, box tests, geom tests, the share of lane slots that ran a
    visit or a test) beside what the plain version counts as needed on the
    sample; the bound.  Returns {name: row}."""
    tree, packed = bvh_ops(scene)
    mo = scene.has_motion
    n, live = rays.shape[1], int((rays[7] > 0).sum())
    need = checked["bvh_closest"]["needed"]
    rows = {}
    for name, want_n in (("bvh_closest", False), ("bvh_closest_n", True)):
        def call(sched, work=None):
            return BT.bvh_closest_variant(rays, *tree, mo, want_n, schedule=sched, work=work,
                                          packed=packed)

        new, old = call("warp"), call("lane")
        equal = all(bool(torch.equal(x, y)) for x, y in zip(new, old))
        del old
        work = torch.zeros(4, dtype=torch.int64, device=rays.device)
        counted = call("warp", work)
        equal = equal and all(bool(torch.equal(x, y)) for x, y in zip(new, counted))
        del new, counted
        visits, boxes, tests, slots = work.tolist()
        # a lane slot runs at most one visit or one test
        counted_ok = 0 < visits + tests <= slots
        t = in_turns({"lane": lambda: call("lane"), "warp": lambda: call("warp")}, 3)
        row = dict(case=case, kernel=name, lanes=n, live=live, geoms=scene.n_geoms,
                   nodes=scene.bvh_nodes_topo.shape[0], ms=sum(t["warp"]) / 2,
                   warp_ms=t["warp"], lane_ms=t["lane"],
                   old_schedule_ms=sum(t["lane"]) / 2,
                   plain_ms=checked[name]["plain_ms"], plain_lanes=checked[name]["lanes"],
                   max_abs_err=checked[name]["max_abs_err"], warp_equals_lane=equal,
                   ran=dict(visits_per_live_lane=visits / max(live, 1),
                            box_tests_per_live_lane=boxes / max(live, 1),
                            tests_per_live_lane=tests / max(live, 1),
                            lane_slots_used=(visits + tests) / max(slots, 1)),
                   needed=dict(box_tests_per_live_lane=need["box_tests"] / max(need["live"], 1),
                               tests_per_live_lane=need["tests"] / max(need["live"], 1)),
                   **plans[name],
                   **accel_bound(n, live, need, need["live"], flops_per_test(scene), 7,
                                 20 if want_n else 8, struct_bytes(scene, "bvh")))
        say("bvh_redesign_ab", **row)
        if not equal:
            fail(f"the schedules of {name} differ on {case}")
        if not counted_ok:
            fail(f"the counting build of {name} counted more visits and tests than lane "
                 f"slots on {case}: {work.tolist()}")
        rows[name] = row
    return rows


def chunked_redesign_ab(CH, case, scene, rays, checked):
    """Phase chunked_redesign_ab: brute_closest_chunked by the package's warp
    schedule without boxes against the one-thread-per-lane sweep it replaced,
    on the same full-width rays of `scene`'s load-order table: torch.equal;
    ms of each by CUDA events in turns (lane, warp, warp, lane); the bound
    (every live ray runs every row) and the launch plan.  Returns the row."""
    ltab = CH.pack_geom_table(scene).contiguous()
    mo = scene.has_motion

    def call(sched):
        return CH.brute_closest_chunked_variant(rays, ltab, mo, schedule=sched)

    new, old = call("warp"), call("lane")
    equal = all(bool(torch.equal(x, y)) for x, y in zip(new, old))
    del new, old
    t = in_turns({"lane": lambda: call("lane"), "warp": lambda: call("warp")}, 1)
    n, live, g = rays.shape[1], int((rays[7] > 0).sum()), scene.n_geoms
    row = dict(case=case, kernel="brute_closest_chunked", lanes=n, live=live, geoms=g,
               ms=sum(t["warp"]) / 2, warp_ms=t["warp"], lane_ms=t["lane"],
               old_schedule_ms=sum(t["lane"]) / 2, plain_ms=checked["plain_ms"],
               plain_lanes=checked["lanes"], max_abs_err=checked["max_abs_err"],
               warp_equals_lane=equal, **CH.brute_closest_chunked_plan(g),
               **accel_bound(n, live, dict(tests=live * g, live=live), live,
                             flops_per_test(scene), 7, 8, struct_bytes(scene, "brute")))
    say("chunked_redesign_ab", **row)
    if not equal:
        fail(f"the schedules of brute_closest_chunked differ on {case}")
    return row


def accel_tile_breakdown(rt, label, scene, opts, dev, schedule, kernels):
    """Phase accel_tile_breakdown: one frame of `scene` (one tile) through
    render_to_srgb_u8, every launch of `kernels` ({name: module}; the first
    is the closest hit that opens each level) timed by CUDA events, level by
    level with its live lanes; the brute closest hits, occlusion_any, the
    chunk kernels and the traversal by `schedule` ("warp", the package's;
    "lane", the one-thread-per-lane kernels they replaced).  Returns (image,
    row)."""
    from ray_tracying_tpu_torch.kernels import bvh_traverse as BT
    from ray_tracying_tpu_torch.kernels import chunk_stream as CS
    from ray_tracying_tpu_torch.kernels import closest_hit as CH

    real = {name: getattr(mod, name) for name, mod in kernels.items()}
    opener = next(iter(kernels))
    launchers = (CS._launch, CH._launch_occlusion, CH._launch_closest, BT._launch)
    rec = []
    level = [-1]

    def timed(name):
        def run(rays, *args, **kw):
            if name == opener:
                level[0] += 1
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real[name](rays, *args, **kw)
            end.record()
            rec.append((level[0], name, start, end, (rays[7] > 0).sum()))
            return out
        # the wrapper counts its launches in the module's name, this one
        run.launches = real[name].launches
        return run

    for name, mod in kernels.items():
        setattr(mod, name, timed(name))
    if schedule == "lane":
        CS._launch = lambda *a: launchers[0](*a, schedule="lane")
        CH._launch_occlusion = lambda *a: launchers[1](*a, schedule="lane")
        CH._launch_closest = lambda *a: launchers[2](*a, schedule="lane")
        BT._launch = lambda *a, packed=None, **k: launchers[3](*a, **k, schedule="lane")
    try:
        img, seconds = accel_frame(rt, scene, opts, 5, dev)
    finally:
        for name, mod in kernels.items():
            real[name].launches = getattr(mod, name).launches
            setattr(mod, name, real[name])
        CS._launch, CH._launch_occlusion, CH._launch_closest, BT._launch = launchers
    launches = [dict(level=lv, kernel=name, live=int(n_live), ms=s.elapsed_time(e))
                for lv, name, s, e, n_live in rec]
    by_kernel = {name: sum(x["ms"] for x in launches if x["kernel"] == name) for name in kernels}
    total = sum(by_kernel.values())
    row = dict(scene=label, schedule=schedule, frame_seconds=seconds, kernel_ms=by_kernel,
               timed_kernels_ms=total, timed_kernels_share=total / 1e3 / seconds,
               launches=launches)
    say("accel_tile_breakdown", **row)
    n_levels = level[0] + 1
    if [x["kernel"] for x in launches].count(opener) != n_levels or \
            len(launches) != (1 + scene.n_lights) * n_levels:
        fail(f"the {label} frame launched {len(launches)} timed kernels over {n_levels} levels")
    return img, row


def strip_breakdown(CH, trace_wavefront, scene, o, d, tm, dev, schedule):
    """The chunkless trace of (o, d, tm) over `scene` with brute_closest_chunked
    by `schedule`, every launch timed by CUDA events: (radiance, [ms])."""
    real, launch = CH.brute_closest_chunked, CH.launch_sweep
    rec = []

    def timed(rays, *a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(rays, *a, **k)
        end.record()
        rec.append((start, end))
        return out

    timed.launches = real.launches
    CH.brute_closest_chunked = timed
    if schedule == "lane":
        CH.launch_sweep = lambda *a: launch(*a, schedule="lane")
    try:
        gen = torch.Generator(device=dev).manual_seed(9)
        rad = trace_wavefront(scene, o, d, tm, generator=gen, fused=False, device=dev)
        torch.cuda.synchronize()
    finally:
        real.launches = timed.launches
        CH.brute_closest_chunked, CH.launch_sweep = real, launch
    return rad, [s.elapsed_time(e) for s, e in rec]


def accel_phases(rt, dev, sizes, kinds, k_table, k_ranges, k_n, n_levels):
    """Phases accel_vs_plain, accel_at_width and accel_path: the five
    kernels of the acceleration path (and the normal-carrying traversal)
    against their plain versions, at the main path's width, and on the
    path itself.  sizes: geoms of the two procedural scenes, resolution,
    stride of the sample the plain versions run on, rows of the strip the
    chunkless trace runs on.  Returns the kernels' entries for the
    `kernels` line."""
    from ray_tracying_tpu_torch.kernels import _build
    from ray_tracying_tpu_torch.kernels import closest_hit as CH
    from ray_tracying_tpu_torch.kernels import wavefront as W
    from ray_tracying_tpu_torch.render import integrator as G
    from ray_tracying_tpu_torch.render import intersect as I
    from ray_tracying_tpu_torch.render.integrator import trace_wavefront
    from ray_tracying_tpu_torch.render.pipeline import tile_rays

    res_w, res_h = sizes["res"]
    # ---- phase 9: the acceleration kernels against their plain versions.
    # (a) the scene with every kind, a moving sphere and a plane, chunks of
    # 4, a ragged width and a random act mask; also against the brute
    # kernels, which this scene fits.
    from ray_tracying_tpu_torch import models
    from ray_tracying_tpu_torch.accel import lbvh
    from ray_tracying_tpu_torch.kernels import bvh_traverse as BT
    from ray_tracying_tpu_torch.kernels import chunk_stream as CS

    gen = torch.Generator(device=dev).manual_seed(77)
    kinds_acc = lbvh.with_bvh(lbvh.with_chunks(kinds, 4))
    if kinds_acc.chunk_boxes.shape[0] != 2 or kinds_acc.bvh_nodes_topo.shape[0] != 3:
        fail("the all-kinds scene did not get 2 chunks and a 3-node tree")
    k_o = torch.randn((k_n, 3), generator=gen, device=dev) * 1.5
    k_d = torch.randn((k_n, 3), generator=gen, device=dev)
    k_d = k_d / k_d.norm(dim=1, keepdim=True)
    k_act = torch.rand(k_n, generator=gen, device=dev) < 0.7
    k_rays = CH.pack_rays(k_o, k_d, torch.rand(k_n, generator=gen, device=dev), k_act)
    k_shadow = (CH.pack_rays(k_o, k_d, torch.zeros(k_n, device=dev), k_act),
                torch.rand(k_n, generator=gen, device=dev) * 20.0 + 0.5)
    k_kernels = accel_kernels(CH, CS, BT, kinds_acc)
    k_case = "every kind, moving sphere, chunks of 4, random times and act mask"
    accel_vs_plain(k_kernels, k_case, k_rays, k_shadow)
    k_brute = CH.brute_closest(k_rays, k_table, k_ranges, True)
    for name in ("brute_closest_chunked", "chunk_closest", "bvh_closest"):
        same_hit_set(k_case, k_kernels[name][0](k_rays), k_brute, name, "brute_closest")
    k_blocked = CH.occlusion_any(*k_shadow, k_table, k_ranges)
    if not torch.equal(k_kernels["chunk_occlusion"][0](k_shadow), k_blocked):
        fail("chunk_occlusion and occlusion_any disagree on the all-kinds scene")
    del k_o, k_d, k_rays, k_shadow, k_brute, k_blocked

    # (b) the two large scenes at the main path's width: their structures
    # (host build, timed), the level-0 rays of the one full-width tile of a
    # 2x2-spp frame, the level-1 rays spawned from them, the level-0 shadow
    # rays of light 0 as the path casts them; each kernel against its plain
    # version on a strided sample of each set.
    acc = {}
    for sname, kw in (("sphere_field", dict(n=sizes["spheres"])),
                      ("cube_city", dict(n=sizes["cubes"]))):
        t0 = time.time()
        bare = models.get(sname, res=sizes["res"], device=dev, **kw)
        t_load = time.time() - t0
        t0 = time.time()
        with_c = lbvh.with_chunks(bare)
        t_chunks = time.time() - t0
        t0 = time.time()
        full = lbvh.with_bvh(with_c)
        t_bvh = time.time() - t0
        big = full.n_geoms > CH.BRUTE_SMEM_MAX_GEOMS
        say("accel_build", scene=sname, geoms=full.n_geoms, over_the_cap=big,
            cap_geoms=CH.BRUTE_SMEM_MAX_GEOMS, load_seconds=t_load,
            with_chunks_seconds=t_chunks, with_bvh_seconds=t_bvh,
            chunks=full.chunk_boxes.shape[0], chunk=lbvh.CHUNK,
            bvh_nodes=full.bvh_nodes_topo.shape[0],
            bvh_depth=lbvh.tree_depth(full.bvh_nodes_topo.cpu().numpy()),
            widest_chunk_slack=float(full.chunk_graze.max()),
            chunks_with_slack=int((full.chunk_graze > 0).sum()),
            fused_gate=W.wave_refusal(full))
        acc[sname] = dict(bare=bare, full=full)
    if not (acc["sphere_field"]["full"].n_geoms > CH.BRUTE_SMEM_MAX_GEOMS
            >= acc["cube_city"]["full"].n_geoms):
        fail("the two scenes do not straddle the shared-memory cap")
    sweep_plans = sweep_plan_phase(CS, _build, acc["sphere_field"]["full"])
    bvh_plans = bvh_plan_phase(BT, _build)
    bvh_ab, chunked_ab = {}, {}

    at_width = {}
    ab_sets = {}
    city_anyhit = {}
    city_brute = {}
    for sname in ("sphere_field", "cube_city"):
        full = acc[sname]["full"]
        big = full.n_geoms > CH.BRUTE_SMEM_MAX_GEOMS
        gen = torch.Generator(device=dev).manual_seed(21)
        w_, h_ = full.camera.resolution
        o, d, tm = tile_rays(full.camera, 0, h_, w_, 2, generator=gen)
        n_acc = o.shape[0]
        rays0 = CH.pack_rays(o, d, tm)
        cast = []
        # the level-0 and level-1 shadow rays as the path casts them: the
        # chunk sweep over the cap, the brute any-hit under it
        entry = "occluded_tid_chunks" if big else "occluded_tid"
        real = getattr(I, entry)

        def recording(scene_, so, sd, maxt, active=None):
            cast.append((CH.pack_rays(so, sd, torch.zeros_like(maxt), active),
                         maxt.contiguous()))
            return real(scene_, so, sd, maxt, active)

        setattr(I, entry, recording)
        trace_wavefront(full, o, d, tm, generator=gen, fused=False, max_depth=1,
                        device=dev, shrink=())
        setattr(I, entry, real)
        if len(cast) != 2 * full.n_lights:  # two levels, one launch a light
            fail("two levels of the path did not cast one any-hit launch per light each")
        o1, d1, tm1, act1 = level1_rays(G, I, CH, full, o, d, tm)
        rays1 = CH.pack_rays(o1, d1, tm1, act1)
        kernels = accel_kernels(CH, CS, BT, full)
        names = (["brute_closest_chunked", "chunk_closest", "chunk_closest_n",
                  "chunk_occlusion", "bvh_closest", "bvh_closest_n"] if big
                 else ["bvh_closest", "bvh_closest_n"])
        idx = torch.arange(0, n_acc, sizes["stride"], device=dev)
        if big:
            # chunk_closest takes the closest hit of the textured scene: the
            # same geoms and rays, its level-1 rays spawned from its own hits
            tex = with_texture(full, models.get("texture", device=dev))
            rays1_tex = CH.pack_rays(*level1_rays(G, I, CH, tex, o, d, tm))
            ab_sets = {"level 0": ("chunk_closest_n", rays0, None),
                       "level 1": ("chunk_closest_n", rays1, None),
                       "level-0 shadow rays of light 0": ("chunk_occlusion", *cast[0]),
                       "textured level 0": ("chunk_closest", rays0, None),
                       "textured level 1": ("chunk_closest", rays1_tex, None)}
            del tex, rays1_tex
        else:
            table_s, ranges_s = CH.scene_table(full)
            for level, shadow in (("level 0", cast[0]), ("level 1", cast[full.n_lights])):
                city_anyhit[level] = anyhit_redesign_ab(
                    CH, _build, f"{sname}, {level} shadow rays of light 0", *shadow, table_s,
                    ranges_s, idx)
            for level, rays_l in (("level 0", rays0), ("level 1", rays1)):
                city_brute[level] = brute_redesign_ab(
                    CH, _build, f"{sname}, {level} rays of the full-width tile", rays_l, table_s,
                    ranges_s, full.has_motion, idx)
        for level, rays_l in (("level 0", rays0), ("level 1", rays1)):
            case = f"{sname}, {level} rays of the full-width tile"
            shadow = cast[0] if big and level == "level 0" else None
            names_l = [x for x in names if x != "chunk_occlusion" or shadow is not None]
            sub = rays_l[:, idx].contiguous()
            sub_shadow = None if shadow is None else (
                shadow[0][:, idx].contiguous(), shadow[1][idx].contiguous())
            checked = accel_vs_plain(kernels, case + ", a strided sample", sub,
                                     sub_shadow, names_l)
            at_width[(sname, level)] = accel_at_width(
                kernels, checked, full, case, rays_l, shadow, names_l)
            # The redesigned kernels against the schedules they replaced.
            if big:
                chunked_ab[level] = chunked_redesign_ab(
                    CH, case, full, rays_l, checked["brute_closest_chunked"])
            if not big or level == "level 0":
                bvh_ab[(sname, level)] = bvh_redesign_ab(BT, case, full, rays_l, checked,
                                                         bvh_plans)
            # One hit set at full width, kernel against kernel: a cull or a
            # traversal that lost a hit to a box that is not conservative
            # in f32 would show here.
            if big:
                ref = kernels["brute_closest_chunked"][0](rays_l)
                ref_name = "brute_closest_chunked"
                others = ("chunk_closest", "bvh_closest")
            else:
                ref = CH.brute_closest(rays_l, table_s, ranges_s, full.has_motion)
                ref_name = "brute_closest"
                others = ("bvh_closest",)
                ms = cuda_ms(lambda: CH.brute_closest(
                    rays_l, table_s, ranges_s, full.has_motion), 2)
                live_l = int((rays_l[7] > 0).sum())
                # a brute closest hit runs every geom test of every live ray
                say("accel_at_width", case=case, kernel="brute_closest", lanes=n_acc,
                    live=live_l, geoms=full.n_geoms, ms=ms,
                    **brute_bound(n_acc, live_l, live_l * full.n_geoms, ranges_s,
                                  full.n_geoms, 7, 8))
            for name in others:
                same_hit_set(case, kernels[name][0](rays_l), ref, name, ref_name)
            del ref
        # The coherence sort on the incoherent level-1 wavefront, at the
        # level of the entry that takes it (ray packing included).
        for entry, fn in (("closest_hit_tid_chunks", CS.closest_hit_tid_chunks),
                          ("closest_hit_tid_bvh", BT.closest_hit_tid_bvh)):
            if entry.endswith("chunks") and not big:
                continue
            plain_t = fn(full, o1, d1, tm1, act1)
            sorted_t = fn(full, o1, d1, tm1, act1, sort_rays=True)
            same = all(torch.equal(x, y) for x, y in zip(plain_t, sorted_t))
            say("accel_at_width", case=f"{sname}, level 1 rays of the full-width tile",
                entry=entry, lanes=n_acc, live=int(act1.sum()),
                unsorted_ms=cuda_ms(lambda: fn(full, o1, d1, tm1, act1), 2),
                sort_rays_ms=cuda_ms(lambda: fn(full, o1, d1, tm1, act1, sort_rays=True), 2),
                slot_for_slot_equal=same)
            if not same:
                fail(f"{entry} with sort_rays is not slot for slot the unsorted call")
            del plain_t, sorted_t
        del o, d, tm, o1, d1, tm1, act1, rays0, rays1, cast, kernels
        torch.cuda.empty_cache()

    # The redesigned sweeps against the schedule they replaced, on the same
    # full-width inputs of sphere_field.
    ab = sweep_redesign_ab(CS, acc["sphere_field"]["full"], ab_sets)
    del ab_sets
    torch.cuda.empty_cache()

    # ---- phase 10: this slice's path at full width, through
    # models.get -> render_to_srgb_u8, counts set to 0 just before.
    counted = dict(
        wave_level=W.wave_level, brute_closest=CH.brute_closest,
        brute_closest_n=CH.brute_closest_n, occlusion_any=CH.occlusion_any,
        brute_closest_chunked=CH.brute_closest_chunked,
        chunk_closest=CS.chunk_closest, chunk_closest_n=CS.chunk_closest_n,
        chunk_occlusion=CS.chunk_occlusion, bvh_closest=BT.bvh_closest,
        bvh_closest_n=BT.bvh_closest_n,
    )

    def reset_counts():
        for fn in counted.values():
            fn.launches = 0

    def read_counts():
        return {k: fn.launches for k, fn in counted.items() if fn.launches}

    # The large scene once more with a texture from golden/Textures: its
    # closest hit is the (t, id) chunk sweep and then pass 2 by indexed
    # loads over 20,001 geoms, on every lane of the frame.
    acc["sphere_field_textured"] = dict(bare=with_texture(
        acc["sphere_field"]["bare"], models.get("texture", device=dev)))
    accel_launches = {}
    frames, frame_seconds = {}, {}
    # cube_city (2,049 geoms) takes the fused level's wide build by the
    # pipeline's routing (cube_city_fused); cube_city_brute is the same
    # frame down the general path, where the brute kernels run.
    for label, sname, use_bvh, general in (
            ("sphere_field", "sphere_field", False, False),
            ("sphere_field_textured", "sphere_field_textured", False, False),
            ("cube_city_bvh", "cube_city", True, False),
            ("cube_city_brute", "cube_city", False, True),
            ("cube_city_fused", "cube_city", False, False)):
        bare = acc[sname]["bare"]
        opts_l = rt.RenderOptions(samples_sqrt=2, use_bvh=use_bvh)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with general_routing() if general else contextlib.nullcontext(), \
                level_marks() as marks:
            img_w, warm_s = accel_frame(rt, bare, opts_l, 5, dev)
            img_t, timed_s = accel_frame(rt, bare, opts_l, 5, dev)
            _, st = rt.render_image(
                bare, rt.RenderOptions(samples_sqrt=1, use_bvh=use_bvh, stats=True), device=dev)
        got = read_counts()
        for k, v in got.items():
            accel_launches[k] = accel_launches.get(k, 0) + v
        n_rays = res_w * res_h * 4
        frames[label] = img_t
        frame_seconds[label] = timed_s
        say("accel_path", scene=sname, frame=label, geoms=bare.n_geoms, use_bvh=use_bvh,
            path="general (forced)" if general else "routed", textured=bare.has_textures,
            width=res_w, height=res_h, spp=4, levels=n_levels, levels_run=len(marks),
            primary_rays=n_rays,
            warmup_seconds=warm_s, timed_seconds=timed_s,
            primary_rays_per_s=n_rays / timed_s, kernel_launches=got,
            peak_memory_bytes=torch.cuda.max_memory_allocated(),
            two_frames_bytes_equal=bool(np.array_equal(img_w, img_t)),
            dropped=0, dropped_at_1spp=st["total_dropped"],
            live_at_1spp=[lv["live"] for lv in st["levels"]])
        # Two frames at 4 spp and one at 1 spp, one tile each; one launch a
        # level they ran (the general path ends a tile where no lane is live).
        per = len(marks)
        if sname == "sphere_field":
            expect = dict(chunk_closest_n=per, chunk_occlusion=per * bare.n_lights)
        elif sname == "sphere_field_textured":
            expect = dict(chunk_closest=per, chunk_occlusion=per * bare.n_lights)
        elif use_bvh:
            expect = dict(bvh_closest_n=per, occlusion_any=per * bare.n_lights)
        elif general:
            expect = dict(brute_closest_n=per, occlusion_any=per * bare.n_lights)
        else:
            expect = dict(wave_level=per)
        if got != expect:
            fail(f"{label} launched {got}, expected {expect}")
        if st["total_dropped"]:
            fail(f"{label} dropped continuations")
        if not np.array_equal(img_w, img_t):
            fail(f"two renders of {label} differ")
        if img_t.shape != (res_h, res_w, 3) or img_t.min() == img_t.max():
            fail(f"the {label} frame is empty or misshapen")
    city_equal = bool(np.array_equal(frames["cube_city_bvh"], frames["cube_city_brute"]))
    say("accel_path", scene="cube_city", use_bvh_on_and_off_bytes_equal=city_equal,
        values_that_differ=int((frames["cube_city_bvh"] != frames["cube_city_brute"]).sum()))
    if not city_equal:
        fail("cube_city with and without use_bvh differ")
    # The fused frame against the general one, from one seed: the
    # deterministic contract (<= 1 uint8 step, < 1 % of values off), and
    # the level-0 winners of the frame's tile, the kernel's record row
    # against the general path's closest hit.
    city = acc["cube_city"]["bare"]
    diff = np.abs(frames["cube_city_fused"].astype(int) - frames["cube_city_brute"].astype(int))
    o, d, tm = tile_rays(city.camera, 0, res_h, res_w, 2,
                         generator=torch.Generator(device=dev).manual_seed(5))
    boot = torch.cat([o.T, d.T, tm[None], torch.ones((2, o.shape[0]), device=dev)]).contiguous()
    won = W.wave_level(boot, None, W.wave_tables(city), record=True)[W.OUT_ROWS]
    hit = I.closest_hit(city, o, d, tm, torch.ones(o.shape[0], dtype=torch.bool, device=dev))
    other = int((won != torch.where(hit.valid, hit.geom_id, -1).to(won.dtype)).sum())
    fused_vs_general = dict(max_diff=int(diff.max()), off_share=float((diff > 0).mean()),
                            level0_lanes=o.shape[0], level0_winners_other_than_general=other)
    say("accel_path", scene="cube_city", fused_vs_general=fused_vs_general,
        contract="deterministic")
    del o, d, tm, boot, won, hit
    if other > MAX_FLIP_SHARE * fused_vs_general["level0_lanes"]:
        fail(f"cube_city: {other} level-0 winners of the fused frame differ from the general path's")
    if not (fused_vs_general["max_diff"] <= 1 and fused_vs_general["off_share"] < 0.01):
        fail("cube_city's fused frame is outside the deterministic contract against its "
             "general frame")
    if np.array_equal(frames["sphere_field"], frames["sphere_field_textured"]):
        fail("the texture left the sphere_field frame as it was")
    # One frame of each large scene (the seed of the frames above) with each
    # schedule of the redesigned kernels, every launch of its closest-hit
    # and any-hit kernels timed: their share of the frame before and after;
    # the bytes equal to each other and to the frame above.
    breakdown = {}
    for label, sname, use_bvh, timed_k in (
            ("sphere_field", "sphere_field", False,
             {"chunk_closest_n": CS, "chunk_occlusion": CS}),
            ("sphere_field_textured", "sphere_field_textured", False,
             {"chunk_closest": CS, "chunk_occlusion": CS}),
            ("cube_city_bvh", "cube_city", True, {"bvh_closest_n": BT, "occlusion_any": CH}),
            ("cube_city_brute", "cube_city", False,
             {"brute_closest_n": CH, "occlusion_any": CH})):
        opts_l = rt.RenderOptions(samples_sqrt=2, use_bvh=use_bvh)
        schedules = ("lane", "warp")
        for schedule in schedules:
            with general_routing() if label == "cube_city_brute" else contextlib.nullcontext():
                img, breakdown[(label, schedule)] = accel_tile_breakdown(
                    rt, label, acc[sname]["bare"], opts_l, dev, schedule, timed_k)
            if not np.array_equal(img, frames[label]):
                fail(f"the {label} frame with the {schedule} schedule differs")
        say("anyhit_redesign_ab" if "occlusion_any" in timed_k else "sweep_redesign_ab",
            scene=label, frames_bytes_equal=True,
            **{f"frame_{sched}_seconds": breakdown[(label, sched)]["frame_seconds"]
               for sched in schedules})
    del frames

    # bvh_det (textured: the (t, id) traversal, then pass 2) with use_bvh
    # against the reference's golden, itself rendered with -bvh.
    reset_counts()
    golden_check(rt, "bvh_det", "bvh_det_s1.ppm", 1, "deterministic", 0, use_bvh=True,
                 device=dev)
    got = read_counts()
    if got != dict(bvh_closest=n_levels, occlusion_any=n_levels * 2):
        fail(f"bvh_det with use_bvh launched {got}")
    accel_launches["bvh_closest"] = accel_launches.get("bvh_closest", 0) + got.get("bvh_closest", 0)

    # A scene over the cap that carries no chunks, traced through the ops
    # entry point: every search is the chunked brute kernel (closest hits,
    # and shadow rays by their closest-hit distance).  Held against the
    # chunk path on the same few image rows.
    reset_counts()
    bare, full = acc["sphere_field"]["bare"], acc["sphere_field"]["full"]
    gen = torch.Generator(device=dev).manual_seed(9)
    o, d, tm = tile_rays(bare.camera, (res_h * 3) // 5, sizes["strip_rows"], res_w, 2, generator=gen)
    torch.cuda.synchronize()
    t0 = time.time()
    with level_marks() as marks:
        rad_chunked = trace_wavefront(bare, o, d, tm, generator=gen, fused=False, device=dev)
    torch.cuda.synchronize()
    chunked_s = time.time() - t0
    got = read_counts()
    rad_chunks = trace_wavefront(full, o, d, tm, generator=gen, fused=False, device=dev)
    # The chunkless path rebuilds normals in pass 2, the chunk path carries
    # them out of the kernel: last-bit differences that up to ten mirror
    # bounces off spheres amplify, so the bar is loose and the share of
    # lanes beyond it is bounded and printed.
    off = ((rad_chunked - rad_chunks).abs() > 1e-3 + 1e-3 * rad_chunks.abs()).any(dim=1)
    say("accel_path", scene="sphere_field without chunks", entry="trace_wavefront",
        lanes=o.shape[0], seconds=chunked_s, kernel_launches=got, rtol=1e-3, atol=1e-3,
        lanes_out_of_tolerance=int(off.sum()), max_share=1e-2,
        max_abs_diff=float((rad_chunked - rad_chunks).abs().max()))
    if got != dict(brute_closest_chunked=len(marks) * (1 + bare.n_lights)):
        fail(f"the chunkless large scene launched {got}")
    if float(off.float().mean()) > 1e-2:
        fail("the chunked brute path and the chunk path disagree")
    accel_launches["brute_closest_chunked"] = got.get("brute_closest_chunked", 0)
    # The same strip by each schedule of brute_closest_chunked, every launch
    # timed: the radiance bit-equal.
    strip = {sched: strip_breakdown(CH, trace_wavefront, bare, o, d, tm, dev, sched)
             for sched in ("lane", "warp")}
    strip_equal = bool(torch.equal(strip["lane"][0], strip["warp"][0]))
    chunked_ab["strip"] = dict(
        case="sphere_field without chunks, a strip of "
             f"{sizes['strip_rows']} rows: trace_wavefront", lanes=o.shape[0],
        launches=len(strip["warp"][1]), warp_ms_all_launches=sum(strip["warp"][1]),
        lane_ms_all_launches=sum(strip["lane"][1]), warp_ms=strip["warp"][1],
        lane_ms=strip["lane"][1], radiance_bitwise_equal=strip_equal)
    say("chunked_redesign_ab", **chunked_ab["strip"])
    if not strip_equal:
        fail("the strip by the two schedules of brute_closest_chunked differs")
    del strip

    # The (t, id) chunk sweep is also what `min_hit_t` takes over the cap:
    # through the ops entry point, on the same rows, beside the
    # normal-carrying sweep.
    from ray_tracying_tpu_torch import ops

    reset_counts()
    t_min = ops.min_hit_t(full, o, d, tm)
    hit = ops.closest_hit(full, o, d, tm, differentiable=False)
    got = read_counts()
    say("accel_path", scene="sphere_field", entry="ops.min_hit_t, ops.closest_hit",
        lanes=o.shape[0], kernel_launches=got,
        t_bitwise_equal=bool(torch.equal(t_min, hit.t)), hits=int(hit.valid.sum()))
    if got != dict(chunk_closest=1, chunk_closest_n=1):
        fail(f"min_hit_t and closest_hit over the cap launched {got}")
    if not torch.equal(t_min, hit.t):
        fail("min_hit_t and closest_hit report different distances over the cap")
    # Counted apart: the `kernels` line carries the launches of the frames.
    del o, d, tm, rad_chunked, rad_chunks, off, t_min, hit

    accel_entries = []
    for name, source, line, scene_key in (
        ("brute_closest_chunked", "closest_hit.cu", "closest_hit.py:460", "sphere_field"),
        ("bvh_closest", "bvh_traverse.cu", "bvh_traverse.py:56", "cube_city"),
        ("bvh_closest_n", "bvh_traverse.cu", "bvh_traverse.py:56", "cube_city"),
        ("chunk_closest", "chunk_stream.cu", "chunk_stream.py:81", "sphere_field"),
        ("chunk_closest_n", "chunk_stream.cu", "chunk_stream.py:108", "sphere_field"),
        ("chunk_occlusion", "chunk_stream.cu", "chunk_stream.py:152", "sphere_field"),
    ):
        row = at_width[(scene_key, "level 0")][name]
        accel_entries.append({
            "name": name,
            "route": "cuda",
            "source": f"ray_tracying_tpu_torch/csrc/{source}",
            "replaces": f"ray_tracying_tpu/kernels/{line}",
            "launches": accel_launches.get(name, 0),
            "launches_from": (
                "trace_wavefront on a strip of sphere_field without chunks: no frame of "
                "render_to_srgb_u8 reaches it, the pipeline attaches chunks over the cap"
                if name == "brute_closest_chunked"
                else "the full-width frames of accel_path and the bvh_det golden"),
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "lanes": row["lanes"],
            "plain_lanes": row["plain_lanes"],
            "shape_note": f"level-0 rays of the one full-width tile of {scene_key} "
                          f"at {res_w}x{res_h}, 2x2 spp; plain_ms and the needed tests behind "
                          f"bound_ms are of every {sizes['stride']}th of these rays",
        })
        if name in ("chunk_closest", "chunk_closest_n", "chunk_occlusion"):
            label = {"chunk_closest": "textured level 0", "chunk_closest_n": "level 0",
                     "chunk_occlusion": "level-0 shadow rays of light 0"}[name]
            r_ab = ab[label]
            accel_entries[-1].update(
                old_schedule_ms=sum(r_ab["lane_ms"]) / 2,
                tests_per_live_lane=r_ab["ran"]["warp"]["tests_per_live_lane"],
                old_schedule_tests_per_live_lane=r_ab["ran"]["lane"]["tests_per_live_lane"],
                **sweep_plans[name])
            if name != "chunk_occlusion":
                r1 = at_width[(scene_key, "level 1")][name]
                label1 = "textured level 1" if name == "chunk_closest" else "level 1"
                accel_entries[-1].update(
                    level1_ms=r1["ms"], level1_bound_ms=r1["bound_ms"],
                    level1_old_schedule_ms=sum(ab[label1]["lane_ms"]) / 2)
            frame = "sphere_field_textured" if name == "chunk_closest" else "sphere_field"
            accel_entries[-1]["frame_ms_all_launches"] = \
                breakdown[(frame, "warp")]["kernel_ms"][name]
            accel_entries[-1]["frame_ms_all_launches_old_schedule"] = \
                breakdown[(frame, "lane")]["kernel_ms"][name]
            accel_entries[-1]["frame"] = frame
        if name == "brute_closest_chunked":
            c0, c1 = chunked_ab["level 0"], chunked_ab["level 1"]
            accel_entries[-1].update(
                old_schedule_ms=c0["old_schedule_ms"], level1_ms=c1["ms"],
                level1_old_schedule_ms=c1["old_schedule_ms"],
                level1_bound_ms=c1["bound_ms"], level1_live=c1["live"],
                strip_ms_all_launches=chunked_ab["strip"]["warp_ms_all_launches"],
                strip_ms_all_launches_old_schedule=chunked_ab["strip"]["lane_ms_all_launches"],
                **{k: c0[k] for k in ("smem_bytes", "blocks_per_sm", "sms", "threads")})
        if name.startswith("bvh_"):
            b0, b1 = bvh_ab[("cube_city", "level 0")][name], bvh_ab[("cube_city", "level 1")][name]
            s0 = bvh_ab[("sphere_field", "level 0")][name]
            accel_entries[-1].update(
                old_schedule_ms=b0["old_schedule_ms"], ran=b0["ran"], needed=b0["needed"],
                level1_ms=b1["ms"], level1_old_schedule_ms=b1["old_schedule_ms"],
                level1_bound_ms=b1["bound_ms"], level1_live=b1["live"],
                sphere_field_ms=s0["ms"], sphere_field_old_schedule_ms=s0["old_schedule_ms"],
                sphere_field_bound_ms=s0["bound_ms"],
                **{k: b0[k] for k in ("smem_bytes", "blocks_per_sm", "sms", "threads")})
            if name == "bvh_closest_n":
                per_level = {sched: [x["ms"] for x in breakdown[("cube_city_bvh", sched)]["launches"]
                                     if x["kernel"] == name] for sched in ("warp", "lane")}
                accel_entries[-1].update(
                    frame="cube_city_bvh",
                    frame_ms_all_launches=sum(per_level["warp"]),
                    frame_ms_all_launches_old_schedule=sum(per_level["lane"]),
                    frame_ms_by_level=per_level["warp"],
                    frame_ms_by_level_old_schedule=per_level["lane"])
        if not accel_entries[-1]["launches"]:
            fail(f"the acceleration path never launched {name}")

    city_frames = {(label, sched): breakdown[(label, sched)]["kernel_ms"]
                   for label in ("cube_city_bvh", "cube_city_brute") for sched in ("warp", "lane")}
    return accel_entries, city_anyhit, city_brute, city_frames, frame_seconds


def ptxas_numbers(report):
    """Registers and spill-store bytes of one entry function's ptxas lines."""
    out = dict(registers=None, spill_store_bytes=None)
    for ln in report:
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            out["spill_store_bytes"] = int(m.group(1))
    return out


def wave_plan_phase(W, _build, tables, scene):
    """Phase wave_plan: what ptxas reports for each build of the level
    kernel (wave_level_blocks_kernel<kBuild*>: staged, the reference; the
    wide table's unculled build, kept to be measured against; the windowed
    build and its counting build; the staged windowed build), the plan the
    flagship's table launches with on this card (the package's build, the
    staged windowed one), and the largest table a block stages and the
    gate takes.  Returns the plan, with each build's ptxas numbers under
    "builds"."""
    reports = {b: ptxas_report(_build, f"wave_level_blocks_kernelILi{code}E")
               for b, code in W.WAVE_BUILDS.items()}
    plan = W.wave_plan(tables)
    n_cols, g = tables.table.shape
    say("wave_plan", kernel="wave_level_blocks_kernel", ptxas=reports,
        geoms=g, n_cols=n_cols, lights=scene.n_lights, **plan,
        cap_geoms=W.wave_cap_geoms(n_cols, scene.n_lights),
        cap_geoms_untextured=W.wave_cap_geoms(31, scene.n_lights),
        cap_geoms_textured=W.wave_cap_geoms(32, scene.n_lights),
        gate_max_geoms=W.WAVE_MAX_GEOMS)
    if _build.last_build["compiled"] and not all(reports.values()):
        fail("ptxas reported nothing for a build of wave_level_blocks_kernel")
    if plan["build"] != "staged_windows":
        fail(f"the flagship's table takes the {plan['build']} build")
    plan["builds"] = {b: ptxas_numbers(r) for b, r in reports.items()}
    return plan


def wave_redesign_ab(rt, W, scene, tables, inputs, fuzz, opts, n_levels):
    """Phase wave_redesign_ab: the package's level kernel (persistent
    blocks, `wave_level`) against the one-thread-per-lane schedule of the
    same stages (`wave_level_lane`) on the inputs of every level of one
    full-width flagship tile: outputs bit-equal, ms of each by CUDA events
    in turns (lane, blocks, blocks, lane).  Then the flagship frame through
    render_to_srgb_u8 once with each kernel from one seed: bytes equal.
    Returns the per-level rows."""
    rows = []
    for lv in range(n_levels):
        prev, fz = inputs[lv], fuzz[lv]
        equal = bool(torch.equal(W.wave_level_lane(prev, fz, tables),
                                 W.wave_level(prev, fz, tables)))
        t = {}
        for turn, fn in (("lane", W.wave_level_lane), ("blocks", W.wave_level),
                         ("blocks_again", W.wave_level), ("lane_again", W.wave_level_lane)):
            t[turn] = cuda_ms(lambda: fn(prev, fz, tables), 5)
        rows.append(dict(level=lv, lanes=prev.shape[1], live=int((prev[7] > 0).sum()),
                         lane_ms=[t["lane"], t["lane_again"]],
                         blocks_ms=[t["blocks"], t["blocks_again"]], bitwise_equal=equal))
        say("wave_redesign_ab", **rows[-1])
        if not equal:
            fail(f"the two schedules of wave_level differ on level {lv}")

    def total(key, levels):
        return sum(sum(r[key]) / 2 for r in rows if r["level"] in levels)

    deep = range(1, n_levels)
    summary = dict(level0_lane_ms=total("lane_ms", [0]), level0_blocks_ms=total("blocks_ms", [0]),
                   levels_1_10_lane_ms=total("lane_ms", deep),
                   levels_1_10_blocks_ms=total("blocks_ms", deep),
                   slower_levels=[r["level"] for r in rows
                                  if max(r["blocks_ms"]) > min(r["lane_ms"])])
    # The frame: the wrapper's launcher swapped for the lane schedule's.
    real = W._launch
    frames = {}
    for name in ("blocks", "lane"):
        if name == "lane":
            W._launch = lambda q, f, tb, m, record=False: W.wave_level_lane(q, f, tb, m)
        torch.cuda.synchronize()
        t0 = time.time()
        frames[name], dropped = srgb_frame(
            rt, scene, opts, torch.Generator(device="cuda").manual_seed(3))
        torch.cuda.synchronize()
        summary[f"frame_{name}_seconds"] = time.time() - t0
        summary[f"frame_{name}_dropped"] = dropped
        W._launch = real
        if dropped:
            fail(f"the flagship frame with the {name} schedule dropped {dropped} rays")
    summary["frames_bytes_equal"] = bool(np.array_equal(frames["blocks"], frames["lane"]))
    say("wave_redesign_ab", **summary)
    if not summary["frames_bytes_equal"]:
        fail("the flagship frame differs between the two schedules of wave_level")
    if summary["level0_blocks_ms"] > summary["level0_lane_ms"] or \
            summary["levels_1_10_blocks_ms"] > summary["levels_1_10_lane_ms"]:
        say("wave_redesign_ab", warning="the redesign is slower on level 0 or on levels 1-10")
    return rows


def wave_build_ab(W, scene, tables, inputs, fuzz, n_levels):
    """Phase wave_build_ab: the level kernel's builds on the flagship's
    table (141 geoms, which a block stages with its windows), on the inputs
    of every level of one full-width tile: the package's route
    (`W.package_build`: the window cull over the staged table, windows and
    rows) against the staged build (every lane tests every row; the
    reference), the wide windowed build (the window cull reading the rows
    where they lie) and the unculled wide build, the last three launched
    through `W.wave_level_build` (not counted).  Every output torch.equal
    to the staged build's, the route's record mode too, or the run fails;
    ms of each by CUDA events in turns (route, staged, windows, unculled,
    unculled, windows, staged, route), each build's plan.  Returns the
    summary row."""
    g = tables.table.shape[1]
    route = W.package_build(tables)
    builds = {"route": route, "staged": "staged", "windows": "windows", "unculled": "unculled"}
    calls = {k: (lambda prev, fz, b=b, record=False: W.wave_level_build(prev, fz, tables, b,
                                                                        record=record))
             for k, b in builds.items()}
    plans = {k: W.wave_plan(tables, build=b) for k, b in builds.items()}
    order = ("route", "staged", "windows", "unculled")
    rows = []
    for lv in range(n_levels):
        prev, fz = inputs[lv], fuzz[lv]
        ref = calls["staged"](prev, fz)
        equal = {k: bool(torch.equal(calls[k](prev, fz), ref)) for k in order[1:] if k != "staged"}
        equal["route"] = bool(torch.equal(calls["route"](prev, fz), ref))
        del ref
        equal["route_record"] = bool(torch.equal(calls["route"](prev, fz, record=True),
                                                 calls["staged"](prev, fz, record=True)))
        t = {}
        for turn in order + tuple(f"{k}_again" for k in reversed(order)):
            k = turn.replace("_again", "")
            t[turn] = cuda_ms(lambda: calls[k](prev, fz), 5)
        rows.append(dict(level=lv, live=int((prev[7] > 0).sum()),
                         **{f"{k}_ms": [t[k], t[f"{k}_again"]] for k in order},
                         bitwise_equal=equal))
        say("wave_build_ab", **rows[-1])
        if not all(equal.values()):
            fail(f"a build differs from the staged one on the flagship's level {lv}: {equal}")

    def total(key, levels):
        return sum(sum(r[key]) / 2 for r in rows if r["level"] in levels)

    deep = range(1, n_levels)
    summary = dict(geoms=g, lanes=inputs[0].shape[1], windows=tables.windows.shape[0],
                   route=route, every_level_equal=True,
                   **{f"level0_{k}_ms": total(f"{k}_ms", [0]) for k in order},
                   **{f"levels_1_10_{k}_ms": total(f"{k}_ms", deep) for k in order},
                   slower_than_staged_levels=[r["level"] for r in rows
                                              if min(r["route_ms"]) > max(r["staged_ms"])],
                   **{f"{k}_smem_bytes": plans[k]["smem_bytes"] for k in order},
                   **{f"{k}_blocks_per_sm": plans[k]["blocks_per_sm"] for k in order},
                   nvidia_smi=smi_line())
    say("wave_build_ab", **summary)
    return summary


# The differentiable path (phase diff_path): the flagship at 1920x1080, its
# six parameter paths (FWDBWD_r5.json's configuration), a 64-row strip for
# fused-against-general gradients, and the tolerance of the CPU tests
# (tests/test_torch_diff.py): rtol 2e-4, atol 2e-4 * max|g|.
DIFF_PATHS = ("materials.diffuse", "materials.roughness", "materials.reflectivity",
              "lights.position", "lights.intensity", "camera.location")
DIFF_STRIP_ROWS = 64
GRAD_RTOL = 2e-4


def record_mode_phase(W, scene, tables, inputs, fuzz, n_levels, per_test, stride):
    """Phase diff_record: the level kernel in record mode on the inputs of
    every level of one full-width flagship tile.  Rows 0..12 torch.equal to
    the inference launch on the same input, every row torch.equal to
    wave_level_plain(record=True) on one lane in `stride`, drawn at random
    each level (`lane_sample`; the plain version is lane-wise, so a subset
    of lanes is a plain run of its own);
    level 0 with and without record in turns by CUDA events, beside the
    staged build's record launch (the route before the window cull), with
    the record launch's bound; then the backward of one level at that width
    (WaveLevelFn: the rebuild's forward and autograd, twice to equal bits)
    and its gather's reduction alone, as shipped (segment_sum) and as an
    atomic index_add_.  Returns the summary row."""
    dev = inputs[0].device
    L = tables.n_lights
    smi = smi_line()
    plain_ms = None
    need0 = None
    for lv in range(n_levels):
        prev, fz = inputs[lv], fuzz[lv]
        inf = W.wave_level(prev, fz, tables)
        rec = W.wave_level(prev, fz, tables, record=True)
        head_equal = bool(torch.equal(rec[:13], inf))
        del inf
        idx = lane_sample(torch.arange(prev.shape[1], device=dev), stride, 2000 + lv)
        need = {}
        torch.cuda.synchronize()
        t0 = time.time()
        plain = W.wave_level_plain(prev[:, idx].contiguous(), fz[:, idx].contiguous(), tables,
                                   stats=need, record=True)
        torch.cuda.synchronize()
        if lv == 0:
            plain_ms, need0 = (time.time() - t0) * 1e3, need
            hits = int((rec[12] > 0).sum())
        sub = rec[:, idx]
        rec_equal = bool(torch.equal(sub, plain))
        hit = sub[12] > 0
        say("diff_record", level=lv, lanes=prev.shape[1], live=int((prev[7] > 0).sum()),
            rows=rec.shape[0], rows_0_12_equal_inference=head_equal,
            sampled_lanes=len(idx), record_rows_equal_plain=rec_equal,
            sampled_hits=int(hit.sum()),
            sampled_visible=[int(((sub[14 + li] > 0) & hit).sum()) for li in range(L)],
            sampled_shadow_rays=need["shadow_rays"], nvidia_smi=smi)
        if not head_equal:
            fail(f"record mode changed rows 0..12 of level {lv}")
        if not rec_equal:
            fail(f"record mode is not bit-equal to its plain version on level {lv}")
        del rec, plain, sub
    prev, fz = inputs[0], fuzz[0]
    n = prev.shape[1]
    t = {}
    for turn, record in (("inference", False), ("record", True), ("record_staged", True),
                         ("record_staged_again", True), ("record_again", True),
                         ("inference_again", False)):
        if "staged" in turn:
            t[turn] = cuda_ms(lambda: W.wave_level_build(prev, fz, tables, "staged",
                                                         record=True), 5)
        else:
            t[turn] = cuda_ms(lambda: W.wave_level(prev, fz, tables, record=record), 5)
    live = int((prev[7] > 0).sum())
    scale = n / need0["lanes"]
    shadow_tests = need0["shadow_tests"] * scale
    n_bytes = 4 * (n * (1 + W.OUT_ROWS + W.record_rows(L, tables.has_tex))
                   + live * (W.Q_ROWS - 1 + 3)) \
        + 4 * (tables.table.numel() + tables.lights.numel()) \
        + (tables.tex.numel() if tables.has_tex else 0)
    flops = per_test * (live * tables.table.shape[1] + shadow_tests) + FLOPS_PER_HIT_LANE * hits
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    summary = dict(
        lanes=n, level0_inference_ms=[t["inference"], t["inference_again"]],
        level0_record_ms=[t["record"], t["record_again"]],
        level0_record_staged_ms=[t["record_staged"], t["record_staged_again"]],
        record_over_inference=(t["record"] + t["record_again"]) / (t["inference"] + t["inference_again"]),
        record_plain_ms_every_nth_lane=plain_ms, stride=stride,
        record_shadow_rays_estimated=need0["shadow_rays"] * scale,
        record_shadow_tests_estimated=shadow_tests,
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bytes_ms=bytes_ms, operations_ms=ops_ms, nvidia_smi=smi)

    # The backward of level 0 at full width, and its winner gather's
    # scatter-add alone (the one atomic pass, into <= G columns).
    from ray_tracying_tpu_torch.core.segment import segment_sum
    from ray_tracying_tpu_torch.kernels import wave_ref as WR

    leaves = [x.detach().clone().requires_grad_(True)
              for x in (prev, tables.table, tables.lights)]
    # the launcher culls only by windows built from the table it is given
    leaf_tables = W.with_windows(dataclasses.replace(tables, table=leaves[1], lights=leaves[2]),
                                 scene)
    out = W.WaveLevelFn.apply(leaves[0], fz, leaves[1], leaves[2], leaf_tables, 0.0)
    cot = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(8), device=dev)

    def backward():
        return torch.autograd.grad(out, leaves, cot, retain_graph=True)

    first = backward()  # the first call loads the CUDA modules of its kernels
    again = backward()
    summary["level0_backward_ms"] = cuda_ms(backward, 3)
    summary["level0_backward_bits_repeat"] = all(
        bool(torch.equal(a, b)) for a, b in zip(first, again))
    best_id, vis, texel = W.split_record(out.detach(), L, tables.has_tex)
    summary["level0_rebuild_forward_ms"] = cuda_ms(lambda: WR.wave_level_ref(
        prev, fz, tables.table, tables.lights, best_id, vis, texel,
        kinds=[k for k, _, _ in tables.ranges], n_lights=L, glossy=tables.glossy), 3)
    # The gather's backward (the one reduction onto the table's columns):
    # segment_sum as shipped, and an atomic index_add_ of the same terms.
    rows = torch.clamp(WR.winner_rows(tables.table, best_id), min=0)
    g29 = torch.randn((29, n), generator=torch.Generator(device=dev).manual_seed(9), device=dev)
    target = torch.zeros((29, tables.table.shape[1]), device=dev)
    summary["level0_gather_segment_sum_ms"] = cuda_ms(
        lambda: segment_sum(g29, rows, tables.table.shape[1]), 3)
    summary["level0_gather_index_add_ms"] = cuda_ms(
        lambda: target.zero_().index_add_(1, rows, g29), 3)
    summary["segment_sum_vs_index_add_max_abs_diff"] = float(
        (segment_sum(g29, rows, tables.table.shape[1]) - target).abs().max())
    del leaves, out, cot, rows, g29, first, again
    say("diff_record", **summary)
    return summary


def _grads_ok(grads):
    return {k: dict(finite=bool(torch.isfinite(g).all()), nonzero=bool((g != 0).any()),
                    max_abs=float(g.abs().max())) for k, g in grads.items()}


def strip_agreement(rt, W, CH, scene, label, n_levels, dev, smi):
    """Fused against general gradients of (radiance * a seeded weight).sum()
    on a DIFF_STRIP_ROWS-row strip at 1 spp through the middle of `scene`,
    the six parameter paths, both paths fed the same rays, glossy fuzz and
    area-light jitter.  Fails past GRAD_RTOL; returns the agreement."""
    from ray_tracying_tpu_torch.core.sampling import uniform_in_unit_sphere
    from ray_tracying_tpu_torch.diff import params as P
    from ray_tracying_tpu_torch.render.integrator import trace_wavefront
    from ray_tracying_tpu_torch.render.pipeline import tile_rays

    width, height = scene.camera.resolution
    n = DIFF_STRIP_ROWS * width
    gen = torch.Generator(device=dev).manual_seed(21)
    draws = {}
    if scene.has_glossy:
        draws["fuzz"] = [uniform_in_unit_sphere(gen, (n,)).T.contiguous()
                         for _ in range(n_levels)]
    if any(scene.lights.is_area):
        draws["light_jitter"] = [[uniform_in_unit_sphere(gen, (n, 1)) if a else None
                                  for a in scene.lights.is_area] for _ in range(n_levels)]
    weight = torch.rand((n, 3), generator=gen, device=dev) + 0.5
    y0 = height // 2 - DIFF_STRIP_ROWS // 2
    strip = {}

    def strip_grads(fused):
        theta = P.extract(scene, DIFF_PATHS)
        sc = P.apply(scene, theta)
        o, d, tm = tile_rays(sc.camera, y0, DIFF_STRIP_ROWS, width, 1,
                             generator=torch.Generator(device=dev).manual_seed(22))
        rad = trace_wavefront(sc, o, d, tm, differentiable=True, fused=fused, device=dev,
                              **draws)
        return torch.autograd.grad((rad * weight).sum(), list(theta.values()))

    for name, fused in (("fused", True), ("general", False)):
        torch.cuda.synchronize()
        t0 = time.time()
        strip_grads(fused)  # the first call loads its kernels' CUDA modules
        torch.cuda.synchronize()
        first_s = time.time() - t0
        CH.brute_closest.launches = CH.occlusion_any.launches = 0
        W.wave_level.launches = W.wave_level.record_launches = 0
        t0 = time.time()
        grads = strip_grads(fused)
        torch.cuda.synchronize()
        strip[name] = dict(zip(DIFF_PATHS, grads))
        say("diff_path", case="strip", scene=label, path=name, lanes=n,
            seconds=time.time() - t0, first_call_seconds=first_s,
            launches=dict(wave_level=W.wave_level.launches,
                          wave_level_record=W.wave_level.record_launches,
                          brute_closest=CH.brute_closest.launches,
                          occlusion_any=CH.occlusion_any.launches),
            grads=_grads_ok(strip[name]), nvidia_smi=smi)
        if fused and not W.wave_level.record_launches:
            fail(f"the fused strip of {label} launched no record-mode level")
        del grads
    agree = {}
    for k in DIFF_PATHS:
        a, b = strip["fused"][k], strip["general"][k]
        tol = GRAD_RTOL * b.abs() + GRAD_RTOL * max(1.0, float(b.abs().max()))
        agree[k] = dict(ok=bool(((a - b).abs() <= tol).all()),
                        max_abs_diff=float((a - b).abs().max()), max_abs=float(b.abs().max()))
    say("diff_path", case="strip fused vs general", scene=label, rtol=GRAD_RTOL,
        atol=f"{GRAD_RTOL} * max(1, max|g|)", agree=agree, nvidia_smi=smi)
    if not all(v["ok"] for v in agree.values()):
        fail(f"fused and general gradients disagree on the strip of {label}")
    return agree


def diff_path_phase(rt, W, CH, scene, n_levels, dev):
    """Phase diff_path: differentiable rendering of the flagship at
    1920x1080 (FWDBWD_r5.json's configuration), the port's training path.
    (a) fused against general gradients on a 64-row strip at 1 spp, the six
    parameter paths (`strip_agreement`), of the flagship, of cornell, of
    the motion demo and of cube_city (the wide build) at its width; (b) the whole frame at 1 spp through
    mse_loss: forward seconds (no graph), forward and backward seconds with a synchronize
    after the gradients are read, peak memory, every gradient finite and
    not all zero; (c) the same through mse_loss_and_grad_tiled at 4x4 spp;
    (d) fit(tiled=True) for 3 steps against a target rendered with the
    diffuse albedo at 0.6 times, the loss falling, a checkpoint after step
    2 restored and step 3 redone to the same values.  The counts are set
    to 0 before (b)-(d) and read after."""
    import shutil
    import tempfile

    from ray_tracying_tpu_torch.diff import params as P
    from ray_tracying_tpu_torch.diff import render as DR
    from ray_tracying_tpu_torch.diff.optimize import fit

    width, height = scene.camera.resolution
    smi = smi_line()
    result = {}

    # (a) the strip, both paths, the same rays and draws: the flagship,
    # then cornell (legacy planes, one-way glass, an area light), motion
    # (moving spheres) and cube_city (2,049 geoms: the level's wide build)
    # at its width.
    result["strip"] = strip_agreement(rt, W, CH, scene, "flagship", n_levels, dev, smi)
    for name in ("cornell", "motion", "cube_city"):
        result[f"strip_{name}"] = strip_agreement(
            rt, W, CH, widened_scene(rt, name, dev), name, n_levels, dev, smi)

    # The target: the frame at 1 spp with the diffuse albedo at 0.6 times.
    opts1 = rt.RenderOptions(samples_sqrt=1, light_samples=1)
    with torch.no_grad():
        target = DR.render_linear(
            P.apply(scene, {"materials.diffuse": scene.materials.diffuse * 0.6}), 0, opts1,
            dev)

    # (b)-(d): the counts set to 0 here and read at the end.
    CH.brute_closest.launches = CH.occlusion_any.launches = 0
    W.wave_level.launches = W.wave_level.record_launches = 0

    def step(run, forward, opts, label, rays):
        theta = P.extract(scene, DIFF_PATHS)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.time()
        loss, grads = run(theta, opts)
        g = {k: grads[k] for k in DIFF_PATHS}
        checked = _grads_ok(g)  # reads every gradient
        torch.cuda.synchronize()
        secs = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.time()
            fwd_loss = float(forward(theta, opts))
            torch.cuda.synchronize()
            fwd = time.time() - t0
        row = dict(case=label, primary_rays=rays, forward_seconds=fwd,
                   forward_backward_seconds=secs, forward_rays_per_s=rays / fwd,
                   forward_backward_rays_per_s=rays / secs, peak_memory_bytes=peak,
                   loss=float(loss.detach()), forward_loss=fwd_loss, grads=checked, nvidia_smi=smi)
        say("diff_path", **row)
        if not all(c["finite"] and c["nonzero"] for c in checked.values()):
            fail(f"{label}: a gradient is not finite or is all zero")
        return row

    def whole(theta, opts):
        loss = DR.mse_loss(P.apply(scene, theta), target, 0, opts, dev)
        return loss, dict(zip(theta, torch.autograd.grad(loss, list(theta.values()))))

    def tiled(theta, opts):
        return DR.mse_loss_and_grad_tiled(scene, theta, target, 0, opts, dev)

    def whole_forward(theta, opts):
        return DR.mse_loss(P.apply(scene, theta), target, 0, opts, dev)

    def tiled_forward(theta, opts):
        return DR.mse_loss_tiled(scene, theta, target, 0, opts, dev)

    step(whole, whole_forward, opts1, "whole frame 1 spp, warm-up", width * height)
    result["whole"] = step(whole, whole_forward, opts1, "whole frame 1 spp", width * height)
    opts16 = rt.RenderOptions(samples_sqrt=4, light_samples=1)
    result["tiled"] = step(tiled, tiled_forward, opts16, "tiled 4x4 spp", width * height * 16)

    # (d) fit, tiled, 3 steps; then the checkpoint after step 2 restored
    # and step 3 redone.
    ckdir = tempfile.mkdtemp(prefix="rtt_fit_")
    try:
        common = dict(steps=3, learning_rate=5e-2, opts=opts1, resample_noise=False,
                      tiled=True, checkpoint_dir=ckdir, checkpoint_every=2, device=dev)
        torch.cuda.synchronize()
        t0 = time.time()
        _, theta3, hist = fit(scene, target, ["materials.diffuse"], **common)
        torch.cuda.synchronize()
        fit_s = time.time() - t0
        # the step-2 checkpoint is the newest: a second fit resumes there
        # and redoes step 3
        saved = sorted(os.listdir(ckdir))
        _, theta_b, hist_b = fit(scene, target, ["materials.diffuse"], **common)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    a, b = theta3["materials.diffuse"], theta_b["materials.diffuse"]
    fit_row = dict(case="fit tiled 3 steps", history=hist, seconds=fit_s,
                   checkpoints=saved, resumed_history=hist_b,
                   resumed_step3_loss_equal=hist_b == hist[2:],
                   resumed_theta_max_abs_diff=float((a - b).abs().max()),
                   nvidia_smi=smi)
    say("diff_path", **fit_row)
    if not (hist[0] > hist[1] > hist[2]):
        fail(f"the fit's loss did not fall step on step: {hist}")
    if len(hist_b) != 1 or hist_b != hist[2:]:
        fail("the resumed fit did not redo step 3 to the same loss")
    if not torch.allclose(a, b, rtol=1e-5, atol=1e-7):
        fail("the resumed fit's theta differs from the uninterrupted one")
    launches = dict(wave_level=W.wave_level.launches,
                    wave_level_record=W.wave_level.record_launches,
                    brute_closest=CH.brute_closest.launches,
                    occlusion_any=CH.occlusion_any.launches)
    say("diff_path", case="launches of (b)-(d)", launches=launches, nvidia_smi=smi)
    if not launches["wave_level_record"]:
        fail("the differentiable path launched no record-mode level")
    result["fit"] = fit_row
    result["launches"] = launches
    return result

# Phase fused_widened: the fused level's specialisations at the flagship's
# width, each a scene the JAX package's fused kernel takes: (name, samples
# per pixel a side, light samples).  cornell: legacy planes, one-way glass,
# a mirror, an area light; motion: the demo's moving spheres; sphere_field
# with a texture on every third geom: spherical UV.
WIDENED_CASES = (("cornell", 4, 4), ("motion", 4, 1), ("sphere_field_textured", 2, 1),
                 ("cube_city", 2, 1), ("sphere_field_textured_3000", 2, 1))
WIDENED_SPHERES = 1500
WIDENED_RES = (1920, 1080)
# Tables over what a block stages (the level's wide build): cube_city's
# 2,049 geoms, a textured sphere_field of 3,001, and the gate's edge of
# 6,144 (levels 0 and 1 of one tile, phase wide_edge).  The plain version
# of such a level runs on one live lane in WIDE_STRIDE of each level, drawn
# at random (`lane_sample`).
WIDE_SPHERES = 3000
WIDE_EDGE_SPHERES = 6143
WIDE_STRIDE = ACCEL_SIZES["stride"]


def shrink_phase(rt, W, G, scene, tables, o, d, tm, fuzz, full_levels, sched, opts,
                 n_levels):
    """Phase shrink, on one full-width flagship tile with its fuzz fed in:
    (a) the trace without shrink and with the main path's schedule: the
    radiance torch.equal, the live counts equal, nothing dropped, 11
    launches each; (b) each level's launch at its width (the shrunk levels'
    inputs rebuilt with the trace's own compaction and their fuzz gathered
    by dest: the outputs equal the trace's, and bit-equal to the plain
    version on the live lanes) against the same level at full width and
    against the staged build at its width (the route before the window
    cull), in turns, with the shrunk levels' bounds; the compactions' ms;
    the levels the package's route is slower on than the staged build;
    (c) the
    tile traced with draws from a generator both ways, in turns; (d) the
    flagship frame through render_to_srgb_u8 with the pipeline's shrink and
    with it turned off (tile_shrink patched to ()), in turns, from one seed
    each: seconds, launches and dropped counts, and the two frames held to
    the stochastic contract (the shrunk levels draw their fuzz at their
    width) and to the limit of `witness_check`, set by the unshrunk frame
    from another seed.  Returns the row for the kernels line."""
    from ray_tracying_tpu_torch.render import pipeline as PL

    smi = smi_line()
    n, dev = o.shape[0], o.device
    # (a)
    runs = {}
    for name, s_ in (("unshrunk", ()), ("shrunk", sched)):
        W.wave_level.launches = 0
        runs[name] = G.trace_wavefront(scene, o, d, tm, fuzz=fuzz, tables=tables, shrink=s_,
                                       return_stats=True, return_levels=True)
        runs[name] += (W.wave_level.launches,)
    (rad0, st0, _, launches0), (rad1, st1, shrunk, launches1) = runs["unshrunk"], runs["shrunk"]
    bounds, widths = G.shrink_plan(n, n_levels, sched)
    row = dict(tile_lanes=n, shrink=sched, stage_levels=bounds, stage_widths=[n] + widths[1:],
               radiance_equal=bool(torch.equal(rad0, rad1)),
               live_unshrunk=st0.live.tolist(), live_shrunk=st1.live.tolist(),
               dropped_shrunk=st1.dropped.tolist(), launches=[launches0, launches1],
               nvidia_smi=smi)
    say("shrink", **row)
    if not row["radiance_equal"] or row["live_unshrunk"] != row["live_shrunk"]:
        fail("the tile traced with shrink differs from the tile traced without")
    if any(row["dropped_shrunk"]) or launches0 != n_levels or launches1 != n_levels:
        fail(f"the shrunk tile dropped {row['dropped_shrunk']}, launched {launches1}")
    del rad0, rad1
    # (b)
    boot = torch.cat([o.T, d.T, tm[None], torch.ones((2, n), device=dev)]).contiguous()
    levels_rows = []
    compaction_ms = {}
    kept_prev = None
    for lv in range(n_levels):
        full_in = boot if lv == 0 else full_levels[lv - 1]
        dest = shrunk.dest[lv]
        if dest is None:
            inp, fz = full_in, fuzz[lv]
        else:
            width = shrunk[lv].shape[1]
            kept = dest[dest >= 0]
            if lv in bounds[1:-1]:
                inp, kept_again, _ = G._shrink(shrunk[lv - 1], width, kept_prev)
                compaction_ms[lv] = cuda_ms(lambda: G._shrink(shrunk[lv - 1], width, kept_prev), 3)
                if not torch.equal(kept_again, kept):
                    fail(f"the compaction at level {lv} kept other lanes than the trace's")
            else:
                inp = shrunk[lv - 1]
            fz = G._gather_draws(fuzz[lv], kept, width, 1).contiguous()
            kept_prev = kept
        lrow = dict(level=lv, width=inp.shape[1], live=int((inp[7] > 0).sum()))
        if dest is not None:
            out = W.wave_level(inp, fz, tables)
            need = {}
            res, _ = compare_level(out, plain_on_live(W, inp, fz, tables, need))
            lrow.update(equal_to_trace=bool(torch.equal(out, shrunk[lv])),
                        bitwise_equal_to_plain=res["bitwise_equal"],
                        **level_bound(W, tables, inp.shape[1], need, int((out[12] > 0).sum())))
            if not (lrow["equal_to_trace"] and res["bitwise_equal"]):
                fail(f"shrunk level {lv}: the kernel differs from the trace or the plain version")
            del out
        t = {}
        for turn, (q, f) in (("full", (full_in, fuzz[lv])), ("at_width", (inp, fz)),
                             ("staged", (inp, fz)), ("staged_again", (inp, fz)),
                             ("at_width_again", (inp, fz)), ("full_again", (full_in, fuzz[lv]))):
            if turn.startswith("staged"):
                t[turn] = cuda_ms(lambda: W.wave_level_build(q, f, tables, "staged"), 3)
            else:
                t[turn] = cuda_ms(lambda: W.wave_level(q, f, tables), 3)
        lrow.update(ms=[t["at_width"], t["at_width_again"]],
                    staged_ms=[t["staged"], t["staged_again"]],
                    full_width_ms=[t["full"], t["full_again"]])
        say("shrink", **lrow)
        levels_rows.append(lrow)
    row.update(compaction_ms=compaction_ms,
               levels_ms=sum(sum(r["ms"]) / 2 for r in levels_rows),
               levels_staged_ms=sum(sum(r["staged_ms"]) / 2 for r in levels_rows),
               slower_than_staged_levels=[r["level"] for r in levels_rows
                                          if min(r["ms"]) > max(r["staged_ms"])],
               levels_full_width_ms=sum(sum(r["full_width_ms"]) / 2 for r in levels_rows))
    # (c)
    gen = torch.Generator(device=dev).manual_seed(7)
    for turn in ("unshrunk", "shrunk", "shrunk_again", "unshrunk_again"):
        s_ = () if turn.startswith("unshrunk") else sched
        row[f"trace_with_draws_ms_{turn}"] = cuda_ms(lambda: G.trace_wavefront(
            scene, o, d, tm, generator=gen, tables=tables, shrink=s_), 3)
    # (d)
    width, height = scene.camera.resolution
    spp = opts.samples_sqrt ** 2
    tile_rows = min(height, opts.max_rays_per_pass // (width * spp))
    n_tiles = -(-height // tile_rows)
    real = PL.tile_shrink
    frames, seconds, dropped, launched = {}, {}, {}, {}
    for turn in ("unshrunk", "shrunk", "shrunk_again", "unshrunk_again"):
        if turn.startswith("unshrunk"):
            PL.tile_shrink = lambda lanes, spp_: ()
        W.wave_level.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        frames[turn], dropped[turn] = srgb_frame(
            rt, scene, opts, torch.Generator(device=dev).manual_seed(2), device=dev)
        torch.cuda.synchronize()
        seconds[turn] = time.time() - t0
        launched[turn] = W.wave_level.launches
        PL.tile_shrink = real
    PL.tile_shrink = lambda lanes, spp_: ()
    witness, dropped["witness"] = srgb_frame(
        rt, scene, opts, torch.Generator(device=dev).manual_seed(3), device=dev)
    PL.tile_shrink = real
    seen, seen_ok = witness_check(frames["shrunk"], frames["unshrunk"], witness)
    diff = np.abs(frames["shrunk"].astype(np.float32) - frames["unshrunk"].astype(np.float32))
    row.update(frame_seconds=seconds, frame_dropped=dropped, frame_launches=launched, **seen,
               frames_repeat=bool(np.array_equal(frames["shrunk"], frames["shrunk_again"])
                                  and np.array_equal(frames["unshrunk"],
                                                     frames["unshrunk_again"])),
               frames_mean_diff=float(diff.mean()), frames_p99=float(np.percentile(diff, 99)),
               frames_max_diff=float(diff.max()), frames_off_share=float((diff > 0).mean()))
    say("shrink", **{k: v for k, v in row.items() if k not in ("live_unshrunk", "live_shrunk")})
    if any(dropped.values()) or set(launched.values()) != {n_levels * n_tiles}:
        fail(f"the flagship frames dropped {dropped}, launched {launched}")
    if not (row["frames_repeat"] and row["frames_mean_diff"] < 1.0 and row["frames_p99"] <= 8):
        fail("the flagship frames with and without shrink are outside the stochastic "
             "contract, or do not repeat")
    if not seen_ok:
        fail("the flagship frames with and without shrink differ by more than two "
             "unshrunk frames from two seeds")
    row["levels"] = levels_rows
    return row


CLI_CASES = (("flagship", "golden/ASCII/scene.json", []),
             ("bvh_det_bvh", "golden/ASCII/bvh_det.json", ["-bvh", "-s", "1"]))


def cli_phase(rt, dev):
    """Phase cli: `python -m ray_tracying_tpu_torch.cli` in a subprocess on
    the flagship (its defaults: 4x4 samples) and on bvh_det with -bvh -s 1
    (the general path's traversal and any-hit), both with --seed 3; the
    PPM's bytes must equal render_to_srgb_u8 + write_ppm of the same scene,
    options and seed in this process (in the stats mode, which counts the
    frame's drops: 0).  Prints the CLI's own rays/s line."""
    out_dir = os.path.join(REPO, "ray_tracying_tpu_torch", "build", "smoke_cli")
    os.makedirs(out_dir, exist_ok=True)
    rows = {}
    for name, scene_path, flags in CLI_CASES:
        cli_ppm, api_ppm = (os.path.join(out_dir, f"{name}_{k}.ppm") for k in ("cli", "api"))
        cmd = [sys.executable, "-m", "ray_tracying_tpu_torch.cli", "-input", scene_path,
               "-output", os.path.basename(cli_ppm), "--output-dir", out_dir, "--seed", "3",
               "--device", str(dev), *flags]
        t0 = time.time()
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
        wall = time.time() - t0
        if proc.returncode != 0:
            fail(f"the CLI exited {proc.returncode} on {name}: {proc.stderr[-2000:]}")
        rays_line = [ln for ln in proc.stdout.splitlines() if "Mrays/s" in ln]
        use_bvh = "-bvh" in flags
        sqrt_spp = int(flags[flags.index("-s") + 1]) if "-s" in flags else 4
        img, dropped = srgb_frame(
            rt, rt.load_scene(os.path.join(REPO, scene_path), device=dev),
            rt.RenderOptions(samples_sqrt=sqrt_spp, use_bvh=use_bvh),
            torch.Generator(device=dev).manual_seed(3), device=dev)
        rt.write_ppm(api_ppm, img)
        with open(cli_ppm, "rb") as a, open(api_ppm, "rb") as b:
            equal = a.read() == b.read()
        rows[name] = dict(argv=cmd[2:], process_seconds=wall, rays_line=rays_line,
                          bytes_equal=equal, ppm_bytes=os.path.getsize(cli_ppm),
                          api_dropped=dropped)
        say("cli", case=name, **rows[name])
        for path in (cli_ppm, api_ppm):
            os.remove(path)
        if not (equal and rays_line):
            fail(f"the CLI's {name} image differs from the API's bytes")
        if dropped:
            fail(f"the API's {name} frame dropped {dropped} continuations")
    return rows


def native_phase(rt, dev):
    """Phase native: the host LBVH build of the 20,001-geom sphere_field by
    the native builder and by the numpy build_lbvh, in turns (arrays
    equal), and the PPM writer on a 1920x1080 frame, native and Python
    (bytes equal).  Host seconds."""
    from ray_tracying_tpu_torch import models, native
    from ray_tracying_tpu_torch.accel import lbvh as L
    from ray_tracying_tpu_torch.io import ppm

    scene = models.get("sphere_field", n=ACCEL_SIZES["spheres"], res=ACCEL_SIZES["res"],
                       device="cpu")
    aabbs = L.geom_aabbs(scene)
    native.load()
    row = dict(geoms=scene.n_geoms, build_seconds=native.last_build["seconds"],
               build_compiled=native.last_build["compiled"])
    trees = {}
    for turn in ("native", "numpy", "numpy_again", "native_again"):
        build = (lambda a: native.lbvh_build(a, L.LEAF_SIZE)) if turn.startswith("native") \
            else L.build_lbvh
        t0 = time.time()
        trees[turn] = build(aabbs)
        row[f"lbvh_{turn}_seconds"] = time.time() - t0
    row["lbvh_arrays_equal"] = all(
        a.tobytes() == b.tobytes() for a, b in zip(trees["native"], trees["numpy"]))
    img = np.random.default_rng(4).integers(0, 256, (1080, 1920, 3), dtype=np.uint8)
    out_dir = os.path.join(REPO, "ray_tracying_tpu_torch", "build")
    paths = {k: os.path.join(out_dir, f"smoke_{k}.ppm") for k in ("native", "python")}
    for k, write in (("native", ppm.write_ppm), ("python", ppm.write_ppm_plain)):
        t0 = time.time()
        write(paths[k], img)
        row[f"ppm_write_{k}_seconds"] = time.time() - t0
    with open(paths["native"], "rb") as a, open(paths["python"], "rb") as b:
        row["ppm_bytes_equal"] = a.read() == b.read()
    t0 = time.time()
    back = ppm.read_ppm(paths["native"])
    row["ppm_read_native_seconds"] = time.time() - t0
    row["ppm_read_back_equal"] = bool(np.array_equal(back, img))
    for path in paths.values():
        os.remove(path)
    say("native", **row)
    if not (row["lbvh_arrays_equal"] and row["ppm_bytes_equal"] and row["ppm_read_back_equal"]):
        fail("the native builders differ from their plain versions")
    return row


def widened_scene(rt, name, dev):
    from ray_tracying_tpu_torch import models

    if name == "cornell":
        return models.get("cornell", res=WIDENED_RES, device=dev)
    if name == "motion":
        scene = load_demo(rt, "motion", dev)
        return dataclasses.replace(
            scene, camera=dataclasses.replace(scene.camera, resolution=WIDENED_RES))
    if name == "cube_city":
        return models.get("cube_city", n=ACCEL_SIZES["cubes"], res=WIDENED_RES, device=dev)
    n = WIDE_SPHERES if name == "sphere_field_textured_3000" else WIDENED_SPHERES
    field = models.get("sphere_field", n=n, res=WIDENED_RES, device=dev)
    return with_texture(field, load_demo(rt, "texture", dev))


def level_bound(W, tables, n, need, hits, box_tests=0.0):
    """Least time of one level call, reckoned as the main path's: bytes =
    every lane's act read and its 13 rows written, a live lane's other 8
    queue rows and its fuzz rows read, the tables once; operations = the
    geom tests of the live lanes' closest hits and of the shadow rays cast
    (each up to its first blocker; an area light's nss a lane), at the
    table's mean cost of a test, the shading of the hit lanes and
    `box_tests` window box tests.  `need` counts every test the unculled
    level runs, or (a wide table's second bound) only the tests a per-ray
    window cull cannot avoid (`wave_level_plain`'s window counts)."""
    n_bytes = 4 * (n * (1 + W.OUT_ROWS) + need["live"] * (W.Q_ROWS - 1 + W.fuzz_rows(tables))) \
        + 4 * (tables.table.numel() + tables.lights.numel()) \
        + (tables.tex.numel() if tables.has_tex else 0)
    per_test = sum(FLOPS_PER_TEST[k] * (e - s) for k, s, e in tables.ranges) \
        / tables.table.shape[1]
    flops = per_test * (need["closest_tests"] + need["shadow_tests"]) + FLOPS_PER_HIT_LANE * hits \
        + FLOPS_PER_BOX_TEST * box_tests
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_ms=bytes_ms, operations_ms=ops_ms, needed_bytes=n_bytes)


def plain_on_live(W, prev, fz, tables, need):
    """wave_level_plain of the lanes that enter live, at full width: the
    plain version is lane-wise, so it runs on those lanes alone, and a dead
    lane's rows are zero.  `need` receives its counts for the whole width."""
    n = prev.shape[1]
    idx = torch.nonzero(prev[7] > 0).squeeze(1)
    out = torch.zeros((W.OUT_ROWS, n), dtype=torch.float32, device=prev.device)
    need.update(lanes=n, live=0, closest_tests=0, shadow_rays=0, shadow_tests=0)
    if len(idx):
        out[:, idx] = W.wave_level_plain(
            prev[:, idx].contiguous(), None if fz is None else fz[:, idx].contiguous(),
            tables, stats=need)
        need["lanes"] = n
    return out


def lane_sample(lanes, stride, seed):
    """One in `stride` of `lanes` (a 1-D index tensor), drawn at random
    from `seed` and kept in order; stride 1 keeps every lane.  A fixed
    stride would not do: a block's chunk of the live list deals entries
    tid and tid + 256 to one thread, so every 64th list entry is always
    lane 0 of warps 0, 2, 4 and 6, and a fault of any other thread slot
    would pass.  Random lanes fall to every slot."""
    if stride == 1:
        return lanes
    gen = torch.Generator(device=lanes.device).manual_seed(seed)
    pick = torch.randperm(len(lanes), generator=gen, device=lanes.device)
    return lanes[pick[: -(-len(lanes) // stride)].sort().values]


def window_need(tables, rb, bound, first_pos=None):
    """What a per-ray window cull cannot avoid, by ray: (geom tests, box
    tests) of the rays `rb` over the windows of a wide table, in window
    order.  A ray enters a window when the slab test of its box (exact,
    without the kernel's slack) meets it no farther than `bound`
    (Euclidean; -inf: a ray that casts nothing).  Without `first_pos`, a
    closest hit: the rows of every window entered, a box test a window.
    With it (each ray's first blocker as a place in the windows' visiting
    order, G for none), a shadow ray: the rows of the windows entered
    before the blocker's, the blocker's window up to and including it, and
    a box test for each window up to the blocker's."""
    from ray_tracying_tpu_torch.core import constants as C
    from ray_tracying_tpu_torch.kernels import wavefront as W

    first, count = W.window_spans(tables)
    o = (rb.ox, rb.oy, rb.oz)
    d = (rb.dx, rb.dy, rb.dz)
    inf = float("inf")
    cast = bound > -inf
    tests = torch.zeros_like(bound, dtype=torch.int64)
    boxes = torch.zeros_like(tests)
    for w, box in enumerate(tables.windows[:, :6].tolist()):
        t0 = torch.full_like(bound, -inf)
        t1 = torch.full_like(bound, inf)
        miss = torch.zeros_like(cast)
        for a in range(3):
            par = torch.abs(d[a]) < C.EPS_PARALLEL
            ds = torch.where(par, 1.0, d[a])
            s1 = (box[a] - o[a]) / ds
            s2 = (box[a + 3] - o[a]) / ds
            t0 = torch.maximum(t0, torch.where(par, -inf, torch.minimum(s1, s2)))
            t1 = torch.minimum(t1, torch.where(par, inf, torch.maximum(s1, s2)))
            miss = miss | (par & ((o[a] < box[a]) | (o[a] > box[a + 3])))
        entered = cast & ~miss & (t0 <= t1) & (t1 >= 0.0) & (t0 * rb.dnorm <= bound)
        lo, n = int(first[w]), int(count[w])
        if first_pos is None:
            tests += entered * n
            boxes += cast
            continue
        reach = cast & (first_pos >= lo)
        inside = first_pos < lo + n
        tests += torch.where(reach & inside, first_pos - lo + 1, (reach & entered) * n)
        boxes += reach
    return tests, boxes


@contextlib.contextmanager
def window_need_counts(W, tables, live, need):
    """For the second bound of a wide table's level: while one
    wave_level_plain call runs (`live`: its lanes that enter live), count
    into `need` what a per-ray window cull cannot avoid (`window_need`):
    closest_window_tests, the rows of the windows whose box a live ray
    enters no farther than its final best t, and closest_window_boxes, a
    box test a window; shadow_window_tests, the rows of the windows a
    shadow ray enters within its reach, visited in window order up to and
    including its first blocker, and shadow_window_boxes, the windows it
    reaches.  The plain version's two row loops (`W.closest_rows`,
    `W.shadow_rows`) are swapped for the same loops that also note each
    shadow ray's first blocker in the windows' order; its outputs do not
    change."""
    perm = tables.perm_rows[:, 15].contiguous().view(torch.int32).to(torch.int64)
    pos = torch.empty_like(perm)
    pos[perm] = torch.arange(len(perm), device=perm.device)
    pos = pos.tolist()
    inf = float("inf")
    need.update(closest_window_tests=0, closest_window_boxes=0, shadow_window_tests=0,
                shadow_window_boxes=0)
    closest, shadow = W.closest_rows, W.shadow_rows

    def closest_rows(rows, tb, rb):
        best = closest(rows, tb, rb)
        tests, _ = window_need(tables, rb, torch.where(live, best[0], -inf))
        need["closest_window_tests"] += int(tests.sum())
        need["closest_window_boxes"] += int(live.sum()) * tables.windows.shape[0]
        return best

    def shadow_rows(rows, ranges, srb, maxt, s_act, count):
        blocked, tests = ~s_act, 0
        first_pos = torch.full(maxt.shape, len(rows), dtype=torch.int64, device=maxt.device)
        for kind, start, end in ranges:
            for g in range(start, end):
                if count:
                    tests += int((~blocked).sum())
                hit = W.geom_t(rows[g], srb, kind) <= maxt
                blocked = blocked | hit
                first_pos = torch.where(hit & (first_pos > pos[g]), pos[g], first_pos)
        t, b = window_need(tables, srb, torch.where(s_act, maxt, -inf), first_pos)
        need["shadow_window_tests"] += int(t.sum())
        need["shadow_window_boxes"] += int(b.sum())
        return blocked, tests

    W.closest_rows, W.shadow_rows = closest_rows, shadow_rows
    try:
        yield need
    finally:
        W.closest_rows, W.shadow_rows = closest, shadow


def sampled_plain(W, tables, samples):
    """wave_level_plain on the sampled lanes of each level of a trace the
    kernel ran (`samples`: by level, the lanes' queue rows `q`, fuzz rows
    `fz` and the kernel's output `out`), against the kernel's output.  The
    plain version is lane-wise, so each level's lanes are a plain run of
    their own: levels 0 and 1 run alone (their counts size the bounds; a
    wide table's also the window counts, `window_need_counts`), the
    deeper ones as one call of their lanes side by side (the plain
    version's cost is per table row).  Yields (level, compare_level's
    result, the call's ms, the call's levels, its counts)."""
    groups = [[0], [1], list(range(2, len(samples)))]
    for grp in [[lv for lv in g if lv < len(samples)] for g in groups]:
        widths = [samples[lv]["q"].shape[1] for lv in grp]
        if not sum(widths):
            for lv in grp:
                yield lv, compare_level(samples[lv]["out"], samples[lv]["out"])[0], 0.0, grp, {}
            continue
        q = torch.cat([samples[lv]["q"] for lv in grp], dim=1).contiguous()
        fz = None
        if samples[grp[0]]["fz"] is not None:
            fz = torch.cat([samples[lv]["fz"] for lv in grp], dim=1).contiguous()
        need = {}
        counted = window_need_counts(W, tables, q[7] > 0, need) \
            if tables.windows is not None and grp[0] < 2 else contextlib.nullcontext()
        torch.cuda.synchronize()
        t0 = time.time()
        with counted:
            b = W.wave_level_plain(q, fz, tables, stats=need)
        torch.cuda.synchronize()
        ms = (time.time() - t0) * 1e3
        for lv, part in zip(grp, torch.split(b, widths, dim=1)):
            yield lv, compare_level(samples[lv]["out"], part)[0], ms, grp, need


# Repetitions of each turn of phase wide_window_ab (the unculled build's
# level 0 takes 0.2-0.55 s on the wide tables).
WINDOW_REPS = 3


def window_ab(W, prev, fz, tables, name, lv):
    """Phase wide_window_ab, one level of a tile: the package's build (a
    window cull, `W.package_build`) against the build it is held to, both
    launched through `W.wave_level_build` (not counted): the staged build
    (every lane tests every row of the staged table) where it takes the
    table (`W.stages_table`: the route before the window cull), else the
    unculled wide build (the same from global memory; kept only to be
    measured against).  Outputs `torch.equal` on every lane, in inference
    and in record mode; ms of each by CUDA events in turns (windowed, base,
    base, windowed); the counting build's tests a live lane
    (W.WINDOW_WORK), its output equal too.  Returns the row."""
    def run(build, record=False, work=None):
        return W.wave_level_build(prev, fz, tables, build, record=record, work=work)

    new = W.package_build(tables)
    base = "staged" if W.stages_table(tables) else "unculled"
    live = int((prev[7] > 0).sum())
    a = run(new)
    equal = bool(torch.equal(a, run(base)))
    work = torch.zeros(len(W.WINDOW_WORK), dtype=torch.int64, device=prev.device)
    count_equal = bool(torch.equal(a, run("windows_count", work=work)))
    del a
    rec_equal = bool(torch.equal(run(new, record=True), run(base, record=True)))
    t = {}
    for turn, build in (("new", new), ("old", base), ("old_again", base), ("new_again", new)):
        t[turn] = cuda_ms(lambda: run(build), WINDOW_REPS)
    row = dict(case=name, level=lv, lanes=prev.shape[1], live=live, build=new, base=base,
               windowed_ms=[t["new"], t["new_again"]],
               **{f"{base}_ms": [t["old"], t["old_again"]]},
               every_lane_equal=equal, record_rows_equal=rec_equal,
               counting_build_equal=count_equal,
               **{f"ran_{k}_per_live_lane": v / max(live, 1)
                  for k, v in zip(W.WINDOW_WORK, work.tolist())})
    say("wide_window_ab", **row)
    if not (equal and rec_equal and count_equal):
        fail(f"{name}: the {new} build differs from the {base} one on level {lv} "
             f"(inference {equal}, record {rec_equal}, counting {count_equal})")
    return row


def levels_against_plain(W, I, name, scene, tables, o, d, tm, prev, gen, levels, row,
                         stride, phase="fused_widened"):
    """Part (a) of phase fused_widened (and phase wide_edge): every level of
    the tile by the kernel, each fed by the kernel's own previous level,
    against wave_level_plain on one in `stride` of the live lanes of that
    level, drawn at random anew each level (`lane_sample`; `sampled_plain`:
    1 for a table a block stages, WIDE_STRIDE for the wide build, whose
    plain version takes seconds a level for any lane count), a dead lane's
    13 rows zero; levels 0 and 1 timed against their bounds (the shadow
    tests scaled from the checked lanes to the live ones); level 0 in record
    mode (rows 0-12 torch.equal to inference) and its winners against the
    general path's closest hit.  The wave_level counter is set to 0 at the
    start and read after the last launch: row["launches"] is every launch
    of this check (each level once, one record-mode launch, 5 timed
    repetitions of levels 0 and 1), and the run fails if it is not that.
    Every level also runs phase wide_window_ab (`window_ab`, uncounted
    launches: the package's window cull against the staged or the unculled
    build), and levels 0 and 1 get the bound on the tests a per-ray window
    cull cannot avoid (what the package's build runs), the bound on every
    test apart.  Updates `row`; returns the per-level rows."""
    from ray_tracying_tpu_torch.render.integrator import level_fuzz

    dev = prev.device
    n = prev.shape[1]
    samples, ms = [], {}
    ab = {}
    W.wave_level.launches = 0
    for lv in range(levels):
        fz = level_fuzz(tables, gen, n, dev)
        ab[lv] = window_ab(W, prev, fz, tables, name, lv)
        a = W.wave_level(prev, fz, tables)
        live = prev[7] > 0
        idx = lane_sample(torch.nonzero(live).squeeze(1), stride, 1000 + lv)
        samples.append(dict(live=int(live.sum()), q=prev[:W.Q_ROWS, idx].contiguous(),
                            fz=None if fz is None else fz[:, idx].contiguous(), out=a[:, idx],
                            dead_rows_zero=not bool(torch.where(live, 0.0, a).any()),
                            hits=int((a[12] > 0).sum()), spawned=int((a[7] > 0).sum())))
        if lv == 0:
            rec = W.wave_level(prev, fz, tables, record=True)
            head_equal = bool(torch.equal(rec[:W.OUT_ROWS], a))
            hit = I.closest_hit(scene, o, d, tm, torch.ones(n, dtype=torch.bool, device=dev))
            other = int((rec[W.OUT_ROWS]
                         != torch.where(hit.valid, hit.geom_id, -1).to(rec.dtype)).sum())
            del rec, hit
            row.update(level0_record_rows_0_12_equal_inference=head_equal,
                       level0_winners_other_than_general=other)
            if not head_equal:
                fail(f"{name}: record mode changed rows 0..12 of level 0")
            if other > MAX_FLIP_SHARE * n:
                fail(f"{name}: {other} level-0 winners differ from the general path's")
        if lv < 2:
            ms[lv] = cuda_ms(lambda: W.wave_level(prev, fz, tables), 5)
        prev = a
    del prev, a
    row["launches"] = W.wave_level.launches
    if row["launches"] != levels + 1 + 5 * min(levels, 2):
        fail(f"{name}: {row['launches']} wave_level launches in the level check, expected "
             f"{levels + 1 + 5 * min(levels, 2)}")
    plan = W.wave_plan(tables)
    row.update(stride=stride, sample="one live lane in stride, at random, seeded by level",
               smem_bytes=plan["smem_bytes"],
               blocks_per_sm=plan["blocks_per_sm"])
    per_level, so_far = [], 0
    for lv, res, plain_ms, grp, need in sampled_plain(W, tables, samples):
        smp = samples[lv]
        so_far += res["disagreeing_lanes_so_far"]
        lvl = dict(level=lv, live=smp["live"], checked_lanes=smp["q"].shape[1],
                   hits=smp["hits"], spawned=smp["spawned"], plain_ms=plain_ms,
                   plain_call_levels=grp, dead_rows_zero=smp["dead_rows_zero"],
                   **dict(res, disagreeing_lanes_so_far=so_far))
        if lv in ab:
            base = ab[lv]["base"]
            lvl.update({"windowed_ms": ab[lv]["windowed_ms"], f"{base}_ms": ab[lv][f"{base}_ms"]})
        if lv < 2:
            scale = smp["live"] / max(1, smp["q"].shape[1])
            full = dict(live=smp["live"], closest_tests=smp["live"] * tables.table.shape[1],
                        shadow_tests=need.get("shadow_tests", 0) * scale)
            every = level_bound(W, tables, n, full, smp["hits"])
            lvl.update(ms=ms[lv], shadow_rays_estimated=need.get("shadow_rays", 0) * scale,
                       **every)
            # The windowed build the package launches runs no more than
            # a cull lets through: its bound is the bound on the tests
            # a per-ray window cull cannot avoid; the bound on every
            # test (what the staged and unculled builds run) keeps its
            # own name.
            per = 1.0 / max(1, smp["q"].shape[1])
            culled = dict(live=smp["live"],
                          closest_tests=need["closest_window_tests"] * scale,
                          shadow_tests=need["shadow_window_tests"] * scale)
            boxes = (need["closest_window_boxes"] + need["shadow_window_boxes"]) * scale
            lvl.update(
                bound_all_tests_ms=every["bound_ms"], bound_all_tests_by=every["bound_by"],
                **level_bound(W, tables, n, culled, smp["hits"], box_tests=boxes),
                needed_closest_tests_per_live_lane=need["closest_window_tests"] * per,
                needed_shadow_tests_per_live_lane=need["shadow_window_tests"] * per,
                needed_box_tests_per_live_lane=(need["closest_window_boxes"]
                                                + need["shadow_window_boxes"]) * per)
            row.update({f"level{lv}_{k}": lvl[k] for k in (
                "bound_all_tests_ms", "bound_all_tests_by",
                "needed_closest_tests_per_live_lane", "needed_shadow_tests_per_live_lane",
                "needed_box_tests_per_live_lane")})
            row.update({f"level{lv}_windowed_ms": ab[lv]["windowed_ms"],
                        f"level{lv}_{base}_ms": ab[lv][f"{base}_ms"],
                        **{f"level{lv}_{k}": ab[lv][k] for k in ab[lv]
                           if k.startswith("ran_")}})
            row.update({f"level{lv}_ms": ms[lv], f"level{lv}_plain_ms": plain_ms,
                        f"level{lv}_bound_ms": lvl["bound_ms"],
                        f"level{lv}_bound_by": lvl["bound_by"], f"level{lv}_live": smp["live"],
                        f"level{lv}_shadow_rays_estimated": lvl["shadow_rays_estimated"]})
        say(phase, case=name, lanes=n, stride=stride, rtol=RTOL, atol=ATOL, **lvl)
        per_level.append(lvl)
        if not (res["ok"] and smp["dead_rows_zero"]):
            fail(f"{name}: kernel and plain version disagree on level {lv} "
                 f"({res['disagreeing_lanes_so_far']} of {smp['q'].shape[1]} checked lanes; "
                 f"dead lanes' rows zero: {smp['dead_rows_zero']})")
    if ab:
        row["window_ab"] = [{k: r[k] for k in ("level", "live", "base", "windowed_ms",
                                               f"{r['base']}_ms")}
                            for r in ab.values()]
        row["window_ab_every_lane_equal_levels"] = sum(r["every_lane_equal"]
                                                       for r in ab.values())
    return per_level


def fused_widened_phase(rt, W, CH, dev, n_levels):
    """Phase fused_widened, for each of WIDENED_CASES at 1920x1080: (a) the
    kernel against wave_level_plain on every level of the middle full-width
    tile, fed by the kernel's own levels, on every live lane (one in
    WIDE_STRIDE, at random, of a table the kernel's wide build takes;
    `levels_against_plain`; bit-equal, or the share of checked lanes that
    differ printed and held to MAX_FLIP_SHARE); levels 0 and 1's ms against
    their bounds; (b) one frame through render_to_srgb_u8
    (the fused level) and one with fused=False (the general path's tile
    loop) from one seed, each with the counts set to 0 just before: timed,
    their launches, the two images.  Both paths draw the same jitter and
    times from one seed, and the tile's level-0 winners must be the same
    (the kernel's record row against the general path's closest hit, at
    most MAX_FLIP_SHARE of the lanes apart).  The images are held to the
    stochastic contract, and their deterministic metrics printed: the two
    paths compute the hit point and the sphere UV by different f32
    arithmetic (the level's geom test; pass 2), and on sphere_field's 1,500
    small spheres, up to ~300 radii from the camera, the quadratic's
    cancellation moves a hit point by more than the 1e-4 normal offset of
    the shadow ray and a texel lookup across its edge on a few lanes in a
    thousand; the JAX package's two paths split on the same lanes
    (tests/test_torch_far_spheres.py).

    The pipeline's queue shrink draws a shrunk level's fuzz and area-light
    jitter at the level's width, so with it the fused frame consumes fewer
    draws than the general path and later tiles' camera draws differ.  So
    the frame held against the general path is the fused frame with the
    shrink turned off (tile_shrink patched to ()).  The frame with the
    pipeline's shrink, which users get, is timed and counted, and held to
    the unshrunk frame from the same seed: byte-equal for a scene that
    draws nothing in the trace; for a scene that does, within the limit
    of `witness_check`, set by the unshrunk frame from another seed, and
    (c) the middle tile traced with its draws fed in is torch.equal with
    and without the shrink.  Returns the rows by case."""
    from ray_tracying_tpu_torch.core.sampling import uniform_in_unit_sphere
    from ray_tracying_tpu_torch.kernels import chunk_stream as CS
    from ray_tracying_tpu_torch.render import intersect as I
    from ray_tracying_tpu_torch.render import pipeline as PL
    from ray_tracying_tpu_torch.render.integrator import level_fuzz, trace_wavefront
    from ray_tracying_tpu_torch.render.pipeline import tile_rays, tile_shrink

    smi = smi_line()
    rows = {}
    for name, sqrt_spp, samples in WIDENED_CASES:
        scene = widened_scene(rt, name, dev)
        refusal = W.wave_refusal(scene, False, samples)
        if refusal is not None:
            fail(f"the fused level refuses {name}: {refusal}")
        tables = W.wave_tables(scene, light_samples=samples)
        opts = rt.RenderOptions(samples_sqrt=sqrt_spp, light_samples=samples)
        width, height = scene.camera.resolution
        spp = sqrt_spp * sqrt_spp
        tile_rows = min(height, opts.max_rays_per_pass // (width * spp))
        n_tiles = -(-height // tile_rows)
        levels = n_levels if (scene.has_reflection or scene.has_refraction) else 1

        # (a) every level of the middle full-width tile
        gen = torch.Generator(device=dev).manual_seed(31)
        y0 = max(0, height // 2 - tile_rows // 2)
        o, d, tm = tile_rays(scene.camera, y0, tile_rows, width, sqrt_spp, generator=gen)
        n = o.shape[0]
        prev = torch.cat([o.T, d.T, tm[None], torch.ones((2, n), device=dev)]).contiguous()
        n_cols = tables.table.shape[0]
        build = W.package_build(tables)
        wide = build == "windows"
        row = dict(case=name, geoms=scene.n_geoms, n_cols=n_cols,
                   kinds=[k for k, _, _ in tables.ranges], lights=scene.n_lights,
                   area=list(tables.area), light_samples=samples, samples_sqrt=sqrt_spp,
                   lanes=n, levels=levels, cap_geoms=W.wave_cap_geoms(n_cols, scene.n_lights),
                   build=build,
                   nvidia_smi=smi)
        # every live lane of a table a block stages; one in WIDE_STRIDE, at
        # random, of a wide one
        per_level = levels_against_plain(W, I, name, scene, tables, o, d, tm, prev, gen,
                                         levels, row, WIDE_STRIDE if wide else 1)
        row.update(
            bitwise_equal_levels=sum(lv_["bitwise_equal"] for lv_ in per_level),
            disagreeing_lanes=per_level[-1]["disagreeing_lanes_so_far"],
            disagreeing_share=per_level[-1]["disagreeing_lanes_so_far"] / n,
            max_abs_err=max(lv_["max_abs_err"] for lv_ in per_level))
        del prev
        sched = tile_shrink(n, spp)
        draws = tables.glossy or any(tables.area)
        if draws:
            # (c) the tile with one set of draws fed to every level
            kw = {}
            if tables.glossy:
                kw["fuzz"] = [uniform_in_unit_sphere(gen, (n,)).T.contiguous()] * levels
            if any(tables.area):
                kw["light_jitter"] = [[uniform_in_unit_sphere(gen, (n, samples)) if a_ else None
                                       for a_ in tables.area]] * levels
            traced = [trace_wavefront(scene, o, d, tm, samples, tables=tables, shrink=s_,
                                      return_dropped=True, **kw) for s_ in ((), sched)]
            row.update(fed_draws_shrink=sched,
                       fed_draws_radiance_equal=bool(torch.equal(traced[0][0], traced[1][0])),
                       fed_draws_dropped=int(traced[1][1]))
            say("fused_widened", case=name, shrink=sched,
                fed_draws_radiance_equal=row["fed_draws_radiance_equal"],
                fed_draws_dropped=row["fed_draws_dropped"])
            if not row["fed_draws_radiance_equal"] or row["fed_draws_dropped"]:
                fail(f"{name}: the tile with its draws fed in differs with shrink")
            del traced, kw
        del o, d, tm

        # (b) one frame each way from one seed, the counts set to 0 before;
        # the fused frame with the pipeline's shrink, and without it
        W.wave_level.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        img_s, fused_dropped = srgb_frame(
            rt, scene, opts, torch.Generator(device=dev).manual_seed(41), device=dev)
        torch.cuda.synchronize()
        fused_s = time.time() - t0
        fused_launches = W.wave_level.launches
        real_shrink = PL.tile_shrink
        PL.tile_shrink = lambda lanes, spp_: ()
        torch.cuda.synchronize()
        t0 = time.time()
        img_f, unshrunk_dropped = srgb_frame(
            rt, scene, opts, torch.Generator(device=dev).manual_seed(41), device=dev)
        torch.cuda.synchronize()
        fused_unshrunk_s = time.time() - t0
        if draws:
            img_w, witness_dropped = srgb_frame(
                rt, scene, opts, torch.Generator(device=dev).manual_seed(42), device=dev)
            unshrunk_dropped += witness_dropped
            seen, seen_ok = witness_check(img_s, img_f, img_w)
            del img_w
        else:
            seen = dict(shrunk_vs_unshrunk_bytes_equal=bool(np.array_equal(img_s, img_f)))
            seen_ok = seen["shrunk_vs_unshrunk_bytes_equal"]
        PL.tile_shrink = real_shrink
        counted = dict(brute_closest=CH.brute_closest, brute_closest_n=CH.brute_closest_n,
                       occlusion_any=CH.occlusion_any, wave_level=W.wave_level,
                       brute_closest_chunked=CH.brute_closest_chunked,
                       chunk_closest=CS.chunk_closest, chunk_closest_n=CS.chunk_closest_n,
                       chunk_occlusion=CS.chunk_occlusion)
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.time()
        with general_routing():
            img_g, dropped = srgb_frame(
                rt, scene, opts, torch.Generator(device=dev).manual_seed(41), device=dev)
        torch.cuda.synchronize()
        general_s = time.time() - t0
        general_launches = {k: fn.launches for k, fn in counted.items()}
        diff = np.abs(img_f.astype(np.float32) - img_g.astype(np.float32))
        frame = dict(fused_frame_seconds=fused_s, fused_unshrunk_frame_seconds=fused_unshrunk_s,
                     general_frame_seconds=general_s, shrink=sched, **seen,
                     fused_launches=fused_launches, general_launches=general_launches,
                     tiles=n_tiles, fused_dropped=fused_dropped,
                     unshrunk_dropped=unshrunk_dropped, general_dropped=dropped,
                     frames_max_diff=float(diff.max()), frames_off_share=float((diff > 0).mean()),
                     frames_far_share=float((diff > 1).mean()),
                     frames_mean_diff=float(diff.mean()),
                     frames_p99=float(np.percentile(diff, 99)),
                     contract="stochastic")
        row.update(frame)
        say("fused_widened", case=name, width=width, height=height, spp=spp, **frame,
            nvidia_smi=smi)
        if fused_launches != levels * n_tiles:
            fail(f"{name}: the fused frame launched the level {fused_launches} times, "
                 f"expected {levels * n_tiles}")
        # the brute kernels, or over their cap (CH.BRUTE_SMEM_MAX_GEOMS) the
        # sweeps, for closest hits and shadow rays
        if scene.n_geoms > CH.BRUTE_SMEM_MAX_GEOMS:
            closest = ("brute_closest_chunked", "chunk_closest", "chunk_closest_n")
            shadow = ("chunk_occlusion", "brute_closest_chunked")
        else:
            closest, shadow = ("brute_closest", "brute_closest_n"), ("occlusion_any",)
        if general_launches["wave_level"] or not any(general_launches[k] for k in shadow) \
                or not any(general_launches[k] for k in closest):
            fail(f"{name}: the general frame launched {general_launches}")
        if img_f.min() == img_f.max():
            fail(f"{name}: the fused frame is constant")
        if fused_dropped or unshrunk_dropped or dropped:
            fail(f"{name}: the frames dropped {fused_dropped} / {unshrunk_dropped} / "
                 f"{dropped} continuations")
        if not seen_ok:
            fail(f"{name}: the fused frame with the pipeline's shrink differs from the "
                 "unshrunk one " + ("by more than two unshrunk frames from two seeds differ"
                                    if draws else "(no draws: it must be byte-equal)"))
        ok = frame["frames_mean_diff"] < 1.0 and frame["frames_p99"] <= 8
        if not ok:
            fail(f"{name}: fused and general frames are outside the "
                 f"{frame['contract']} contract")
        rows[name] = row
        del img_f, img_g, img_s, diff, tables, scene
        torch.cuda.empty_cache()
    return rows


def wide_edge_phase(rt, W, dev):
    """Phase wide_edge: the gate's edge, sphere_field(n=6143) (6,144
    geoms, WAVE_MAX_GEOMS) at 1920x1080, 2x2 spp: levels 0 and 1 of its
    middle full-width tile by the kernel's wide build against the plain
    version on one live lane in WIDE_STRIDE (`levels_against_plain`),
    their ms against their bounds; one geom more is refused.  Returns the
    row."""
    from ray_tracying_tpu_torch import models
    from ray_tracying_tpu_torch.render import intersect as I
    from ray_tracying_tpu_torch.render.pipeline import tile_rays

    scene = models.get("sphere_field", n=WIDE_EDGE_SPHERES, res=WIDENED_RES, device=dev)
    over = models.get("sphere_field", n=WIDE_EDGE_SPHERES + 1, res=(8, 6), device=dev)
    if scene.n_geoms != W.WAVE_MAX_GEOMS or W.wave_refusal(scene) is not None \
            or W.wave_refusal(over) is None:
        fail(f"the gate's edge: {W.wave_refusal(scene)} / {W.wave_refusal(over)}")
    tables = W.wave_tables(scene)
    width, height = WIDENED_RES
    rows = min(height, rt.RenderOptions().max_rays_per_pass // (width * 4))
    gen = torch.Generator(device=dev).manual_seed(31)
    o, d, tm = tile_rays(scene.camera, height // 2 - rows // 2, rows, width, 2, generator=gen)
    n = o.shape[0]
    prev = torch.cat([o.T, d.T, tm[None], torch.ones((2, n), device=dev)]).contiguous()
    row = dict(case="sphere_field_6143", geoms=scene.n_geoms, n_cols=tables.table.shape[0],
               lanes=n, levels=2, build=W.package_build(tables),
               over_the_gate=W.wave_refusal(over), nvidia_smi=smi_line())
    per_level = levels_against_plain(W, I, "sphere_field_6143", scene, tables, o, d, tm, prev,
                                     gen, 2, row, WIDE_STRIDE, phase="wide_edge")
    row.update(max_abs_err=max(lv["max_abs_err"] for lv in per_level),
               disagreeing_lanes=per_level[-1]["disagreeing_lanes_so_far"])
    say("wide_edge", **row)
    return row


# ---------------------------------------------------------------------------
# Phase sharded: multi-device rendering (parallel/) and the entry
# points (entry.py).  The script needs one card: NCCL runs at world size 1,
# and two ranks share the card over gloo (NCCL refuses two ranks on one
# device).
# ---------------------------------------------------------------------------
SHARDED_SEED = 5        # the main path's per-level tile (main(): seed 5)
SHARDED_STEP_SEED = 22  # the step's rays and draws
SHARDED_TARGET = 0.3
SHARDED_TIMEOUT_S = 300
SHARDED_TILE_SQRT = 4   # the main path's tile: 8,386,560 lanes at 4x4 spp
SHARDED_REPS = 3
# The all-reduced gradient against one process, per leaf:
# |g - g_one| <= rtol * |g_one| + atol * max|g_one| (tests/test_torch_parallel.py's bar)
SHARDED_GRAD_RTOL = 1e-5
SHARDED_GRAD_ATOL = 1e-5
# The card's dryrun step against the host's (tests/test_torch_parallel.py's
# Adam-against-optax bar)
DRYRUN_RTOL = 1e-4


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sharded_tile(scene, y0, rows, samples_sqrt, seed, n_levels, dev):
    """A full-width flagship tile from image row y0 and its glossy fuzz for
    every level, from one seed: the same bits in every process on one
    card."""
    from ray_tracying_tpu_torch.core.sampling import uniform_in_unit_sphere
    from ray_tracying_tpu_torch.render.pipeline import tile_rays

    gen = torch.Generator(device=dev).manual_seed(seed)
    o, d, tm = tile_rays(scene.camera, y0, rows, scene.camera.resolution[0], samples_sqrt,
                         generator=gen)
    fuzz = [uniform_in_unit_sphere(gen, (o.shape[0],), device=dev).T.contiguous()
            for _ in range(n_levels)]
    return o, d, tm, fuzz


def diff_step(scene, rows, n_levels, trace, dev):
    """Forward and backward of the frame's middle `rows` rows (the whole
    frame at its height) at 1 spp with respect to DIFF_PATHS: the rays are made from theta's camera and traced
    by trace(scene, o, d, tm, fuzz), which returns the radiance of the
    lanes it owns, and the loss is sum((c - 0.3)^2) / (pixels * 3) over
    them.  Returns (theta with its grads, the loss)."""
    from ray_tracying_tpu_torch.core.sampling import uniform_in_unit_sphere
    from ray_tracying_tpu_torch.diff import params as P
    from ray_tracying_tpu_torch.render.pipeline import tile_rays

    width, height = scene.camera.resolution
    theta = P.extract(scene, DIFF_PATHS)
    sc = P.apply(scene, theta)
    gen = torch.Generator(device=dev).manual_seed(SHARDED_STEP_SEED)
    o, d, tm = tile_rays(sc.camera, (height - rows) // 2, rows, width, 1, generator=gen)
    fuzz = [uniform_in_unit_sphere(gen, (o.shape[0],), device=dev).T.contiguous()
            for _ in range(n_levels)]
    c = trace(sc, o, d, tm, fuzz)
    loss = torch.sum((c - SHARDED_TARGET) ** 2) / (rows * width * 3)
    loss.backward()
    return theta, loss.detach()


def sharded_rank(rank, world_size, init_method, dev_type, tile_rows, step_rows, n_levels,
                 out_path):
    """One of phase sharded's two gloo ranks on the one card, in a spawned
    process: (b) its half of the flagship tile through the kernel, the
    radiance gathered (rank 0 saves it to out_path); (c) the sharded
    record-mode step twice (the first loads the backward's modules), its
    gradients all-reduced after a barrier (so that all_reduce_ms is the
    collective's, not the wait for the other rank; seconds includes it).  The counts are set to 0 just before each and
    read just after.  Returns counts, times, peak memory and the second
    step's gradients."""
    import ray_tracying_tpu_torch as rt
    import torch.distributed as dist

    from ray_tracying_tpu_torch.kernels import wavefront as W
    from ray_tracying_tpu_torch.parallel import cluster
    from ray_tracying_tpu_torch.parallel.sharding import (
        all_reduce_grads,
        make_mesh,
        trace_wavefront_sharded,
    )

    cluster.initialize(init_method, world_size, rank, backend="gloo", device=dev_type,
                       retries=3, backoff_s=0.5)
    dev = torch.device(dev_type)
    mesh = make_mesh()
    scene = rt.load_scene(os.path.join(REPO, "golden", "ASCII", "scene.json"), device=dev)
    o, d, tm, fuzz = sharded_tile(scene, tile_rows, tile_rows, SHARDED_TILE_SQRT,
                                  SHARDED_SEED, n_levels, dev)
    W.wave_level.launches = 0
    _sync(dev)
    t0 = time.time()
    rad = trace_wavefront_sharded(scene, o, d, tm, 1, mesh, fuzz=fuzz, device=dev)
    _sync(dev)
    out = dict(rank=rank, lanes=o.shape[0] // world_size, tile_seconds=time.time() - t0,
               tile_launches=W.wave_level.launches)
    if rank == 0:
        torch.save(rad.cpu(), out_path)
    del o, d, tm, fuzz, rad

    def trace(sc, o_, d_, tm_, fz):
        return trace_wavefront_sharded(sc, o_, d_, tm_, 1, mesh, fuzz=fz, device=dev,
                                       differentiable=True, gather=False)

    steps = []
    for _ in range(2):
        W.wave_level.record_launches = 0
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        _sync(dev)
        t0 = time.time()
        theta, share = diff_step(scene, step_rows, n_levels, trace, dev)
        _sync(dev)
        t1 = time.time()
        dist.barrier()
        t_reduce = time.time()
        all_reduce_grads(theta, mesh)
        _sync(dev)
        t2 = time.time()
        steps.append(dict(
            seconds=t2 - t0, forward_backward_seconds=t1 - t0,
            all_reduce_ms=(t2 - t_reduce) * 1e3,
            peak_memory_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
            record_launches=W.wave_level.record_launches, loss_share=float(share)))
    out.update(steps=steps, grads={k: v.grad.cpu().numpy() for k, v in theta.items()})
    return out


def sharded_phase(rt, W, dev, scene, tile_rows, n_levels):
    """Phase sharded (parallel/ and entry.py), on the main path's second
    full-width flagship tile (tile_rows rows at 4x4 spp) with its fuzz fed
    in: (a) NCCL at world size 1 in this process: the sharded trace
    torch.equal to the unsharded one, 11 wave_level launches, both timed in
    turns; (b) two gloo ranks on the one card in spawned processes, each
    tracing half the tile through the kernel: the gathered radiance
    torch.equal to the unsharded trace, each rank's launches; (c) the
    sharded record-mode step at diff_path's configuration (the frame at 1
    spp) over the same two ranks: its all-reduced gradients within
    SHARDED_GRAD_RTOL / _ATOL of this process's one-process gradients, leaf
    by leaf, each rank's step seconds, all-reduce ms and peak memory; (d)
    entry(), and dryrun_multichip(1) over NCCL held to the same step over a
    gloo rank on the host at DRYRUN_RTOL.  Returns the summary for the
    kernels line."""
    import shutil
    import tempfile

    from ray_tracying_tpu_torch import entry as E
    from ray_tracying_tpu_torch.parallel import cluster
    from ray_tracying_tpu_torch.parallel.sharding import make_mesh, trace_wavefront_sharded
    from ray_tracying_tpu_torch.render.integrator import trace_wavefront

    step_rows = scene.camera.resolution[1]  # the whole frame at 1 spp
    smi = smi_line() if dev.type == "cuda" else None
    o, d, tm, fuzz = sharded_tile(scene, tile_rows, tile_rows, SHARDED_TILE_SQRT,
                                  SHARDED_SEED, n_levels, dev)
    n = o.shape[0]
    ref = trace_wavefront(scene, o, d, tm, fuzz=fuzz, device=dev)

    # (a) NCCL at world size 1, the counts set to 0 just before
    backend = cluster.initialize(f"tcp://127.0.0.1:{cluster.free_port()}", 1, 0, device=dev)
    try:
        mesh = make_mesh()
        W.wave_level.launches = 0
        got = trace_wavefront_sharded(scene, o, d, tm, 1, mesh, fuzz=fuzz, device=dev)
        _sync(dev)
        launches_a = W.wave_level.launches
        equal_a = torch.equal(got, ref)
        del got
        turns = {}
        for turn in ("unsharded", "sharded", "sharded_again", "unsharded_again"):
            if turn.startswith("unsharded"):
                turns[f"{turn}_ms"] = cuda_ms(
                    lambda: trace_wavefront(scene, o, d, tm, fuzz=fuzz, device=dev), SHARDED_REPS)
            else:
                turns[f"{turn}_ms"] = cuda_ms(lambda: trace_wavefront_sharded(
                    scene, o, d, tm, 1, mesh, fuzz=fuzz, device=dev), SHARDED_REPS)
    finally:
        cluster.destroy()
    say("sharded", case="(a) world size 1, one full-width flagship tile, fuzz fed",
        backend=backend, lanes=n, torch_equal=equal_a, wave_level_launches=launches_a,
        **turns, nvidia_smi=smi)
    if not equal_a:
        fail("the sharded trace at world size 1 is not torch.equal to the unsharded trace")
    if launches_a != n_levels:
        fail(f"the sharded trace launched wave_level {launches_a} times, not {n_levels}")
    del o, d, tm, fuzz
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (b) and (c): two gloo ranks on the one card
    tmp = tempfile.mkdtemp(prefix="rtt_sharded_")
    try:
        path = os.path.join(tmp, "radiance.pt")
        t0 = time.time()
        ranks = cluster.launch(sharded_rank, 2,
                               (dev.type, tile_rows, step_rows, n_levels, path),
                               timeout_s=SHARDED_TIMEOUT_S)
        ranks_s = time.time() - t0
        gathered = torch.load(path).to(dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    equal_b = torch.equal(gathered, ref)
    launches_b = [r["tile_launches"] for r in ranks]
    say("sharded", case="(b) two gloo ranks on one card, half the tile each", lanes=n,
        lanes_per_rank=[r["lanes"] for r in ranks], torch_equal=equal_b,
        wave_level_launches_per_rank=launches_b,
        rank_tile_seconds=[r["tile_seconds"] for r in ranks],
        launch_seconds_both_phases=ranks_s, nvidia_smi=smi)
    del gathered, ref
    if not equal_b:
        fail("the two ranks' gathered radiance is not torch.equal to the unsharded trace")
    if launches_b != [n_levels] * 2:
        fail(f"the two ranks launched wave_level {launches_b} times, not {n_levels} each")

    # (c) this process's one-process gradient of the same step, twice as
    # the ranks ran it (the second is timed against theirs)
    one_s = []
    for _ in range(2):
        W.wave_level.record_launches = 0
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        _sync(dev)
        t0 = time.time()
        theta, loss = diff_step(
            scene, step_rows, n_levels,
            lambda sc, o_, d_, tm_, fz: trace_wavefront(sc, o_, d_, tm_, 1, fuzz=fz,
                                                        device=dev, differentiable=True), dev)
        _sync(dev)
        one_s.append(time.time() - t0)
    agree = {}
    for k in DIFF_PATHS:
        ref_g = theta[k].grad
        a, b = (r["grads"][k] for r in ranks)
        g = torch.from_numpy(a).to(dev)
        tol = (SHARDED_GRAD_RTOL * ref_g.abs()
               + SHARDED_GRAD_ATOL * float(ref_g.abs().max()))
        ratio = float(((g - ref_g).abs() / tol).max()) if bool((tol > 0).all()) else None
        agree[k] = dict(ok=bool(((g - ref_g).abs() <= tol).all()),
                        nonzero=bool((ref_g != 0).any()),
                        ranks_equal=a.tobytes() == b.tobytes(),
                        max_abs_diff=float((g - ref_g).abs().max()),
                        max_abs=float(ref_g.abs().max()), max_diff_over_limit=ratio)
    rays = step_rows * scene.camera.resolution[0]
    say("sharded", case="(c) record-mode step, the frame at 1 spp over two gloo ranks",
        primary_rays=rays, rank_steps=[r["steps"] for r in ranks],
        one_process_seconds_first_second=one_s,
        one_process_peak_memory_bytes=(torch.cuda.max_memory_allocated(dev)
                                       if dev.type == "cuda" else None),
        one_process_record_launches=W.wave_level.record_launches,
        loss=float(loss), loss_sum_of_shares=sum(r["steps"][1]["loss_share"] for r in ranks),
        rtol=SHARDED_GRAD_RTOL, atol=f"{SHARDED_GRAD_ATOL} * max|g| of the leaf", agree=agree,
        nvidia_smi=smi)
    if not all(v["ok"] and v["ranks_equal"] and v["nonzero"] for v in agree.values()):
        fail("the all-reduced gradients of the sharded step disagree with one process")
    if not all(s["record_launches"] for r in ranks for s in r["steps"]):
        fail("a rank's sharded step launched no record-mode level")

    # (d) the entry points, the counts set to 0 just before entry()
    W.wave_level.launches = 0
    fn, args = E.entry(device=dev)
    out = fn(*args)
    _sync(dev)
    entry_launches = W.wave_level.launches
    t0 = time.time()
    dry_loss, dry_theta = E.dryrun_multichip(1, device=dev)
    dry_s = time.time() - t0
    host_loss, host_theta = E.dryrun_multichip(1, device="cpu")
    dry_ok = bool(np.isfinite(dry_loss)) and all(np.isfinite(v).all() for v in dry_theta.values())
    dry_rel = {k: float(np.max(np.abs(dry_theta[k] - host_theta[k])
                               / np.maximum(np.abs(host_theta[k]), 1e-30)))
               for k in host_theta}
    dry_rel["loss"] = abs(dry_loss - host_loss) / abs(host_loss)
    say("sharded", case="(d) entry() and dryrun_multichip(1)", entry_shape=list(out.shape),
        entry_finite=bool(torch.isfinite(out).all()), entry_launches=entry_launches,
        dryrun_loss=dry_loss, dryrun_loss_host=host_loss, dryrun_max_rel_diff_vs_host=dry_rel,
        rtol=DRYRUN_RTOL, dryrun_seconds=dry_s,
        dryrun_backend="nccl" if dev.type == "cuda" else "gloo", nvidia_smi=smi)
    if tuple(out.shape) != (E.ENTRY_RAYS, 3) or not torch.isfinite(out).all():
        fail("entry() did not give finite (4096, 3) radiance")
    if entry_launches != n_levels:
        fail(f"entry() launched wave_level {entry_launches} times, not {n_levels}")
    if not dry_ok:
        fail("dryrun_multichip(1) gave a loss or theta that is not finite")
    if not all(v <= DRYRUN_RTOL for v in dry_rel.values()):
        fail("dryrun_multichip(1) on the card disagrees with the same step on the host")
    return dict(
        launches_world_size_1=launches_a, launches_per_rank=launches_b,
        record_launches_per_rank=[[s["record_launches"] for s in r["steps"]] for r in ranks],
        entry_launches=entry_launches,
        sharded_ms=(turns["sharded_ms"] + turns["sharded_again_ms"]) / 2,
        unsharded_ms=(turns["unsharded_ms"] + turns["unsharded_again_ms"]) / 2,
        step_seconds=[r["steps"][1]["seconds"] for r in ranks],
        one_process_step_seconds=one_s[1],
        all_reduce_ms=[r["steps"][1]["all_reduce_ms"] for r in ranks],
    )



def main():
    t_start = time.time()
    # ---- phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs on the GPU only",
              file=sys.stderr)
        return 1
    import ray_tracying_tpu_torch as rt
    from ray_tracying_tpu_torch.core import constants as C
    from ray_tracying_tpu_torch.core.sampling import uniform_in_unit_sphere
    from ray_tracying_tpu_torch.kernels import _build
    from ray_tracying_tpu_torch.kernels import closest_hit as CH
    from ray_tracying_tpu_torch.kernels import wavefront as W
    from ray_tracying_tpu_torch.render import integrator as G
    from ray_tracying_tpu_torch.render import intersect as I
    from ray_tracying_tpu_torch.render.integrator import trace_wavefront
    from ray_tracying_tpu_torch.render.materials import gather_materials
    from ray_tracying_tpu_torch.render.shade import shade
    from ray_tracying_tpu_torch.render.pipeline import tile_rays, tile_shrink

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    say("device", kind=kind, count=torch.cuda.device_count(),
        nvidia_smi_name_power_limit=smi, torch=torch.__version__,
        cuda=torch.version.cuda)

    # ---- phase 2: build.  The --fmad=true variant (phase fma_variant) is
    # compiled beside the package's build, in a process of its own, which
    # is joined before any check starts.
    fused_build = subprocess.Popen([sys.executable, "-c", (
        "import sys; sys.path.insert(0, %r); "
        "from ray_tracying_tpu_torch.kernels import _build; _build.build(fmad=True)") % REPO])
    _build.load()
    if fused_build.wait() != 0:
        fail("the --fmad=true variant of the kernels did not build")
    ptxas = [ln.strip() for ln in _build.last_build["log"].splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    # wave_level (blocks: the staged build, the wide table's unculled and
    # windowed build and its counting build, the staged windowed build) and its
    # one-thread-per-lane schedule, three brute
    # kernels by one thread per lane and their three warp kernels; the two
    # one-thread-per-lane traversals and the traversal's warp kernel (closest
    # hit, with the normal, each with its counting build); seven
    # one-thread-per-lane sweeps (the chunked brute, and each of the three
    # chunk kernels with its counting build); seven warp sweeps (the three
    # chunk kernels, each with its counting build, and the chunked brute)
    if sum("entry function" in ln for ln in ptxas) != 32 and _build.last_build["compiled"]:
        fail("the build did not report thirty-two kernels")
    say("build", seconds=round(_build.last_build["seconds"], 2),
        compiled=_build.last_build["compiled"], flags=_build.last_build["flags"],
        library=os.path.relpath(_build.last_build["path"], REPO), ptxas=ptxas)

    scene = rt.load_scene(os.path.join(REPO, "golden", "ASCII", "scene.json"))
    tables = W.wave_tables(scene)
    plan = wave_plan_phase(W, _build, tables, scene)
    width, height = scene.camera.resolution
    n_levels = C.MAX_RECURSION_DEPTH + 1
    opts = rt.RenderOptions(samples_sqrt=4, light_samples=1)
    spp = 16
    tile_rows = min(height, opts.max_rays_per_pass // (width * spp))
    n_tiles = -(-height // tile_rows)

    # ---- phase 3: kernel against plain version, every level of a trace
    gen = torch.Generator(device=dev).manual_seed(1234)
    o, d, tm = tile_rays(scene.camera, height // 2, 2, width, 4, generator=gen)
    n = o.shape[0]
    fuzz = [uniform_in_unit_sphere(gen, (n,)).T.contiguous() for _ in range(n_levels)]
    # level by level at full width: no shrink
    common = dict(fuzz=fuzz, tables=tables, return_levels=True, shrink=())
    W.wave_level.launches = 0
    _, lv_kernel = trace_wavefront(scene, o, d, tm, **common)
    torch.cuda.synchronize()
    if W.wave_level.launches != n_levels:
        fail("the small-tile trace did not go through the kernel")
    t0 = time.time()
    _, lv_plain = trace_wavefront(scene, o, d, tm, level_fn=W.wave_level_plain, **common)
    torch.cuda.synchronize()
    plain_trace_s = time.time() - t0
    tainted = None
    for lv, (a, b) in enumerate(zip(lv_kernel, lv_plain)):
        res, tainted = compare_level(a, b, tainted)
        say("kernel_vs_plain", level=lv, lanes=n, spawned=int((b[7] > 0).sum()),
            rtol=RTOL, atol=ATOL, max_disagreeing_share=MAX_FLIP_SHARE, **res)
        if not res["bitwise_equal"]:
            fail(f"kernel and plain version are not bit-equal on level {lv}")
    say("kernel_vs_plain", plain_trace_seconds=round(plain_trace_s, 2), lanes=n,
        levels=n_levels)

    # Mixed mask: dead and live lanes share every warp; the width is no
    # multiple of the block, so the last block is ragged.
    m = n - 37
    boot = torch.cat([o.T, d.T, tm[None], torch.ones((2, n), device=dev)])[:, :m].contiguous()
    boot[7] = (torch.rand(m, generator=gen, device=dev) < 0.5).float()
    fz = fuzz[0][:, :m].contiguous()
    a = W.wave_level(boot, fz, tables)
    b = W.wave_level_plain(boot, fz, tables)
    res, _ = compare_level(a, b)
    dead_zero = bool((a[:, boot[7] <= 0] == 0).all())
    say("kernel_vs_plain", case="random act mask, ragged width", lanes=m,
        live=int(boot[7].sum()), dead_lanes_all_zero=dead_zero, **res)
    if not (res["bitwise_equal"] and dead_zero):
        fail("kernel and plain version are not bit-equal on the mixed-mask tile")

    # The three brute kernels on the same ragged tile with a random act
    # mask, and on a scene with every kind and a moving sphere, rays at
    # random times.
    g_table, g_ranges = CH.scene_table(scene)
    rays_small = CH.pack_rays(o[:m], d[:m], tm[:m], boot[7] > 0)
    maxt_small = torch.rand(m, generator=gen, device=dev) * 30.0
    brute_vs_plain(CH, "flagship tile, random act mask, ragged width",
                   rays_small, maxt_small, g_table, g_ranges, scene.has_motion)
    kinds = all_kinds_scene(rt)
    k_table, k_ranges = CH.scene_table(kinds)
    k_n = 100003
    k_o = torch.randn((k_n, 3), generator=gen, device=dev) * 1.5
    k_d = torch.randn((k_n, 3), generator=gen, device=dev)
    k_d = k_d / k_d.norm(dim=1, keepdim=True)
    k_rays = CH.pack_rays(k_o, k_d, torch.rand(k_n, generator=gen, device=dev),
                          torch.rand(k_n, generator=gen, device=dev) < 0.7)
    if not (kinds.has_motion and len(k_ranges) == 4):
        fail("the all-kinds scene lost a kind or its motion")
    brute_vs_plain(CH, "every kind, moving sphere, random times and act mask",
                   k_rays, torch.rand(k_n, generator=gen, device=dev) * 20.0 + 0.5,
                   k_table, k_ranges, True)
    del rays_small, maxt_small, k_rays, k_o, k_d

    # ---- phase 4: goldens of the reference renderer, through the
    # pipeline's own routing (fused level or general path)
    golden_check(rt, "bvh_det", "bvh_det_s1.ppm", 1, "deterministic", 0)
    golden_check(rt, "bvh_glossy", "bvh_glossy_s8.ppm", 8, "stochastic", 7)
    # det_basic (a legacy plane, one-way glass) and texture (a textured
    # sphere) take the fused level; det_twoway (mirror and glass on one
    # material) the general path.
    for name, path in (("det_basic", "fused"), ("det_mirrors", "fused"),
                       ("det_twoway", "general"), ("texture", "fused")):
        golden_check(rt, name, f"{name}_s1.ppm", 1, "deterministic", 0, expect_path=path)
    golden_check(rt, "dof", "dof_s6.ppm", 6, "stochastic", 3)
    golden_check(rt, "motion", "motion_s6.ppm", 6, "stochastic", 3, expect_path="fused")
    golden_check(rt, "glossy", "glossy_s6.ppm", 6, "stochastic", 3)
    golden_check(rt, "softshadow", "softshadow_s4_l16.ppm", 4, "stochastic", 3,
                 light_samples=16, expect_path="fused")
    # the same goldens' traces by the package's route and by the staged build
    staged_goldens = staged_golden_traces(rt, W, dev)

    # The general path's other branch, with the counts set to 0 just
    # before: the compacted two-way queue (det_twoway: untextured, so the
    # fused-normal kernel; rendered twice at 1 spp, bytes equal, no drop).
    # Its area-light jitter runs in phase fused_widened (cornell's general
    # frame).
    CH.brute_closest.launches = CH.brute_closest_n.launches = 0
    CH.occlusion_any.launches = W.wave_level.launches = 0
    twoway = load_demo(rt, "det_twoway")
    one = rt.RenderOptions(samples_sqrt=1)
    img_a = rt.render_to_srgb_u8(twoway, one)
    img_b = rt.render_to_srgb_u8(twoway, one)
    _, tw_stats = rt.render_image(twoway, rt.RenderOptions(samples_sqrt=1, stats=True))
    golden_check(rt, "det_twoway", "det_twoway_s6.ppm", 6, "stochastic", 3,
                 expect_path="general")
    branch_launches = dict(
        brute_closest=CH.brute_closest.launches,
        brute_closest_n=CH.brute_closest_n.launches,
        occlusion_any=CH.occlusion_any.launches,
        wave_level=W.wave_level.launches,
    )
    say("general_branches", scenes=["det_twoway"],
        det_twoway_bytes_equal=bool(np.array_equal(img_a, img_b)),
        det_twoway_total_dropped=tw_stats["total_dropped"],
        det_twoway_live=[lv["live"] for lv in tw_stats["levels"]],
        kernel_launches=branch_launches)
    if not np.array_equal(img_a, img_b):
        fail("two renders of det_twoway differ")
    if tw_stats["total_dropped"] != 0:
        fail("det_twoway dropped continuations")
    if not (branch_launches["brute_closest_n"] and branch_launches["occlusion_any"]):
        fail("the two-way renders did not go through the fused-normal and any-hit kernels")
    if branch_launches["wave_level"] or branch_launches["brute_closest"]:
        fail("untextured general-path scenes launched another kernel")

    # ---- phase 5: the main path, full frame
    n_rays = width * height * spp
    runs = 3  # one warm-up, two timed
    torch.cuda.reset_peak_memory_stats()
    W.wave_level.launches = 0
    seconds = []
    imgs = []
    for i in range(runs):
        gen_i = torch.Generator(device=dev).manual_seed(i)
        torch.cuda.synchronize()
        t0 = time.time()
        imgs.append(rt.render_to_srgb_u8(scene, opts, gen_i))
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
    launches = W.wave_level.launches
    peak_bytes = torch.cuda.max_memory_allocated()
    # The dropped counts: each run again in the stats mode, from its seed,
    # byte-equal to the timed frame.
    main_dropped = []
    for i in range(runs):
        again, dropped = srgb_frame(rt, scene, opts, torch.Generator(device=dev).manual_seed(i))
        if not np.array_equal(again, imgs[i]):
            fail(f"the flagship frame of seed {i} differs in the stats mode")
        main_dropped.append(dropped)
    img = imgs[-1]
    del imgs, again
    if launches != n_levels * n_tiles * runs:
        fail(f"main path launched the kernel {launches} times, expected "
             f"{n_levels * n_tiles * runs}")
    if img.shape != (height, width, 3) or img.dtype != np.uint8:
        fail(f"main path image has shape {img.shape} dtype {img.dtype}")
    if img.min() == img.max():
        fail("main path image is constant")
    timed = seconds[1:]
    mean_s = sum(timed) / len(timed)
    gold = rt.read_ppm(os.path.join(REPO, "golden", "Output", "bvh_s4_textured_r4.ppm"))
    diff = np.abs(img.astype(np.float32) - gold.astype(np.float32))
    flag_mean, flag_p99 = float(diff.mean()), float(np.percentile(diff, 99))
    say("main_path", scene="golden/ASCII/scene.json", width=width, height=height,
        spp=spp, levels=n_levels, tiles=n_tiles, primary_rays=n_rays,
        warmup_seconds=seconds[0], timed_seconds=timed, mean_seconds=mean_s,
        primary_rays_per_s=n_rays / mean_s, kernel_launches=launches,
        shrink=tile_shrink(tile_rows * width * spp, spp),
        dropped=main_dropped, peak_memory_bytes=peak_bytes,
        golden="bvh_s4_textured_r4.ppm", golden_mean_diff=flag_mean,
        golden_p99=flag_p99)
    if not (flag_mean < 1.0 and flag_p99 <= 8):
        fail("the flagship frame is outside the stochastic contract against "
             "its golden")
    if any(main_dropped):
        fail(f"the flagship frames dropped {main_dropped} continuations")
    # The frame by the route before the window cull (`parent_route`: the
    # staged build, no windows built) and by the package's, in turns from
    # seed 0: seconds, and the images byte-equal.
    ab_s, ab_img = {}, {}
    for turn in ("route", "parent", "parent_again", "route_again"):
        with parent_route(W) if turn.startswith("parent") else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.time()
            ab_img[turn] = rt.render_to_srgb_u8(scene, opts,
                                                torch.Generator(device=dev).manual_seed(0))
            torch.cuda.synchronize()
            ab_s[turn] = time.time() - t0
    main_ab = dict(route_seconds=[ab_s["route"], ab_s["route_again"]],
                   parent_route_seconds=[ab_s["parent"], ab_s["parent_again"]],
                   bytes_equal=all(np.array_equal(x, ab_img["route"]) for x in ab_img.values()))
    main_ab.update(
        route_primary_rays_per_s=n_rays * 2 / sum(main_ab["route_seconds"]),
        parent_route_primary_rays_per_s=n_rays * 2 / sum(main_ab["parent_route_seconds"]))
    del ab_img
    say("main_path", case="the package's route against the route before the window cull, "
        "in turns", **main_ab, nvidia_smi=smi)
    if not main_ab["bytes_equal"]:
        fail("the flagship frame differs between the window-culled route and the staged build")

    # Per-level counters of one full-width tile (the second: rows with
    # cubes), traced without shrink: its levels are the full-width inputs
    # of the phases below.
    gen = torch.Generator(device=dev).manual_seed(5)
    y0 = tile_rows if n_tiles > 1 else 0
    o, d, tm = tile_rays(scene.camera, y0, tile_rows, width, 4, generator=gen)
    n = o.shape[0]
    fuzz = [uniform_in_unit_sphere(gen, (n,)).T.contiguous() for _ in range(n_levels)]
    _, stats, levels = trace_wavefront(
        scene, o, d, tm, fuzz=fuzz, tables=tables, return_stats=True,
        return_levels=True, shrink=(),
    )
    say("main_path", tile_rows=tile_rows, tile_lanes=n,
        live=stats.live.tolist(), hits=stats.hits.tolist(),
        spawned=stats.spawned.tolist())

    # Where that tile's time goes, by CUDA events: ray generation, the 11
    # fuzz draws, the whole trace given the draws (launches, accumulation,
    # bootstrap, and with shrink the compactions), and each level's launch
    # alone on its own full-width input; the draws and the trace both
    # ways, without shrink and with the main path's schedule (phase shrink
    # takes the shrunk tile apart).
    from ray_tracying_tpu_torch.render.integrator import level_fuzz, shrink_plan

    boot = torch.cat([o.T, d.T, tm[None], torch.ones((2, n), device=dev)]).contiguous()
    inputs = [boot] + levels[:-1]
    tile_sched = tile_shrink(n, spp)
    bounds, widths = shrink_plan(n, n_levels, tile_sched)
    stage = [max(i for i, b in enumerate(bounds[:-1]) if b <= lv) for lv in range(n_levels)]
    level_width = [n if si == 0 else widths[si] for si in stage]
    breakdown = dict(tile_lanes=n, shrink=tile_sched, level_widths=level_width)
    for turn in ("unshrunk", "shrunk", "shrunk_again", "unshrunk_again"):
        sched = () if turn.startswith("unshrunk") else tile_sched
        ws = [n] * n_levels if sched == () else level_width
        breakdown[f"fuzz_ms_{turn}"] = cuda_ms(
            lambda: [level_fuzz(tables, gen, w, dev) for w in ws], 3)
        breakdown[f"trace_ms_{turn}"] = cuda_ms(lambda: trace_wavefront(
            scene, o, d, tm, fuzz=fuzz, tables=tables, shrink=sched), 3)
    level_ms = {}
    for turn in ("route", "staged", "staged_again", "route_again"):
        fn = W.wave_level if turn.startswith("route") else staged_level(W)
        level_ms[turn] = [cuda_ms(lambda: fn(inputs[lv], fuzz[lv], tables), 3)
                          for lv in range(n_levels)]
    # the tile's trace once more through the staged build: the radiance
    # torch.equal to the package's route (the main path's shrink schedule)
    rad_route = trace_wavefront(scene, o, d, tm, fuzz=fuzz, tables=tables)
    rad_staged = trace_wavefront(scene, o, d, tm, fuzz=fuzz, tables=tables,
                                 level_fn=staged_level(W))
    breakdown["staged_trace_radiance_equal"] = bool(torch.equal(rad_route, rad_staged))
    del rad_route, rad_staged
    say("tile_breakdown",
        rays_ms=cuda_ms(lambda: tile_rays(scene.camera, y0, tile_rows, width, 4, generator=gen), 3),
        level_ms=[(a + b) / 2 for a, b in zip(level_ms["route"], level_ms["route_again"])],
        level_ms_turns={k: v for k, v in level_ms.items()}, **breakdown, nvidia_smi=smi)
    if not breakdown["staged_trace_radiance_equal"]:
        fail("the flagship tile's radiance differs between the route and the staged build")
    shrink_row = shrink_phase(rt, W, G, scene, tables, o, d, tm, fuzz, levels, tile_sched,
                              opts, n_levels)

    # ---- phase 6: the kernel at the main path's shapes: every level of
    # that tile against the plain version on the same input (bit-equal, or
    # the run fails), and for level 0 and a deep level the kernel's time
    # and roofline bound: on the tests a per-ray window cull needs
    # (`window_need_counts` around the plain call), what the package's
    # build runs, and apart on every test; beside them the tests a live
    # lane the counting build ran.  The plain version runs at full width on
    # those two levels (their plain_ms are the full-width times) and on the
    # live lanes alone on the others (`plain_on_live`: lane-wise, dead
    # lanes zero), which keeps the run within its time.
    deep = 4
    rows_out = {}
    plain0 = None
    for lv in range(n_levels):
        prev = inputs[lv]
        a = W.wave_level(prev, fuzz[lv], tables)
        need = {}
        torch.cuda.synchronize()
        t0 = time.time()
        if lv in (0, deep):
            with window_need_counts(W, tables, prev[7] > 0, need):
                b = W.wave_level_plain(prev, fuzz[lv], tables, stats=need)
        else:
            b = plain_on_live(W, prev, fuzz[lv], tables, need)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        res, _ = compare_level(a, b)
        if lv == 0:
            plain0 = b
        del a, b
        row = dict(case=f"level{lv}", lanes=n, plain_ms=plain_ms,
                   plain_on_live_lanes=lv not in (0, deep), needed=need, **res)
        if lv in (0, deep):
            ms = cuda_ms(lambda: W.wave_level(prev, fuzz[lv], tables), 5)
            # Least work this call's data needs.  Bytes: every lane's act
            # row read and its 13 output rows written (zeros for a dead
            # lane); only a live lane's other 8 queue rows and 3 fuzz rows
            # are read; the tables once.  Operations: G tests per live
            # lane, the shadow tests up to each ray's first blocker, the
            # shading of hit lanes.  With --fmad=false no multiply-add is
            # fused, so the build can reach at best half the f32 peak on the
            # operations part: fmad_false_floor_ms is twice operations_ms.
            n_bytes = 4 * (n * (1 + W.OUT_ROWS) + need["live"] * (W.Q_ROWS - 1 + 3)) \
                + 4 * (tables.table.numel() + tables.lights.numel()) \
                + (tables.tex.numel() if tables.has_tex else 0)
            per_test = sum(
                FLOPS_PER_TEST[k] * (e - s) for k, s, e in tables.ranges
            ) / tables.table.shape[1]
            flops = per_test * (need["closest_tests"] + need["shadow_tests"]) \
                + FLOPS_PER_HIT_LANE * int(stats.hits[lv])
            bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
            ops_ms = flops / PEAK_F32_FLOPS * 1e3
            # the tests a per-ray window cull needs, and the box tests
            culled = per_test * (need["closest_window_tests"] + need["shadow_window_tests"]) \
                + FLOPS_PER_HIT_LANE * int(stats.hits[lv]) \
                + FLOPS_PER_BOX_TEST * (need["closest_window_boxes"] + need["shadow_window_boxes"])
            culled_ms = culled / PEAK_F32_FLOPS * 1e3
            work = torch.zeros(len(W.WINDOW_WORK), dtype=torch.int64, device=dev)
            counted = W.wave_level_build(prev, fuzz[lv], tables, "windows_count", work=work)
            if not torch.equal(counted, W.wave_level(prev, fuzz[lv], tables)):
                fail(f"the counting build differs from the package's on level {lv}")
            del counted
            live_n = max(1, need["live"])
            row.update(ms=ms, bound_ms=max(bytes_ms, culled_ms),
                       bound_by="bytes" if bytes_ms >= culled_ms else "operations",
                       bytes_ms=bytes_ms, operations_ms=culled_ms,
                       fmad_false_floor_ms=max(bytes_ms, 2 * culled_ms), needed_bytes=n_bytes,
                       bound_all_tests_ms=max(bytes_ms, ops_ms),
                       bound_all_tests_by="bytes" if bytes_ms >= ops_ms else "operations",
                       operations_all_tests_ms=ops_ms,
                       fmad_false_floor_all_tests_ms=max(bytes_ms, 2 * ops_ms),
                       needed_closest_tests_per_live_lane=need["closest_window_tests"] / live_n,
                       needed_shadow_tests_per_live_lane=need["shadow_window_tests"] / live_n,
                       needed_box_tests_per_live_lane=(need["closest_window_boxes"]
                                                       + need["shadow_window_boxes"]) / live_n,
                       **{f"ran_{k}_per_live_lane": v / live_n
                          for k, v in zip(W.WINDOW_WORK, work.tolist())})
        rows_out[lv] = row
        say("kernel_at_width", level=lv, **row)
        if not res["bitwise_equal"]:
            fail(f"kernel and plain version are not bit-equal at full width, level {lv}")
    r0, r1 = rows_out[0], rows_out[deep]

    # The same sources built with FMA contraction on, beside the package's
    # --fmad=false build: level 0 of that tile against the plain version,
    # both builds timed in turn, and bvh_det against its golden.  This is
    # the measurement behind --fmad=false; the package never runs this
    # variant, so it is swapped in here and out again.
    strict = _build.load()
    shipped = dict(_build.last_build)
    fused = _build.load_variant(fmad=True)
    # the ptxas reports of later phases are the shipped build's
    _build.last_build.update(shipped)
    det = rt.load_scene(os.path.join(REPO, "scenes", "bvh_det.json"),
                        textures_dir=os.path.join(REPO, "golden", "Textures"))
    det_gold = rt.read_ppm(os.path.join(REPO, "golden", "Output", "bvh_det_s1.ppm")).astype(int)
    variant = {}
    for name, lib in (("fmad_false", strict), ("fmad_true", fused),
                      ("fmad_true_again", fused), ("fmad_false_again", strict)):
        _build._lib = lib
        res, _ = compare_level(W.wave_level(boot, fuzz[0], tables), plain0)
        diff = np.abs(rt.render_to_srgb_u8(det, rt.RenderOptions(samples_sqrt=1)).astype(int) - det_gold)
        variant[name] = dict(
            level0_ms=cuda_ms(lambda: W.wave_level(boot, fuzz[0], tables), 5),
            disagreeing_lanes=res["disagreeing_lanes_so_far"],
            bitwise_equal=res["bitwise_equal"],
            bvh_det_max_diff=int(diff.max()), bvh_det_values_off=int((diff > 0).sum()))
    _build._lib = strict
    del plain0
    say("fma_variant", lanes=n, **variant)

    # The redesign against the one-thread-per-lane schedule of the same
    # stages (the kernel before the redesign), on one card in one run.
    ab = wave_redesign_ab(rt, W, scene, tables, inputs, fuzz, opts, n_levels)
    # The same inputs through the kernel's wide build: does the staged one
    # still pay on a table a block stages?
    builds = wave_build_ab(W, scene, tables, inputs, fuzz, n_levels)
    # Record mode (differentiable rendering) of the same kernel on the same
    # inputs.
    per_test = sum(FLOPS_PER_TEST[k] * (e - s) for k, s, e in tables.ranges) \
        / tables.table.shape[1]
    rec_mode = record_mode_phase(W, scene, tables, inputs, fuzz, n_levels, per_test,
                                 ACCEL_SIZES["stride"])
    del inputs
    # ---- phase 7: the three brute kernels at the main path's width: the
    # 8,386,560 level-0 rays of that cube-heavy tile, and the tile's
    # level-0 shadow rays for the first light, as the general path casts
    # them (recorded from one level of the path itself).
    rays_w = CH.pack_rays(o, d, tm)
    cast = []
    real_occluded_tid = I.occluded_tid

    def recording(scene_, so, sd, maxt, active=None):
        cast.append((CH.pack_rays(so, sd, torch.zeros_like(maxt), active),
                     maxt.contiguous()))
        return real_occluded_tid(scene_, so, sd, maxt, active)

    I.occluded_tid = recording
    fuzz0 = [fuzz[0]]
    rad_general0 = trace_wavefront(scene, o, d, tm, fused=False, max_depth=0, fuzz=fuzz0)
    I.occluded_tid = real_occluded_tid
    if len(cast) != scene.n_lights:
        fail("one level of the general path did not cast one any-hit launch per light")
    width_rows = brute_vs_plain(CH, "level 0 of one full-width flagship tile",
                                rays_w, cast[0], g_table, g_ranges,
                                scene.has_motion, timed=True)
    flag_anyhit = anyhit_redesign_ab(
        CH, _build, "level-0 shadow rays of light 0 of one full-width flagship tile", *cast[0],
        g_table, g_ranges, torch.arange(0, n, ACCEL_SIZES["stride"], device=dev))
    flag_brute = brute_redesign_ab(
        CH, _build, "level 0 of one full-width flagship tile", rays_w, g_table, g_ranges,
        scene.has_motion, torch.arange(0, n, ACCEL_SIZES["stride"], device=dev))

    # Level 0 of that tile, general path against fused path: the same
    # radiance to rtol 1e-4 / atol 1e-5.  The two paths rebuild the texture
    # uv by different arithmetic (in the kernel; in pass 2), so a lane on a
    # texel boundary may fetch the neighbouring texel: the share of such
    # lanes is bounded and printed.
    rad_fused0 = trace_wavefront(scene, o, d, tm, max_depth=0, fuzz=fuzz0, tables=tables)
    off = ((rad_general0 - rad_fused0).abs()
           > 1e-5 + 1e-4 * rad_fused0.abs()).any(dim=1)
    off_share = float(off.float().mean())
    say("general_vs_fused", level=0, lanes=n, rtol=1e-4, atol=1e-5,
        lanes_out_of_tolerance=int(off.sum()), max_share=1e-4,
        max_abs_diff=float((rad_general0 - rad_fused0).abs().max()))
    if off_share > 1e-4:
        fail("general and fused paths disagree on level 0 of the tile")
    del rad_general0, rad_fused0, off

    # Where one level of the general path goes on that tile, by CUDA
    # events: level 0, every lane live.
    act = torch.ones(n, dtype=torch.bool, device=dev)
    hit = I.closest_hit(scene, o, d, tm, act, differentiable=False)
    mrec = gather_materials(scene, hit.geom_id)
    q0 = G._Queue(o, d, tm, torch.ones(n, device=dev),
                  torch.arange(n, device=dev), act)
    fz = fuzz[0].T
    anyhit_ms = [cuda_ms(lambda: CH.occlusion_any(r_, m_, g_table, g_ranges), 5)
                 for r_, m_ in cast]
    closest_ms = cuda_ms(lambda: I.closest_hit(scene, o, d, tm, act, differentiable=False), 3)
    shade_ms = cuda_ms(lambda: shade(scene, hit, o, gen, 1, mrec, hit.valid), 3)
    general_tile = dict(
        tile_lanes=n,
        closest_hit_launch_ms=width_rows["brute_closest"]["ms"],
        pass2_and_packing_ms=closest_ms - width_rows["brute_closest"]["ms"],
        materials_ms=cuda_ms(lambda: gather_materials(scene, hit.geom_id), 3),
        shade_without_launches_ms=shade_ms - sum(anyhit_ms),
        anyhit_launch_ms=anyhit_ms,
        spawn_ms=cuda_ms(lambda: G._spawn_one_way(scene, q0, hit, mrec, hit.valid, fz, 0.0), 3),
        fuzz_draw_ms=cuda_ms(lambda: uniform_in_unit_sphere(gen, (n,)), 3),
        level0_ms=cuda_ms(lambda: trace_wavefront(
            scene, o, d, tm, fused=False, max_depth=0, fuzz=fuzz0), 3),
    )
    # The whole trace of the tile at its live width (the default schedule)
    # and at full width (shrink=()), in turns, its draws from one seed: the
    # same radiance, and each level's width and ms by CUDA events.
    widths = {"live_width": "auto", "full_width": ()}

    def general_trace(shrink):
        return trace_wavefront(scene, o, d, tm, fused=False, shrink=shrink,
                               generator=torch.Generator(device=dev).manual_seed(77))

    rads, general_tile["levels"] = {}, {}
    for label, shrink in widths.items():
        with level_marks() as marks:
            rads[label] = general_trace(shrink)
        general_tile["levels"][label] = marks_ms(marks)
    general_tile["radiance_equal"] = torch.equal(rads["live_width"], rads["full_width"])
    del rads
    general_tile["trace_ms"] = in_turns(
        {label: functools.partial(general_trace, shrink) for label, shrink in widths.items()}, 2)
    say("general_tile_breakdown", **general_tile)
    if not general_tile["radiance_equal"]:
        fail("the general path's tile at its live width is not the full width's, draws from one seed")
    del hit, mrec, q0, cast, rays_w, act

    # ---- phase 8: the general path at full resolution: the flagship frame with
    # fused=False, one warm-up and one timed frame, counts set to 0 just
    # before.
    CH.brute_closest.launches = CH.brute_closest_n.launches = 0
    CH.occlusion_any.launches = W.wave_level.launches = 0
    torch.cuda.reset_peak_memory_stats()
    g_seconds = []
    g_levels = 0
    for i in range(2):
        gen_i = torch.Generator(device=dev).manual_seed(10 + i)
        torch.cuda.synchronize()
        t0 = time.time()
        with general_routing(), level_marks() as marks:
            g_img, g_dropped = srgb_frame(rt, scene, opts, gen_i, device=dev)
        torch.cuda.synchronize()
        g_seconds.append(time.time() - t0)
        g_levels += len(marks)
    general_launches = dict(
        brute_closest=CH.brute_closest.launches,
        brute_closest_n=CH.brute_closest_n.launches,
        occlusion_any=CH.occlusion_any.launches,
        wave_level=W.wave_level.launches,
    )
    g_diff = golden_diff(rt, g_img, "bvh_s4_textured_r4.ppm")
    g_mean, g_p99 = float(g_diff.mean()), float(np.percentile(g_diff, 99))
    say("general_path", scene="golden/ASCII/scene.json", width=width, height=height,
        spp=spp, levels=n_levels, tiles=n_tiles, primary_rays=n_rays,
        warmup_seconds=g_seconds[0], timed_seconds=g_seconds[1],
        primary_rays_per_s=n_rays / g_seconds[1],
        fused_path_mean_seconds=mean_s, kernel_launches=general_launches, levels_run=g_levels,
        dropped=g_dropped, peak_memory_bytes=torch.cuda.max_memory_allocated(),
        golden="bvh_s4_textured_r4.ppm", golden_mean_diff=g_mean, golden_p99=g_p99)
    # One launch a level the tiles ran (a tile ends where no lane is live).
    expect = dict(brute_closest=g_levels, brute_closest_n=0,
                  occlusion_any=g_levels * scene.n_lights, wave_level=0)
    if general_launches != expect:
        fail(f"general path launched {general_launches}, expected {expect}")
    if g_dropped:
        fail("the in-slot general path dropped continuations")
    if not (g_mean < 1.0 and g_p99 <= 8):
        fail("the general-path flagship frame is outside the stochastic "
             "contract against its golden")


    # ---- phase fused_widened: the fused level's specialisations at full
    # width (legacy planes, one-way refraction, area lights, motion blur,
    # spherical UV)
    del o, d, tm, fuzz, levels, boot, g_img, img
    torch.cuda.empty_cache()
    widened = fused_widened_phase(rt, W, CH, dev, n_levels)
    edge = wide_edge_phase(rt, W, dev)
    torch.cuda.empty_cache()

    # ---- phases 9 and 10: the acceleration path
    accel_entries, city_anyhit, city_brute, city_frames, accel_seconds = accel_phases(
        rt, dev, ACCEL_SIZES, kinds, k_table, k_ranges, k_n, n_levels)
    torch.cuda.empty_cache()

    # ---- phase 11: the differentiable path (record mode, diff/)
    diff = diff_path_phase(rt, W, CH, scene, n_levels, dev)

    # ---- phases cli and native: the command line in a subprocess, the
    # host builders against their plain versions
    cli_phase(rt, dev)
    native_phase(rt, dev)

    # ---- phase sharded: multi-device rendering and the entry points
    sharded = sharded_phase(rt, W, dev, scene, tile_rows, n_levels)

    brute_entries = []
    for name, line, count in (
        ("brute_closest", 367, general_launches["brute_closest"]),
        ("brute_closest_n", 583, branch_launches["brute_closest_n"]),
        ("occlusion_any", 682, general_launches["occlusion_any"]),
    ):
        row = width_rows[name]
        brute_entries.append({
            "name": name,
            "route": "cuda",
            "source": "ray_tracying_tpu_torch/csrc/closest_hit.cu",
            "replaces": f"ray_tracying_tpu/kernels/closest_hit.py:{line}",
            "launches": count,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
            "lanes": row["lanes"],
            "shape_note": "level 0 of one full-width flagship tile"
                          + ("'s shadow rays of light 0" if name == "occlusion_any" else "")
                          + ("; launches counted on det_twoway, "
                             "the untextured general-path renders"
                             if name == "brute_closest_n" else
                             "; launches counted on two general-path frames"),
        })
        # the redesign's rows: the flagship tile's, cube_city's levels 0 and 1
        flag, city = (flag_anyhit, city_anyhit) if name == "occlusion_any" else \
            (flag_brute[name], {lv: r[name] for lv, r in city_brute.items()})
        c0, c1 = city["level 0"], city["level 1"]
        brute_entries[-1].update(
            old_schedule_ms=flag["old_schedule_ms"],
            blocks_per_sm=flag["blocks_per_sm"], smem_bytes=flag["smem_bytes"],
            threads=flag["threads"],
            cube_city_ms=c0["ms"], cube_city_old_schedule_ms=c0["old_schedule_ms"],
            cube_city_bound_ms=c0["bound_ms"], cube_city_bound_by=c0["bound_by"],
            cube_city_live=c0["live"], cube_city_smem_bytes=c0["smem_bytes"],
            cube_city_blocks_per_sm=c0["blocks_per_sm"],
            cube_city_level1_ms=c1["ms"],
            cube_city_level1_old_schedule_ms=c1["old_schedule_ms"],
            cube_city_level1_bound_ms=c1["bound_ms"])
        # every launch of the kernel in the cube_city frames that launch it
        frames = {"occlusion_any": ("cube_city_bvh", "cube_city_brute"),
                  "brute_closest_n": ("cube_city_brute",)}.get(name, ())
        if frames:
            brute_entries[-1].update(
                cube_city_frame_ms_all_launches={
                    f: city_frames[(f, "warp")][name] for f in frames},
                cube_city_frame_ms_all_launches_old_schedule={
                    f: city_frames[(f, "lane")][name] for f in frames})
    print(json.dumps({"kernels": [{
        "name": "wave_level",
        "route": "cuda",
        "source": "ray_tracying_tpu_torch/csrc/wavefront.cu",
        "replaces": "ray_tracying_tpu/kernels/wavefront.py:211",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows_out.values()),
        "ms": r0["ms"],
        "plain_ms": r0["plain_ms"],
        "bound_ms": r0["bound_ms"],
        "bound_by": r0["bound_by"],
        "library_ms": None,
        "lanes": n,
        "shape_note": "level 0 of one full-width flagship tile; "
                      f"deep_* is level {deep} of the same tile; bound_ms is the bound on "
                      "the tests a per-ray window cull needs (what the package's build "
                      "runs), bound_all_tests_ms the bound on every test",
        "bound_all_tests_ms": r0["bound_all_tests_ms"],
        "bound_all_tests_by": r0["bound_all_tests_by"],
        **{k: r0[k] for k in r0 if k.startswith(("needed_", "ran_"))},
        "deep_ms": r1["ms"],
        "deep_plain_ms": r1["plain_ms"],
        "deep_bound_ms": r1["bound_ms"],
        "deep_bound_by": r1["bound_by"],
        "deep_bound_all_tests_ms": r1["bound_all_tests_ms"],
        "fmad_false_floor_ms": r0["fmad_false_floor_ms"],
        "fmad_false_floor_all_tests_ms": r0["fmad_false_floor_all_tests_ms"],
        "lane_schedule_ms": sum(ab[0]["lane_ms"]) / 2,
        "lane_schedule_deep_ms": sum(ab[deep]["lane_ms"]) / 2,
        "flagship_build_ab": builds,
        "main_path_ab": main_ab,
        "staged_goldens_radiance_equal": sum(r["radiance_equal"] for r in staged_goldens),
        "builds_ptxas": plan["builds"],
        "blocks_per_sm": plan["blocks_per_sm"],
        "smem_bytes": plan["smem_bytes"],
        "record_mode": {
            "launches": diff["launches"]["wave_level_record"],
            "launches_note": "record-mode launches of diff_path (b)-(d): whole frame 1 spp "
                             "twice, tiled 4x4 spp, the forward-only runs, fit",
            "max_abs_err": 0.0,
            "ms": sum(rec_mode["level0_record_ms"]) / 2,
            "inference_ms_same_turns": sum(rec_mode["level0_inference_ms"]) / 2,
            "staged_build_ms_same_turns": sum(rec_mode["level0_record_staged_ms"]) / 2,
            "plain_ms_every_nth_lane": rec_mode["record_plain_ms_every_nth_lane"],
            "stride": rec_mode["stride"],
            "bound_ms": rec_mode["bound_ms"],
            "bound_by": rec_mode["bound_by"],
            "library_ms": None,
            "level0_backward_ms": rec_mode["level0_backward_ms"],
            "level0_gather_segment_sum_ms": rec_mode["level0_gather_segment_sum_ms"],
            "level0_gather_index_add_ms": rec_mode["level0_gather_index_add_ms"],
            "diff_tiled_forward_backward_seconds": diff["tiled"]["forward_backward_seconds"],
        },
        "shrunk_levels": [
            {k: r[k] for k in ("level", "width", "live", "ms", "staged_ms", "full_width_ms",
                               "bound_ms", "bound_by") if k in r}
            for r in shrink_row["levels"] if r["width"] != n],
        "shrink_compaction_ms": shrink_row["compaction_ms"],
        "shrunk_levels_slower_than_staged": shrink_row["slower_than_staged_levels"],
        "sharded": sharded,
        "widened": {
            name: {k: row.get(k) for k in (
                "level0_ms", "level0_plain_ms", "level0_bound_ms", "level0_bound_by",
                "level0_bound_all_tests_ms", "level0_windowed_ms", "level0_staged_ms",
                "level0_needed_closest_tests_per_live_lane",
                "level0_needed_shadow_tests_per_live_lane",
                "level1_ms", "level1_bound_ms", "level1_bound_all_tests_ms",
                "lanes", "geoms", "light_samples", "disagreeing_lanes", "max_abs_err",
                "fused_frame_seconds",
                "fused_unshrunk_frame_seconds", "general_frame_seconds",
                "fused_launches", "window_ab")}
            for name, row in widened.items() if row["build"] == "staged_windows"
        },
        # tables over what a block stages: the kernel's wide build
        "wide": {
            name: dict(
                {k: row.get(k) for k in (
                    "geoms", "lanes", "level0_ms", "level1_ms", "stride", "level0_bound_ms",
                    "level0_bound_by", "level1_bound_ms", "level1_bound_by", "smem_bytes",
                    "blocks_per_sm", "disagreeing_lanes", "max_abs_err",
                    "fused_frame_seconds",
                    "general_frame_seconds")},
                plain_ms_every_nth_lane=row["level0_plain_ms"],
                level1_plain_ms_every_nth_lane=row["level1_plain_ms"],
                # the bound of the windowed build the package launches: the
                # tests a per-ray window cull cannot avoid (the bound on
                # every test, what the unculled build runs, apart)
                bound_ms=row["level0_bound_ms"], bound_by=row["level0_bound_by"],
                bound_all_tests_ms=row["level0_bound_all_tests_ms"],
                # the windowed build against the unculled one, or the staged one
                # where it takes the table (wide_window_ab),
                # the tests a live lane it needs and the counting build ran
                **{k: v for k, v in row.items()
                   if k.startswith(("level0_", "level1_"))
                   and any(x in k for x in ("windowed", "unculled", "staged", "needed",
                                            "all_tests", "ran_"))},
                window_ab=row.get("window_ab"),
                launches=row.get("fused_launches", row["launches"]),
                launches_note=("the fused frame's, counted (fused_widened)"
                               if "fused_launches" in row else
                               "every launch of phase wide_edge, counted: levels 0 and 1, "
                               "one record-mode launch, 5 timed repetitions of each level"),
                accel_path_fused_frame_seconds=accel_seconds.get(f"{name}_fused"),
                accel_path_general_frame_seconds=accel_seconds.get(f"{name}_brute"))
            for name, row in list(widened.items()) + [(edge["case"], edge)]
            if row["build"] == "windows"
        },
    }] + brute_entries + accel_entries}), flush=True)

    say("done", seconds=round(time.time() - t_start, 1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
