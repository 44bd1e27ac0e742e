#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Drives the port's main paths through the public entry points: the flagship
render (golden/ASCII/scene.json at 1920x1080 with 4x4 samples per pixel, 11
bounce levels) down the fused level path and, forced with fused=False, down
the general path (closest hit, pass 2, materials, shading with one shadow
any-hit launch per light, spawn), and the general path's other branches on
their own scenes (the two-way queue, area lights).  It builds the CUDA
kernels from the sources of this checkout, holds each kernel against its
plain PyTorch version on the card, checks eleven images against the
reference renderer's goldens, and prints one JSON line per phase.  Any
failure exits non-zero; nothing is caught.

    python3 chip_smoke.py

Needs one CUDA device, nvcc, and no network.  Without a device it exits 1
and prints no result.  The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import os
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


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def load_demo(rt, name):
    return rt.load_scene(
        os.path.join(REPO, "scenes", f"{name}.json"),
        textures_dir=os.path.join(REPO, "golden", "Textures"),
    )


def golden_diff(rt, img, golden):
    gold = rt.read_ppm(os.path.join(REPO, "golden", "Output", golden))
    return np.abs(img.astype(np.float32) - gold.astype(np.float32))


def golden_check(rt, name, golden, samples_sqrt, contract, seed, light_samples=1):
    """Render scenes/<name>.json through the pipeline's own routing and
    hold it against the reference renderer's golden."""
    from ray_tracying_tpu_torch.kernels.wavefront import wave_refusal

    scene = load_demo(rt, name)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    img = rt.render_to_srgb_u8(
        scene,
        rt.RenderOptions(samples_sqrt=samples_sqrt, light_samples=light_samples),
        gen,
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
    say("golden", scene=name, golden=golden, samples_sqrt=samples_sqrt,
        light_samples=light_samples, contract=contract,
        path="general" if wave_refusal(scene) else "fused", ok=ok, **res)
    if not ok:
        fail(f"{name} is outside the {contract} contract against {golden}")


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


def general_frame(rt, scene, opts, tile_rows, gen):
    """The flagship frame down the general path: the pipeline's own tile
    loop with `trace_wavefront(..., fused=False)` in place of the routing.
    Returns ((H, W, 3) uint8 image, dropped continuations)."""
    from ray_tracying_tpu_torch.render.integrator import trace_wavefront
    from ray_tracying_tpu_torch.render.pipeline import linear_to_srgb_u8, tile_rays

    width, height = scene.camera.resolution
    n = opts.samples_sqrt
    image = torch.zeros((height, width, 3), dtype=torch.uint8, device="cuda")
    dropped = []
    for y0 in range(0, height, tile_rows):
        take = min(tile_rows, height - y0)
        o, d, tm = tile_rays(scene.camera, y0, take, width, n, generator=gen)
        rad, drop = trace_wavefront(
            scene, o, d, tm, opts.light_samples, generator=gen, fused=False,
            return_dropped=True,
        )
        image[y0 : y0 + take] = linear_to_srgb_u8(
            rad.reshape(take, width, n * n, 3).mean(dim=2)
        )
        dropped.append(drop)
    return image.cpu().numpy(), int(torch.stack(dropped).sum())


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
    from ray_tracying_tpu_torch.render.pipeline import tile_rays

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    say("device", kind=kind, count=torch.cuda.device_count(),
        nvidia_smi_name_power_limit=smi, torch=torch.__version__,
        cuda=torch.version.cuda)

    # ---- phase 2: build
    _build.load()
    ptxas = [ln.strip() for ln in _build.last_build["log"].splitlines()
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    if sum("entry function" in ln for ln in ptxas) != 4 and _build.last_build["compiled"]:
        fail("the build did not report four kernels")
    say("build", seconds=round(_build.last_build["seconds"], 2),
        compiled=_build.last_build["compiled"], flags=_build.last_build["flags"],
        library=os.path.relpath(_build.last_build["path"], REPO), ptxas=ptxas)

    scene = rt.load_scene(os.path.join(REPO, "golden", "ASCII", "scene.json"))
    tables = W.wave_tables(scene)
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
    common = dict(fuzz=fuzz, tables=tables, return_levels=True)
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
        if not res["ok"]:
            fail(f"kernel and plain version disagree on level {lv}")
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
    if not (res["ok"] and dead_zero):
        fail("kernel and plain version disagree on the mixed-mask tile")

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
    for name in ("det_basic", "det_mirrors", "det_twoway", "texture"):
        golden_check(rt, name, f"{name}_s1.ppm", 1, "deterministic", 0)
    golden_check(rt, "dof", "dof_s6.ppm", 6, "stochastic", 3)
    golden_check(rt, "motion", "motion_s6.ppm", 6, "stochastic", 3)
    golden_check(rt, "glossy", "glossy_s6.ppm", 6, "stochastic", 3)

    # The general path's other two branches, with the counts set to 0 just
    # before: the compacted two-way queue (det_twoway: untextured, so the
    # fused-normal kernel; rendered twice at 1 spp, bytes equal, no drop)
    # and area-light jitter (softshadow, 16 shadow rays per light).
    CH.brute_closest.launches = CH.brute_closest_n.launches = 0
    CH.occlusion_any.launches = W.wave_level.launches = 0
    twoway = load_demo(rt, "det_twoway")
    one = rt.RenderOptions(samples_sqrt=1)
    img_a = rt.render_to_srgb_u8(twoway, one)
    img_b = rt.render_to_srgb_u8(twoway, one)
    _, tw_stats = rt.render_image(twoway, rt.RenderOptions(samples_sqrt=1, stats=True))
    golden_check(rt, "det_twoway", "det_twoway_s6.ppm", 6, "stochastic", 3)
    golden_check(rt, "softshadow", "softshadow_s4_l16.ppm", 4, "stochastic", 3,
                 light_samples=16)
    branch_launches = dict(
        brute_closest=CH.brute_closest.launches,
        brute_closest_n=CH.brute_closest_n.launches,
        occlusion_any=CH.occlusion_any.launches,
        wave_level=W.wave_level.launches,
    )
    say("general_branches", scenes=["det_twoway", "softshadow"],
        det_twoway_bytes_equal=bool(np.array_equal(img_a, img_b)),
        det_twoway_total_dropped=tw_stats["total_dropped"],
        det_twoway_live=[lv["live"] for lv in tw_stats["levels"]],
        kernel_launches=branch_launches)
    if not np.array_equal(img_a, img_b):
        fail("two renders of det_twoway differ")
    if tw_stats["total_dropped"] != 0:
        fail("det_twoway dropped continuations")
    if not (branch_launches["brute_closest_n"] and branch_launches["occlusion_any"]):
        fail("the two-way and area-light renders did not go through the "
             "fused-normal and any-hit kernels")
    if branch_launches["wave_level"] or branch_launches["brute_closest"]:
        fail("untextured general-path scenes launched another kernel")

    # ---- phase 5: the main path, full frame
    n_rays = width * height * spp
    runs = 3  # one warm-up, two timed
    torch.cuda.reset_peak_memory_stats()
    W.wave_level.launches = 0
    seconds = []
    img = None
    for i in range(runs):
        gen_i = torch.Generator(device=dev).manual_seed(i)
        torch.cuda.synchronize()
        t0 = time.time()
        img = rt.render_to_srgb_u8(scene, opts, gen_i)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
    launches = W.wave_level.launches
    peak_bytes = torch.cuda.max_memory_allocated()
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
        peak_memory_bytes=peak_bytes,
        golden="bvh_s4_textured_r4.ppm", golden_mean_diff=flag_mean,
        golden_p99=flag_p99)
    if not (flag_mean < 1.0 and flag_p99 <= 8):
        fail("the flagship frame is outside the stochastic contract against "
             "its golden")

    # Per-level counters of one full-width tile (the second: rows with cubes).
    gen = torch.Generator(device=dev).manual_seed(5)
    y0 = tile_rows if n_tiles > 1 else 0
    o, d, tm = tile_rays(scene.camera, y0, tile_rows, width, 4, generator=gen)
    n = o.shape[0]
    fuzz = [uniform_in_unit_sphere(gen, (n,)).T.contiguous() for _ in range(n_levels)]
    _, stats, levels = trace_wavefront(
        scene, o, d, tm, fuzz=fuzz, tables=tables, return_stats=True,
        return_levels=True,
    )
    say("main_path", tile_rows=tile_rows, tile_lanes=n,
        live=stats.live.tolist(), hits=stats.hits.tolist(),
        spawned=stats.spawned.tolist())

    # Where that tile's time goes, by CUDA events: ray generation, the 11
    # fuzz draws, the whole trace given the draws (launches, accumulation,
    # bootstrap), and each level's launch alone on its own input.
    from ray_tracying_tpu_torch.render.integrator import level_fuzz

    boot = torch.cat([o.T, d.T, tm[None], torch.ones((2, n), device=dev)]).contiguous()
    inputs = [boot] + levels[:-1]
    say("tile_breakdown", tile_lanes=n,
        rays_ms=cuda_ms(lambda: tile_rays(scene.camera, y0, tile_rows, width, 4, generator=gen), 3),
        fuzz_ms=cuda_ms(lambda: [level_fuzz(tables, gen, n, dev) for _ in range(n_levels)], 3),
        trace_ms=cuda_ms(lambda: trace_wavefront(scene, o, d, tm, fuzz=fuzz, tables=tables), 3),
        level_ms=[cuda_ms(lambda: W.wave_level(inputs[lv], fuzz[lv], tables), 3)
                  for lv in range(n_levels)])

    # ---- phase 6: the kernel at the main path's shapes: level 0 and a deep
    # level of that tile, against the plain version on the same inputs,
    # with its times and its roofline bound.
    del inputs
    deep = 4
    rows_out = []
    plain0 = None
    for name, lv, prev in (("level0", 0, boot), (f"level{deep}", deep, levels[deep - 1])):
        a = W.wave_level(prev, fuzz[lv], tables)
        need = {}
        torch.cuda.synchronize()
        t0 = time.time()
        b = W.wave_level_plain(prev, fuzz[lv], tables, stats=need)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        res, _ = compare_level(a, b)
        if lv == 0:
            plain0 = b
        del a, b
        ms = cuda_ms(lambda: W.wave_level(prev, fuzz[lv], tables), 5)
        # Least work this call's data needs.  Bytes: every lane's act row
        # read and its 13 output rows written (zeros for a dead lane); only
        # a live lane's other 8 queue rows and 3 fuzz rows are read; the
        # tables once.  Operations: G tests per live lane, the shadow tests
        # up to each ray's first blocker, the shading of hit lanes.
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
        rows_out.append(dict(
            case=name, lanes=n, ms=ms, plain_ms=plain_ms,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            bytes_ms=bytes_ms, operations_ms=ops_ms, needed_bytes=n_bytes,
            needed=need, **res))
        say("kernel_at_width", **rows_out[-1])
        if not res["ok"]:
            fail(f"kernel and plain version disagree at full width, {name}")
    r0, r1 = rows_out

    # The same sources built with FMA contraction on, beside the package's
    # --fmad=false build: level 0 of that tile against the plain version,
    # both builds timed in turn, and bvh_det against its golden.  This is
    # the measurement behind --fmad=false; the package never runs this
    # variant, so it is swapped in here and out again.
    strict = _build.load()
    fused = _build.load_variant(fmad=True)
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
        trace_ms=cuda_ms(lambda: trace_wavefront(
            scene, o, d, tm, fused=False, fuzz=fuzz), 2),
    )
    say("general_tile_breakdown", **general_tile)
    del hit, mrec, q0, cast, rays_w, act

    # ---- phase 8: the general path at full width: the flagship frame with
    # fused=False, one warm-up and one timed frame, counts set to 0 just
    # before.
    CH.brute_closest.launches = CH.brute_closest_n.launches = 0
    CH.occlusion_any.launches = W.wave_level.launches = 0
    torch.cuda.reset_peak_memory_stats()
    g_seconds = []
    for i in range(2):
        gen_i = torch.Generator(device=dev).manual_seed(10 + i)
        torch.cuda.synchronize()
        t0 = time.time()
        g_img, g_dropped = general_frame(rt, scene, opts, tile_rows, gen_i)
        torch.cuda.synchronize()
        g_seconds.append(time.time() - t0)
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
        fused_path_mean_seconds=mean_s, kernel_launches=general_launches,
        dropped=g_dropped, peak_memory_bytes=torch.cuda.max_memory_allocated(),
        golden="bvh_s4_textured_r4.ppm", golden_mean_diff=g_mean, golden_p99=g_p99)
    expect = dict(brute_closest=n_levels * n_tiles * 2, brute_closest_n=0,
                  occlusion_any=n_levels * n_tiles * scene.n_lights * 2, wave_level=0)
    if general_launches != expect:
        fail(f"general path launched {general_launches}, expected {expect}")
    if g_dropped:
        fail("the in-slot general path dropped continuations")
    if not (g_mean < 1.0 and g_p99 <= 8):
        fail("the general-path flagship frame is outside the stochastic "
             "contract against its golden")

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
                          + ("; launches counted on det_twoway and softshadow, "
                             "the untextured general-path renders"
                             if name == "brute_closest_n" else
                             "; launches counted on two general-path frames"),
        })
    print(json.dumps({"kernels": [{
        "name": "wave_level",
        "route": "cuda",
        "source": "ray_tracying_tpu_torch/csrc/wavefront.cu",
        "replaces": "ray_tracying_tpu/kernels/wavefront.py:211",
        "launches": launches,
        "max_abs_err": max(r0["max_abs_err"], r1["max_abs_err"]),
        "ms": r0["ms"],
        "plain_ms": r0["plain_ms"],
        "bound_ms": r0["bound_ms"],
        "bound_by": r0["bound_by"],
        "library_ms": None,
        "lanes": n,
        "shape_note": "level 0 of one full-width flagship tile; "
                      f"deep_* is level {deep} of the same tile",
        "deep_ms": r1["ms"],
        "deep_plain_ms": r1["plain_ms"],
        "deep_bound_ms": r1["bound_ms"],
        "deep_bound_by": r1["bound_by"],
    }] + brute_entries}), flush=True)

    say("done", seconds=round(time.time() - t_start, 1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
