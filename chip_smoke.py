#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Drives the port's main path — the flagship render, golden/ASCII/scene.json
at 1920x1080 with 4x4 samples per pixel, 11 bounce levels — through the
public entry points, builds the CUDA kernel from the sources of this
checkout, holds the kernel against its plain PyTorch version on the card,
checks two images against the reference renderer's goldens, and prints one
JSON line per phase.  Any failure exits non-zero; nothing is caught.

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
# the world->object transform (18 + 15) plus the kind's own test.
FLOPS_PER_TEST = {0: 33 + 38, 1: 33 + 45, 2: 33 + 15}
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


def golden_check(rt, name, golden, samples_sqrt, contract, seed):
    scene = rt.load_scene(
        os.path.join(REPO, "scenes", f"{name}.json"),
        textures_dir=os.path.join(REPO, "golden", "Textures"),
    )
    gen = torch.Generator(device="cuda").manual_seed(seed)
    img = rt.render_to_srgb_u8(
        scene, rt.RenderOptions(samples_sqrt=samples_sqrt, light_samples=1), gen
    )
    gold = rt.read_ppm(os.path.join(REPO, "golden", "Output", golden))
    diff = np.abs(img.astype(np.float32) - gold.astype(np.float32))
    if contract == "deterministic":
        # max diff <= 1 uint8 step, < 1 % of values off by one
        res = dict(max_diff=float(diff.max()), off_share=float((diff > 0).mean()))
        ok = res["max_diff"] <= 1 and res["off_share"] < 0.01
    else:
        # two Monte-Carlo estimates: mean diff < 1, p99 <= 8
        res = dict(mean_diff=float(diff.mean()), p99=float(np.percentile(diff, 99)))
        ok = res["mean_diff"] < 1.0 and res["p99"] <= 8
    say("golden", scene=name, golden=golden, samples_sqrt=samples_sqrt,
        contract=contract, ok=ok, **res)
    if not ok:
        fail(f"{name} is outside the {contract} contract against {golden}")


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
    from ray_tracying_tpu_torch.kernels import wavefront as W
    from ray_tracying_tpu_torch.render.integrator import trace_wavefront
    from ray_tracying_tpu_torch.render.pipeline import tile_rays

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    say("device", kind=kind, count=torch.cuda.device_count(),
        nvidia_smi_name_power_limit=smi, torch=torch.__version__,
        cuda=torch.version.cuda)

    # ---- phase 2: build
    _build.load()
    ptxas = [ln for ln in _build.last_build["log"].splitlines()
             if "registers" in ln or "spill" in ln]
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

    # ---- phase 4: goldens of the reference renderer
    golden_check(rt, "bvh_det", "bvh_det_s1.ppm", 1, "deterministic", 0)
    golden_check(rt, "bvh_glossy", "bvh_glossy_s8.ppm", 8, "stochastic", 7)

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
    del o, d, tm, inputs
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
    }]}), flush=True)

    say("done", seconds=round(time.time() - t_start, 1))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
