"""The command line, mirroring the reference CLI exactly.

Flags (Code/raytracer.cpp:367-390): `-bvh`, `-s N`, `-light_sample N`,
`-input name.json`, `-output name.ppm`.  Defaults match the reference:
4x4 samples, 1 light sample, BVH off, output "output.ppm"
(Code/raytracer.cpp:361-365); a missing -input is an error with the same
message shape (:391-395).

Path resolution generalizes the reference's hardcoded "../../ASCII" /
"../../Output" (Code/raytracer.cpp:358,397-398): if -input is an existing
path it is used as-is, otherwise it resolves against --scene-dir
(default: ./ASCII if present, else cwd); -output goes to --output-dir
(default: ./Output if present, else cwd).

Besides the reference's flags, the JAX package's: `--seed N` (the seed of
the render's torch.Generator, 0 by default) and `--stats` (one JSON line a
bounce level and one a tile, from render_with_stats); and one of its own:
`--device` (default "cuda"; "cpu" runs the plain versions on the host).
Without a card the CLI exits 1 unless asked for the CPU.

    python -m ray_tracying_tpu_torch.cli -input scene.json -output out.ppm
"""

from __future__ import annotations

import os
import sys
import time


def parse_args(argv):
    opts = {
        "use_bvh": False,
        "samples_sqrt": 4,
        "light_samples": 1,
        "input": "",
        "output": "output.ppm",
        "scene_dir": None,
        "output_dir": None,
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-bvh":
            opts["use_bvh"] = True
        elif a == "-s" and i + 1 < len(argv):
            opts["samples_sqrt"] = int(argv[i + 1]); i += 1
        elif a == "-light_sample" and i + 1 < len(argv):
            opts["light_samples"] = int(argv[i + 1]); i += 1
        elif a == "-input" and i + 1 < len(argv):
            opts["input"] = argv[i + 1]; i += 1
        elif a == "-output" and i + 1 < len(argv):
            opts["output"] = argv[i + 1]; i += 1
        elif a == "--scene-dir" and i + 1 < len(argv):
            opts["scene_dir"] = argv[i + 1]; i += 1
        elif a == "--output-dir" and i + 1 < len(argv):
            opts["output_dir"] = argv[i + 1]; i += 1
        elif a == "--seed" and i + 1 < len(argv):
            opts["seed"] = int(argv[i + 1]); i += 1
        elif a == "--stats":
            opts["stats"] = True
        elif a == "--device" and i + 1 < len(argv):
            opts["device"] = argv[i + 1]; i += 1
        else:
            print(f"Warning: ignoring unknown argument {a!r}", file=sys.stderr)
        i += 1
    return opts


def main(argv=None) -> int:
    opts = parse_args(sys.argv[1:] if argv is None else argv)
    if not opts["input"]:
        print("Error: Please specify scene file name", file=sys.stderr)
        print(
            "Correct usage: python -m ray_tracying_tpu_torch.cli "
            "-input {scene_file_name.json}"
        )
        return 1

    scene_dir = opts["scene_dir"] or ("ASCII" if os.path.isdir("ASCII") else ".")
    out_dir = opts["output_dir"] or ("Output" if os.path.isdir("Output") else ".")
    scene_path = (
        opts["input"] if os.path.exists(opts["input"])
        else os.path.join(scene_dir, opts["input"])
    )
    out_path = os.path.join(out_dir, opts["output"])

    import torch

    import ray_tracying_tpu_torch as rt

    device = torch.device(opts.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"Error: no CUDA device for --device {device}; "
              "pass --device cpu to render on the host", file=sys.stderr)
        return 1

    scene = rt.load_scene(scene_path, device=device)
    width, height = scene.camera.resolution
    if width == 0 or height == 0:
        print("Error: Camera resolution is 0. Check scene json.", file=sys.stderr)
        return 1

    render_opts = rt.RenderOptions(
        samples_sqrt=opts["samples_sqrt"],
        light_samples=opts["light_samples"],
        use_bvh=opts["use_bvh"],
    )
    generator = torch.Generator(device=device)
    generator.manual_seed(opts.get("seed", 0))
    print(f"BVH mode: {'ON' if opts['use_bvh'] else 'OFF'}")
    print(
        f"Rendering {width}x{height} with {opts['samples_sqrt']}x"
        f"{opts['samples_sqrt']} samples and {opts['light_samples']} "
        "light sampling points ..."
    )
    t0 = time.time()
    if opts.get("stats"):
        # Diagnostic mode: per-level live/hit/spawn/drop counters + per-tile
        # timings as JSON lines (the reference's only observability is a
        # progress print every 100 rows, Code/raytracer.cpp:473-475).
        import json

        from ray_tracying_tpu_torch.render.pipeline import (
            linear_to_srgb_u8, render_with_stats,
        )

        linear, stats = render_with_stats(scene, render_opts, generator, device=device)
        img = linear_to_srgb_u8(torch.from_numpy(linear).to(device)).cpu().numpy()
        for row in stats["levels"]:
            print(json.dumps(row))
        for row in stats["tiles"]:
            print(json.dumps(row))
        if stats["total_dropped"]:
            print(
                f"WARNING: {stats['total_dropped']} continuation rays dropped "
                "by queue-shrink or compacted-queue overflow",
                file=sys.stderr,
            )
    else:
        img = rt.render_to_srgb_u8(scene, render_opts, generator, device=device)
    dt = time.time() - t0
    spp = opts["samples_sqrt"] ** 2 if opts["samples_sqrt"] > 1 else 1
    mrays = width * height * spp / dt / 1e6
    print(f"Rendering complete in {dt:.2f}s ({mrays:.2f} primary Mrays/s)")
    rt.write_ppm(out_path, img)
    print(f"Image written to {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
