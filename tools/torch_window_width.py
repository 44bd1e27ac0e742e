#!/usr/bin/env python3
"""The window width of the fused level's windowed build, measured on one
NVIDIA GPU (the PyTorch/CUDA port; no JAX).

The build cuts each kind range of a wide table into windows of W rows
(csrc/wavefront.cu::kWinRows, kernels/wavefront.py::WAVE_WINDOW).  This
script measures the shipped W = 32 against W = 64 in turns (32, 64, 64,
32), each turn a process of its own.  Each width runs from a copy of the
package under _archive/window_width/ (which .gitignore lists; W = 64 with
both constants changed), built there by the first turn of that width, whose
ptxas report (registers and spills of the windowed build and its counting
build) the copy keeps for the second.  Each turn, for each of the three
wide tables (cube_city(n=2048), a textured sphere_field(n=3000),
sphere_field(n=6143)) at 1920x1080, 2x2 spp, the middle full-width tile:
levels 0 and 1 by the windowed build (CUDA events, 3 repetitions after a
warm-up launch), and the tests a live lane its counting build ran.  One
JSON line a (width, table, level), then the card's name and power limit.

    python3 tools/torch_window_width.py

Exits 1 without a CUDA device.
"""

import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPY = os.path.join(REPO, "_archive", "window_width")
CASES = ("cube_city", "sphere_field_textured_3000", "sphere_field_6143")


def copy_with_width(width):
    """A copy of the package and chip_smoke.py with W = width, and no
    build; its root."""
    root = os.path.join(COPY, f"w{width}")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "ray_tracying_tpu_torch"),
                    os.path.join(root, "ray_tracying_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), root)
    for data in ("scenes", "golden"):  # the demo scenes and textures chip_smoke loads
        os.symlink(os.path.join(REPO, data), os.path.join(root, data))
    for rel, pattern, repl in (
            ("csrc/wavefront.cu", r"constexpr int kWinRows = \d+;",
             f"constexpr int kWinRows = {width};"),
            ("kernels/wavefront.py", r"\nWAVE_WINDOW = \d+\n", f"\nWAVE_WINDOW = {width}\n")):
        path = os.path.join(root, "ray_tracying_tpu_torch", rel)
        with open(path) as f:
            text, n = re.subn(pattern, repl, f.read())
        if n != 1:
            raise RuntimeError(f"{rel}: the window width's constant not found")
        with open(path, "w") as f:
            f.write(text)
    return root


def measure(root):
    """One turn, in this process, with the package under `root`."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as S
    import ray_tracying_tpu_torch as rt
    from ray_tracying_tpu_torch import models
    from ray_tracying_tpu_torch.kernels import _build
    from ray_tracying_tpu_torch.kernels import wavefront as W
    from ray_tracying_tpu_torch.render.pipeline import tile_rays

    dev = torch.device("cuda")
    _build.load()
    kept = os.path.join(root, "ptxas.json")
    if _build.last_build["compiled"]:
        ptxas = {b: S.ptxas_numbers(S.ptxas_report(_build, f"wave_level_blocks_kernelILi{c}E"))
                 for b, c in W.WAVE_BUILDS.items() if b.startswith("windows")}
        with open(kept, "w") as f:
            json.dump(ptxas, f)
    with open(kept) as f:
        ptxas = json.load(f)
    for name in CASES:
        scene = (models.get("sphere_field", n=6143, res=S.WIDENED_RES, device=dev)
                 if name == "sphere_field_6143" else S.widened_scene(rt, name, dev))
        tables = W.wave_tables(scene)
        width, height = S.WIDENED_RES
        rows = min(height, rt.RenderOptions().max_rays_per_pass // (width * 4))
        gen = torch.Generator(device=dev).manual_seed(31)
        o, d, tm = tile_rays(scene.camera, height // 2 - rows // 2, rows, width, 2,
                             generator=gen)
        n = o.shape[0]
        prev = torch.cat([o.T, d.T, tm[None], torch.ones((2, n), device=dev)]).contiguous()
        for lv in range(2):
            W.wave_level_build(prev, None, tables, "windows")  # warm-up
            ms = S.cuda_ms(lambda: W.wave_level_build(prev, None, tables, "windows"), 3)
            plan = W.wave_plan(tables, build="windows")
            work = torch.zeros(len(W.WINDOW_WORK), dtype=torch.int64, device=dev)
            W.wave_level_build(prev, None, tables, "windows_count", work=work)
            live = int((prev[7] > 0).sum())
            print(json.dumps(dict(
                window_rows=W.WAVE_WINDOW, case=name, level=lv, lanes=n, live=live,
                windows=tables.windows.shape[0], ms=ms, smem_bytes=plan["smem_bytes"],
                blocks_per_sm=plan["blocks_per_sm"],
                ptxas=ptxas, per_live_lane={k: v / max(live, 1)
                                            for k, v in zip(W.WINDOW_WORK, work.tolist())})),
                flush=True)
            prev = W.wave_level(prev, None, tables)
            del work


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        measure(sys.argv[2])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_window_width: no CUDA device", file=sys.stderr)
        return 1
    roots = {w: copy_with_width(w) for w in (32, 64)}
    for width in (32, 64, 64, 32):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", roots[width]],
                       check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
