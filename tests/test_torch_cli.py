"""The port's command line and render_with_stats against the JAX package's.

`python -m ray_tracying_tpu_torch.cli` takes the JAX CLI's flags, parsed by
the same rules (`parse_args` equal on the same argv lists), plus `--device`;
its PPM is the API's bytes from the same seed; `--stats` prints a JSON line
a level and a tile; render_with_stats' level counts equal the JAX
package's on a small in-slot scene.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ray_tracying_tpu_torch as rt
from ray_tracying_tpu.cli.main import parse_args as parse_jax
from ray_tracying_tpu_torch.cli import main as cli_main
from ray_tracying_tpu_torch.cli import parse_args
from ray_tracying_tpu_torch.render.pipeline import render_with_stats

from test_integrator import _mirror_glass_scene
from test_torch_integrator import mirror_glass_scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASCII = os.path.join(REPO, "golden", "ASCII")

ARGVS = [
    [],
    ["-input", "scene.json"],
    ["-bvh", "-s", "2", "-light_sample", "8", "-input", "a.json", "-output", "b.ppm"],
    ["-input", "a.json", "--scene-dir", "sd", "--output-dir", "od", "--seed", "7", "--stats"],
    ["-s"],                                # a flag without its value is ignored
    ["-input", "x.json", "-frobnicate", "3"],
    ["-output", "o.ppm", "-input", "x.json", "-bvh", "-bvh"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_parse_args_equals_the_jax_clis(argv, capsys):
    """The same dict and the same warnings for the same argv."""
    jax_opts = parse_jax(list(argv))
    jax_err = capsys.readouterr().err
    assert parse_args(list(argv)) == jax_opts
    assert capsys.readouterr().err == jax_err


def test_device_flag_is_the_ports_own():
    assert parse_args(["--device", "cpu"])["device"] == "cpu"
    assert "device" not in parse_args(["-input", "a.json"])


def test_missing_input_returns_1_with_the_jax_message(capsys):
    assert cli_main(["-s", "2"]) == 1
    out = capsys.readouterr()
    assert out.err == "Error: Please specify scene file name\n"
    assert out.out.startswith("Correct usage: python -m ray_tracying_tpu_torch.cli -input")


def test_module_entry_exits_1_without_input():
    proc = subprocess.run([sys.executable, "-m", "ray_tracying_tpu_torch.cli"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1
    assert "Please specify scene file name" in proc.stderr


def test_without_a_card_the_cli_does_not_carry_on_on_the_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["-input", os.path.join(ASCII, "det_basic.json"), "--output-dir", str(tmp_path)]
    assert cli_main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("name, flags", [("bvh_det", []), ("det_basic", ["-bvh"])])
def test_cli_writes_the_apis_bytes(name, flags, tmp_path, capsys):
    """main([... "--device", "cpu"]) at -s 1 writes the bytes of
    render_to_srgb_u8 + write_ppm from the same seed (bvh_det down the fused
    level; det_basic with -bvh down the general path's traversal)."""
    path = os.path.join(ASCII, f"{name}.json")
    assert cli_main(["-input", path, "-s", "1", "-output", "cli.ppm", "--output-dir",
                     str(tmp_path), "--seed", "5", "--device", "cpu", *flags]) == 0
    out = capsys.readouterr().out
    assert "primary Mrays/s" in out and "Image written to" in out
    img = rt.render_to_srgb_u8(
        rt.load_scene(path, device="cpu"),
        rt.RenderOptions(samples_sqrt=1, use_bvh=bool(flags)),
        torch.Generator().manual_seed(5), device="cpu")
    rt.write_ppm(str(tmp_path / "api.ppm"), img)
    assert (tmp_path / "cli.ppm").read_bytes() == (tmp_path / "api.ppm").read_bytes()


def test_cli_resolves_the_scene_and_output_dirs(tmp_path, capsys):
    """-input resolves against --scene-dir when it is not a path, -output
    goes into --output-dir."""
    assert cli_main(["-input", "det_mirrors.json", "--scene-dir", ASCII, "-s", "1",
                     "-output", "m.ppm", "--output-dir", str(tmp_path),
                     "--device", "cpu"]) == 0
    assert rt.read_ppm(str(tmp_path / "m.ppm")).shape == (56, 80, 3)


def test_stats_prints_a_line_a_level_and_a_tile(tmp_path, capsys):
    """--stats: one JSON line a bounce level (live / hits / spawned /
    dropped) and one a tile (rows, rays, seconds), then the image, the same
    bytes as without --stats."""
    path = os.path.join(ASCII, "det_basic.json")
    common = ["-input", path, "-s", "1", "--output-dir", str(tmp_path), "--device", "cpu"]
    assert cli_main(common + ["-output", "stats.ppm", "--stats"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    levels = [ln for ln in lines if "level" in ln]
    tiles = [ln for ln in lines if "tile" in ln]
    assert [ln["level"] for ln in levels] == list(range(11))
    assert set(levels[0]) == {"level", "live", "hits", "spawned", "dropped"}
    assert levels[0]["live"] == 96 * 64 and levels[0]["hits"] > 0
    assert len(tiles) == 1 and tiles[0]["rows"] == 64 and tiles[0]["rays"] == 96 * 64
    assert tiles[0]["seconds"] > 0
    assert cli_main(common + ["-output", "plain.ppm"]) == 0
    assert (tmp_path / "stats.ppm").read_bytes() == (tmp_path / "plain.ppm").read_bytes()


def test_render_with_stats_counts_equal_the_jax_packages():
    """The per-level counts of render_with_stats on the mirror + glass scene
    at 1 spp equal the JAX package's; the image is render_image's; every
    tile reports its rows, rays and seconds (two tiles here)."""
    from ray_tracying_tpu.render.pipeline import RenderOptions as OptsJax
    from ray_tracying_tpu.render.pipeline import render_with_stats as stats_jax

    _, ref = stats_jax(_mirror_glass_scene(), OptsJax(samples_sqrt=1))
    st = mirror_glass_scene()
    w, h = st.camera.resolution
    opts = rt.RenderOptions(samples_sqrt=1, max_rays_per_pass=w * (h // 2 + 1))
    img, stats = render_with_stats(st, opts, device="cpu")
    assert stats["levels"] == ref["levels"]
    assert stats["total_dropped"] == ref["total_dropped"] == 0
    assert [t["tile"] for t in stats["tiles"]] == [0, 1]
    assert sum(t["rays"] for t in stats["tiles"]) == w * h
    assert sum(t["rows"] for t in stats["tiles"]) == h
    assert all(t["seconds"] > 0 for t in stats["tiles"])
    np.testing.assert_array_equal(img, rt.render_image(st, opts, device="cpu"))
    img2, stats2 = rt.render_image(st, rt.RenderOptions(samples_sqrt=1, stats=True),
                                   device="cpu")
    assert stats2["levels"] == stats["levels"] and len(stats2["tiles"]) == 1
    assert rt.render_with_stats is render_with_stats
