"""What a run may load: no module of the benchmark imports JAX or the JAX
package (top-level names compared whole, since the port's name begins with
the JAX package's), the reference imports nothing of the port, and a run
without a card, or without the program, prints no result."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from yardstick import guard, manifest

SOURCES = sorted(
    os.path.join(root, f)
    for root, _, files in os.walk(manifest.BENCH_DIR)
    for f in files if f.endswith(".py"))


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, manifest.BENCH_DIR))
def test_no_jax(path):
    assert not set(_imports(path)) & set(guard.FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in SOURCES if f"{os.sep}reference{os.sep}" in p],
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_port(path):
    assert set(_imports(path)) <= {"__future__", "math", "os", "typing", "numpy", "torch"}


def test_guard_compares_top_level_names_whole():
    mods = ["ray_tracying_tpu_torch", "ray_tracying_tpu_torch.render", "jaxtyping", "jax.numpy",
            "ray_tracying_tpu", "flax", "numpy"]
    assert guard.loaded_forbidden(mods) == ["flax", "jax.numpy", "ray_tracying_tpu"]


def _run(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "flagship-frames", "--seed", "3000000019",
         "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    out = _run(manifest.ROOT)
    assert out.returncode != 0 and "CUDA" in out.stderr and not out.stdout.strip()


def test_benchmark_alone_prints_no_result(tmp_path):
    """Past the look for a card (device="cpu"), a checkout of the benchmark
    without the program fails when it loads the program."""
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, 'portbench'); import run; "
            "run.main(['--workload', 'flagship-bvh-frames', '--seed', '5', '--seconds', '1'], device='cpu')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and "ray_tracying_tpu_torch" in out.stderr and not out.stdout.strip()
