"""Entry points of the port, the counterparts of the JAX package's
`__graft_entry__.py`.

entry(device=None)      -> (fn, args): fn(*args) traces 4,096 camera rays
                           of the flagship (golden/ASCII/scene.json, the
                           140-cube scene) through trace_wavefront at one
                           light sample, on the card.
dryrun_multichip(n)     -> one sharded inverse-rendering training step over
                           n ranks, each in its own process: the tiny scene
                           replicated, the rays sharded, each rank's loss
                           backward, the gradients all-reduced
                           (parallel/sharding.py), one Adam step.

    python -m ray_tracying_tpu_torch.entry [--device cpu] [--ranks N]

runs both (the dryrun over one rank a card, or two ranks on the host).
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ray_tracying_tpu_torch.models.zoo import bvh_stress
from ray_tracying_tpu_torch.render.camera import pixel_rays
from ray_tracying_tpu_torch.render.integrator import trace_wavefront

ENTRY_RAYS = 4096
DRYRUN_PATHS = ("materials.diffuse", "lights.intensity", "camera.location")
DRYRUN_SPP = 2  # two samples a pixel: the "sp" axis has work to split
DRYRUN_TARGET = 0.3
DRYRUN_LR = 1e-2


def _forward(scene, origins, directions, times, generator):
    return trace_wavefront(scene, origins, directions, times, 1, generator=generator,
                           device=scene.device)


def entry(device=None):
    """(fn, args) of the forward step: fn(*args) is the (4096, 3) radiance
    of rays spread along the flagship's image diagonal.  device: None =
    "cuda" (raises without a card)."""
    dev = torch.device("cuda" if device is None else device)
    scene = bvh_stress(device=dev)
    width, height = scene.camera.resolution
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    xs = torch.linspace(0.5, width - 0.5, ENTRY_RAYS, device=dev)
    ys = torch.linspace(0.5, height - 0.5, ENTRY_RAYS, device=dev)
    o, d = pixel_rays(scene.camera, xs, ys, generator=gen)
    return _forward, (scene, o, d, torch.zeros(ENTRY_RAYS, device=dev), gen)


def _tiny_scene_dict(width: int = 32, height: int = 16) -> dict:
    """The dryrun's scene (the JAX package's `_tiny_scene`): a reflective
    sphere, a cube and a floor under one point light."""
    return {
        "cameras": [{
            "location": [0.0, -4.0, 1.5], "gaze_vector": [0.0, 0.94, -0.34],
            "up_vector": [0.0, 0.34, 0.94], "focal_length": 20.0,
            "sensor_width": 36, "sensor_height": 24,
        }],
        "render": {"resolution_x": width, "resolution_y": height},
        "lights": [{"location": [2.0, -2.0, 3.0], "color": [1, 1, 1],
                    "intensity": 500.0, "radius": 0.0}],
        "spheres": [{"location": [-0.8, 0.5, 0.2], "radius": 0.5,
                     "material": {"diffuse_color": [0.8, 0.3, 0.2], "reflectivity": 0.3}}],
        "cubes": [{"translation": [0.8, 0.8, 0.0], "rotation": [0.3, 0.5, 0.1],
                   "scale": [0.4, 0.4, 0.4],
                   "material": {"diffuse_color": [0.2, 0.5, 0.9]}}],
        "rectangles": [{"translation": [0, 1, -0.5], "rotation": [0, 0, 0],
                        "scale": [8, 8, 1],
                        "material": {"diffuse_color": [0.7, 0.7, 0.7]}}],
    }


def _dryrun_rank(rank: int, world_size: int, init_method: str, device: str,
                 backend: Optional[str], threads: int):
    """One rank of dryrun_multichip; returns (loss, updated theta as numpy)
    (module docstring)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ray_tracying_tpu_torch.diff import params as P
    from ray_tracying_tpu_torch.parallel import cluster
    from ray_tracying_tpu_torch.parallel.sharding import (
        all_reduce_grads,
        make_mesh,
        mesh_device_type,
        trace_wavefront_sharded,
    )
    from ray_tracying_tpu_torch.scene.loader import load_scene_dict

    torch.set_num_threads(threads)
    cluster.initialize(init_method, world_size, rank, backend=backend, device=device,
                       retries=3, backoff_s=0.5)
    dev = torch.device("cpu") if device == "cpu" else torch.device(
        "cuda", torch.cuda.current_device())
    if world_size >= 4 and world_size % 2 == 0:
        mesh = init_device_mesh(mesh_device_type(), (world_size // 2, 2),
                                mesh_dim_names=("dp", "sp"))
    else:
        mesh = make_mesh(world_size, axis="dp")

    scene = load_scene_dict(_tiny_scene_dict(), device=dev)
    width, height = scene.camera.resolution
    n_rays = width * height * DRYRUN_SPP
    pix = torch.arange(width * height, device=dev)
    xs = (pix % width + 0.5).to(torch.float32).repeat(DRYRUN_SPP)
    ys = (pix // width + 0.5).to(torch.float32).repeat(DRYRUN_SPP)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    o, d = pixel_rays(scene.camera, xs, ys, generator=gen)
    times = torch.zeros(n_rays, device=dev)

    theta = P.extract(scene, DRYRUN_PATHS)
    opt = torch.optim.Adam(list(theta.values()), lr=DRYRUN_LR)
    colors = trace_wavefront_sharded(P.apply(scene, theta), o, d, times, 1, mesh, seed=0,
                                     differentiable=True, gather=False, device=dev)
    share = torch.sum((colors - DRYRUN_TARGET) ** 2)
    (share / n_rays).backward()
    all_reduce_grads(theta, mesh)
    opt.step()
    loss = share.detach().clone()
    dist.all_reduce(loss)
    loss = float(loss) / n_rays
    if rank == 0:
        shape = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        print(f"dryrun_multichip: mesh={shape} loss={loss:.6f} ok", flush=True)
    return loss, {k: v.detach().cpu().numpy() for k, v in theta.items()}


def dryrun_multichip(
    n_devices: int, device=None, backend: Optional[str] = None, timeout_s: float = 300.0,
) -> Tuple[float, Dict[str, np.ndarray]]:
    """One sharded training step over n_devices ranks, each a spawned
    process on a free port of 127.0.0.1: the JAX package's dryrun in
    PyTorch.  Mesh ("dp", "sp") = (n / 2, 2) when n >= 4 and even, else
    ("dp",); the rays (32x16 pixels at 2 spp) shard over every axis.  theta
    is materials.diffuse, lights.intensity and camera.location (the rays
    are made before theta is applied, as in the JAX dryrun, so the camera's
    gradient is zero); each rank's loss is sum((c - 0.3)^2), the total that
    sum over ranks / n_rays; torch.optim.Adam at 1e-2.  Rank 0 prints the
    JAX dryrun's line.  device: None = "cuda" (NCCL, one card a rank);
    "cpu" runs gloo ranks on the host.  Returns (loss, updated theta as
    numpy); raises if a rank fails or is not done in timeout_s."""
    from ray_tracying_tpu_torch.parallel import cluster

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the host")
    cluster.choose_backend(backend, dev.type, n_devices,
                           torch.cuda.device_count() if dev.type == "cuda" else 0)
    threads = max(1, torch.get_num_threads() // n_devices)
    return cluster.launch(_dryrun_rank, n_devices, (dev.type, backend, threads),
                          timeout_s=timeout_s)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ray_tracying_tpu_torch.entry",
                                 description="Run entry() and dryrun_multichip(n).")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the dryrun (default: one a card on cuda, 2 on cpu)")
    args = ap.parse_args(argv)
    fn, fn_args = entry(args.device)
    out = fn(*fn_args)
    print("entry ok:", tuple(out.shape), flush=True)
    n = args.ranks or (torch.cuda.device_count() if args.device == "cuda" else 2)
    dryrun_multichip(n, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
