"""Multi-device rendering: rays data-parallel over the ranks of a mesh.

The rays of a batch shard over every axis of the mesh (each rank traces
its equal, contiguous share, `cluster.local_ray_slice`), the scene is
replicated (each rank holds its own copy), and nothing crosses between
ranks while tracing: each rank's fused trace, its queue shrink and the
shrink's host read of the live count stay on that rank.  Collectives
appear only at the boundaries:

  - forward: an all-gather of the radiance (`gather=True`), NCCL on the
    device, or through the host where gloo holds CUDA tensors (gloo
    gathers CPU tensors only);
  - backward: the gradients of the replicated scene parameters are summed
    over the ranks (`all_reduce_grads`), the port's form of the JAX
    package's transpose-psum.  A differentiable caller takes its own
    slice (`gather=False`), computes its share of the loss, runs backward,
    then calls `all_reduce_grads`: the summed gradient is the one-process
    gradient of the whole batch (to float tolerance: the ranks' partial
    sums are added in the backend's order).

Each rank seeds its generator with `fold_in(seed, rank)`, the counterpart
of the JAX package's `fold_in(key, axis_index)`; draws passed in as
full-width tensors are sliced to the rank's lanes, so a sharded trace fed
its draws is the one-process trace bit for bit.

Port of the JAX package's parallel/sharding.py.  Its `shard_map_compat`
has no counterpart: it only bridged a keyword rename of jax.shard_map.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ray_tracying_tpu_torch.diff.render import fold_in
from ray_tracying_tpu_torch.parallel.cluster import local_ray_slice
from ray_tracying_tpu_torch.render.integrator import trace_wavefront
from ray_tracying_tpu_torch.scene.types import Scene


def make_mesh(n_devices: Optional[int] = None, axis: str = "rays") -> DeviceMesh:
    """A 1-D mesh named `axis` over the ranks of the process group (which
    must be up: cluster.initialize): device type cuda under NCCL, cpu under
    gloo (whose collectives go through the host).  n_devices: None = every
    rank; another count raises."""
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"the mesh spans every rank: {n_devices} asked, {world} in the group")
    return init_device_mesh(mesh_device_type(), (world,), mesh_dim_names=(axis,))


def mesh_device_type() -> str:
    """The device type of a mesh over the group: cuda under NCCL, cpu
    under gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _check_mesh(mesh: Optional[DeviceMesh]) -> None:
    """The shard of a rank is its rank: the mesh must hold every rank of
    the group in rank order, over any number of axes (init_device_mesh
    lays them out so)."""
    if mesh is None:
        return
    ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        raise ValueError(f"the mesh must hold ranks 0..{dist.get_world_size() - 1} in order, "
                         f"not {ranks}")


def _slice_draws(fuzz, light_jitter, r: int, sl: slice):
    """Full-width draws cut to the lanes `sl` (fuzz: (3, r) a level;
    light_jitter: (r, nss, 3) a level and light)."""
    if fuzz is not None:
        if any(f.shape[1] != r for f in fuzz):
            raise ValueError(
                f"sharded fuzz must be (3, {r}) a level: the draws of a compacted "
                "(two-way) queue do not split by lane")
        fuzz = [f[:, sl].contiguous() for f in fuzz]
    if light_jitter is not None:
        light_jitter = [[None if j is None else j[sl].contiguous() for j in lv]
                        for lv in light_jitter]
    return fuzz, light_jitter


def _all_gather_rays(local: torch.Tensor, n_rays: int) -> torch.Tensor:
    """The (n_rays, ...) batch from every rank's contiguous share `local`,
    on every rank, on local's device.  NCCL gathers on the device; gloo
    gathers CPU tensors only, so CUDA tensors go through the host."""
    world = dist.get_world_size()
    if local.shape[0] * world != n_rays:
        raise ValueError(f"{world} shares of {local.shape[0]} rays are not {n_rays}")
    local = local.contiguous()
    if dist.get_backend() == "nccl":
        out = torch.empty((n_rays,) + tuple(local.shape[1:]), dtype=local.dtype,
                          device=local.device)
        dist.all_gather_into_tensor(out, local)
        return out
    host = local.cpu()
    parts = [torch.empty_like(host) for _ in range(world)]
    dist.all_gather(parts, host)
    return torch.cat(parts).to(local.device)


def trace_wavefront_sharded(
    scene: Scene,
    origins: torch.Tensor,     # (R, 3), R divisible by the mesh size
    directions: torch.Tensor,  # (R, 3)
    times: torch.Tensor,       # (R,)
    light_samples: int,
    mesh: Optional[DeviceMesh] = None,
    queue_mult: int = 2,
    *,
    seed: int = 0,
    fuzz: Optional[Sequence[torch.Tensor]] = None,
    light_jitter: Optional[Sequence[Sequence[Optional[torch.Tensor]]]] = None,
    use_bvh: bool = False,
    differentiable: bool = False,
    fused: Optional[bool] = None,
    device=None,
    gather: bool = True,
    shrink="auto",
) -> torch.Tensor:
    """Trace this rank's share of R rays (module docstring); every rank
    passes the same full batch.  Returns the (R, 3) radiance on every rank
    with gather=True, else this rank's (R / ranks, 3) share at
    `local_ray_slice(R)`.

    mesh: None = every rank of the group (make_mesh); any mesh over every
    rank in order (the dryrun's ("dp", "sp")): the rays shard over all its
    axes.  seed: the rank's generator is seeded with fold_in(seed, rank),
    for what is not passed in; fuzz / light_jitter: trace_wavefront's
    full-width draws, sliced here.  shrink: the rank's fused trace plans
    its queue shrink from its own width.  differentiable: the share keeps
    its graph; it takes gather=False (the gradient of a gathered batch
    would need a collective in autograd; sum the gradients instead, with
    all_reduce_grads).  device: None = "cuda"."""
    if differentiable and gather:
        raise ValueError("a differentiable sharded trace takes gather=False, then "
                         "all_reduce_grads after backward")
    _check_mesh(mesh)
    r = origins.shape[0]
    sl = local_ray_slice(r)
    dev = torch.device("cuda" if device is None else device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(fold_in(seed, dist.get_rank()))
    fz, lj = _slice_draws(fuzz, light_jitter, r, sl)
    local = trace_wavefront(
        scene, origins[sl], directions[sl], times[sl], light_samples, queue_mult,
        generator=gen, fuzz=fz, light_jitter=lj, use_bvh=use_bvh,
        differentiable=differentiable, fused=fused, device=dev, shrink=shrink,
    )
    return _all_gather_rays(local, r) if gather else local


def all_reduce_grads(
    params: Union[Mapping[str, torch.Tensor], Iterable[torch.Tensor]],
    mesh: Optional[DeviceMesh] = None,
) -> None:
    """Sum the .grad of the replicated parameters over every rank, in
    place, in one collective (a parameter without a gradient on this rank
    counts as zeros, so every rank reduces the same buffer).  After it each
    rank holds the gradient of the whole batch's loss."""
    _check_mesh(mesh)
    leaves = list(params.values()) if isinstance(params, Mapping) else list(params)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    dist.all_reduce(flat)
    for p, g in zip(leaves, flat.split([g.numel() for g in grads])):
        p.grad = g.view(p.shape).to(p.dtype)
