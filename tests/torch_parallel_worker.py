"""Rank function for tests/test_torch_parallel.py: two gloo ranks on the
host run the port's sharded trace and sharded gradient on the jobs the
test passes in (scenes and rays made by the test), and return numpy
arrays.  Imports torch and the port only, so that a spawned rank starts
fast."""

import time

import torch

from ray_tracying_tpu_torch.diff import params as P
from ray_tracying_tpu_torch.parallel import cluster
from ray_tracying_tpu_torch.parallel.sharding import (
    all_reduce_grads,
    make_mesh,
    trace_wavefront_sharded,
)


def run_jobs(rank, world_size, init_method, jobs):
    """jobs: {name: dict(kind="trace" | "grad", scene, o, d, t, kw, path)}.
    trace: the gathered radiance of trace_wavefront_sharded(**kw); grad:
    the all-reduced gradient of sum(c^2) over the rank's share with
    respect to `path`."""
    torch.set_num_threads(1)
    cluster.initialize(init_method, world_size, rank, device="cpu", retries=3,
                       backoff_s=0.5, timeout_s=60)
    mesh = make_mesh()
    out = {}
    for name, job in jobs.items():
        rays = (job["o"], job["d"], job["t"])
        if job["kind"] == "trace":
            rad = trace_wavefront_sharded(job["scene"], *rays, 1, mesh, device="cpu",
                                          **job.get("kw", {}))
            out[name] = rad.numpy()
        else:
            theta = P.extract(job["scene"], [job["path"]])
            c = trace_wavefront_sharded(P.apply(job["scene"], theta), *rays, 1, mesh,
                                        device="cpu", differentiable=True, gather=False)
            torch.sum(c ** 2).backward()
            all_reduce_grads(theta, mesh)
            out[name] = theta[job["path"]].grad.numpy()
    return out


def fail_or_sleep(rank, world_size, init_method, how):
    """Rank 1 raises (how="raise") or outsleeps its launch ("sleep");
    rank 0 returns at once."""
    if rank == 1 and how == "raise":
        raise ValueError("rank 1 fails")
    if rank == 1:
        time.sleep(600)
    return rank
