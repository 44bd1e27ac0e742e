"""Multi-device rendering of the port (parallel/, entry.py) against the
port's one-process trace and the JAX package's sharded trace, on the CPU.

Two gloo ranks, spawned by `cluster.launch` (each launch bounded by its
timeout), trace their shares of a batch; the gathered radiance must be
`torch.equal` to one process on a deterministic scene and, with the draws
fed in, on a glossy one with the queue shrink on and off.  The JAX side
runs its sharded trace on `make_mesh(2)` of the 8 virtual CPU devices:
the forward with its Pallas kernel in interpret mode (as the other
test_torch_* files run JAX's trace) at rtol 2e-5 / atol 2e-6; the gradient
as tests/test_sharding.py takes it.  Gradients are summed in the backend's
order on top of each rank's own, so they are compared at a tolerance:
rtol 1e-5 against one process (tests/test_sharding.py's bar), rtol 2e-4 /
atol 2e-4 * max|g| against JAX (tests/test_torch_diff.py's).
"""

import importlib.util
import os
import socket

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from ray_tracying_tpu.diff import params as P_jax
from ray_tracying_tpu.parallel import sharding as S_jax
from ray_tracying_tpu.render.camera import pixel_rays as pixel_rays_jax
from ray_tracying_tpu.render.intersect import pallas_disabled
from ray_tracying_tpu_torch import entry as E
from ray_tracying_tpu_torch.diff import params as P
from ray_tracying_tpu_torch.parallel import cluster
from ray_tracying_tpu_torch.render import integrator as G
from ray_tracying_tpu_torch.render.integrator import trace_wavefront

import torch_parallel_worker
from test_diff import tiny_scene
from test_sharding import make_rays
from test_torch_diff import assert_grads_close, carried
from test_torch_wavefront import ATOL, RTOL, interpret
from test_wavefront import clustered_rays, wave_scene

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 240
GLOSSY_LANES = 8192  # two ranks of 4,096: the shrink narrows a rank to 2,048
SHRINKS = {"off": (), "auto": "auto", "level1": ((1, 2),)}


def numpy_rays(o, d, t):
    return tuple(torch.from_numpy(np.array(x, np.float32)) for x in (o, d, t))


def glossy_case():
    """wave_scene with glossy surfaces; each rank's 4,096 lanes have 1,024
    rays at the mirror sphere and 3,072 that miss; numpy unit-ball fuzz
    for 11 levels."""
    sj = wave_scene(roughness=0.05)
    half = GLOSSY_LANES // 2
    parts = [np.concatenate([np.asarray(x) for x in xs])
             for xs in zip(clustered_rays(n=half, n_live=1024, seed=31),
                           clustered_rays(n=half, n_live=1024, seed=32))]
    rng = np.random.default_rng(5)
    fuzz = []
    for _ in range(11):
        v = rng.normal(size=(3, GLOSSY_LANES))
        v *= rng.uniform(size=GLOSSY_LANES) ** (1 / 3) / np.linalg.norm(v, axis=0)
        fuzz.append(torch.from_numpy(v.astype(np.float32)))
    return carried(sj), numpy_rays(*parts), fuzz


@pytest.fixture(scope="module")
def two_ranks():
    """Everything the two ranks compute, in one launch: (a) the
    deterministic tiny scene, 512 rays; (b) the glossy case under each of
    SHRINKS; (c) the all-reduced gradient of sum(c^2) on 256 rays with
    respect to lights.intensity.  Returns (inputs, per-rank results)."""
    det_scene = carried(tiny_scene())
    det_rays = numpy_rays(*make_rays(512))
    grad_rays = numpy_rays(*make_rays(256))
    g_scene, g_rays, fuzz = glossy_case()
    jobs = {"det": dict(kind="trace", scene=det_scene, o=det_rays[0], d=det_rays[1],
                        t=det_rays[2])}
    for name, shrink in SHRINKS.items():
        jobs[f"glossy_{name}"] = dict(kind="trace", scene=g_scene, o=g_rays[0], d=g_rays[1],
                                      t=g_rays[2], kw=dict(fuzz=fuzz, shrink=shrink))
    jobs["grad"] = dict(kind="grad", scene=det_scene, o=grad_rays[0], d=grad_rays[1],
                        t=grad_rays[2], path="lights.intensity")
    results = cluster.launch(torch_parallel_worker.run_jobs, 2, (jobs,),
                             timeout_s=LAUNCH_TIMEOUT_S)
    inputs = dict(det_scene=det_scene, det_rays=det_rays, grad_rays=grad_rays,
                  glossy=(g_scene, g_rays, fuzz))
    return inputs, results


def both_ranks(results, name):
    """The result of job `name`, which every rank must hold bit for bit."""
    a, b = (r[name] for r in results)
    assert a.tobytes() == b.tobytes(), name
    return torch.from_numpy(a)


def test_sharded_trace_matches_one_process_and_jax(two_ranks):
    """(a) The deterministic tiny scene (point light, roughness 0), 512
    rays over two ranks: the gathered radiance is torch.equal to the
    port's one-process trace, and matches JAX's trace_wavefront_sharded on
    make_mesh(2) at RTOL / ATOL."""
    inputs, results = two_ranks
    got = both_ranks(results, "det")
    ref = trace_wavefront(inputs["det_scene"], *inputs["det_rays"], 1, device="cpu")
    assert got.shape == (512, 3)
    assert torch.equal(got, ref)
    assert (ref - 0.1).abs().max() > 1e-3  # the scene is hit
    o, d, t = make_rays(512)
    with interpret():
        jx = S_jax.trace_wavefront_sharded(tiny_scene(), o, d, t, jax.random.key(0), 1,
                                           S_jax.make_mesh(2))
    np.testing.assert_allclose(got.numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shrink", sorted(SHRINKS))
def test_sharded_glossy_fed_draws_equal_one_process(two_ranks, shrink):
    """(b) A glossy scene with its fuzz fed in from a seed: each rank
    takes its lanes' columns of the full-width draws, so the gathered
    radiance is torch.equal to the one-process trace without shrink, with
    each rank's shrink on ("auto", and a stage from level 1: the rank
    plans from its own 4,096 lanes) and off."""
    inputs, results = two_ranks
    scene, rays, fuzz = inputs["glossy"]
    ref = trace_wavefront(scene, *rays, 1, fuzz=fuzz, shrink=(), device="cpu")
    assert torch.equal(both_ranks(results, f"glossy_{shrink}"), ref)
    bounds, widths = G.shrink_plan(GLOSSY_LANES // 2, 11, SHRINKS[shrink])
    assert (len(widths) > 1) == (shrink != "off")
    assert min(widths) == (GLOSSY_LANES // 2 if shrink == "off" else 2048)


def test_all_reduced_gradient_matches_one_process_and_jax_psum(two_ranks):
    """(c) d sum(c^2) / d lights.intensity, each rank backward over its
    share and `all_reduce_grads`: the one-process gradient at rtol 1e-5,
    JAX's psum gradient (tests/test_sharding.py's loss) at rtol 2e-4 /
    atol 2e-4 * max|g|."""
    inputs, results = two_ranks
    got = both_ranks(results, "grad").numpy()
    theta = P.extract(inputs["det_scene"], ["lights.intensity"])
    c = trace_wavefront(P.apply(inputs["det_scene"], theta), *inputs["grad_rays"], 1,
                        device="cpu", differentiable=True)
    torch.sum(c ** 2).backward()
    ref = theta["lights.intensity"].grad.numpy()
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-5)

    sj = tiny_scene()
    o, d, t = make_rays(256)
    mesh = S_jax.make_mesh(2)

    def loss_sharded(intensity):
        sc = sj.replace(lights=sj.lights.replace(intensity=intensity))
        return jnp.sum(S_jax.trace_wavefront_sharded(sc, o, d, t, jax.random.key(0), 1,
                                                     mesh) ** 2)

    assert_grads_close(got, jax.grad(loss_sharded)(sj.lights.intensity))


def test_local_ray_slice_tiles_the_batch():
    """(d) The ranks' slices are equal, contiguous and cover the batch; a
    batch that does not split raises."""
    for world in (1, 2, 3, 4):
        n = 12 * world
        slices = [cluster.local_ray_slice(n, rank=r, world_size=world) for r in range(world)]
        covered = np.concatenate([np.arange(n)[s] for s in slices])
        np.testing.assert_array_equal(covered, np.arange(n))
        assert {s.stop - s.start for s in slices} == {12}
    with pytest.raises(ValueError):
        cluster.local_ray_slice(10, rank=0, world_size=4)


def test_initialize_retries_a_refused_address_then_raises():
    """(d) A rank whose store never answers retries with backoff, then
    raises RuntimeError chained to the last error; it leaves no group."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]  # closed again before the ranks try it
    with pytest.raises(RuntimeError, match="after 2 attempts") as err:
        cluster.initialize(f"tcp://127.0.0.1:{port}", world_size=2, rank=1, device="cpu",
                           retries=2, backoff_s=0.01, timeout_s=1)
    assert isinstance(err.value.__cause__, RuntimeError)
    assert not torch.distributed.is_initialized()


def test_backend_choice_is_explicit():
    """(d) None is NCCL on cuda and gloo on cpu; NCCL with more ranks than
    cards, or on the CPU, raises and says why; gloo may share a card; the
    entry points want a card unless told the CPU."""
    assert cluster.choose_backend(None, "cuda", 1, 1) == "nccl"
    assert cluster.choose_backend(None, "cpu", 4, 0) == "gloo"
    assert cluster.choose_backend("gloo", "cuda", 2, 1) == "gloo"
    with pytest.raises(ValueError, match="one card a rank"):
        cluster.choose_backend(None, "cuda", 2, 1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        cluster.choose_backend("nccl", "cpu", 1, 0)
    with pytest.raises(ValueError, match="one card a rank"):
        cluster.choose_backend("nccl", "cuda", 2, 0)
    with pytest.raises(ValueError, match="backend must be"):
        cluster.choose_backend("mpi", "cpu", 1, 0)
    if not torch.cuda.is_available():  # the default device is cuda
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cluster.initialize("tcp://127.0.0.1:1", 1, 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            E.dryrun_multichip(1)


def test_host_layout_by_hand_and_from_torchrun(monkeypatch):
    """(d) Ranks started by hand, one a card on each of several hosts, take
    card rank % cards and leave the host's ranks unknown, so NCCL is not
    refused; torchrun's LOCAL_RANK / LOCAL_WORLD_SIZE place the rank, and
    more ranks on a host than its cards raise before the init."""
    for name in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert cluster.host_layout(rank=1, n_cards=1) == (0, None)
    assert cluster.host_layout(rank=13, n_cards=8) == (5, None)
    assert cluster.choose_backend(None, "cuda", None, 1) == "nccl"
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert cluster.host_layout(rank=3, n_cards=1) == (1, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks on this host, 1 card"):
        cluster.initialize("tcp://127.0.0.1:1", world_size=4, rank=3)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("case", ["raises", "outlives"])
def test_launch_fails_on_a_failing_or_hanging_rank(case):
    """(d) launch raises, naming the rank, when a rank raises; and raises
    RuntimeError when a rank is still running at timeout_s; no child is
    left running either way."""
    import multiprocessing

    if case == "raises":
        with pytest.raises(Exception, match="rank 1 fails"):
            cluster.launch(torch_parallel_worker.fail_or_sleep, 2, ("raise",),
                           timeout_s=LAUNCH_TIMEOUT_S)
    else:
        with pytest.raises(RuntimeError, match="still running after 2"):
            cluster.launch(torch_parallel_worker.fail_or_sleep, 2, ("sleep",), timeout_s=2)
    assert not multiprocessing.active_children()


def test_entry_runs():
    """(e) entry(device="cpu") gives (fn, args) whose call traces 4,096
    flagship rays to finite radiance."""
    fn, args = E.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (E.ENTRY_RAYS, 3)
    assert torch.isfinite(out).all() and out.max() > out.min()


def _graft():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_dryrun_step(n):
    """The JAX package's dryrun step (__graft_entry__.py::dryrun_multichip)
    on n virtual CPU devices, written out to return (loss, theta): the
    same mesh, scene, rays, loss and optax.adam(1e-2) update."""
    from jax.sharding import Mesh, PartitionSpec as PS

    from ray_tracying_tpu.render.integrator import trace_wavefront as trace_jax

    devices = jax.devices("cpu")[:n]
    if n >= 4 and n % 2 == 0:
        mesh = Mesh(np.array(devices).reshape(n // 2, 2), ("dp", "sp"))
    else:
        mesh = Mesh(np.array(devices), ("dp",))
    axes = tuple(mesh.axis_names)
    scene = _graft()._tiny_scene()
    width, height = scene.camera.resolution
    n_rays = width * height * E.DRYRUN_SPP
    key = jax.random.key(0)
    xs = jnp.tile((jnp.arange(width * height) % width + 0.5).astype(jnp.float32), E.DRYRUN_SPP)
    ys = jnp.tile((jnp.arange(width * height) // width + 0.5).astype(jnp.float32),
                  E.DRYRUN_SPP)
    o, d = pixel_rays_jax(scene.camera, xs, ys, key)
    times = jnp.zeros(n_rays)
    theta = P_jax.extract(scene, list(E.DRYRUN_PATHS))
    opt = optax.adam(E.DRYRUN_LR)

    def loss_fn(theta):
        sc = P_jax.apply(scene, theta)

        def body(sc_rep, o_s, d_s, t_s):
            k = jax.random.fold_in(key, jax.lax.axis_index(axes))
            c = trace_jax(sc_rep, o_s, d_s, t_s, k, 1)
            return jnp.sum((c - E.DRYRUN_TARGET) ** 2)[None]

        per_shard = S_jax.shard_map_compat(
            body, mesh=mesh, in_specs=(PS(), PS(axes), PS(axes), PS(axes)),
            out_specs=PS(axes))(sc, o, d, times)
        return jnp.sum(per_shard) / n_rays

    with pallas_disabled(), mesh:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(theta)
        updates, _ = opt.update(grads, opt.init(theta))
        theta = optax.apply_updates(theta, updates)
    return float(loss), {k: np.asarray(v) for k, v in theta.items()}


@pytest.mark.parametrize("n,mesh", [(2, "{'dp': 2}"), (4, "{'dp': 2, 'sp': 2}")])
def test_dryrun_multichip_matches_the_jax_step(capfd, n, mesh):
    """(e) dryrun_multichip(n, device="cpu") over n gloo ranks (the
    ("dp", "sp") mesh at 4) prints the JAX dryrun's line, and its loss and
    updated theta match the JAX step at rtol 1e-4 (the Adam-against-optax
    bar of tests/test_torch_diff.py)."""
    loss, theta = E.dryrun_multichip(n, device="cpu")
    assert f"dryrun_multichip: mesh={mesh} loss={loss:.6f} ok" in capfd.readouterr().out
    ref_loss, ref_theta = jax_dryrun_step(n)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    assert set(theta) == set(E.DRYRUN_PATHS)
    for k in E.DRYRUN_PATHS:
        np.testing.assert_allclose(theta[k], ref_theta[k], rtol=1e-4, err_msg=k)
    # the step moved the albedo and the light; the camera has no gradient
    scene = carried(_graft()._tiny_scene())
    assert not np.allclose(theta["materials.diffuse"], scene.materials.diffuse.numpy())
    np.testing.assert_array_equal(theta["camera.location"], scene.camera.location.numpy())


def test_module_runs_entry_and_dryrun():
    """(e) `python -m ray_tracying_tpu_torch.entry --device cpu --ranks 2`
    runs both entry points, as __graft_entry__.py's __main__ does."""
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "ray_tracying_tpu_torch.entry", "--device", "cpu",
         "--ranks", "2"], cwd=REPO, capture_output=True, text=True, timeout=LAUNCH_TIMEOUT_S,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert f"entry ok: ({E.ENTRY_RAYS}, 3)" in proc.stdout
    assert "dryrun_multichip: mesh={'dp': 2} loss=" in proc.stdout
