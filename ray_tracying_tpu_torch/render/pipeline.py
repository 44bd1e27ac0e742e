"""Image render pipeline: tiled, device-resident end to end.

Replaces the reference's sequential per-pixel double loop
(Code/raytracer.cpp:433-476) with row-tile batches: each tile generates
rows * width * spp primary rays, traces the full wavefront on the device,
and averages samples.  Gamma (1.1) + clamp + *255.999 quantization
(Code/raytracer.cpp:446-457) are applied only at the output boundary —
everything upstream stays linear.  Tiles are written into one image
tensor on the device; one copy brings the finished image to the host.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ray_tracying_tpu_torch import spans
from ray_tracying_tpu_torch.accel.lbvh import with_bvh, with_chunks
from ray_tracying_tpu_torch.core import constants as C
from ray_tracying_tpu_torch.kernels import closest_hit as _CH
from ray_tracying_tpu_torch.kernels.wavefront import wave_refusal, wave_tables
from ray_tracying_tpu_torch.render.camera import pixel_rays
from ray_tracying_tpu_torch.render.integrator import WAVE_SHRINK_SPARSE, trace_wavefront
from ray_tracying_tpu_torch.scene.types import Camera, Scene


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Mirrors the reference CLI surface (Code/raytracer.cpp:362-390)."""

    samples_sqrt: int = 4      # -s     (n x n stratified samples per pixel)
    light_samples: int = 1     # -light_sample
    use_bvh: bool = False      # -bvh   (identical hit set either way)
    # Mirror+glass branching: capacity of the compacted ray queue as a
    # multiple of the primary ray count.
    queue_mult: int = 2
    # Rays per device pass: bounds the level tensors (13 f32 rows per ray).
    max_rays_per_pass: int = 1 << 23
    # Kill continuation rays at throughput <= this.  0.0 = exact reference
    # semantics; positive values trade bounded uint8 error for speed.
    min_throughput: float = 0.0
    # Collect per-level TraceStats summed over tiles and each tile's wall
    # seconds (render_with_stats; one synchronization a tile): render_image
    # then returns (image, stats dict).
    stats: bool = False


def tile_rays(
    camera: Camera,
    y0: int,
    rows: int,
    width: int,
    samples_sqrt: int,
    *,
    generator: Optional[torch.Generator] = None,
    jitter: Optional[torch.Tensor] = None,
    lens: Optional[torch.Tensor] = None,
    times: Optional[torch.Tensor] = None,
):
    """Primary rays of a (rows, width) tile starting at image row y0:
    (origins (N, 3), directions (N, 3), times (N,)) with N = rows * width *
    spp, pixels row-major and the samples of one pixel adjacent.

    Draws not passed in come from `generator`, on the camera's device:
    jitter (rows, width, n, n, 2) uniform sub-stratum offsets (only when
    samples_sqrt > 1), lens (N, 2) unit-disk samples, times (N,) uniform
    exposure times."""
    dev = camera.location.device
    f32 = dict(dtype=torch.float32, device=dev)
    spp = samples_sqrt * samples_sqrt if samples_sqrt > 1 else 1
    n = rows * width * spp

    ys = float(y0) + torch.arange(rows, **f32)[:, None, None]
    xs = torch.arange(width, **f32)[None, :, None]

    if samples_sqrt <= 1:
        # One ray through the pixel center (Code/raytracer.cpp:30-40).
        sub = torch.full((rows, width, 1, 2), 0.5, **f32)
    else:
        # Fresh jitter per pixel per stratum (Code/raytracer.cpp:46-66).
        if jitter is None:
            jitter = torch.rand(
                (rows, width, samples_sqrt, samples_sqrt, 2),
                generator=generator, **f32,
            )
        idx = torch.arange(samples_sqrt, **f32)
        # (n, n, 2) with [..., 0] = x stratum (inner), [..., 1] = y stratum
        strata = torch.stack(
            [
                idx[None, :].expand(samples_sqrt, samples_sqrt),
                idx[:, None].expand(samples_sqrt, samples_sqrt),
            ],
            dim=-1,
        )
        sub = (strata[None, None] + jitter) / float(samples_sqrt)
        sub = sub.reshape(rows, width, spp, 2)

    px = (xs + sub[..., 0]).reshape(-1)
    py = (ys + sub[..., 1]).reshape(-1)

    o, d = pixel_rays(camera, px, py, lens=lens, generator=generator)
    # Every primary ray gets a fresh exposure time in [0,1)
    # (Code/raytracer.cpp:37,61).
    if times is None:
        times = torch.rand((n,), generator=generator, **f32)
    return o, d, times


def tile_shrink(n_lanes: int, spp: int):
    """The fused path's queue-shrink schedule for a tile of n_lanes rays at
    spp samples a pixel, chosen as the JAX package's pipeline chooses it:
    none under 2^20 lanes (the dead levels being saved cost milliseconds,
    and the narrow stages would leave scattered live lanes little room),
    "auto" (WAVE_SHRINK_AUTO) at >= 8 samples a pixel, where each pixel's
    samples keep their liveness together, and the later, wider
    WAVE_SHRINK_SPARSE at fewer samples."""
    if n_lanes < (1 << 20):
        return ()
    return "auto" if spp >= 8 else WAVE_SHRINK_SPARSE


def _render_tile(
    scene: Scene, y0: int, rows: int, width: int, opts: RenderOptions,
    generator: torch.Generator, tables=None, differentiable: bool = False,
):
    """Render a (rows, width) tile -> ((rows, width, 3) linear radiance,
    TraceStats when opts.stats, else the count of dropped continuations
    as a 0-d tensor).  `scene` is already on its device.  differentiable:
    the tile keeps its graph to the scene's tensors, the camera's included
    (diff/render.py)."""
    spp = opts.samples_sqrt * opts.samples_sqrt if opts.samples_sqrt > 1 else 1
    with spans.span("rtt.rays"):
        o, d, times = tile_rays(
            scene.camera, y0, rows, width, opts.samples_sqrt, generator=generator
        )
    colors, aux = trace_wavefront(
        scene, o, d, times, opts.light_samples, opts.queue_mult,
        generator=generator, use_bvh=opts.use_bvh,
        min_throughput=opts.min_throughput, return_stats=opts.stats,
        return_dropped=not opts.stats, device=scene.device, tables=tables,
        differentiable=differentiable, shrink=tile_shrink(rows * width * spp, spp),
    )
    with spans.span("rtt.post"):
        return colors.reshape(rows, width, spp, 3).mean(dim=2), aux


def _render_tiles(scene, opts, generator, device, post=None, out_dtype=torch.float32):
    """Shared tile loop.  post: optional device-side postprocess applied
    per tile (e.g. uint8 quantization, so that only bytes cross to the
    host).  Returns the image as numpy, or (image, stats dict) when
    opts.stats: per-level counts summed over tiles, and each tile's wall
    seconds (the stats mode synchronizes after each tile).  A frame is the
    root span of spans.py ("rtt.frame")."""
    dev = torch.device("cuda" if device is None else device)
    width, height = scene.camera.resolution
    spp = opts.samples_sqrt * opts.samples_sqrt if opts.samples_sqrt > 1 else 1
    with spans.span("rtt.frame", rays=width * height * spp):
        with spans.span("rtt.prep"):
            # Acceleration structures are built on the host, once per
            # frame.  A scene whose table does not fit a block's shared
            # memory always gets the chunk structures, so that no path
            # falls back to a full-table sweep.
            if opts.use_bvh and scene.bvh_geoms is None:
                scene = with_bvh(scene)
            if scene.n_geoms > _CH.BRUTE_SMEM_MAX_GEOMS:
                scene = with_chunks(scene)
            scene = scene.to(dev)
            if generator is None:
                generator = torch.Generator(device=dev)
                generator.manual_seed(0)
            # The fused level's operands are packed once per frame; a scene
            # the fused gate refuses goes down the integrator's general path.
            tables = None
            if scene.n_geoms and wave_refusal(scene, opts.use_bvh, opts.light_samples) is None:
                tables = wave_tables(scene, light_samples=opts.light_samples)
        rows = max(1, min(height, opts.max_rays_per_pass // max(1, width * spp)))

        image = torch.zeros((height, width, 3), dtype=out_dtype, device=dev)
        level_acc = None
        drop_counts = []
        tile_times = []
        for y0 in range(0, height, rows):
            take = min(rows, height - y0)
            t_start = time.time()
            with spans.span("rtt.tile", lanes=take * width * spp):
                tile, aux = _render_tile(
                    scene, y0, take, width, opts, generator, tables
                )
                with spans.span("rtt.post"):
                    image[y0 : y0 + take] = tile if post is None else post(tile)
                if opts.stats:
                    with spans.read("level counts"):
                        rowsum = torch.stack(list(aux)).cpu().numpy().astype(np.int64)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                    tile_times.append({"tile": len(tile_times), "rows": take,
                                       "rays": take * width * spp,
                                       "seconds": time.time() - t_start})
                    level_acc = rowsum if level_acc is None else level_acc + rowsum
                else:
                    drop_counts.append(aux)
        with spans.read("image"):
            out = image.cpu().numpy()  # the one device -> host copy
        if not opts.stats:
            # The reference never drops rays (Code/raytracer.cpp:280-351): a
            # continuation lost to queue-shrink or compaction overflow is
            # surfaced, never silent.  The counts are read after every tile
            # is enqueued.
            with spans.read("dropped"):
                dropped = int(torch.stack(drop_counts).sum()) if drop_counts else 0
            if dropped:
                warnings.warn(
                    f"render dropped {dropped} live continuation rays to "
                    "queue-shrink or compacted-queue overflow (dimmest paths "
                    "first); use render_with_stats for per-level counts, "
                    "trace_wavefront(shrink=()) for lossless tracing, or raise "
                    "queue_mult",
                    RuntimeWarning,
                    stacklevel=3,
                )
            return out
    levels = [
        {
            "level": i,
            "live": int(level_acc[0, i]),
            "hits": int(level_acc[1, i]),
            "spawned": int(level_acc[2, i]),
            "dropped": int(level_acc[3, i]),
        }
        for i in range(level_acc.shape[1])
    ]
    return out, {"levels": levels, "tiles": tile_times,
                 "total_dropped": int(level_acc[3].sum())}


def render_image(
    scene: Scene,
    opts: Optional[RenderOptions] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> np.ndarray:
    """Render the full image -> (H, W, 3) float32 linear radiance.  With
    opts.stats, returns (image, stats dict) instead.

    device: None = "cuda" (raises without a card); "cpu" runs on the host.
    generator: a torch.Generator on that device; seeded with 0 when not
    given."""
    return _render_tiles(scene, opts or RenderOptions(), generator, device)


def render_with_stats(
    scene: Scene,
    opts: Optional[RenderOptions] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
):
    """Render with per-level instrumentation -> (linear (H, W, 3) image,
    stats dict).

    stats["levels"]: per bounce level, live/hit/spawned/dropped ray counts
    summed over tiles; stats["total_dropped"] counts continuations lost to
    queue-shrink or compacted-queue overflow; stats["tiles"]: each tile's
    index, rows, rays and wall seconds (around a synchronization of the
    device)."""
    opts = dataclasses.replace(opts or RenderOptions(), stats=True)
    return _render_tiles(scene, opts, generator, device)


def linear_to_srgb_u8(linear: torch.Tensor) -> torch.Tensor:
    """Gamma 1.1 + clamp + *255.999 quantize (Code/raytracer.cpp:446-457)."""
    corr = torch.pow(torch.clamp(linear, min=0.0), 1.0 / C.GAMMA)
    return (torch.clamp(corr, 0.0, 1.0) * C.QUANT_SCALE).to(torch.uint8)


def render_to_srgb_u8(
    scene: Scene,
    opts: Optional[RenderOptions] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> np.ndarray:
    """Render and quantize to the reference's output encoding, (H, W, 3)
    uint8.  Quantization runs on the device, so only bytes cross to the
    host.  With opts.stats, returns (image, stats dict) as
    render_with_stats does, the image the same bytes."""
    return _render_tiles(
        scene, opts or RenderOptions(), generator, device,
        post=linear_to_srgb_u8, out_dtype=torch.uint8,
    )
