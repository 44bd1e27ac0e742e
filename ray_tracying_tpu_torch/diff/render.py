"""Differentiable rendering: pixel gradients back to Scene tensors.

`render_linear` renders the whole image as one tile of the pipeline with
`differentiable=True`, so that autograd flows pixel gradients back to any
tensor of the Scene.  Hit decisions (which geom, shadow visibility) are
piecewise constant and carry no gradient; everything downstream of a fixed
hit (shading, attenuation, throughput weights, camera and lens geometry)
is smooth (the "closest-hit re-use" scope).  The fused level path runs its
kernel in record mode and replays the level backward
(kernels/wavefront.py::WaveLevelFn); the general path differentiates pass
2 and shading around the discrete kernels.

`mse_loss_and_grad_tiled` accumulates gradients over row tiles bounded by
`opts.max_rays_per_pass`, the differentiable mirror of the pipeline's
tiling: autograd then holds one tile's residuals at a time, not the whole
frame's.  Each tile's term is rendered and differentiated on its own with
a generator seeded from (seed, tile index), and the gradients add up on
the device.

Randomness: `seed` seeds a torch.Generator on the render device (a tile's
seed is `fold_in(seed, tile)`); deterministic scenes do not depend on it.

Port of the JAX package's diff/render.py.
"""

from __future__ import annotations

import warnings
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ray_tracying_tpu_torch import spans
from ray_tracying_tpu_torch.diff import params as P
from ray_tracying_tpu_torch.render.pipeline import RenderOptions, _render_tile
from ray_tracying_tpu_torch.scene.types import Scene


def fold_in(seed: int, i: int) -> int:
    """A seed derived from (seed, i), as jax.random.fold_in derives a key:
    different i give independent streams."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0])


def _generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _warn_dropped(counts) -> None:
    """The reference never drops rays: a continuation lost to the fused
    path's queue shrink or a compacted queue's overflow is surfaced (one
    host read, after all is enqueued; the JAX package's differentiable
    render discards this count)."""
    with spans.read("dropped"):
        dropped = int(torch.stack(counts).sum()) if counts else 0
    if dropped:
        warnings.warn(
            f"differentiable render dropped {dropped} live continuation rays "
            "to queue-shrink or compacted-queue overflow; render smaller "
            "tiles (RenderOptions.max_rays_per_pass) or raise queue_mult",
            RuntimeWarning,
            stacklevel=3,
        )


def render_linear(
    scene: Scene,
    seed: int = 0,
    opts: Optional[RenderOptions] = None,
    device=None,
) -> torch.Tensor:
    """Render the full image in one differentiable call -> (H, W, 3) linear
    f32 on the device, with its graph to the scene's tensors.  device: None
    = "cuda"."""
    opts = opts or RenderOptions()
    dev = torch.device("cuda" if device is None else device)
    sc = scene.to(dev)
    width, height = sc.camera.resolution
    tile, dropped = _render_tile(
        sc, 0, height, width, opts, _generator(dev, seed), differentiable=True
    )
    _warn_dropped([dropped])
    return tile


def mse_loss(
    scene: Scene,
    target_linear: torch.Tensor,
    seed: int = 0,
    opts: Optional[RenderOptions] = None,
    device=None,
) -> torch.Tensor:
    """Mean squared error of the whole-frame render against the target, a
    0-d tensor with its graph."""
    img = render_linear(scene, seed, opts, device)
    return torch.mean((img - target_linear.to(img.device)) ** 2)


def _tiles(scene: Scene, opts: RenderOptions):
    """(rows a tile, [(tile index, start, offset, take)]): the last tile
    clamps its start to height - rows and masks the rows it renders again."""
    width, height = scene.camera.resolution
    spp = opts.samples_sqrt ** 2 if opts.samples_sqrt > 1 else 1
    rows = max(1, min(height, opts.max_rays_per_pass // max(1, width * spp)))
    out = []
    y0 = 0
    while y0 < height:
        take = min(rows, height - y0)
        start = min(y0, height - rows)
        out.append((len(out), start, y0 - start, take))
        y0 += take
    return rows, out


def _tile_term(sc, target, start, offset, take, rows, opts, gen, differentiable):
    """(MSE term over image rows [start + offset, start + offset + take) of
    the tile rendered at `start`, dropped count)."""
    width, height = sc.camera.resolution
    tile, dropped = _render_tile(
        sc, start, rows, width, opts, gen, differentiable=differentiable
    )
    tgt = target[start : start + rows]
    ridx = torch.arange(rows, device=tile.device)
    live = ((ridx >= offset) & (ridx < offset + take))[:, None, None]
    sq = torch.where(live, (tile - tgt) ** 2, 0.0)
    return torch.sum(sq) / float(height * width * 3), dropped


def mse_loss_and_grad_tiled(
    scene: Scene,
    theta: Mapping[str, torch.Tensor],
    target_linear: torch.Tensor,
    seed: int = 0,
    opts: Optional[RenderOptions] = None,
    device=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, grads) of the MSE with respect to the theta dict, with the
    gradients accumulated over row tiles (module docstring).  d(sum of tile
    terms)/d(theta) is the sum of the tiles' gradients, so on a
    deterministic scene this equals the whole-frame gradient to float
    tolerance.  The loss is a detached 0-d tensor and each grad a tensor on
    the device; no tile's loss is read on the host."""
    opts = opts or RenderOptions()
    dev = torch.device("cuda" if device is None else device)
    sc = P.apply(scene, theta).to(dev)
    target = target_linear.to(dev)
    rows, tiles = _tiles(sc, opts)
    keys = list(theta)
    leaves = [theta[k] for k in keys]
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    grads = [torch.zeros_like(v) for v in leaves]
    drops = []
    for idx, start, offset, take in tiles:
        with spans.span("rtt.forward"):
            term, dropped = _tile_term(
                sc, target, start, offset, take, rows, opts,
                _generator(dev, fold_in(seed, idx)), True,
            )
        with spans.span("rtt.backward"):
            g = torch.autograd.grad(term, leaves, allow_unused=True)
        for acc, gi in zip(grads, g):
            if gi is not None:
                acc += gi.to(acc.device)
        loss = loss + term.detach()
        drops.append(dropped)
    _warn_dropped(drops)
    return loss, dict(zip(keys, grads))


def mse_loss_tiled(
    scene: Scene,
    theta: Mapping[str, torch.Tensor],
    target_linear: torch.Tensor,
    seed: int = 0,
    opts: Optional[RenderOptions] = None,
    device=None,
) -> torch.Tensor:
    """Forward-only counterpart of mse_loss_and_grad_tiled: the same tiles,
    the same terms, summed on the device; no graph is kept."""
    opts = opts or RenderOptions()
    dev = torch.device("cuda" if device is None else device)
    target = target_linear.to(dev)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    drops = []
    with torch.no_grad():
        sc = P.apply(scene, theta).to(dev)
        rows, tiles = _tiles(sc, opts)
        for idx, start, offset, take in tiles:
            term, dropped = _tile_term(
                sc, target, start, offset, take, rows, opts,
                _generator(dev, fold_in(seed, idx)), True,
            )
            loss = loss + term
            drops.append(dropped)
    _warn_dropped(drops)
    return loss
