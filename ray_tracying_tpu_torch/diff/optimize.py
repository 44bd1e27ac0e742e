"""Inverse-rendering optimization loop (parameter fitting against a target
image): Adam on selected scene tensors.

Port of the JAX package's diff/optimize.py: `torch.optim.Adam` takes the
place of `optax.adam`, with the same update (b1 0.9, b2 0.999, eps 1e-8).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

from ray_tracying_tpu_torch import spans
from ray_tracying_tpu_torch.diff import params as P
from ray_tracying_tpu_torch.diff.render import fold_in, mse_loss, mse_loss_and_grad_tiled
from ray_tracying_tpu_torch.render.pipeline import RenderOptions
from ray_tracying_tpu_torch.scene.types import Scene


def fit(
    scene: Scene,
    target_linear: torch.Tensor,
    param_paths: Iterable[str],
    steps: int = 100,
    learning_rate: float = 5e-2,
    opts: Optional[RenderOptions] = None,
    seed: int = 0,
    resample_noise: bool = True,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 25,
    tiled: bool = False,
    device=None,
    optimizer: Optional[torch.optim.Adam] = None,
    theta: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[Scene, Dict[str, torch.Tensor], list]:
    """Adam-optimize the given scene tensors against the target.

    resample_noise: a fresh render seed every step (`fold_in(seed, step)`:
    stochastic effects act as unbiased noise on the gradient); else the
    same seed every step, for deterministic scenes.
    checkpoint_dir: if set, saves {theta, optimizer state} every
    checkpoint_every steps (diff/checkpoint.py) and RESUMES from the latest
    checkpoint found there.
    tiled: accumulate gradients over row tiles bounded by
    opts.max_rays_per_pass (mse_loss_and_grad_tiled) instead of
    differentiating the whole frame at once, for frames whose residuals do
    not fit the device; the same gradients to float tolerance.
    device: None = "cuda".
    theta / optimizer: a fit to carry on (e.g. one carried across from the
    JAX package with params.theta_from_numpy and
    params.adam_state_from_numpy); by default fresh ones from the scene.
    Returns (fitted scene, fitted params, loss history)."""
    opts = opts or RenderOptions(samples_sqrt=1, light_samples=1)
    dev = torch.device("cuda" if device is None else device)
    scene = scene.to(dev)
    target_linear = target_linear.to(dev)
    if theta is None:
        theta = P.extract(scene, param_paths)
    if optimizer is None:
        optimizer = torch.optim.Adam(
            list(theta.values()), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8
        )

    start = 0
    if checkpoint_dir is not None:
        from ray_tracying_tpu_torch.diff import checkpoint as ckpt

        restored = ckpt.restore(checkpoint_dir, dev)
        if restored is not None:
            start, values, opt_state = restored
            with torch.no_grad():
                for k, v in theta.items():
                    v.copy_(values[k])
            optimizer.load_state_dict(opt_state)

    history = []
    width, height = scene.camera.resolution
    spp = opts.samples_sqrt * opts.samples_sqrt if opts.samples_sqrt > 1 else 1
    for i in range(start, steps):
        with spans.span("rtt.step", rays=width * height * spp):
            s_i = fold_in(seed, i) if resample_noise else seed
            optimizer.zero_grad(set_to_none=True)
            if tiled:
                loss, grads = mse_loss_and_grad_tiled(scene, theta, target_linear, s_i, opts, dev)
                for k, v in theta.items():
                    v.grad = grads[k]
            else:
                with spans.span("rtt.forward"):
                    loss = mse_loss(P.apply(scene, theta), target_linear, s_i, opts, dev)
                with spans.span("rtt.backward"):
                    loss.backward()
            with spans.span("rtt.adam"):
                optimizer.step()
            with spans.read("loss"):
                history.append(float(loss.detach()))
        if checkpoint_dir is not None and (i + 1) % checkpoint_every == 0:
            ckpt.save(checkpoint_dir, i + 1, theta, optimizer.state_dict())
    fitted = {k: v.detach() for k, v in theta.items()}
    return P.apply(scene, fitted), fitted, history
