"""Checkpoint / resume for inverse-rendering fits.

The reference renders one shot and keeps no state; the differentiable path
adds long-running parameter fitting, so the fitted parameters and the
optimizer state are saved with `torch.save` every so many steps and a fit
resumes from the latest (diff/optimize.fit(checkpoint_dir=...)).  One file a
checkpoint, `step_<step>.pt`, written to a temporary name and renamed;
the newest `keep` are kept.  Loading uses `torch.load(weights_only=True)`:
a checkpoint holds tensors and plain values only.

Port of the JAX package's diff/checkpoint.py (which uses orbax).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _steps(directory: str):
    """Saved steps in `directory`, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(m.group(1)) for m in (_NAME.match(f) for f in os.listdir(directory)) if m
    )


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:09d}.pt")


def save(
    directory: str,
    step: int,
    theta: Mapping[str, torch.Tensor],
    opt_state: Dict[str, Any],
    keep: int = 3,
) -> None:
    """Write {theta, opt_state} at `step` (opt_state: the optimizer's
    state_dict()) and keep the newest `keep` checkpoints."""
    os.makedirs(directory, exist_ok=True)
    payload = {
        "step": int(step),
        "theta": {k: v.detach().cpu() for k, v in theta.items()},
        "opt_state": opt_state,
    }
    path = _path(directory, step)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in _steps(directory)[:-keep]:
        os.remove(_path(directory, old))


def restore(
    directory: str, device=None
) -> Optional[Tuple[int, Dict[str, torch.Tensor], Dict[str, Any]]]:
    """The latest (step, theta, opt_state) in `directory`, theta on
    `device` (None = "cuda"), or None when there is no checkpoint."""
    steps = _steps(directory)
    if not steps:
        return None
    dev = torch.device("cuda" if device is None else device)
    payload = torch.load(_path(directory, steps[-1]), weights_only=True, map_location="cpu")
    theta = {k: v.to(dev) for k, v in payload["theta"].items()}
    return int(payload["step"]), theta, payload["opt_state"]
