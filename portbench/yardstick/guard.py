"""The check that the process never loaded JAX or the JAX package."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tracying_tpu")


def loaded_forbidden(modules=None) -> list:
    """Names in sys.modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
