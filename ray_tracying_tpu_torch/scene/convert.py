"""Carry a scene across from the JAX package: the port's "weights across".

A caller that holds the JAX package's `Scene` turns its arrays into numpy
(`jax.tree.map(np.asarray, scene)`) and hands the result here; both
packages then render the same data.  This module never imports the JAX
package: it reads attributes (or dict keys) by name only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ray_tracying_tpu_torch.scene import types as T


# Fields of the port's Scene that the JAX package's has not: derived here
# from the arrays that came across.
_PORT_ONLY = ("bvh_nodes_graze", "chunk_graze", "bvh_inner", "bvh_rows")


def _get(tree, name):
    if name in _PORT_ONLY:
        return None
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def _build(cls, tree, device, nested=()):
    """Instantiate dataclass `cls` from `tree`, field by field: arrays
    become tensors on `device`, nested dataclasses recurse, static facts
    pass through as plain Python values."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = _get(tree, f.name)
        if f.name in nested:
            kwargs[f.name] = _build(nested[f.name], v, device)
        elif v is None:
            kwargs[f.name] = None
        elif isinstance(v, (np.ndarray, np.generic)):
            kwargs[f.name] = torch.from_numpy(np.array(v)).to(device)
        elif isinstance(v, (tuple, list)):
            kwargs[f.name] = tuple(
                x.item() if isinstance(x, np.generic) else x for x in v
            )
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def scene_from_numpy(tree, device=None) -> T.Scene:
    """Port `Scene` from a numpy-leaved scene tree (attribute object or
    dict) with the JAX package's field names and static facts; the BVH and
    chunk-stream arrays, where the tree holds them, come across too, and
    get what the port keeps beside them: each box's slack, the traversal
    kernel's packed copy of the tree, and the check that the tree fits the
    traversal kernel's stack.
    device: None = "cuda" (raises without a card), as `load_scene`."""
    from ray_tracying_tpu_torch.accel import lbvh

    dev = torch.device("cuda" if device is None else device)
    scene = _build(
        T.Scene, tree, dev,
        nested=dict(
            camera=T.Camera, lights=T.Lights, prims=T.Primitives,
            planes=T.Planes, materials=T.Materials,
        ),
    )
    extra = {}
    if scene.bvh_geoms is not None:
        extra.update(lbvh.bvh_fields(
            np.asarray(_get(tree, "bvh_geoms")), np.asarray(_get(tree, "bvh_nodes_box")),
            np.asarray(_get(tree, "bvh_nodes_topo")), dev))
    if scene.chunk_geoms is not None:
        table = np.asarray(_get(tree, "chunk_geoms"))
        chunk = table.shape[0] // np.asarray(_get(tree, "chunk_boxes")).shape[0]
        extra["chunk_graze"] = torch.from_numpy(lbvh.chunk_graze(table, chunk)).to(dev)
    return dataclasses.replace(scene, **extra) if extra else scene
