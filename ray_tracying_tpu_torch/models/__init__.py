"""Scene model zoo (the reference ships one scene + demo .blends,
SURVEY.md §2 row 16; here every demo and stress scene is a named model)."""

from ray_tracying_tpu_torch.models.zoo import (
    DEMO_SCENES,
    REGISTRY,
    bvh_stress,
    cornell,
    cube_city,
    demo,
    get,
    sphere_field,
)

__all__ = [
    "DEMO_SCENES",
    "REGISTRY",
    "bvh_stress",
    "cornell",
    "cube_city",
    "demo",
    "get",
    "sphere_field",
]
