"""The port's model zoo (models/zoo.py) against the JAX package's: the
procedural generators draw the same numpy seeds, so the scene dicts are
equal and every loaded scene equals JAX's field for field."""

import numpy as np
import jax
import pytest
import torch

from ray_tracying_tpu import models as models_jax
from ray_tracying_tpu.models import zoo as zoo_jax
from ray_tracying_tpu_torch import models
from ray_tracying_tpu_torch.models import zoo

from test_torch_scene import assert_same_scene

torch.set_num_threads(1)

CASES = {
    "bvh_stress": {},
    "cornell": {"res": (32, 32)},
    "sphere_field": {"n": 50, "seed": 3, "res": (32, 18)},
    "cube_city": {"n": 30, "seed": 2, "res": (32, 18)},
    **{name: {} for name in models.DEMO_SCENES},
}


def test_registry_names_equal_jax():
    assert sorted(models.REGISTRY) == sorted(models_jax.REGISTRY) == sorted(CASES)
    assert models.DEMO_SCENES == models_jax.DEMO_SCENES
    assert sorted(models.__all__) == sorted(models_jax.__all__)


@pytest.mark.parametrize("name", sorted(CASES))
def test_loaded_scene_equals_jax(name):
    sj = models_jax.get(name, **CASES[name])
    st = models.get(name, device="cpu", **CASES[name])
    assert st.device.type == "cpu"
    assert_same_scene(jax.tree.map(np.asarray, sj), st)
    assert st.n_geoms == sj.n_geoms > 0


@pytest.mark.parametrize("name", ["cornell", "sphere_field", "cube_city"])
def test_scene_dict_equals_jax(monkeypatch, name):
    """What the generators hand to the loader is the same dict."""
    seen = {}
    monkeypatch.setattr(zoo_jax, "load_scene_dict", lambda d: seen.setdefault("jax", d))
    monkeypatch.setattr(zoo, "load_scene_dict", lambda d, device=None: seen.setdefault("port", d))
    models_jax.get(name, **CASES[name])
    models.get(name, device="cpu", **CASES[name])
    assert seen["jax"] == seen["port"]
    assert seen["port"]["render"]["resolution_x"] == CASES[name]["res"][0]


def test_unknown_names_raise():
    with pytest.raises(KeyError, match="unknown scene model"):
        models.get("nope")
    with pytest.raises(KeyError, match="unknown demo scene"):
        models.demo("nope", device="cpu")


def test_large_scenes_pass_the_cap():
    """sphere_field(n) holds n + 1 geoms: past 3,417 spheres the table no
    longer fits a block's shared memory and the pipeline attaches chunks."""
    from ray_tracying_tpu_torch.kernels.closest_hit import BRUTE_SMEM_MAX_GEOMS

    s = models.sphere_field(n=BRUTE_SMEM_MAX_GEOMS, res=(8, 6), device="cpu")
    assert s.n_geoms == BRUTE_SMEM_MAX_GEOMS + 1 and s.kind_counts == (3418, 0, 1)
