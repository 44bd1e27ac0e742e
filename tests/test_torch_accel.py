"""The port's acceleration builds (accel/lbvh.py) and ray sort key
(kernels/ray_sort.py) against the JAX package's: the same scene gives the
same arrays, bit for bit.  Scenes are those of tests/test_bvh.py and
tests/test_chunk_stream.py, carried across by scene_from_numpy."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ray_tracying_tpu.accel import lbvh as lbvh_jax
from ray_tracying_tpu.kernels.ray_sort import ray_sort_key as key_jax
from ray_tracying_tpu.scene.loader import load_scene_dict as load_jax
from ray_tracying_tpu_torch.accel import lbvh
from ray_tracying_tpu_torch.kernels import closest_hit as ch
from ray_tracying_tpu_torch.kernels.ray_sort import ray_sort_key
from ray_tracying_tpu_torch.scene.convert import scene_from_numpy

from test_bvh import cluttered_scene
from test_chunk_stream import mixed_scene
from test_scene_loader import minimal_camera

torch.set_num_threads(1)

SCENES = {"cluttered": cluttered_scene, "mixed": mixed_scene}
BVH_FIELDS = ("bvh_nodes_box", "bvh_nodes_topo", "bvh_geoms")
CHUNK_FIELDS = ("chunk_geoms", "chunk_boxes")


def carried(sj):
    return scene_from_numpy(jax.tree.map(np.asarray, sj), device="cpu")


def both(name):
    sj = SCENES[name]()
    return sj, carried(sj)


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_geom_aabbs_equal_jax(name):
    sj, st = both(name)
    same(lbvh.geom_aabbs(st), lbvh_jax.geom_aabbs(sj))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_morton_codes_equal_jax(name):
    sj, st = both(name)
    a = lbvh.geom_aabbs(st)
    c = (a[:, :3] + a[:, 3:]) * 0.5
    same(lbvh.morton_codes(c), lbvh_jax.morton_codes(c))
    assert len(set(lbvh.morton_codes(c).tolist())) > 1


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_lbvh_equal_jax(name):
    sj, st = both(name)
    got = lbvh.build_lbvh(lbvh.geom_aabbs(st))
    ref = lbvh_jax.build_lbvh(lbvh_jax.geom_aabbs(sj))
    for a, b in zip(got, ref):
        same(a, b)


@pytest.mark.parametrize("chunk", [4, 7])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_chunks_equal_jax(name, chunk):
    sj, st = both(name)
    for a, b in zip(lbvh.build_chunks(st, chunk), lbvh_jax.build_chunks(sj, chunk)):
        same(a, b)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_with_bvh_and_with_chunks_equal_jax(name):
    sj, st = both(name)
    bj, bt = lbvh_jax.with_bvh(sj), lbvh.with_bvh(st)
    for f in BVH_FIELDS:
        same(getattr(bt, f).numpy(), getattr(bj, f))
    assert bt.chunk_geoms is None  # under the cap: no chunks
    cj, ct = lbvh_jax.with_chunks(sj, 4), lbvh.with_chunks(st, 4)
    for f in CHUNK_FIELDS:
        same(getattr(ct, f).numpy(), getattr(cj, f))
    assert lbvh.with_chunks(ct, 8) is ct  # already attached


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_from_numpy_carries_the_structures(name):
    sj = lbvh_jax.with_chunks(lbvh_jax.with_bvh(SCENES[name]()), 4)
    st = carried(sj)
    for f in BVH_FIELDS + CHUNK_FIELDS:
        got = getattr(st, f)
        assert isinstance(got, torch.Tensor)
        same(got.numpy(), getattr(sj, f))
    assert st.bvh_nodes_topo.dtype == torch.int32
    # beside them, what the port derives: each box's slack, as its own
    # builds attach it
    own = lbvh.with_chunks(lbvh.with_bvh(carried(SCENES[name]())), 4)
    for f in ("bvh_nodes_graze", "chunk_graze"):
        same(getattr(st, f).numpy(), getattr(own, f).numpy())
    # and a scene without them stays without
    bare = carried(SCENES[name]())
    assert all(getattr(bare, f) is None
               for f in BVH_FIELDS + CHUNK_FIELDS + ("bvh_nodes_graze", "chunk_graze"))


def test_box_slack_is_each_boxes_own():
    """One tiny sphere among large geoms widens only the chunk and the
    nodes that hold it: 1.2e-7 * 9 / r for the smallest sphere below a box,
    0 for a box without spheres."""
    d = minimal_camera()
    d["spheres"] = [{"location": [10.0 * i, 5, 0], "radius": 1.0} for i in range(11)]
    d["spheres"].append({"location": [200, 5, 0], "radius": 0.001})
    d["cubes"] = [{"translation": [-10.0 * (i + 1), 5, 0], "rotation": [0, 0, 0],
                   "scale": [1, 1, 1]} for i in range(8)]
    st = lbvh.with_chunks(lbvh.with_bvh(carried(load_jax(d))), 4)
    big, tiny = np.float32(1.2e-7 * 9.0), np.float32(1.2e-7 * 9000.0)
    rows = lbvh.row_graze(st.bvh_geoms.numpy())
    np.testing.assert_allclose(np.sort(rows), [0.0] * 8 + [big] * 11 + [tiny], rtol=1e-5)
    topo, node = st.bvh_nodes_topo.numpy(), st.bvh_nodes_graze.numpy()
    assert node.dtype == np.float32 and node.shape == (topo.shape[0],)
    row = int(np.argmax(rows))
    for i, (left, right, first, count) in enumerate(topo.tolist()):
        if left < 0:
            np.testing.assert_allclose(node[i], rows[first:first + count].max(initial=0.0))
            assert (node[i] == rows[row]) == (first <= row < first + count)
        else:
            assert node[i] == max(node[left], node[right])
    assert node[0] == rows[row]                       # the root holds everything
    # only the path from the root to the tiny sphere's leaf carries it
    assert 2 <= int((node == rows[row]).sum()) <= lbvh.tree_depth(topo) + 1
    assert (node == 0).any()                          # a leaf of cubes
    chunk = st.chunk_graze.numpy()
    crow = lbvh.row_graze(st.chunk_geoms.numpy())
    assert chunk.shape == (st.chunk_boxes.shape[0],)
    np.testing.assert_array_equal(chunk, crow.reshape(-1, 4).max(axis=1))
    assert int((chunk == tiny).sum()) == 1
    shuffled = topo[::-1].copy()
    with pytest.raises(ValueError, match="preorder"):
        lbvh.node_graze(st.bvh_geoms.numpy(), shuffled)


def test_with_bvh_over_the_cap_also_attaches_chunks(monkeypatch):
    _, st = both("mixed")
    monkeypatch.setattr(ch, "BRUTE_SMEM_MAX_GEOMS", 4)
    s = lbvh.with_bvh(st)
    assert s.bvh_geoms is not None and s.chunk_geoms is not None
    assert s.chunk_geoms.shape[0] == s.chunk_boxes.shape[0] * lbvh.CHUNK


def test_the_cap_is_this_cards_shared_memory():
    assert ch.BRUTE_SMEM_MAX_GEOMS == 232448 // (4 * 17) == 3418
    assert 4 * 17 * lbvh.CHUNK <= 48 * 1024  # a chunk needs no opt-in


def test_empty_scene_builds_nothing():
    st = carried(load_jax(minimal_camera()))
    assert lbvh.geom_aabbs(st).shape == (0, 6)
    assert lbvh.with_bvh(st) is st and lbvh.with_chunks(st) is st
    boxes, topo, order = lbvh.build_lbvh(np.zeros((0, 6), np.float32))
    assert topo.tolist() == [[-1, -1, 0, 0]] and order.size == 0


# --- invariants of tests/test_bvh.py:36-73 and test_chunk_stream.py:64-80
def test_build_invariants():
    _, st = both("cluttered")
    aabbs = lbvh.geom_aabbs(st)
    boxes, topo, order = lbvh.build_lbvh(aabbs)
    g = aabbs.shape[0]
    seen = []
    for left, right, first, count in topo:
        if left < 0:
            seen.extend(order[first:first + count])
            assert count <= lbvh.LEAF_SIZE
    assert sorted(seen) == list(range(g))
    for i, (left, right, first, count) in enumerate(topo):
        if left >= 0:
            for child in (left, right):
                assert (boxes[child][:3] >= boxes[i][:3] - 1e-5).all()
                assert (boxes[child][3:] <= boxes[i][3:] + 1e-5).all()
        else:
            members = aabbs[order[first:first + count]]
            assert (members[:, :3] >= boxes[i][:3] - 1e-5).all()
            assert (members[:, 3:] <= boxes[i][3:] + 1e-5).all()


def test_sphere_aabb_includes_velocity_extent():
    d = minimal_camera()
    d["spheres"] = [{"location": [0, 0, 0], "radius": 1.0, "velocity": [10.0, 0, 0]}]
    box = lbvh.geom_aabbs(carried(load_jax(d)))[0]
    np.testing.assert_allclose(box[:3], [-1, -1, -1], atol=1e-5)
    np.testing.assert_allclose(box[3:], [3, 1, 1], atol=1e-5)


def test_build_chunks_invariants():
    _, st = both("mixed")
    table, boxes = lbvh.build_chunks(st, chunk=4)
    g = st.n_geoms
    nc = boxes.shape[0]
    assert table.shape == (nc * 4, 17)
    assert (table[g:] == 0).all()
    ids = np.sort(np.round(table[:g, 16]).astype(int))
    np.testing.assert_array_equal(ids, np.arange(g))
    aabbs = lbvh.geom_aabbs(st)
    for i in range(g):
        gid, c = int(round(table[i, 16])), i // 4
        assert (aabbs[gid, :3] >= boxes[c, :3] - 1e-6).all()
        assert (aabbs[gid, 3:] <= boxes[c, 3:] + 1e-6).all()


@pytest.mark.parametrize("n,depth", [(1, 0), (4, 0), (5, 1), (24, 3), (40, 4), (300, 7)])
def test_tree_depth(n, depth):
    """A median split over n geoms with leaves of 4."""
    rng = np.random.default_rng(n)
    lo = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    aabbs = np.concatenate([lo, lo + 0.5], axis=1)
    _, topo, _ = lbvh.build_lbvh(aabbs)
    assert lbvh.tree_depth(topo) == depth
    loop = np.array([[0, 0, 0, 0]], np.int32)
    with pytest.raises(ValueError, match="not a tree"):
        lbvh.tree_depth(loop)


# --- ray sort key (tests/test_chunk_stream.py:191-207)
@pytest.mark.parametrize("seed", [0, 1])
def test_ray_sort_key_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = 4096
    lo = np.array([-3.0, -1.0, 0.5], np.float32)
    hi = np.array([4.0, 9.0, 0.5], np.float32)  # a flat axis: span clamps
    o = rng.uniform(-5, 11, (n, 3)).astype(np.float32)  # some outside: clip
    d = rng.normal(size=(n, 3)).astype(np.float32)
    ref = np.asarray(key_jax(jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo), jnp.asarray(hi)))
    got = ray_sort_key(*(torch.from_numpy(x) for x in (o, d, lo, hi)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref)) > n // 2


def test_ray_sort_key_octant_major():
    lo, hi = torch.zeros(3), torch.ones(3)
    o = torch.tensor([[0.1, 0.1, 0.1], [0.9, 0.9, 0.9]])
    k_pos = ray_sort_key(o, torch.tensor([[1.0, 1.0, 1.0]] * 2), lo, hi)
    k_neg = ray_sort_key(o, torch.tensor([[-1.0, 1.0, 1.0]] * 2), lo, hi)
    assert (k_pos >= 0).all() and (k_neg >= 0).all()
    assert k_neg.min() > k_pos.max()
    assert k_pos[0] != k_pos[1]
