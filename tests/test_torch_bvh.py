"""The port's BVH traversal module (kernels/bvh_traverse.py) against the JAX
package's, whose Pallas kernel runs in interpret mode as tests/test_bvh.py
runs it, and against the port's own brute kernels.

On the CPU the port's wrappers take their plain versions (a row-order sweep
of the Morton-ordered table); the CUDA source's traversal is held against
the same plain versions by tests/test_torch_kernel_source.py (g++) and by
chip_smoke.py (on the card).

Tolerance against JAX: ids and validity equal; t at rtol 2e-5 / atol 2e-6
with the grazing-sphere allowance of tests/test_torch_intersect.py;
normals rtol 1e-4.  Against the port's own brute kernels: bit-equal (the
same arithmetic per geom, and no exact ties in these scenes)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ray_tracying_tpu.accel import lbvh as lbvh_jax
from ray_tracying_tpu.kernels.bvh_traverse import closest_hit_tid_bvh as bvh_jax
from ray_tracying_tpu.render import intersect as I_jax
from ray_tracying_tpu_torch.accel import lbvh
from ray_tracying_tpu_torch.kernels import bvh_traverse as bt
from ray_tracying_tpu_torch.kernels import closest_hit as ch
from ray_tracying_tpu_torch.render import intersect as I

from test_bvh import cluttered_scene
from test_chunk_stream import mixed_scene
from test_torch_accel import carried
from test_torch_intersect import close, interpret, rays, tt

torch.set_num_threads(1)

SCENES = {"cluttered": lambda: cluttered_scene(24), "mixed": mixed_scene}


def both(name):
    sj = lbvh_jax.with_bvh(SCENES[name]())
    return sj, carried(sj)


def batch(seed, n=128):
    o, d, tm, act, maxt = rays(n, seed)
    o[:, 1] -= 3.0  # stand back: the geoms lie around y = 5..12
    return o, d, tm, act, maxt


@pytest.mark.parametrize("name", sorted(SCENES))
def test_closest_hit_tid_bvh_matches_jax(name):
    sj, st = both(name)
    o, d, tm, act, _ = batch(seed=5)
    with interpret():
        t_ref, id_ref = (np.asarray(x) for x in bvh_jax(
            sj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm)))
    t, pid = bt.closest_hit_tid_bvh(st, *tt(o, d, tm))
    np.testing.assert_array_equal(pid.numpy(), id_ref)
    hit = id_ref >= 0
    assert 0 < hit.sum() < hit.size
    assert np.isinf(t.numpy()[~hit]).all()
    close(t.numpy()[hit], t_ref[hit], loose_share=0.02)
    # an inactive lane reports a miss; the live ones are unchanged
    ta, ia = bt.closest_hit_tid_bvh(st, *tt(o, d, tm, act))
    assert (ia[~torch.from_numpy(act)] == -1).all()
    assert torch.equal(ta[torch.from_numpy(act)], t[torch.from_numpy(act)])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_bvh_hit_set_equals_brute(name):
    """The traversal's (t, id) and (t, id, normal) are those of the brute
    kernels of the same package, bit for bit."""
    _, st = both(name)
    o, d, tm, act, _ = batch(seed=6, n=256)
    args = tt(o, d, tm, act)
    t0, i0, n0 = ch.closest_hit_tid_n(st, *args)
    t1, i1 = bt.closest_hit_tid_bvh(st, *args)
    t2, i2, n2 = bt.closest_hit_tid_n_bvh(st, *args)
    assert torch.equal(t0, t1) and torch.equal(i0, i1)
    assert torch.equal(t0, t2) and torch.equal(i0, i2) and torch.equal(n0, n2)
    assert n2.shape == (256, 3) and int((i0 >= 0).sum()) > 0


def test_fused_normals_match_jax_pass2():
    sj, st = both("mixed")
    o, d, tm, _, _ = batch(seed=7)
    ref = I_jax.closest_hit(sj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
    t, pid, n = bt.closest_hit_tid_n_bvh(st, *tt(o, d, tm))
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(pid.numpy(), np.asarray(ref.geom_id))
    close(t.numpy()[valid], np.asarray(ref.t)[valid], rtol=1e-5, atol=1e-5, loose_share=0.02)
    np.testing.assert_allclose(
        n.numpy()[valid], np.asarray(ref.normal)[valid], rtol=1e-4, atol=1e-5
    )
    assert not n.numpy()[~valid].any()


def test_sort_rays_is_slot_for_slot_invariant():
    _, st = both("mixed")
    o, d, tm, act, _ = batch(seed=13)
    perm = np.random.default_rng(1).permutation(o.shape[0])
    args = tt(o[perm], d[perm], tm[perm], act[perm])
    t0, i0 = bt.closest_hit_tid_bvh(st, *args)
    t1, i1 = bt.closest_hit_tid_bvh(st, *args, sort_rays=True)
    assert torch.equal(t0, t1) and torch.equal(i0, i1)
    t2 = I.min_hit_t(st, *args, use_bvh=True, sort_rays=True)
    assert torch.equal(t0, t2)


def test_plain_version_counts_what_no_traversal_avoids():
    _, st = both("cluttered")
    o, d, tm, act, _ = batch(seed=3)
    r = ch.pack_rays(*tt(o, d, tm, act))
    need = {}
    t, pid = bt.bvh_closest_plain(
        r, st.bvh_geoms, st.bvh_nodes_box, st.bvh_nodes_topo, st.bvh_nodes_graze,
        False, stats=need
    )
    assert need["lanes"] == 128 and need["live"] == int(act.sum())
    # the root is tested by every ray that can hit anything; a ray runs far
    # fewer geom tests than the table has rows
    assert need["box_tests"] >= int((pid >= 0).sum())
    assert 0 < need["tests"] < need["live"] * st.n_geoms // 2


@pytest.mark.parametrize("fn", ["bvh_closest", "bvh_closest_n"])
def test_cuda_tensor_never_takes_the_plain_version(monkeypatch, fn):
    _, st = both("mixed")
    called = []
    monkeypatch.setattr(bt, "_launch", lambda *a, **k: called.append(k) or ("t", "id", "n"))
    monkeypatch.setattr(bt, fn + "_plain", lambda *a, **k: pytest.fail("plain"))
    monkeypatch.setattr(bt, "mixed_closest_plain", lambda *a, **k: pytest.fail("plain"))

    class FakeCuda(torch.Tensor):
        is_cuda = True

    r = torch.zeros((8, 8)).as_subclass(FakeCuda)
    before = getattr(bt, fn).launches
    out = getattr(bt, fn)(r, st.bvh_geoms, st.bvh_nodes_box, st.bvh_nodes_topo,
                          st.bvh_nodes_graze)
    assert out == ("t", "id", "n") and len(called) == 1
    assert getattr(bt, fn).launches == before + 1


def test_a_tree_deeper_than_the_stack_is_refused(monkeypatch):
    """Where the tree is attached, by the port's own build or carried
    across, before any launch: the kernel's stack is never truncated."""
    sj = lbvh_jax.with_bvh(cluttered_scene())
    depth = lbvh.tree_depth(np.asarray(sj.bvh_nodes_topo))
    assert depth >= 2 and lbvh.check_depth(np.asarray(sj.bvh_nodes_topo)) == depth
    monkeypatch.setattr(lbvh, "BVH_STACK_MAX", depth)  # holds depth + 1 nodes
    with pytest.raises(ValueError, match="stack"):
        carried(sj)
    with pytest.raises(ValueError, match="stack"):
        lbvh.with_bvh(carried(cluttered_scene()))
    monkeypatch.setattr(lbvh, "BVH_STACK_MAX", depth + 1)
    assert carried(sj).bvh_nodes_graze.shape == (sj.bvh_nodes_topo.shape[0],)


def test_wrapper_refuses_malformed_operands():
    _, st = both("mixed")
    r = torch.zeros((8, 8))
    with pytest.raises(TypeError, match="topo"):
        bt.bvh_closest(r, st.bvh_geoms, st.bvh_nodes_box, st.bvh_nodes_topo[:-1],
                       st.bvh_nodes_graze)
    with pytest.raises(TypeError, match="table"):
        bt.bvh_closest(r, st.bvh_geoms.T.contiguous(), st.bvh_nodes_box,
                       st.bvh_nodes_topo, st.bvh_nodes_graze)
    with pytest.raises(TypeError, match="graze"):
        bt.bvh_closest(r, st.bvh_geoms, st.bvh_nodes_box, st.bvh_nodes_topo,
                       st.bvh_nodes_graze[:-1])
    with pytest.raises(ValueError, match="with_bvh"):
        bt.closest_hit_tid_bvh(carried(mixed_scene()), *tt(*batch(0)[:3]))


def test_use_bvh_routes_through_the_traversal(monkeypatch):
    """render/intersect.py: use_bvh with a BVH attached and under the cap
    goes to the traversal for closest hits (the normal-carrying one for
    inference on an untextured scene); shadow rays stay with the brute
    any-hit; without a BVH, or over the cap, the traversal is not called."""
    sj, st = both("mixed")
    o, d, tm, act, maxt = batch(seed=11)
    args = tt(o, d, tm, act)
    seen = []
    for name in ("closest_hit_tid_bvh", "closest_hit_tid_n_bvh", "occluded_tid",
                 "closest_hit_tid", "closest_hit_tid_n"):
        real = getattr(I, name)
        monkeypatch.setattr(
            I, name, lambda *a, _n=name, _f=real, **k: seen.append(_n) or _f(*a, **k))
    ref = I.closest_hit(st, *args)
    assert seen == ["closest_hit_tid"]
    del seen[:]
    hit = I.closest_hit(st, *args, use_bvh=True)
    fast = I.closest_hit(st, *args, use_bvh=True, differentiable=False)
    I.min_hit_t(st, *args, use_bvh=True)
    blocked = I.occluded(st, *tt(o, d, maxt, act), use_bvh=True)
    assert seen == ["closest_hit_tid_bvh", "closest_hit_tid_n_bvh",
                    "closest_hit_tid_bvh", "occluded_tid"]
    for a, b in zip(hit, ref):
        assert torch.equal(a, b)
    assert torch.equal(fast.geom_id, ref.geom_id)
    with interpret():
        occ_ref = np.asarray(I_jax.occluded(
            sj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(maxt), jnp.asarray(act), True))
    np.testing.assert_array_equal(blocked.numpy()[act], occ_ref[act])
    del seen[:]
    I.closest_hit(carried(mixed_scene()), *args, use_bvh=True, differentiable=False)
    monkeypatch.setattr(ch, "BRUTE_SMEM_MAX_GEOMS", 4)
    I.min_hit_t(st, *args, use_bvh=True)
    assert seen == ["closest_hit_tid_n", "closest_hit_tid"]


@pytest.mark.parametrize("name", sorted(SCENES))
def test_packed_tree_is_the_trees_arrays(name):
    """accel/lbvh.py::pack_bvh, the traversal kernel's copy of the tree: each
    inner node's record holds its children's boxes, slacks and references in
    that order; an inner reference is the child's record index (inner nodes
    in index order, the root first), a leaf's decodes to its (first, count);
    every row keeps columns 0-14 and carries id and kind exactly."""
    sj, st = both(name)
    boxes, topo, graze = (x.numpy() for x in (st.bvh_nodes_box, st.bvh_nodes_topo,
                                              st.bvh_nodes_graze))
    table = st.bvh_geoms.numpy()
    inner, rows = st.bvh_inner.numpy(), st.bvh_rows.numpy()
    nodes = np.nonzero(topo[:, 0] >= 0)[0]
    assert nodes[0] == 0 and inner.shape == (nodes.size, 16) == ((topo.shape[0] - 1) // 2, 16)
    index = {int(v): k for k, v in enumerate(nodes)}
    refs = inner[:, 14:].view(np.int32)
    seen = []
    for k, node in enumerate(nodes):
        for side, child in enumerate(topo[node, :2]):
            np.testing.assert_array_equal(inner[k, 6 * side:6 * side + 6], boxes[child])
            assert inner[k, 12 + side] == graze[child]
            ref = int(refs[k, side])
            if topo[child, 0] >= 0:
                assert ref == index[int(child)]
            else:
                code = ~ref
                assert ref < 0 and (code >> lbvh.LEAF_COUNT_BITS,
                                    code & ((1 << lbvh.LEAF_COUNT_BITS) - 1)) == \
                    tuple(topo[child, 2:])
                seen.append(tuple(topo[child, 2:]))
    # the leaves cover the table once, in order
    assert sorted(seen) == sorted(map(tuple, topo[topo[:, 0] < 0, 2:]))
    assert sum(c for _, c in seen) == table.shape[0]
    np.testing.assert_array_equal(rows[:, :15], table[:, :15])
    code = rows[:, 15].astype(np.int64)
    assert (rows[:, 15] == code).all()
    np.testing.assert_array_equal(code >> 2, np.rint(table[:, 16]))
    np.testing.assert_array_equal(code & 3, np.rint(table[:, 15]))
    # a scene carried across gets the same copy as the port's own build
    assert torch.equal(carried(sj).bvh_inner.view(torch.int32), st.bvh_inner.view(torch.int32))
    assert torch.equal(carried(sj).bvh_rows, st.bvh_rows)


def test_pack_refuses_what_the_kernel_cannot_read(monkeypatch):
    """A table past the last geom whose id * 4 + kind is exact in f32, and a
    leaf longer than a reference codes, are refused where the tree is
    packed."""
    _, st = both("mixed")
    arrays = [x.numpy() for x in (st.bvh_geoms, st.bvh_nodes_box, st.bvh_nodes_topo,
                                  st.bvh_nodes_graze)]
    nodes, rows = lbvh.pack_bvh(*arrays)
    assert rows.dtype == nodes.dtype == np.float32 and rows.flags.c_contiguous
    last = (lbvh.BVH_MAX_GEOMS - 1) * 4 + 3        # the last id's code is exact ...
    assert int(np.float32(last)) == last and int(np.float32(last + 2)) != last + 2  # ... no more
    monkeypatch.setattr(lbvh, "BVH_MAX_GEOMS", st.n_geoms - 1)
    with pytest.raises(ValueError, match="at most"):
        lbvh.pack_bvh(*arrays)
    monkeypatch.undo()
    topo = arrays[2].copy()
    leaf = int(np.nonzero(topo[:, 0] < 0)[0][0])
    topo[leaf, 3] = 1 << lbvh.LEAF_COUNT_BITS
    with pytest.raises(ValueError, match="leaf"):
        lbvh.pack_bvh(arrays[0], arrays[1], topo, arrays[3])


def test_variant_and_plan_are_for_the_card_and_count_apart(monkeypatch):
    """The schedules chip_smoke.py measures the package's against: reached
    by name, refusing a CPU tensor, a counting build of the replaced kernel
    and a malformed count buffer, and counting their launches apart."""
    _, st = both("mixed")
    ops = (st.bvh_geoms, st.bvh_nodes_box, st.bvh_nodes_topo, st.bvh_nodes_graze)
    with pytest.raises(ValueError, match="card"):
        bt.bvh_closest_variant(torch.zeros((8, 8)), *ops)
    called = []
    monkeypatch.setattr(bt, "_launch", lambda *a, **k: called.append(a) or "launched")

    class FakeCuda(torch.Tensor):
        is_cuda = True

    r = torch.zeros((8, 8)).as_subclass(FakeCuda)
    work = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="variant"):
        bt.bvh_closest_variant(r, *ops, schedule="blocks")
    with pytest.raises(ValueError, match="variant"):
        bt.bvh_closest_variant(r, *ops, schedule="lane", work=work)
    with pytest.raises(TypeError, match="work"):
        bt.bvh_closest_variant(r, *ops, work=torch.zeros(3, dtype=torch.int64))
    before = (bt.bvh_closest_variant.launches, bt.bvh_closest.launches,
              bt.bvh_closest_n.launches)
    bt.bvh_closest_variant(r, *ops, want_n=True, schedule="lane")
    bt.bvh_closest_variant(r, *ops, work=work)
    assert [a[6:9] for a in called] == [(True, "lane", None), (False, "warp", work)]
    assert (bt.bvh_closest_variant.launches, bt.bvh_closest.launches,
            bt.bvh_closest_n.launches) == (before[0] + 2, *before[1:])


def test_wrapper_checks_the_packed_tree():
    """The packed copy the kernel reads must be given, and match the tree it
    is given: one record per inner node, one row per table row."""
    _, st = both("mixed")
    r = torch.zeros((8, 8))
    ops = (st.bvh_geoms, st.bvh_nodes_box, st.bvh_nodes_topo, st.bvh_nodes_graze)
    inner, rows = bt._packed(r, *ops, (st.bvh_inner, st.bvh_rows))
    assert inner is st.bvh_inner and rows is st.bvh_rows
    with pytest.raises(ValueError, match="bvh_inner"):
        bt._packed(r, *ops, None)
    with pytest.raises(TypeError, match="inner"):
        bt._packed(r, *ops, (st.bvh_inner[:-1], st.bvh_rows))
    with pytest.raises(TypeError, match="rows"):
        bt._packed(r, *ops, (st.bvh_inner, st.bvh_rows[:-1].contiguous()))
    with pytest.raises(ValueError, match="aligned"):
        bt._packed(r, *ops, (st.bvh_inner, torch.zeros(st.bvh_rows.numel() + 1)[1:].view(
            st.bvh_rows.shape)))
