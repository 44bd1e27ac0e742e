"""The port's chunk-stream module (kernels/chunk_stream.py) and chunked
brute closest hit (kernels/closest_hit.py) against the JAX package's, whose
Pallas kernels run in interpret mode as tests/test_chunk_stream.py runs
them, and against the port's own brute kernels.

On the CPU the port's wrappers take their plain versions (a row-order sweep
of the whole table, no cull); the CUDA source's chunk sweep with its cull
is held against the same plain versions by
tests/test_torch_kernel_source.py (g++) and by chip_smoke.py (on the card).

Tolerance against JAX: ids, validity and `blocked` equal; t at rtol 2e-5 /
atol 2e-6 with the grazing-sphere allowance of
tests/test_torch_intersect.py; normals rtol 1e-4.  Against the port's own
brute kernels: bit-equal."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ray_tracying_tpu.accel import lbvh as lbvh_jax
from ray_tracying_tpu.kernels import chunk_stream as cs_jax
from ray_tracying_tpu.kernels import closest_hit as ch_jax
from ray_tracying_tpu.render import intersect as I_jax
from ray_tracying_tpu_torch.accel import lbvh
from ray_tracying_tpu_torch.kernels import chunk_stream as cs
from ray_tracying_tpu_torch.kernels import closest_hit as ch
from ray_tracying_tpu_torch.render import intersect as I

from test_chunk_stream import mixed_scene
from test_torch_accel import carried
from test_torch_bvh import batch
from test_torch_intersect import close, interpret, tt

torch.set_num_threads(1)


def both(chunk=4):
    sj = lbvh_jax.with_chunks(mixed_scene(), chunk=chunk)
    return sj, carried(sj)


def jj(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("chunk", [4, 5])
def test_closest_hit_tid_chunks_matches_jax(chunk):
    sj, st = both(chunk)
    o, d, tm, act, _ = batch(seed=3)
    with interpret():
        t_ref, id_ref = (np.asarray(x) for x in cs_jax.closest_hit_tid_chunks(sj, *jj(o, d, tm)))
    t, pid = cs.closest_hit_tid_chunks(st, *tt(o, d, tm))
    np.testing.assert_array_equal(pid.numpy(), id_ref)
    hit = id_ref >= 0
    assert 0 < hit.sum() < hit.size
    assert np.isinf(t.numpy()[~hit]).all()
    close(t.numpy()[hit], t_ref[hit], loose_share=0.02)
    ta, ia = cs.closest_hit_tid_chunks(st, *tt(o, d, tm, act))
    dead = ~torch.from_numpy(act)
    assert (ia[dead] == -1).all() and torch.isinf(ta[dead]).all()
    assert torch.equal(ta[~dead], t[~dead])


def test_closest_hit_tid_n_chunks_matches_jax():
    sj, st = both()
    o, d, tm, _, _ = batch(seed=5)
    with interpret():
        t_ref, id_ref, n_ref = (
            np.asarray(x) for x in cs_jax.closest_hit_tid_n_chunks(sj, *jj(o, d, tm)))
    t, pid, n = cs.closest_hit_tid_n_chunks(st, *tt(o, d, tm))
    np.testing.assert_array_equal(pid.numpy(), id_ref)
    hit = id_ref >= 0
    close(t.numpy()[hit], t_ref[hit], loose_share=0.02)
    assert n.shape == (o.shape[0], 3)
    np.testing.assert_allclose(n.numpy()[hit], n_ref[hit], rtol=1e-4, atol=1e-5)
    assert not n.numpy()[~hit].any()


def test_occluded_tid_chunks_matches_jax():
    sj, st = both()
    o, d, _, act, maxt = batch(seed=7)
    with interpret():
        ref = np.asarray(cs_jax.occluded_tid_chunks(sj, *jj(o, d, maxt)))
    got = cs.occluded_tid_chunks(st, *tt(o, d, maxt))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum() < ref.size
    masked = cs.occluded_tid_chunks(st, *tt(o, d, maxt, act))
    np.testing.assert_array_equal(masked.numpy(), ref & act)


def test_chunked_brute_closest_hit_matches_jax(monkeypatch):
    """closest_hit_tid over the cap, no chunk structures: the load-order
    table streamed in chunks, mixed-kind rows."""
    sj, st = carried_pair = (mixed_scene(), carried(mixed_scene()))
    monkeypatch.setattr(ch_jax, "BRUTE_SMEM_MAX_GEOMS", 4)
    monkeypatch.setattr(ch_jax, "GEOM_CHUNK", 8)
    monkeypatch.setattr(ch, "BRUTE_SMEM_MAX_GEOMS", 4)
    called = []
    real = ch.brute_closest_chunked
    monkeypatch.setattr(
        ch, "brute_closest_chunked", lambda *a, **k: called.append(1) or real(*a, **k))
    o, d, tm, act, _ = batch(seed=9)
    with interpret():
        t_ref, id_ref = (np.asarray(x) for x in ch_jax.closest_hit_tid(sj, *jj(o, d, tm)))
    t, pid = ch.closest_hit_tid(st, *tt(o, d, tm))
    assert called == [1]
    np.testing.assert_array_equal(pid.numpy(), id_ref)
    hit = id_ref >= 0
    close(t.numpy()[hit], t_ref[hit], loose_share=0.02)
    ta, ia = ch.closest_hit_tid(st, *tt(o, d, tm, act))
    assert (ia[~torch.from_numpy(act)] == -1).all()


def test_chunk_kernels_equal_the_brute_kernels():
    """One hit set, whatever the route: bit-equal t, id, normal, blocked."""
    _, st = both()
    o, d, tm, act, maxt = batch(seed=6, n=256)
    args = tt(o, d, tm, act)
    t0, i0, n0 = ch.closest_hit_tid_n(st, *args)
    t1, i1 = cs.closest_hit_tid_chunks(st, *args)
    t2, i2, n2 = cs.closest_hit_tid_n_chunks(st, *args)
    t3, i3 = ch.brute_closest_chunked(
        ch.pack_rays(*args), ch.pack_geom_table(st).contiguous(), st.has_motion)
    for t, i in ((t1, i1), (t2, i2), (t3, i3)):
        assert torch.equal(t, t0) and torch.equal(i, i0)
    assert torch.equal(n2, n0)
    b0 = ch.occluded_tid(st, *tt(o, d, maxt, act))
    assert torch.equal(cs.occluded_tid_chunks(st, *tt(o, d, maxt, act)), b0)
    assert st.has_motion and int((i0 >= 0).sum()) > 0 and 0 < int(b0.sum())


def test_sort_rays_is_slot_for_slot_invariant():
    _, st = both()
    o, d, tm, act, _ = batch(seed=13)
    perm = np.random.default_rng(1).permutation(o.shape[0])
    args = tt(o[perm], d[perm], tm[perm], act[perm])
    t0, i0 = cs.closest_hit_tid_chunks(st, *args)
    t1, i1 = cs.closest_hit_tid_chunks(st, *args, sort_rays=True)
    assert torch.equal(t0, t1) and torch.equal(i0, i1)


def test_big_scene_routing_uses_chunks(monkeypatch):
    """closest_hit / min_hit_t / occluded go through the chunk kernels when
    the scene exceeds the cap and carries chunks (tests/test_chunk_stream.py:
    140-161), and agree with the JAX package under the same cap."""
    sj, st = both()
    monkeypatch.setattr(ch_jax, "BRUTE_SMEM_MAX_GEOMS", 4)
    monkeypatch.setattr(ch, "BRUTE_SMEM_MAX_GEOMS", 4)
    seen = []
    for name in ("closest_hit_tid_chunks", "closest_hit_tid_n_chunks",
                 "occluded_tid_chunks", "closest_hit_tid", "closest_hit_tid_n",
                 "occluded_tid", "closest_hit_tid_bvh"):
        real = getattr(I, name)
        monkeypatch.setattr(
            I, name, lambda *a, _n=name, _f=real, **k: seen.append(_n) or _f(*a, **k))
    o, d, tm, _, _ = batch(seed=11)
    maxt = np.full(o.shape[0], 8.0, np.float32)
    fast = I.closest_hit(st, *tt(o, d, tm), differentiable=False)
    slow = I.closest_hit(st, *tt(o, d, tm), use_bvh=True)
    t2 = I.min_hit_t(st, *tt(o, d, tm), use_bvh=True)
    occ = I.occluded(st, *tt(o, d, maxt))
    assert seen == ["closest_hit_tid_n_chunks", "closest_hit_tid_chunks",
                    "closest_hit_tid_chunks", "occluded_tid_chunks"]
    with interpret():
        ref = I_jax.closest_hit(sj, *jj(o, d, tm), differentiable=False)
        t2_ref = np.asarray(I_jax.min_hit_t(sj, *jj(o, d, tm)))
        occ_ref = np.asarray(I_jax.occluded(sj, *jj(o, d, maxt)))
    valid = np.asarray(ref.valid)
    for hit in (fast, slow):
        np.testing.assert_array_equal(hit.geom_id.numpy(), np.asarray(ref.geom_id))
        close(hit.t.numpy()[valid], np.asarray(ref.t)[valid], rtol=1e-5, atol=1e-5,
              loose_share=0.02)
    np.testing.assert_allclose(
        fast.normal.numpy()[valid], np.asarray(ref.normal)[valid], rtol=1e-4, atol=1e-5)
    close(t2.numpy()[valid], t2_ref[valid], loose_share=0.02)
    np.testing.assert_array_equal(occ.numpy(), occ_ref)


def test_big_scene_without_chunks_takes_the_chunked_brute(monkeypatch):
    st = carried(mixed_scene())
    monkeypatch.setattr(ch, "BRUTE_SMEM_MAX_GEOMS", 4)
    o, d, tm, _, maxt = batch(seed=12)
    ref_t, _ = ch.brute_closest(ch.pack_rays(*tt(o, d, tm)), *ch.scene_table(st), True)
    hit = I.closest_hit(st, *tt(o, d, tm), differentiable=False)
    assert torch.equal(torch.isfinite(ref_t), hit.valid)
    assert torch.equal(I.min_hit_t(st, *tt(o, d, tm)), ref_t)
    t0, _ = ch.brute_closest(
        ch.pack_rays(*tt(o, d, np.zeros_like(tm))), *ch.scene_table(st), True)
    assert torch.equal(I.occluded(st, *tt(o, d, maxt)), t0 <= torch.from_numpy(maxt))


def test_plain_versions_count_what_a_cull_cannot_avoid():
    _, st = both()
    o, d, tm, act, maxt = batch(seed=3)
    r = ch.pack_rays(*tt(o, d, tm, act))
    boxes, graze, table, g = st.chunk_boxes, st.chunk_graze, st.chunk_geoms, st.n_geoms
    need = {}
    cs.chunk_closest_plain(r, boxes, graze, table, g, True, stats=need)
    live = int(act.sum())
    assert need["live"] == live and need["box_tests"] == live * boxes.shape[0]
    assert 0 < need["tests"] < live * g
    need_o = {}
    r0 = ch.pack_rays(*tt(o, d, np.zeros_like(tm), act))
    blocked = cs.chunk_occlusion_plain(
        r0, torch.from_numpy(maxt), boxes, graze, table, g, stats=need_o)
    unculled = {}
    ref = ch.occlusion_plain(r0, torch.from_numpy(maxt), *ch.scene_table(st), stats=unculled)
    assert torch.equal(blocked, ref)
    assert 0 < need_o["tests"] < unculled["tests"]


@pytest.mark.parametrize("fn", ["chunk_closest", "chunk_closest_n", "chunk_occlusion",
                                "brute_closest_chunked"])
def test_cuda_tensor_never_takes_the_plain_version(monkeypatch, fn):
    _, st = both()
    mod = ch if fn == "brute_closest_chunked" else cs
    called = []
    # the three chunk kernels launch the warp schedule
    launcher = "launch_sweep" if fn == "brute_closest_chunked" else "_launch"
    monkeypatch.setattr(mod, launcher, lambda *a, **k: called.append(a) or "launched")
    monkeypatch.setattr(mod, fn + "_plain", lambda *a, **k: pytest.fail("plain"))

    class FakeCuda(torch.Tensor):
        is_cuda = True

    r = torch.zeros((8, 8)).as_subclass(FakeCuda)
    boxes, graze, table, g = st.chunk_boxes, st.chunk_graze, st.chunk_geoms, st.n_geoms
    args = {
        "chunk_closest": (r, boxes, graze, table, g),
        "chunk_closest_n": (r, boxes, graze, table, g),
        "chunk_occlusion": (r, torch.zeros(8), boxes, graze, table, g),
        "brute_closest_chunked": (r, table),
    }[fn]
    before = getattr(mod, fn).launches
    assert getattr(mod, fn)(*args) == "launched"
    assert len(called) == 1 and called[0][0] == fn
    assert getattr(mod, fn).launches == before + 1


def test_sweep_variants_are_for_the_card_and_count_apart(monkeypatch):
    """The schedules chip_smoke.py measures the package's against are
    reached by name, refuse a CPU tensor and operands of the other
    function, and count their launches apart from the wrappers'."""
    _, st = both()
    boxes, graze, table, g = st.chunk_boxes, st.chunk_graze, st.chunk_geoms, st.n_geoms
    r = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="card"):
        cs.chunk_sweep_variant("chunk_closest_n", r, None, boxes, graze, table, g)
    called = []
    monkeypatch.setattr(cs, "_launch", lambda *a, **k: called.append(a) or "launched")

    class FakeCuda(torch.Tensor):
        is_cuda = True

    r = r.as_subclass(FakeCuda)
    with pytest.raises(ValueError, match="variant"):
        cs.chunk_sweep_variant("chunk_closest_n", r, torch.zeros(8), boxes, graze, table, g)
    with pytest.raises(ValueError, match="variant"):
        cs.chunk_sweep_variant("chunk_closest", r, torch.zeros(8), boxes, graze, table, g)
    with pytest.raises(ValueError, match="variant"):
        cs.chunk_sweep_variant("chunk_closest_n", r, None, boxes, graze, table, g,
                               schedule="blocks")
    before = (cs.chunk_sweep_variant.launches, cs.chunk_closest.launches,
              cs.chunk_closest_n.launches, cs.chunk_occlusion.launches)
    cs.chunk_sweep_variant("chunk_closest_n", r, None, boxes, graze, table, g, schedule="lane")
    work = torch.zeros(3, dtype=torch.int64)
    cs.chunk_sweep_variant("chunk_occlusion", r, torch.zeros(8), boxes, graze, table, g,
                           work=work)
    cs.chunk_sweep_variant("chunk_closest", r, None, boxes, graze, table, g, schedule="lane")
    assert [a[0] for a in called] == ["chunk_closest_n", "chunk_occlusion", "chunk_closest"]
    assert called[0][9:] == ("lane", None) and called[2][9:] == ("lane", None)
    assert called[1][9] == "warp" and called[1][10] is work
    assert (cs.chunk_sweep_variant.launches, cs.chunk_closest.launches,
            cs.chunk_closest_n.launches, cs.chunk_occlusion.launches) == \
        (before[0] + 3, *before[1:])


def test_wrappers_refuse_malformed_operands():
    _, st = both()
    r = torch.zeros((8, 8))
    boxes, graze, table, g = st.chunk_boxes, st.chunk_graze, st.chunk_geoms, st.n_geoms
    with pytest.raises(ValueError, match="chunks"):
        cs.chunk_closest(r, boxes, graze, table[:-1], g - 1)
    with pytest.raises(ValueError, match="chunks"):
        cs.chunk_closest(r, boxes, graze, table, g - 4)
    with pytest.raises(TypeError, match="table"):
        cs.chunk_closest(r, boxes, graze, table.T.contiguous(), g)
    with pytest.raises(TypeError, match="graze"):
        cs.chunk_closest(r, boxes, graze[:-1], table, g)
    with pytest.raises(TypeError, match="maxt"):
        cs.chunk_occlusion(r, torch.zeros(7), boxes, graze, table, g)
    with pytest.raises(ValueError, match="with_chunks"):
        cs.closest_hit_tid_chunks(carried(mixed_scene()), *tt(*batch(0)[:3]))
    # a chunk beyond a block's shared memory is refused before any build
    with pytest.raises(ValueError, match="shared memory"):
        ch.launch_sweep("brute_closest_chunked", r, table, g, ch.BRUTE_SMEM_MAX_GEOMS + 1,
                        False)


def test_chunked_variant_is_for_the_card_and_counts_apart(monkeypatch):
    """brute_closest_chunked's warp schedule and the one-thread-per-lane
    sweep it replaced, reached by name only: a CPU tensor and an unknown
    schedule are refused, and the launches count apart from the wrapper's."""
    _, st = both()
    table = st.chunk_geoms
    with pytest.raises(ValueError, match="card"):
        ch.brute_closest_chunked_variant(torch.zeros((8, 8)), table)
    called = []
    monkeypatch.setattr(ch, "launch_sweep", lambda *a, **k: called.append(a) or "launched")

    class FakeCuda(torch.Tensor):
        is_cuda = True

    r = torch.zeros((8, 8)).as_subclass(FakeCuda)
    with pytest.raises(ValueError, match="variant"):
        ch.brute_closest_chunked_variant(r, table, schedule="blocks")
    before = (ch.brute_closest_chunked_variant.launches, ch.brute_closest_chunked.launches)
    ch.brute_closest_chunked_variant(r, table, True, schedule="lane")
    ch.brute_closest_chunked_variant(r, table)
    assert [(a[0], a[4], a[5], a[6]) for a in called] == [
        ("brute_closest_chunked", ch.GEOM_CHUNK, True, "lane"),
        ("brute_closest_chunked", ch.GEOM_CHUNK, False, "warp")]
    assert (ch.brute_closest_chunked_variant.launches, ch.brute_closest_chunked.launches) == \
        (before[0] + 2, before[1])
