"""The yardstick's arithmetic on made-up data: rates and tails, the idle
share and the gaps of a made-up timeline, the split into the port's and
PyTorch's kernels, the live-lane bytes, the frame comparison, the fit's
leaf gaps and the seeds."""

import math

import numpy as np
import pytest
import torch

from yardstick import bytes as B
from yardstick import compare, manifest, seeds, stats
from yardstick.profile import UNIT, WINDOW, Trace, is_torch_kernel


def test_rate_and_percentile():
    assert stats.rate(33177600 * 300, 20.0) == pytest.approx(497664000.0)
    v = list(np.random.default_rng(1).exponential(60.0, 257))
    assert stats.percentile(v, 95) == pytest.approx(float(np.percentile(v, 95)))
    assert stats.percentile([5.0], 95) == 5.0


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace():
    return Trace.annotated([
        _ev("user_annotation", WINDOW, 0, 1000),
        _ev("user_annotation", UNIT, 0, 500), _ev("user_annotation", UNIT, 500, 500),
        _ev("kernel", "void rtt::wave_level_blocks_kernel<4>(rtt::WaveParams, int)", 100, 200),
        _ev("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)", 200, 200),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 600, 100),
        _ev("kernel", "void cub::DeviceRadixSortOnesweepKernel<x>(int)", 1200, 50),
        _ev("cpu_op", "aten::cat", 420, 100),
        _ev("cuda_runtime", "cudaMemcpyAsync", 440, 20),
        _ev("cpu_op", "aten::nonzero", 700, 300),
    ])


def test_marked_span_leaves_out_its_markers_and_takes_host_gaps_apart():
    mark = "void at::native::vectorized_elementwise_kernel<4, AddFunctor>(int)"
    t = Trace.marked([
        _ev("kernel", mark, 0, 2),
        _ev("kernel", "void rtt::wave_level_blocks_kernel<4>(rtt::WaveParams, int)", 52, 100),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 152, 20),
        _ev("cpu_op", "aten::add", 10, 5),  # host events are not read from this span
        _ev("kernel", mark, 202, 2),
    ], units=1)
    assert (t.t0, t.t1, t.units) == (2.0, 202.0, 1)
    assert t.busy_s() == pytest.approx(120e-6) and t.window_s == pytest.approx(200e-6)
    assert len(t.device) == 2 and not t.host
    t.host_trace = _trace()
    bd = t.breakdown()
    assert [k for k, _ in bd["device_ops"]][0].startswith("void rtt::wave_level")
    assert [k for k, _ in bd["idle_gaps"]] == ["aten::nonzero", "aten::cat", UNIT]
    with pytest.raises(ValueError):
        Trace.marked([_ev("kernel", mark, 0, 2), _ev("kernel", "other", 5, 2)], units=1)


def test_idle_share_gaps_and_breakdown():
    t = _trace()
    assert t.units == 2 and t.window_s == pytest.approx(1e-3)
    assert t.busy_s() == pytest.approx(400e-6)      # [100, 400] and [600, 700]
    assert t.gaps() == [(0.0, 100.0), (400.0, 600.0), (700.0, 1000.0)]
    # 200 us busy a unit against an untraced unit of 500 us
    idle = manifest.module("metrics", "device_idle_pct.frames").read({"trace": t, "units": 2, "unit_s": 500e-6})
    assert manifest.module("metrics", "device_idle_pct.fit").read({"trace": t, "units": 2, "unit_s": 500e-6}) == idle
    assert manifest.module("metrics", "device_idle_pct.bvh").read({"trace": t, "units": 2, "unit_s": None}) is None
    assert idle == pytest.approx(60.0)
    assert t.host_at(450.0) == "cudaMemcpyAsync"
    bd = t.breakdown()
    assert bd["device_ops"][0][0] == "void rtt::wave_level_blocks_kernel<4>(rtt::WaveParams, int)"
    assert bd["device_ops"][0][1] == pytest.approx(200e-6)
    want = {"aten::nonzero": 300e-6, "aten::cat": 200e-6, UNIT: 100e-6}
    assert [k for k, _ in bd["idle_gaps"]] == list(want)
    assert [v for _, v in bd["idle_gaps"]] == pytest.approx(list(want.values()))


@pytest.mark.parametrize("name,torch_side", [
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<long> >(int)", True),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>(float*)", True),
    ("void cub::DeviceRadixSortOnesweepKernel<int>(int)", True),
    ("void at_cuda_detail::cub::DeviceScanKernel<int>(int)", True),
    ("void thrust::cuda_cub::core::_kernel_agent<int>(int)", True),
    ("void rtt::wave_level_blocks_kernel<4>(rtt::WaveParams, int, int, int*, int*)", False),
    ("rtt::occlusion_warp_kernel(rtt::BruteParams, rtt::SweepParams, int*, int*)", False),
    ("void (anonymous namespace)::chunk_kernel<1>(int)", False),
    ("wave_level_lane_kernel", False),
])
def test_kernel_split(name, torch_side):
    assert is_torch_kernel(name) is torch_side


def test_port_and_torch_ms_and_launches():
    t = _trace()
    ctx = {"trace": t, "units": 2}
    port = manifest.module("metrics", "port_kernels_ms.frames").read(ctx)
    ours = manifest.module("metrics", "torch_ops_ms.frames").read(ctx)
    assert port == pytest.approx(0.2 / 2) and ours == pytest.approx(0.3 / 2)
    assert manifest.module("metrics", "launches.frames").read(ctx) == 1.0


def test_live_lane_bytes_and_roofline():
    assert B.level_bytes(1000, 400, glossy=True) == 1000 * 21 * 4 + 400 * 3 * 4
    assert B.level_bytes(1000, 400, glossy=False, motion=True) == 1000 * 22 * 4
    assert B.table_bytes(141, 2) == (141 * 12 + 2 * 8) * 4
    t = _trace()
    levels = [{"live": 8_386_560, "hits": 6_000_000}, {"live": 0, "hits": 0}]
    ctx = {"trace": t, "units": 1, "counters": [levels],
           "facts": {"glossy": True, "motion": False, "n_geoms": 141, "n_lights": 2}}
    need = B.level_bytes(8_386_560, 6_000_000, True) + B.table_bytes(141, 2)
    got = manifest.module("metrics", "wave_level_roofline").read(ctx)
    assert got == pytest.approx(100.0 * need / B.PEAK_BYTES_PER_S / 200e-6)
    ctx["trace"] = Trace.annotated([_ev("user_annotation", WINDOW, 0, 10)])
    assert manifest.module("metrics", "wave_level_roofline").read(ctx) is None


def test_excess_error_reads_zero_for_a_copy_and_a_bias_for_a_shift():
    g = torch.Generator().manual_seed(3)
    base = torch.randint(40, 200, (4096, 3), generator=g).double()
    noisy = lambda: (base + 6 * torch.randn(base.shape, generator=g)).round().clamp(0, 255).to(torch.uint8)  # noqa: E731
    copies = torch.stack([noisy() for _ in range(8)])
    assert abs(compare.excess_error(noisy(), copies)) < 0.15
    # a shift under the noise adds less than itself (second order), one
    # over it nearly all of itself
    shifted = (noisy().double() + 3).clamp(0, 255).to(torch.uint8)
    assert compare.excess_error(shifted, copies) > 0.3
    shifted = (noisy().double() + 20).clamp(0, 255).to(torch.uint8)
    assert compare.excess_error(shifted, copies) > 12.0
    x, y = compare.sample_pixels(64, 36, 100, np.random.default_rng(0))
    assert len(set(zip(x.tolist(), y.tolist()))) == 100 and x.max() < 64 and y.max() < 36


def test_leaf_gaps():
    fit = manifest.module("loops", "fit")
    ref = {"a": torch.ones(4), "b": torch.full((3,), 1e-9), "c": torch.full((2,), 2.0)}
    prog = {"a": torch.ones(4) * 1.1, "b": torch.full((3,), 2e-9), "c": torch.full((2,), 2.0)}
    # a: 0.2 / 2 over its own norm 2; b: tiny gap over the median leaf's norm
    assert fit.leaf_gaps(prog, ref) == pytest.approx(0.1, rel=1e-5)
    assert fit.leaf_gaps(prog, ref, skip={"a"}) < 1e-8


def test_seeds():
    a = seeds.derive(2**31 + 12345, "frame", 7)
    assert a == seeds.derive(2**31 + 12345, "frame", 7)
    assert a != seeds.derive(2**31 + 12345, "frame", 8) and 0 <= a < 2**63
    assert len({seeds.derive(s, "frame", 0) for s in range(1000)}) == 1000
    assert not math.isnan(float(a))
