"""The trace reduction and the yardstick on synthetic traces: device
operations tied to the benchmark's spans by correlation, the idle share
from overlapping intervals, the per-layer readers, and K5's bound against
chip_smoke.k5_bytes."""

from __future__ import annotations

import types

import pytest

import tiny_cell
from benchmark import harness, trace_reduce, yardstick


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def _events():
    """One call: api span 0-100 us, driver span 20-90 inside it, a K5 span
    40-50 inside that. Launches at 5 (api), 30 (driver), 45 (k5) and 95
    (api again); device ops overlapping as [10, 30] [25, 35] [50, 70]
    [96, 99]."""
    return [
        _x("bench::api", "user_annotation", 0, 100),
        _x("bench::driver", "user_annotation", 20, 70),
        _x("bench::k5", "user_annotation", 40, 10),
        _x("aten::argsort", "cpu_op", 28, 5),
        _x("cudaLaunchKernel", "cuda_runtime", 5, 1, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 30, 1, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 45, 1, correlation=3),
        _x("cudaMemcpyAsync", "cuda_runtime", 95, 1, correlation=4),
        _x("gen_rays", "kernel", 10, 20, correlation=1, grid=[4, 1, 1], block=[256, 1, 1]),
        _x("radix_sort", "kernel", 25, 10, correlation=2, grid=[8, 1, 1], block=[128, 1, 1]),
        _x("void seg_kernel<true>(Pack)", "kernel", 50, 20, correlation=3, grid=[3, 1, 1],
           block=[128, 1, 1]),
        _x("Memcpy DtoH", "gpu_memcpy", 96, 3, correlation=4),
    ]


def test_spans_and_idle_from_overlapping_intervals():
    tr = trace_reduce.reduce_events(_events())
    layers = {o.name: o.layer for o in tr.ops}
    assert layers == {"gen_rays": "api", "radix_sort": "driver",
                      "void seg_kernel<true>(Pack)": "k5", "Memcpy DtoH": "api"}
    assert tr.window_us == 100
    # union: [10, 35] + [50, 70] + [96, 99] = 25 + 20 + 3
    assert trace_reduce.busy_us(tr) == pytest.approx(48.0)
    gaps = trace_reduce.idle_gaps(tr)
    assert [round(s * 1e6, 6) for _, s in gaps] == [26.0, 15.0, 10.0, 1.0]
    assert gaps[1][0] == "bench::k5"  # [35, 50]: the host inside K5's span
    ops = trace_reduce.top_device_ops(tr)
    assert ops[0][0] == "gen_rays" and ops[0][1] == pytest.approx(20e-6)


def _ctx(tr, passes=1):
    return harness.LayerContext(tr, passes, 1.5, 1000, (84, 108))


@pytest.mark.parametrize("name,want", [
    ("api.launches_per_pass", 2.0), ("api.device_ms_per_pass", 0.023),
    ("driver.launches_per_pass", 1.0), ("driver.device_ms_per_pass", 0.010),
    ("k5.ms_per_pass", 0.020), ("device.idle_share", 52.0), ("scene.compile_s", 1.5),
    ("k5.ms_per_pass.offline", 0.020), ("device.idle_share.offline", 52.0)])
def test_readers(name, want):
    read = harness.load_reader(name, tiny_cell.REPO)
    assert read(_ctx(trace_reduce.reduce_events(_events()))) == pytest.approx(want)


def test_readers_return_nothing_on_an_empty_trace():
    tr = trace_reduce.Trace([], 0.0, 0.0, [])
    for name in ("api.launches_per_pass", "driver.device_ms_per_pass", "k5.ms_per_pass",
                 "k5_roofline", "device.idle_share"):
        assert harness.load_reader(name, tiny_cell.REPO)(_ctx(tr)) is None


def test_k5_roofline_arithmetic():
    """384 lanes (grid 3 x 128) of 84 + 108 B and a 1,000 B pack, over the
    kernel's 20 us, against the published 3.35 TB/s."""
    read = harness.load_reader("k5_roofline", tiny_cell.REPO)
    got = read(_ctx(trace_reduce.reduce_events(_events())))
    want = 100.0 * (1000 + 384 * (84 + 108)) / 3.35e12 / 20e-6
    assert got == pytest.approx(want)


@pytest.mark.parametrize("media,textured,grid", [(False, True, False), (True, False, False),
                                                 (True, True, True), (False, False, False)])
def test_k5_bytes_equal_chip_smoke(media, textured, grid):
    """The frozen plane bytes equal chip_smoke.k5_bytes on a fixed lane
    list (no misses), for the kitchen's (84 + 108 B) and medium_cbox's
    (104 + 104 B) plane sets among others."""
    import chip_smoke

    pack = types.SimpleNamespace(has_media=media, textured=textured, has_grid=grid,
                                 tri_only=True)
    lanes = [1048576, 600000, 250000, 17, 0, 3]
    nbytes, reads, writes = chip_smoke.k5_bytes(pack, lanes, [0] * len(lanes))
    assert yardstick.k5_lane_bytes(media, textured, grid) == (reads, writes)
    assert yardstick.k5_bound_s(0, 1, lanes, (reads, writes)) * yardstick.PEAK_BYTES_S \
        == pytest.approx(nbytes)
    if (media, textured, grid) == (False, True, False):
        assert (reads, writes) == (84, 108)
    if (media, textured, grid) == (True, False, False):
        assert (reads, writes) == (104, 104)


def test_idle_share_reads_the_device_alone_stretch():
    """With a stretch traced on the device alone, device.idle_share reads
    it over its host-clock window: the same operations over 200 us."""
    tr = trace_reduce.reduce_events(_events())
    idle = trace_reduce.reduce_events([e for e in _events() if e["cat"] in
                                       trace_reduce.DEVICE_CATS])
    idle.window_us = 200.0
    ctx = harness.LayerContext(tr, 1, 1.5, 1000, (84, 108), idle)
    got = harness.load_reader("device.idle_share", tiny_cell.REPO)(ctx)
    assert got == pytest.approx(100.0 * (1.0 - 48.0 / 200.0))
