"""Each per-layer reader on a canned record, and the trace reduction on
canned chrome-trace events."""

import pytest

from benchmark import manifest, trace
from benchmark.roofline import b1, b2, b3
from conftest import ROOT

REC = {
    "requests": [
        {"frames": 128, "seconds": {"load": 0.4, "front_end": 1.0,
                                    "filter": 0.6}},
        {"frames": 128, "seconds": {"load": 0.44, "front_end": 1.08,
                                    "filter": 0.52}},
    ],
    "device_events": [
        ("stencil_rounds(unsigned char const*, int const*, int*, int, int)",
         0.0, 400.0),
        ("void scan_rows(int*, long long, int, int)", 500.0, 100.0),
        ("void subpix_kernel<unsigned char>(unsigned char const*)", 700.0,
         10.0),
        ("void (anonymous namespace)::ns_cluster_cols<1>(float const*)",
         800.0, 50.0),
        ("void gemm_kernel<2>(Gemm)", 900.0, 50.0),
        ("void at::native::vectorized_elementwise_kernel<4>(int)", 950.0,
         30.0),
    ],
    "window_s": 0.01,
    "busy_s": 0.0025,
    "calls": {"b1": [((32, 540, 960), 16, 4)],
              "b2": [(12288, ((6, 6), (3, 4)), 1)],
              "b3": [(1, 201, 48, 20), (1, 201, 48, 20)]},
}


def reader(name):
    return manifest.load_reader(ROOT / "benchmark/metrics" / f"{name}.py")


def test_stage_readers():
    assert reader("load_ms_per_frame").read(REC) == pytest.approx(
        1e3 * 0.84 / 256)
    assert reader("front_end_ms_per_frame").read(REC) == pytest.approx(
        1e3 * (0.6 + 0.64) / 256)
    assert reader("filter_ms_per_frame").read(REC) == pytest.approx(
        1e3 * 1.12 / 256)
    assert reader("load_ms_per_frame").read({"requests": []}) is None


def test_roofline_readers():
    b1_ms = b1.bound_ms((32, 540, 960), 16, 4)
    assert reader("b1_roofline_pct").read(REC) == pytest.approx(
        100 * b1_ms / 0.5)
    assert reader("b2_roofline_pct").read(REC) == pytest.approx(
        100 * b2.bound_ms(12288, ((6, 6), (3, 4)), 1) / 0.01)
    assert reader("b3_roofline_pct").read(REC) == pytest.approx(
        100 * 2 * b3.bound_ms(1, 201, 48) / 0.1)
    # no recorded calls, or no device time: the metric is left out
    assert reader("b1_roofline_pct").read(dict(REC, calls={})) is None
    assert reader("b2_roofline_pct").read(dict(REC, device_events=[])) \
        is None


def test_device_idle_reader():
    assert reader("device_idle_pct").read(REC) == pytest.approx(75.0)
    assert reader("device_idle_pct").read({"window_s": 0.0}) is None


def _x(name, cat, ts, dur, pid=0):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid}


def test_reduce_events_takes_the_union_of_overlapping_intervals():
    events = [
        _x(trace.WINDOW, "user_annotation", 1000.0, 1000.0),
        _x("k1", "kernel", 1100.0, 200.0),   # 1100-1300
        _x("k2", "kernel", 1200.0, 200.0),   # 1200-1400, overlaps k1
        _x("cp", "gpu_memcpy", 1600.0, 100.0),
        _x("k3", "kernel", 1950.0, 200.0),   # clipped at the window's end
        _x("k0", "kernel", 0.0, 10.0),       # outside the window
        _x("aten::item", "cpu_op", 1400.0, 200.0),
    ]
    red = trace.reduce_events(events)
    assert red["window_s"] == pytest.approx(1e-3)
    # 1100-1400, 1600-1700, 1950-2000: 450 us, not the 550 us summed
    assert red["busy_s"] == pytest.approx(450e-6)
    names = [n for n, _ in red["breakdown"]["device_ops"]]
    assert names[:2] == ["k1", "k2"] and "k0" not in names
    gaps = dict(red["breakdown"]["idle_gaps"])
    assert gaps["aten::item x1"] == pytest.approx(200e-6)
    assert sum(gaps.values()) == pytest.approx(550e-6)


def test_union_seconds():
    assert trace.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.union_seconds([]) == 0
