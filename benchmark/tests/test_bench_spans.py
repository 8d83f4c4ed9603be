"""The span readers on a canned record, and the probe that takes the
traced spans and launches from the trace: the reduction's outputs are
the same with the program's annotations in the trace as without, and
with the probe as without."""

import copy

import pytest

from benchmark import spans, trace
from conftest import ROOT
from test_bench_metrics import REC, _x, reader

EXISTING = ("load_ms_per_frame", "front_end_ms_per_frame",
            "filter_ms_per_frame", "b1_roofline_pct", "b2_roofline_pct",
            "b3_roofline_pct", "device_idle_pct")
NEW = ("sweep_ms_per_frame", "slots_ms_per_frame", "pnp_ms_per_frame",
       "upload_ms_per_frame", "readback_ms_per_frame", "scan_ms_per_frame",
       "output_ms_per_frame", "front_end_launches_per_frame",
       "filter_launches_per_frame", "front_end_idle_pct", "filter_idle_pct")

SECONDS = {"front_end.upload": 0.05, "front_end.sweep": 0.2,
           "front_end.slots": 0.1, "front_end.pnp": 0.05,
           "front_end.readback": 0.1, "filter.upload": 0.01,
           "filter.scan": 0.4, "filter.readback": 0.05,
           "output.write": 0.02, "input.load": 0.4,
           "run_slam.request": 1.7}

# one traced request, us: front end 100-500, the scan 520-900
SPANS = [("run_slam.request", 0.0, 1000.0), ("input.load", 0.0, 100.0),
         ("front_end.upload", 100.0, 50.0), ("front_end.sweep", 150.0, 200.0),
         ("front_end.pnp", 350.0, 50.0), ("front_end.readback", 400.0, 100.0),
         ("filter.upload", 500.0, 20.0), ("filter.scan", 520.0, 380.0),
         ("filter.readback", 900.0, 50.0), ("output.write", 950.0, 50.0)]
EVENTS = [("k1", 120.0, 30.0),    # front end
          ("k2", 300.0, 150.0),   # front end
          ("k3", 480.0, 60.0),    # 20 us in each
          ("k4", 600.0, 100.0),   # the scan
          ("k5", 1100.0, 10.0)]   # in no span
LAUNCHES = [5.0, 110.0, 160.0, 170.0, 360.0, 450.0, 499.0, 530.0, 600.0,
            610.0, 905.0]


def _record(events=True):
    """REC with the spans' seconds and the traced keys; with ``events``
    the device events above in place of REC's."""
    rec = copy.deepcopy(REC)
    for r in rec["requests"]:
        r["seconds"].update(SECONDS)
    rec["calls"] = dict(rec.get("calls", {}),
                        spans=[{"host_spans": SPANS, "launches": LAUNCHES}])
    if events:
        rec["device_events"] = EVENTS
    return rec


def test_span_seconds_readers():
    rec = _record()
    per = {"sweep_ms_per_frame": 0.2, "slots_ms_per_frame": 0.1,
           "pnp_ms_per_frame": 0.05, "upload_ms_per_frame": 0.06,
           "readback_ms_per_frame": 0.15, "scan_ms_per_frame": 0.4,
           "output_ms_per_frame": 0.02}
    for name, secs in per.items():
        # two requests of 128 frames, each with these seconds
        assert reader(name).read(rec) == pytest.approx(1e3 * secs / 128), \
            name


def test_launch_and_idle_readers():
    rec = _record()
    assert reader("front_end_launches_per_frame").read(rec) == \
        pytest.approx(6 / 128)
    assert reader("filter_launches_per_frame").read(rec) == \
        pytest.approx(3 / 128)
    # front end: 30 + 150 + 20 us busy of 400; the scan 20 + 100 of 380
    assert reader("front_end_idle_pct").read(rec) == pytest.approx(50.0)
    assert reader("filter_idle_pct").read(rec) == pytest.approx(
        100 * (1 - 120 / 380))


def test_new_readers_read_nothing_without_the_spans():
    """The parent's program has no spans: each new reader returns None
    and raises nothing, traced keys or not."""
    for rec in (REC, dict(REC, calls={"spans": [{}]}),
                dict(REC, calls={"spans": [{"host_spans": [],
                                            "launches": []}]})):
        for name in NEW:
            assert reader(name).read(rec) is None, name


def test_existing_readers_read_the_same_with_the_new_keys():
    rec = _record(events=False)
    for name in EXISTING:
        assert reader(name).read(rec) == reader(name).read(REC), name


def _trace(annotated: bool):
    events = [_x(trace.WINDOW, "user_annotation", 1000.0, 1000.0),
              _x("k1", "kernel", 1100.0, 200.0),
              _x("k2", "kernel", 1200.0, 200.0),
              _x("cp", "gpu_memcpy", 1600.0, 100.0),
              _x("k3", "kernel", 1950.0, 200.0),
              _x("k0", "kernel", 0.0, 10.0),
              _x("aten::item", "cpu_op", 1400.0, 200.0),
              _x("aten::to", "cpu_op", 1700.0, 240.0),
              _x("cudaLaunchKernel", "cuda_runtime", 1090.0, 5.0),
              _x("cudaLaunchKernelExC_v11060", "cuda_runtime", 1180.0, 5.0),
              _x("cudaMemcpyAsync", "cuda_runtime", 1590.0, 5.0),
              _x("cudaStreamSynchronize", "cuda_runtime", 1600.0, 90.0),
              _x("cudaLaunchKernel", "cuda_runtime", 500.0, 5.0)]
    if annotated:
        events += [_x("run_slam.request", "user_annotation", 1050.0, 900.0),
                   _x("front_end.sweep", "user_annotation", 1060.0, 500.0),
                   _x("filter.scan", "user_annotation", 1600.0, 300.0),
                   _x("front_end.sweep", "gpu_user_annotation", 1100.0,
                      300.0),
                   _x("input.load", "user_annotation", 10.0, 20.0)]
    return events


def test_reduce_events_is_unchanged_by_annotations():
    plain = trace.reduce_events(_trace(False))
    assert trace.reduce_events(_trace(True)) == plain


def test_the_probe_takes_spans_and_launches_from_the_reduced_trace():
    plain = trace.reduce_events(_trace(True))
    real = trace.reduce_events
    held = spans.hook()
    assert spans.hook(0) is held  # armed once, however often it fires
    assert held == {}
    out = trace.reduce_events(_trace(True))
    assert trace.reduce_events is real  # hooked for that one call
    assert out == plain
    # inside the window, the window's own annotation left out
    assert held["host_spans"] == [("run_slam.request", 1050.0, 900.0),
                                  ("front_end.sweep", 1060.0, 500.0),
                                  ("filter.scan", 1600.0, 300.0)]
    # launching calls in the window: kernels, copies; not the sync
    assert held["launches"] == [1090.0, 1180.0, 1590.0]
    assert spans.trace_keys(_trace(False))["host_spans"] == []


def test_a_traced_run_hands_the_probe_its_spans(monkeypatch):
    """trace.run on the CPU with the readers' probe: the window's
    ``torch.cuda.synchronize`` (a no-op here) arms it, and the record's
    ``calls`` then hold the program's annotations from the export."""
    import torch
    from torch.profiler import record_function
    def no_op(device=None):
        return None

    monkeypatch.setattr(torch.cuda, "synchronize", no_op)
    real = trace.reduce_events

    def fn():
        with record_function("run_slam.request"):
            with record_function("front_end.sweep"):
                torch.ones(64).sum()
        torch.cuda.synchronize()
        return 1

    out = trace.run(fn, spans.PROBES, "cpu")
    assert trace.reduce_events is real
    assert torch.cuda.synchronize is no_op  # unwrapped again
    held = spans.traced(out["record"])
    assert [n for n, _, _ in held["host_spans"]] == ["run_slam.request",
                                                     "front_end.sweep"]
    assert held["launches"] == []  # no card


def test_every_new_metric_is_declared():
    import json
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in man["per_layer"]}
    assert [m["name"] for m in man["per_layer"]][-len(NEW):] == list(NEW)
    for name in NEW:
        m = entries[name]
        assert m["moves"] == "frames_per_s" and m["better"] == "lower"
        assert (ROOT / "benchmark/metrics" / f"{name}.py").is_file()
        full_only = name in ("sweep_ms_per_frame", "slots_ms_per_frame")
        assert m["workloads"] == ["mono1080-mekf.full"] + (
            [] if full_only else ["mono1080-mekf.corners"])
