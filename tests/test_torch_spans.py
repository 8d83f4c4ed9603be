"""The port's spans (`utils.profiling.StageTimer`): the recorder itself,
and run_slam's spans at its layer boundaries on the CPU, single-stream
and fleet, with and without a torch.profiler running."""

import functools
import json

import pytest
import torch

from aruco_slam_tpu_torch.apps import front_end
from aruco_slam_tpu_torch.apps import make_synthetic as tsyn
from aruco_slam_tpu_torch.apps import run_slam as trun
from aruco_slam_tpu_torch.io import save_npz
from aruco_slam_tpu_torch.utils import profiling

FRONT = ("front_end.upload", "front_end.sweep", "front_end.slots",
         "front_end.pnp", "front_end.readback")
FILTER = ("filter.upload", "filter.scan", "filter.readback")
SPANS = {"run_slam.request", "input.load", *FRONT, *FILTER, "output.write"}
# corner input skips the image detector
IMAGE_ONLY = {"front_end.sweep", "front_end.slots"}
# one stream's npz images: the chunk step's wait on the reader thread
WAIT = "input.wait"


class FakeCuda(torch.Tensor):
    """A CPU tensor that says it lies on a card."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """A 4-frame 960x540 image bundle, and the same clip at corner
    level."""
    root = tmp_path_factory.mktemp("spans")
    img = tsyn.build(frames=4, markers=5, capacity=16, with_images=True,
                     image_size=(960, 540))
    paths = {"images": root / "img.npz", "corners": root / "cor.npz"}
    save_npz(paths["images"], **img)
    save_npz(paths["corners"],
             **{k: v for k, v in img.items() if k != "images"})
    return paths


@pytest.fixture
def chunk4(monkeypatch):
    """The image front ends' chunk cut to the bundle's 4 frames, so no
    chunk is padded to 32."""
    real = front_end.observations_from_frames
    monkeypatch.setattr(front_end, "observations_from_frames",
                        lambda *a: real(*a, chunk=4))
    monkeypatch.setattr(trun, "run_multi_stream", functools.partial(
        trun.run_multi_stream, chunk=4))


def _argv(inp, out, *flags):
    return ["--input", inp, "--platform", "cpu",
            "--trajectory", str(out / "traj.txt"),
            "--map", str(out / "map.txt"), *flags]


def test_spans_nest_with_parent_indices():
    timer = profiling.StageTimer()
    with timer.stage("a"):
        with timer.stage("b"):
            pass
        with timer.stage("c"):
            with timer.stage("d"):
                pass
    with pytest.raises(ValueError):
        with timer.stage("e"):
            raise ValueError
    with timer.stage("f"):
        pass
    assert [(s.name, s.parent) for s in timer.spans] == [
        ("a", -1), ("b", 0), ("c", 0), ("d", 2), ("e", -1), ("f", -1)]
    for s in timer.spans:
        assert s.start <= s.end
        if s.parent >= 0:
            up = timer.spans[s.parent]
            assert up.start <= s.start and s.end <= up.end
    assert timer.spans[0].end <= timer.spans[4].start


def test_a_stage_waits_only_on_a_given_result(monkeypatch):
    """No span synchronises the card unless handed a result to wait
    for."""
    waited = []

    def synchronize(device=None):
        if not waited or waited[-1] != "allowed":
            raise AssertionError("a span synchronised the card")
        waited.append(device)
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    card = torch.ones(2).as_subclass(FakeCuda)
    timer = profiling.StageTimer()
    with timer.stage("plain"):
        card * 2
    with timer.stage("nested"), timer.stage("inner"):
        pass
    waited.append("allowed")
    with timer.stage("given", result=(card, [torch.zeros(1)])):
        pass
    assert waited == ["allowed", torch.device("cuda", 0)]
    waited.append("allowed")
    with timer.stage("set") as out:
        out["result"] = {"x": card}
    assert waited[-1] == torch.device("cuda", 0)
    assert timer.counts == {"plain": 1, "nested": 1, "inner": 1,
                            "given": 1, "set": 1}


def test_record_function_only_while_a_profiler_runs(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def record_function(name, args=None):
        opened.append((name, args))
        return real(name, args)
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    timer = profiling.StageTimer(request_id="req-1")
    with timer.stage("off"):
        pass
    assert opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with timer.stage("on"), timer.stage("on.inner"):
            pass
    with timer.stage("off.again"):
        pass
    assert opened == [("on", "req-1"), ("on.inner", "req-1")]
    assert [s.name for s in timer.spans] == ["off", "on", "on.inner",
                                            "off.again"]


def test_spans_are_user_annotations_in_a_device_trace(tmp_path):
    timer = profiling.StageTimer()
    with profiling.device_trace(str(tmp_path)):
        with timer.stage("outer.span"), timer.stage("inner.span"):
            torch.ones(8) @ torch.ones(8)
    events = json.loads((tmp_path / "trace.json").read_text())
    ann = {e["name"]: e for e in events["traceEvents"]
           if e.get("cat") == "user_annotation"}
    assert {"outer.span", "inner.span"} <= set(ann)
    outer, inner = ann["outer.span"], ann["inner.span"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("kind", ["images", "corners"])
def test_run_slam_returns_every_span(bundles, chunk4, tmp_path, monkeypatch,
                                    kind):
    """Every span of run_slam's path lands in RunResult.seconds beside
    the outside-in stages, which keep their meaning: ``load`` +
    ``front_end.*`` reconcile with ``front_end`` (which includes the
    load), ``filter.*`` with ``filter``, and the top-level spans with
    the request. No span waits on the card."""
    def no_wait(result):
        raise AssertionError("a span of run_slam waited on a result")
    monkeypatch.setattr(profiling, "_block_until_ready", no_wait)
    res = trun.main(_argv(str(bundles[kind]), tmp_path))
    s = res.seconds
    want = SPANS - (IMAGE_ONLY if kind == "corners" else set())
    assert want <= set(s)
    assert not (IMAGE_ONLY - want) & set(s)
    assert (WAIT in s) == (kind == "images")
    assert {"load", "front_end", "filter"} <= set(s)
    assert s["input.load"] <= s["load"] <= s["front_end"] <= \
        s["run_slam.request"]
    front = s["load"] + sum(s[k] for k in (*FRONT, WAIT) if k in s)
    assert 0.75 * s["front_end"] <= front <= s["front_end"]
    back = sum(s[k] for k in FILTER)
    assert 0.5 * s["filter"] <= back <= s["filter"]
    top = s["input.load"] + front - s["load"] + back + s["output.write"]
    assert top <= s["run_slam.request"]


def test_run_slam_spans_follow_the_request(bundles, chunk4, tmp_path,
                                          monkeypatch):
    """One timer a request: its spans nest under ``run_slam.request``
    and each chunk opens one span a stage."""
    timers = []
    real = profiling.StageTimer

    def timer(*a, **k):
        timers.append(real(*a, **k))
        return timers[-1]
    monkeypatch.setattr(trun, "StageTimer", timer)
    trun.main(_argv(str(bundles["images"]), tmp_path))
    trun.main(_argv(str(bundles["images"]), tmp_path))
    main_timers = [t for t in timers if t.request_id is not None]
    assert len(main_timers) == 2
    assert main_timers[0].request_id != main_timers[1].request_id
    spans = main_timers[0].spans
    assert spans[0].name == "run_slam.request" and spans[0].parent == -1
    assert all(sp.parent == 0 for sp in spans[1:])
    names = [sp.name for sp in spans[1:]]
    assert names == ["input.load", WAIT, *FRONT[:4], WAIT,
                     "front_end.readback",
                     "filter.upload", "filter.scan", "filter.readback",
                     "filter.readback", "output.write"]


def test_fleet_profile_writes_the_spans(bundles, chunk4, tmp_path):
    """A two-stream --profile run writes DIR/trace.json with the
    fleet's spans as user annotations, and its seconds hold them."""
    inp = ",".join([str(bundles["images"])] * 2)
    prof = tmp_path / "prof"
    res = trun.main(_argv(inp, tmp_path, "--profile", str(prof)))
    assert len(res) == 2 and res[0].seconds is res[1].seconds
    events = json.loads((prof / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert SPANS - {"run_slam.request", "filter.upload"} <= names
    assert SPANS - {"filter.upload"} <= set(res[0].seconds)
    assert {"load", "front_end", "filter"} <= set(res[0].seconds)
