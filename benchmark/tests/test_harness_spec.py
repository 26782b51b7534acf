"""BENCHMARK.json against the format the benchmark keeps to, and every cell's files
found by name; a cell added as new files runs with no file edited; the
result line's keys."""

import dataclasses
import hashlib
import json
import re
import time

import pytest

import harness
import spec
from conftest import BENCH, ROOT

BENCH_FILE = ROOT / "BENCHMARK.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in json.loads(BENCH_FILE.read_text())["workloads"]]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _bench():
    return json.loads(BENCH_FILE.read_text())


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_its_format():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert BENCH_FILE.stat().st_size <= 64 * 1024
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [c["name"] for c in b["configs"]]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    cells = b["workloads"]
    assert [w["name"] for w in cells] == ["plume256-rbgs50", "plume1024-mg", "plume1024-rbgs50",
                                          "plume256-grow"]
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in names and _line(w["why"])
        assert NAME.match(w["traffic"])
    assert {c["name"] for c in b["configs"]} == {w["config"] for w in cells}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert list(e2e) == ["voxel_updates_per_s", "frame_ms_p95", "peak_mem_gib", "setup_s"]
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25
    metric_names = list(e2e) + [m["name"] for m in b["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and _line(m["layer"])
        assert m["moves"] == "voxel_updates_per_s" and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(m["workloads"]) <= {w["name"] for w in cells}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:  # every cell reports setup_s, another end-to-end metric and a per-layer one
        assert sum(1 for m in b["per_layer"] if w["name"] in m["workloads"]) >= 1


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_are_found_by_name(workload):
    cell = spec.load(workload, BENCH_FILE)
    assert cell.base == BENCH
    assert cell.scene.__name__ == "bench_scene_plume"  # no "scene" key: the plume
    assert cell.config["dtype"] == "float32"
    for m in cell.end_to_end + cell.per_layer:
        mod = spec.reader(cell, m["name"])
        assert mod.NEEDS in ("window", "frames", "trace", "timed") and callable(mod.read)
        if mod.NEEDS == "timed":
            assert cell.traffic["timed_frames"] > 0 and len(mod.FUNCTION) == 2
    numbers = {"last_gap", "start_gap"}
    if cell.traffic["topology"] == "grow":
        numbers |= {"last_tiles_off", "start_tiles_off"}
    assert set(cell.limits) == numbers


def _tree_hash():
    h = hashlib.sha256()
    for p in sorted(BENCH.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts and "out" not in p.parts:
            h.update(str(p.relative_to(BENCH)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def test_a_toy_cell_added_as_files_runs_with_no_file_edited(toy):
    before = _tree_hash()
    cell = toy("fixed")  # new files in a copy of the folder, whose old files are unchanged
    copy = cell.base
    for p in BENCH.rglob("*"):
        rel = p.relative_to(BENCH)
        if p.is_file() and rel.parts[0] not in ("tests", "out") and "__pycache__" not in rel.parts:
            assert (copy / rel).read_bytes() == p.read_bytes(), rel
    out = harness.run(cell, 2 ** 31 + 11, 0.5, False, "cpu", 0.0)
    assert out["correct"] is True and out["attempted"] >= 1
    assert _tree_hash() == before
    # the result line's keys in their order, the checks last
    assert list(out) == RESULT_KEYS + ["checks"]
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["metrics"]) == {"voxel_updates_per_s", "frame_ms_p95", "setup_s"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_a_traced_run_line(toy):
    out = harness.run(toy("fixed"), 7, 0.5, True, "cpu", 0.0)
    assert list(out) == RESULT_KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "enqueue_ms" in out["metrics"]  # the CPU has no device trace: those are left out


def test_cook_starts_lie_outside_the_frames_and_the_segments():
    """A cook's start is the benchmark's input: drawn with the frame clock
    stopped, it adds nothing to a frame's time, and a traced segment starts
    after it, with the window's second cook."""
    import torch

    pause = 0.3
    win = harness.Window(60.0, torch.device("cpu"), 2, 0)
    win.begin()
    assert win.active is None  # the first cook is left untraced
    win.frame_done(512, 0.001)
    win.new_cook(lambda: time.sleep(pause))
    assert win.active == "trace"
    win.frame_done(512, 0.001)
    win.frame_done(512, 0.001)
    assert win.active is None and win.rec.frames == 2 and win.rec.window_s < pause
    assert max(win.frame_s) < pause and win.window_s == pytest.approx(sum(win.frame_s))
    assert win.rec.enqueue_s == [0.001]  # the untraced frames' alone


def test_a_traced_grown_run_times_the_growth_pass(toy):
    cell = toy("grow")
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "timed_frames": 3})
    out = harness.run(cell, 2 ** 31 + 17, 0.3, True, "cpu", 0.0)
    assert out["correct"] is True
    assert out["metrics"]["growth_ms"]["value"] > 0
    from hnanosolver_tpu_torch.core import activation
    from hnanosolver_tpu_torch.models import plume

    assert plume.expand_for_state is activation.expand_for_state  # unwrapped again
