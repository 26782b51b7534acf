"""A configuration brings its own scene as new files: a copy of the benchmark
takes the test-only moving emitter (``moving_emitter.py``: the emitter moves
with the frame's index within its cook, and a ``dye`` field joins the start)
with a configuration, a traffic mix, limits and a cell, every file it
already had left byte for byte. Its cell runs correct on the CPU, and not
correct where the program or the reference ignores the index. A scene with
no module fails as the cell is loaded."""

import json
import shutil
from pathlib import Path

import pytest

import harness
import spec
from conftest import BENCH, make_toy

SEED = 2 ** 31 + 8191
MIN_FRAMES = 3  # the window's frames: its last is frame 2 of its cook, not 0


def _files(base: Path) -> dict:
    skip = {"tests", "out", "__pycache__"}  # what make_toy leaves out of its copy
    return {p.relative_to(base): p.read_bytes() for p in base.rglob("*")
            if p.is_file() and not skip & set(p.relative_to(base).parts)}


def _moving_emitter(tmp: Path):
    """The toy fixed cell's copy with the moving emitter's cell added as
    new files; returns the loaded cell."""
    bench_file = make_toy(tmp, "fixed")
    copy = tmp / "benchmark"
    shutil.copy(BENCH / "tests" / "moving_emitter.py", copy / "scenes" / "moving_emitter.py")
    cfg = json.loads((copy / "configs" / "toy.json").read_text())
    cfg.update(scene="moving_emitter", motion=[1.0, 0.0, 0.5], dye=0.5)
    (copy / "configs" / "toy-moving.json").write_text(json.dumps(cfg))
    tr = json.loads((copy / "traffic" / "toy-fixed.json").read_text())
    tr["frames_per_cook"] = 1000  # the window is one cook
    (copy / "traffic" / "toy-moving.json").write_text(json.dumps(tr))
    shutil.copy(copy / "checks" / "toy-fixed.json", copy / "checks" / "toy-moving.json")
    bench = json.loads(bench_file.read_text())
    bench["configs"].append({"name": "toy-moving", "source": "a moving emitter for the CPU",
                             "file": "benchmark/configs/toy-moving.json", "reduced": [],
                             "why": "CPU tests"})
    bench["workloads"].append({"name": "toy-moving", "config": "toy-moving",
                               "traffic": "toy-moving", "chips": 1, "why": "CPU tests"})
    bench_file.write_text(json.dumps(bench))
    for rel, data in _files(BENCH).items():  # every file the benchmark has, byte for byte
        assert (copy / rel).read_bytes() == data, rel
    return spec.load("toy-moving", bench_file)


def _run(cell, monkeypatch) -> tuple:
    """A run of ``cell`` whose window holds MIN_FRAMES frames; (the result,
    the frame indices the reference was given)."""
    real_done = harness.Window.frame_done
    monkeypatch.setattr(harness.Window, "frame_done", lambda self, *a: real_done(self, *a)
                        and len(self.frame_s) >= MIN_FRAMES)
    seen, real_frame = [], cell.scene.frame

    def frame(cell, topo, state, levels, index):
        seen.append(index)
        return real_frame(cell, topo, state, levels, index)

    monkeypatch.setattr(cell.scene, "frame", frame)
    return harness.run(cell, SEED, 0.01, False, "cpu", 0.0), seen


def _program_ignores_index(cell, monkeypatch):
    real = cell.scene.Driver.step
    monkeypatch.setattr(cell.scene.Driver, "step",
                        lambda self, topo, state, params, hier, index:
                        real(self, topo, state, params, hier, 0))


def _reference_ignores_index(cell, monkeypatch):
    real = cell.scene.frame
    monkeypatch.setattr(cell.scene, "frame", lambda cell, topo, state, levels, index:
                        real(cell, topo, state, levels, 0))


FAULTS = {"program": _program_ignores_index, "reference": _reference_ignores_index}


@pytest.mark.usefixtures("toy")  # one CPU thread
def test_a_scene_added_as_files_runs_correct(tmp_path, monkeypatch):
    cell = _moving_emitter(tmp_path)
    assert cell.scene.__name__ == "bench_scene_moving_emitter"
    out, seen = _run(cell, monkeypatch)
    assert seen == [MIN_FRAMES - 1, 0]  # the last frame's index, then the first's
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == MIN_FRAMES


@pytest.mark.usefixtures("toy")
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_side_that_ignores_the_index_is_not_correct(tmp_path, monkeypatch, fault):
    cell = _moving_emitter(tmp_path)
    FAULTS[fault](cell, monkeypatch)
    out, seen = _run(cell, monkeypatch)
    assert seen == [MIN_FRAMES - 1, 0]
    assert out["correct"] is False
    assert out["checks"]["last_gap"]["value"] > out["checks"]["last_gap"]["limit"]
    assert out["checks"]["start_gap"]["value"] <= out["checks"]["start_gap"]["limit"]


def test_a_scene_with_no_module_fails_at_load(tmp_path):
    bench_file = make_toy(tmp_path, "fixed")
    cfg_file = tmp_path / "benchmark" / "configs" / "toy.json"
    cfg_file.write_text(json.dumps({**json.loads(cfg_file.read_text()), "scene": "no_such"}))
    with pytest.raises(FileNotFoundError, match=r"no_such\.py"):
        spec.load("toy-fixed", bench_file)
