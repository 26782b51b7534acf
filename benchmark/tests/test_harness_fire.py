"""The fire's cell on the CPU: a toy fire (the toy plume's envelope with a
burner at its foot, config 3's combustion constants, vorticity confinement
at offset 1) through the real ``scenes/fire.py`` and ``reference/fire.py``,
added to a copy of the benchmark as a configuration, a traffic mix, limits
(``fire512-rbgs50``'s) and a cell. The program matches the float64
reference at a cook's frame 0 and frame 2; the confinement switched off on
the program's side comes out not correct, and the scene ``Driver``'s check of the
confinement's count refuses a frame that does not apply it. Also the
confinement's roofline bound counted by hand, its readers on synthetic
records, and the fire512 configuration's tiles."""

import dataclasses
import json
import types

import pytest
import torch

import devtrace
import harness
import inputs
import spec
from conftest import BENCH, ROOT, make_toy
from reference import topology as rt

SEED = 2 ** 31 + 7013
MIN_FRAMES = 3  # the window's frames: its last is frame 2 of its cook
TOY_BURNER = {"center": [32.0, 8.0, 32.0], "radius": 7.0, "height": 4.0, "fuel_rate": 4.0,
              "ignition_temp": 80.0, "swirl": 2.0}


def _fire(tmp):
    """The toy fixed cell's copy with the fire's toy cell added as new
    files; returns the loaded cell."""
    bench_file = make_toy(tmp, "fixed")
    copy = tmp / "benchmark"
    cfg = json.loads((copy / "configs" / "toy.json").read_text())
    real = json.loads((BENCH / "configs" / "fire512.json").read_text())
    cfg.update(scene="fire", burner=dict(TOY_BURNER), solver=real["solver"],
               emitter={"center": TOY_BURNER["center"], "radius": TOY_BURNER["radius"],
                        "velocity_jet": 8.0})
    (copy / "configs" / "toy-fire.json").write_text(json.dumps(cfg))
    (copy / "checks" / "toy-fire.json").write_bytes(
        (BENCH / "checks" / "fire512-rbgs50.json").read_bytes())
    bench = json.loads(bench_file.read_text())
    bench["configs"].append({"name": "toy-fire", "source": "a toy fire for the CPU",
                             "file": "benchmark/configs/toy-fire.json", "reduced": [],
                             "why": "CPU tests"})
    bench["workloads"].append({"name": "toy-fire", "config": "toy-fire",
                               "traffic": "toy-fixed", "chips": 1, "why": "CPU tests"})
    bench_file.write_text(json.dumps(bench))
    return spec.load("toy-fire", bench_file)


def _run(cell, monkeypatch) -> tuple:
    """A run whose window holds MIN_FRAMES frames; (the result, the frame
    indices the reference was given)."""
    real_done = harness.Window.frame_done
    monkeypatch.setattr(harness.Window, "frame_done", lambda self, *a: real_done(self, *a)
                        and len(self.frame_s) >= MIN_FRAMES)
    seen, real_frame = [], cell.scene.frame

    def frame(cell, topo, state, levels, index):
        seen.append(index)
        return real_frame(cell, topo, state, levels, index)

    monkeypatch.setattr(cell.scene, "frame", frame)
    return harness.run(cell, SEED, 0.01, False, "cpu", 0.0), seen


def _confinement_off(cell, monkeypatch):
    """The program's side at factor_scale 0.5 (offset 0), the reference's
    at 1.0; the scene ``Driver``'s own count check is passed by."""
    real = cell.scene.Driver.step

    def step(self, topo, state, params, hier, i):
        self.checked = True
        off = dataclasses.replace(params.combustion, factor_scale=0.5)
        return real(self, topo, state, dataclasses.replace(params, combustion=off), hier, i)

    monkeypatch.setattr(cell.scene.Driver, "step", step)


@pytest.mark.usefixtures("toy")  # one CPU thread
def test_the_fire_matches_the_reference(tmp_path, monkeypatch):
    cell = _fire(tmp_path)
    assert cell.scene.__name__ == "bench_scene_fire"
    out, seen = _run(cell, monkeypatch)
    assert seen == [MIN_FRAMES - 1, 0]  # the last frame's index, then the first's
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == MIN_FRAMES


@pytest.mark.usefixtures("toy")
def test_the_confinement_off_is_not_correct(tmp_path, monkeypatch):
    cell = _fire(tmp_path)
    _confinement_off(cell, monkeypatch)
    out, _ = _run(cell, monkeypatch)
    assert out["correct"] is False
    for name in ("last_gap", "start_gap"):
        assert out["checks"][name]["value"] > 10 * out["checks"][name]["limit"], out["checks"]


@pytest.mark.usefixtures("toy")
def test_the_driver_refuses_a_frame_without_the_confinement(tmp_path):
    cell = _fire(tmp_path)
    prep = harness.prepare(cell, torch.device("cpu"))
    driver, prog = prep.prog.driver, prep.prog
    state = prog.state(inputs.start_fields(cell, prep.rows, SEED, "cpu"))
    off = dataclasses.replace(prog.params.combustion, factor_scale=0.5)
    with pytest.raises(RuntimeError, match="applied the vorticity confinement 0 times"):
        driver.step(prep.topo, state, dataclasses.replace(prog.params, combustion=off), (), 0)
    assert not driver.checked
    driver.step(prep.topo, state, prog.params, (), 0)
    assert driver.checked


def test_the_fire512_tiles_are_the_envelope():
    cell = spec.load("fire512-rbgs50", ROOT / "BENCHMARK.json")
    tiles, cap = inputs.start_tiles(cell)
    cfg = cell.config
    assert len(tiles) == len(set(rt.pack(tiles).tolist())) == cfg["active_tiles"] == 33656
    assert len(tiles) * rt.TILE == cfg["active_voxels"] and cap == cfg["capacity"] == 33792
    assert cell.scene.__name__ == "bench_scene_fire" and cell.config["solver"]["combustion"][
        "factor_scale"] == 1.0


# ---- the confinement's roofline bound and readers -------------------------------------------

def _reader(name):
    return spec.reader(spec.load("fire512-rbgs50", ROOT / "BENCHMARK.json"), name)


def test_vorticity_bound_counted_by_hand():
    # the velocity read once and written once over the capacity's rows
    assert 6 * 33792 * 512 * 4 == 415_236_096
    got = _reader("vorticity_roofline").bound_ms({"T": 33792, "scalars": 5})
    assert got == pytest.approx(415_236_096 / 3.35e12 * 1e3, rel=1e-12)
    assert got == pytest.approx(0.12395, abs=5e-6)
    # 154 float32 operations a voxel stay under the bytes' time
    assert 154 * 33792 * 512 / 67e12 * 1e3 < got


def _run_with(frames, shapes=None):
    rec = devtrace.Record(frames=frames, window_s=0.01 * frames, shapes=shapes)
    return harness.Run([0.01] * frames, 512 * frames, 0.01 * frames, 0, 1.0, rec)


@pytest.fixture
def records(monkeypatch):
    from hnanosolver_tpu_torch.utils import profiling

    state = {"records": []}
    monkeypatch.setattr(profiling, "records", lambda: list(state["records"]))
    return state


def test_vorticity_readers_on_synthetic_records(records):
    shapes = {"T": 33792, "scalars": 5}
    rows = [("fire.step", None), ("step.emit", 1.0), ("step.forces", 50.0),
            ("forces.vorticity", 40.0), ("step.forces", 52.0), ("forces.vorticity", 42.0)]
    records["records"] = [types.SimpleNamespace(name=n, device_ms=d, host_ms=0.1)
                          for n, d in rows]
    run = _run_with(2, shapes=shapes)
    assert _reader("vorticity_device_ms").read(run) == pytest.approx(41.0)
    bound = _reader("vorticity_roofline").bound_ms(shapes)
    assert _reader("vorticity_roofline").read(run) == pytest.approx(100.0 * bound / 41.0)
    # the parent's program: no confinement span, so nothing to read
    records["records"] = [r for r in records["records"] if r.name != "forces.vorticity"]
    run = _run_with(2, shapes=shapes)
    assert _reader("vorticity_device_ms").read(run) is None
    assert _reader("vorticity_roofline").read(run) is None
