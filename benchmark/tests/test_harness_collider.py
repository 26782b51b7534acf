"""The moving collider's cell on the CPU: a toy collider (the toy plume with
a sphere crossing it at 2 voxels a frame) through the real
``scenes/collider.py`` and ``reference/collider.py``, added to a copy of the
benchmark as a configuration, a traffic mix, limits (``collider1024-mg``'s)
and a cell. The program matches the float64 reference at a cook's frame 0
and frame 2; the reference's float32 SDF is bitwise the program's; the
fixed topology holds the sphere's shell at every frame of a cook; and each
fault planted in the program's collision comes out not correct. Also the
collision's roofline bounds counted by hand, and its readers on synthetic
records."""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import devtrace
import harness
import inputs
import spec
from conftest import BENCH, ROOT, make_toy
from reference import collider as ref
from reference import topology as rt

SEED = 2 ** 31 + 4099
MIN_FRAMES = 3  # the window's frames: its last is frame 2 of its cook
# a sphere of radius 5 crossing the toy plume's column at 2 voxels a frame
TOY_COLLIDER = {"center0": [26.0, 30.0, 32.0], "velocity": [48.0, 0.0, 0.0], "radius": 5.0,
                "shell_tiles": 1}


def _collider(tmp):
    """The toy multigrid cell's copy with the collider's toy cell added as
    new files; returns the loaded cell."""
    bench_file = make_toy(tmp, "mg")
    copy = tmp / "benchmark"
    cfg = json.loads((copy / "configs" / "toy.json").read_text())
    cfg.update(scene="collider", collider=dict(TOY_COLLIDER))
    (copy / "configs" / "toy-collider.json").write_text(json.dumps(cfg))
    tr = json.loads((copy / "traffic" / "toy-mg.json").read_text())
    tr["frames_per_cook"] = 4
    (copy / "traffic" / "toy-collider.json").write_text(json.dumps(tr))
    (copy / "checks" / "toy-collider.json").write_bytes(
        (BENCH / "checks" / "collider1024-mg.json").read_bytes())
    bench = json.loads(bench_file.read_text())
    bench["configs"].append({"name": "toy-collider", "source": "a toy collider for the CPU",
                             "file": "benchmark/configs/toy-collider.json", "reduced": [],
                             "why": "CPU tests"})
    bench["workloads"].append({"name": "toy-collider", "config": "toy-collider",
                               "traffic": "toy-collider", "chips": 1, "why": "CPU tests"})
    bench_file.write_text(json.dumps(bench))
    return spec.load("toy-collider", bench_file)


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


@pytest.mark.usefixtures("toy")  # one CPU thread
def test_the_collider_matches_the_reference(tmp_path, monkeypatch):
    cell = _collider(tmp_path)
    assert cell.scene.__name__ == "bench_scene_collider"
    out, seen = _run(cell, monkeypatch)
    assert seen == [MIN_FRAMES - 1, 0]  # the last frame's index, then the first's
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] == MIN_FRAMES


def _collision_off(cell, monkeypatch):
    real = cell.scene.Driver.step
    monkeypatch.setattr(cell.scene.Driver, "step", lambda self, topo, state, params, hier, i:
                        real(self, topo, state, dataclasses.replace(params, has_collision=False),
                             hier, i))


def _sdf_at_frame_0(cell, monkeypatch):
    real = cell.scene.Driver.step
    monkeypatch.setattr(cell.scene.Driver, "step", lambda self, topo, state, params, hier, i:
                        real(self, topo, state, params, hier, 0))


def _no_trace_rejection(cell, monkeypatch):
    from hnanosolver_tpu_torch.ops import cuda_bfecc

    real = cuda_bfecc.bfecc_sample
    monkeypatch.setattr(cuda_bfecc, "bfecc_sample", lambda nbr, fields, sdt, f_lo, sdf=None:
                        real(nbr, fields, sdt, f_lo, None))


def _tail_blends_at_the_gate(cell, monkeypatch):
    """The velocity advection's tail blends with 1 - sdf/0.1, not 1 - sdf/1.5."""
    from hnanosolver_tpu_torch.ops import collision

    real = collision.enforce_collision
    monkeypatch.setattr(collision, "enforce_collision",
                        lambda topo, vel, sdf, inv_dx, margin=0.1, blend_denom=None:
                        real(topo, vel, sdf, inv_dx, margin))


FAULTS = {"collision_off": _collision_off, "sdf_at_frame_0": _sdf_at_frame_0,
          "no_trace_rejection": _no_trace_rejection,
          "tail_blends_at_the_gate": _tail_blends_at_the_gate}


@pytest.mark.usefixtures("toy")
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_collision_fault_is_not_correct(tmp_path, monkeypatch, fault):
    cell = _collider(tmp_path)
    FAULTS[fault](cell, monkeypatch)
    out, seen = _run(cell, monkeypatch)
    assert seen == [MIN_FRAMES - 1, 0]
    assert out["correct"] is False
    assert out["checks"]["last_gap"]["value"] > out["checks"]["last_gap"]["limit"]
    if fault == "sdf_at_frame_0":  # the first frame's index is 0: it is right there
        assert out["checks"]["start_gap"]["value"] <= out["checks"]["start_gap"]["limit"]


@pytest.mark.parametrize("col", [TOY_COLLIDER, {"center0": [26.3, 30.7, 31.9],
                                                "velocity": [50.0, -3.0, 7.5], "radius": 5.5,
                                                "shell_tiles": 1}])
def test_the_reference_sdf_is_bitwise_the_programs(col):
    from hnanosolver_tpu_torch.core.topology import build_topology
    from hnanosolver_tpu_torch.models import collider

    tiles = rt.emitter_tiles(col["center0"], col["radius"], 2)
    rows = rt.build(tiles, None)
    topo = build_topology(tiles, capacity=rows.capacity, device="cpu")
    assert np.array_equal(topo.keys.numpy(), rows.keys)
    c = collider.ColliderConfig(center0=tuple(col["center0"]), velocity=tuple(col["velocity"]),
                                radius=col["radius"])
    dt = 1.0 / 24.0
    for index in (0, 1, 2, 7, 47):
        want = collider.sphere_sdf(topo, collider.collider_center(c, index, dt), c.radius)
        got = ref.sphere_sdf(rows.origins, col, index, dt, "cpu")
        assert got.dtype == torch.float32 and torch.equal(got, want), index
    if col is TOY_COLLIDER:  # an integral centre: exact zeros on the lattice
        assert int((ref.sphere_sdf(rows.origins, col, 0, dt, "cpu") == 0).sum()) > 0


def test_the_fixed_topology_holds_the_shell_at_every_frame(tmp_path):
    from hnanosolver_tpu_torch.models import collider

    cell = _collider(tmp_path)
    tiles, _ = inputs.start_tiles(cell)
    held = set(rt.pack(tiles).tolist())
    assert len(held) == len(tiles)
    col = cell.config["collider"]
    c = collider.ColliderConfig(center0=tuple(col["center0"]), velocity=tuple(col["velocity"]),
                                radius=col["radius"])
    dt = cell.config["solver"]["dt"]
    for f in range(cell.traffic["frames_per_cook"]):
        shell = collider.collider_tiles(c, f, dt, shell=col["shell_tiles"])
        assert set(rt.pack(shell).tolist()) <= held, f


def test_the_collider1024_tiles_are_the_envelope_and_the_sweep():
    """The real configuration's tiles, counted as cells.py counts c4's: the
    cone and the program's collider shell at each of a cook's 48 frames."""
    from hnanosolver_tpu_torch.models import collider

    cell = spec.load("collider1024-mg", ROOT / "BENCHMARK.json")
    tiles, cap = inputs.start_tiles(cell)
    cfg, col = cell.config, cell.config["collider"]
    c = collider.ColliderConfig(center0=tuple(col["center0"]), velocity=tuple(col["velocity"]),
                                radius=col["radius"])
    want = np.concatenate([inputs.envelope(cfg)] + [
        collider.collider_tiles(c, f, cfg["solver"]["dt"], shell=col["shell_tiles"])
        for f in range(cell.traffic["frames_per_cook"])])
    assert np.array_equal(np.unique(rt.pack(tiles)), np.unique(rt.pack(want)))
    assert len(tiles) == cfg["active_tiles"] == 273289 and cap == cfg["capacity"] == 273408


# ---- the collision's roofline bounds and readers --------------------------------------------

def _reader(name):
    return spec.reader(spec.load("collider1024-mg", ROOT / "BENCHMARK.json"), name)


def test_collision_bounds_counted_by_hand():
    shapes = {"T": 1024, "scalars": 5}
    vox = 1024 * 512
    # four enforce passes: the SDF and the velocity read once, the velocity
    # written once (7 fields); the refresh writes the SDF: bytes bound both
    want = ((4 * 7 + 1) * vox * 4) / 3.35e12 * 1e3
    assert _reader("collide_roofline").bound_ms(shapes) == pytest.approx(want, rel=1e-12)
    # B1 with the SDF: the velocity pass reads 3 fields and the SDF and writes
    # 3 + 3 samples; the scalar pass reads 8 and the SDF and writes 5 + 5;
    # each reads the neighbour table (27 int32 a row); bytes bound both
    nbr = 1024 * 27 * 4
    want = ((3 + 1 + 6) * vox * 4 + nbr + (8 + 1 + 10) * vox * 4 + nbr) / 3.35e12 * 1e3
    assert _reader("B1sdf_roofline").bound_ms(shapes) == pytest.approx(want, rel=1e-12)
    # its float32 operations, a voxel: 18 + the samples of 3 and 3 fields and
    # two of the SDF (15 + 8 (2 + 2n) each), and of 8 and 5 fields and two
    ops = (18 + 79 + 79 + 2 * 47) * vox, (18 + 159 + 111 + 2 * 47) * vox
    assert ops[0] / 67e12 < (10 * vox * 4 + nbr) / 3.35e12
    assert ops[1] / 67e12 < (19 * vox * 4 + nbr) / 3.35e12


def _run_with(frames, device_ops=(), shapes=None):
    rec = devtrace.Record(frames=frames, window_s=0.01 * frames, shapes=shapes)
    rec.device_ops = list(device_ops)
    return harness.Run([0.01] * frames, 512 * frames, 0.01 * frames, 0, 1.0, rec)


@pytest.fixture
def records(monkeypatch):
    from hnanosolver_tpu_torch.utils import profiling

    state = {"records": []}
    monkeypatch.setattr(profiling, "records", lambda: list(state["records"]))
    return state


def test_collision_readers_on_synthetic_records(records):
    shapes = {"T": 1024, "scalars": 5}
    rows = [("collider.step", None), ("step.emit", 1.0), ("collide.sdf", 0.5),
            ("step.collide", 2.0)] + [("collide.enforce", 2.0)] * 4 + [("step.project", 5.0)]
    records["records"] = [types.SimpleNamespace(name=n, device_ms=d, host_ms=0.1)
                          for n, d in rows]
    run = _run_with(2, shapes=shapes)
    assert _reader("collide_device_ms").read(run) == pytest.approx((0.5 + 8.0) / 2)
    bound = _reader("collide_roofline").bound_ms(shapes)
    assert _reader("collide_roofline").read(run) == pytest.approx(100.0 * bound / 4.25)
    # the parent's program: no collision span, so nothing to read
    records["records"] = [r for r in records["records"] if not r.name.startswith("collide.")]
    run = _run_with(2, shapes=shapes)
    assert _reader("collide_device_ms").read(run) is None
    assert _reader("collide_roofline").read(run) is None


def test_b1sdf_reader_reads_the_kernels_time():
    shapes = {"T": 1024, "scalars": 5}
    ops = [("void hn::bfecc_sample_kernel<3, 0, true>(float const*)", 0.0, 40.0),
           ("void hn::bfecc_sample_kernel<8, 3, true>(float const*)", 50.0, 110.0),
           ("void hn::bfecc_tail_kernel(float const*)", 120.0, 200.0)]
    run = _run_with(2, ops, shapes)
    ms = (40.0 + 60.0) / 1e3 / 2
    reader = _reader("B1sdf_roofline")
    assert reader.read(run) == pytest.approx(100.0 * reader.bound_ms(shapes) / ms)
    assert reader.read(_run_with(2, ops[2:], shapes)) is None
