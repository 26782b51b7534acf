"""The port's fire frame (``models/fire.fire_step``: the burner's emit and
the step with vorticity confinement at offset 1) against the benchmark's
plain reference (``benchmark/reference/fire.py``) on the CPU, on a toy fixed
topology (the developed column's envelope at radius 32, 264 tiles) from one
of the benchmark's seeded starts (``benchmark/inputs.start_fields``), with
the fire512 configuration's constants and pressure (``rbgs50``).

- The gap is the benchmark's (max |program - reference| / max |reference|
  over the velocity and the five scalars), held at the fire512-rbgs50
  cell's limits, against the reference in float64: ``start_gap``'s at a
  cook's first frame from the start, ``last_gap``'s at its second from the
  program's own output.
- The reference in float32 repeats the port's arithmetic: each field within
  1e-6 of its largest |value|.
- Each planted fault, a first frame from the start, reads over
  ``start_gap``'s limit: the confinement off (the program at factor_scale
  0.5, so offset 0), offset 2 in place of 1, the +1e-5 of the
  normalisation dropped (the float32 reference in the program's place: the
  null row's 0 / 0 is NaN, and the frame's trace of a NaN velocity indexes
  out of range, so no run with it reads correct) and the burner's swirl
  left out.
"""

import dataclasses
import importlib
import json
import sys
from pathlib import Path

import pytest
import torch

from hnanosolver_tpu_torch.config import CombustionParams, SolverParams
from hnanosolver_tpu_torch.core.topology import build_topology
from hnanosolver_tpu_torch.fields import FieldState
from hnanosolver_tpu_torch.models import fire

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 2663
ENVELOPE = {"radius_vox": 32, "height_vox": 64, "center_x": 32, "center_z": 32}
BURNER = {"center": [32.0, 8.0, 32.0], "radius": 10.0, "height": 4.0, "fuel_rate": 4.0,
          "ignition_temp": 80.0, "swirl": 2.0}
TOL32 = 1e-6  # the float32 reference: the port's op order
NAMES = ("density", "temperature", "fuel", "waste", "flame")


@pytest.fixture(scope="module")
def bench():
    """The benchmark's modules, imported as its harness imports them, and
    the toy fire cell: fire512-rbgs50 with the toy envelope and burner."""
    path = str(ROOT / "benchmark")
    sys.path.insert(0, path)
    try:
        spec, inputs = importlib.import_module("spec"), importlib.import_module("inputs")
        ref = importlib.import_module("reference.fire")
        rt = importlib.import_module("reference.topology")
        cell = spec.load("fire512-rbgs50", ROOT / "BENCHMARK.json")  # imports its scene
    finally:
        sys.path.remove(path)
    cfg = json.loads(json.dumps(cell.config))
    cfg.update(envelope=dict(ENVELOPE), burner=dict(BURNER),
               emitter={"center": BURNER["center"], "radius": BURNER["radius"],
                        "velocity_jet": 8.0})
    cell = dataclasses.replace(cell, config=cfg)
    tiles, cap = inputs.start_tiles(cell)
    rows = rt.build(tiles, cap)
    topo = build_topology(tiles, capacity=cap, device="cpu")
    assert (topo.keys.numpy() == rows.keys).all() and len(tiles) == 264 and cap == 512
    start = inputs.start_fields(cell, rows, SEED, "cpu")
    return dict(cell=cell, ref=ref, rows=rt.with_index(rows, "cpu"), topo=topo, start=start)


def _params(cell, **combustion) -> SolverParams:
    sv, pr = cell.config["solver"], cell.traffic["pressure"]
    return SolverParams(dt=sv["dt"], voxel_size=sv["voxel_size"],
                        combustion=CombustionParams(**{**sv["combustion"], **combustion}),
                        pressure_solver="rbgs", iterations=pr["iterations"],
                        halo_lag=pr["halo_lag"])


def _port(b, fields: dict, burner: dict | None = None, **combustion) -> dict:
    bn = dict(BURNER if burner is None else burner)
    cfg = fire.FireConfig(center=tuple(bn["center"]), radius=bn["radius"], height=bn["height"],
                          fuel_rate=bn["fuel_rate"], ignition_temp=bn["ignition_temp"],
                          swirl=bn["swirl"])
    state = FieldState(velocity=fields["velocity"].float(),
                       scalars={k: fields[k].float() for k in NAMES})
    out = fire.fire_step(b["topo"], state, _params(b["cell"], **combustion), cfg, ())
    return {"velocity": out.velocity, **out.scalars}


def _reference(b, fields: dict, dtype) -> dict:
    return b["ref"].frame(b["rows"], {k: v.to(dtype) for k, v in fields.items()},
                          b["cell"].solver(), BURNER, [])


def _gaps(prog: dict, ref: dict) -> dict:
    return {k: float((prog[k].double() - r.double()).abs().max())
            / max(float(r.abs().max()), 1e-30) for k, r in ref.items()}


def _gap(prog: dict, ref: dict) -> float:
    """The largest of :func:`_gaps`, NaN where any is."""
    g = torch.tensor(list(_gaps(prog, ref).values()), dtype=torch.float64)
    return float(g.max())


def _limit(b, which: str) -> float:
    """The cell's limit of ``which`` ("start": a cook's first frame from the
    seeded start; "last": a later frame from the program's own input)."""
    return json.loads((ROOT / "benchmark" / "checks" / f"{b['cell'].name}.json").read_text())[
        f"{which}_gap"]


def test_the_port_matches_the_float64_reference(bench):
    first = _port(bench, bench["start"])
    gap0 = _gap(first, _reference(bench, bench["start"], torch.float64))
    second = _port(bench, first)
    gap1 = _gap(second, _reference(bench, first, torch.float64))
    assert gap0 <= _limit(bench, "start") and gap1 <= _limit(bench, "last"), (gap0, gap1)
    assert gap0 < 1e-5 and gap1 < 1e-5  # float32's rounding over one frame


def test_the_float32_reference_repeats_the_port(bench):
    gaps = _gaps(_port(bench, bench["start"]), _reference(bench, bench["start"], torch.float32))
    assert max(gaps.values()) <= TOL32, gaps


def test_the_confinement_acts_at_the_start(bench):
    """The start's vorticity is strong enough that the force shows: the
    confined velocity lies far from the unconfined one."""
    ref, rows = bench["ref"], bench["rows"]
    vel = bench["start"]["velocity"].double()
    sv = bench["cell"].config["solver"]
    c = sv["combustion"]
    out = ref.confine(rows.nbr, vel, sv["dt"], 1.0 / sv["voxel_size"], c["vorticity_scale"],
                      c["factor_scale"])
    assert float((out - vel).abs().max()) > 1e-2 * float(vel.abs().max())


def _off(b):
    return _port(b, b["start"], factor_scale=0.5)


def _offset_2(b):
    return _port(b, b["start"], factor_scale=2.0)


def _no_eps(b):
    b["ref"].EPS = 0.0
    try:
        return _reference(b, b["start"], torch.float32)
    finally:
        b["ref"].EPS = 1e-5


def _no_swirl(b):
    return _port(b, b["start"], burner={**BURNER, "swirl": 0.0})


FAULTS = {"confinement_off": _off, "offset_2": _offset_2, "eps_dropped": _no_eps,
          "swirl_left_out": _no_swirl}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_over_the_limit(bench, fault):
    try:
        gap = _gap(FAULTS[fault](bench), _reference(bench, bench["start"], torch.float64))
    except RuntimeError as e:  # a NaN velocity's trace indexes out of range
        assert fault == "eps_dropped", e
        gap = float("nan")
    assert not gap <= _limit(bench, "start"), gap  # NaN too: "correct" is gap <= limit
