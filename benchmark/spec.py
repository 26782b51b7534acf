"""A cell of ``BENCHMARK.json`` and the files that define it, found by name:

- ``configs/<config>.json``: the domain, the emitter and the solver
  constants (the file ``BENCHMARK.json`` names for the configuration), and
  optionally ``"scene"``, the scene it runs ("plume" where it has none);
- ``scenes/<scene>.py``: all the harness knows of one kind of scene. Its
  program side is ``SOLVER`` (``SolverParams`` keywords beyond those the
  harness sets from the configuration and the traffic) and ``Driver(cell)``
  with ``step(topo, state, params, hier, index)`` and ``cook(frames,
  params, topo, state, on_frame, interrupter)``, each through the port's
  public model entry points; its inputs are ``start_tiles(cell)`` and
  ``extra_fields(cell, topo, generator, device)`` (fields beyond the six the
  harness draws, drawn after them); its reference side is ``frame(cell,
  topo, state, levels, index)``, ``occupancy(topo, state)``,
  ``grown_tiles(cell, topo, occ, threshold, index)`` and ``grow(cell, topo,
  state, index)``, over a copy of its plain reference under ``reference/``.
  ``index`` is the frame's index within its cook, from 0;
- ``traffic/<traffic>.json``: the pressure solver, the topology mode
  (fixed or grown), frames a cook, warm-up, the traced and timed frames
  and the seeded start;
- ``checks/<workload>.json``: the limit of each number the output check
  compares;
- ``metrics/<metric>.py``: one reader per per-layer metric.

A later cell, configuration, scene or metric is new files and new entries
in ``BENCHMARK.json``; no file here names one, but the plume as the scene of
a configuration without the key.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    base: Path  # the benchmark's folder: that of the command's script
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # metric entries of BENCHMARK.json this cell reports
    per_layer: list
    scene: object  # the module scenes/<scene>.py

    def solver(self) -> dict:
        """The configuration's solver constants with the traffic's pressure
        settings."""
        return {**self.config["solver"], "pressure": self.traffic["pressure"]}


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, bench_file: Path) -> Cell:
    """The cell ``workload`` of ``bench_file``; raises where a file is
    missing."""
    bench = _load_json(bench_file)
    root = bench_file.resolve().parent
    base = (root / bench["command"][-1]).parent
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_file}; there are {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    return Cell(
        name=workload, base=base, chips=int(w["chips"]), config=config,
        traffic=_load_json(base / "traffic" / f"{w['traffic']}.json"),
        limits=_load_json(base / "checks" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        scene=scene(base, config.get("scene", "plume")))


def _module(name: str, path: Path):
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = mod  # what dataclasses and pickling look a module up by
    mod_spec.loader.exec_module(mod)
    return mod


def scene(base: Path, name: str):
    """The module ``scenes/<name>.py`` of the benchmark folder ``base``;
    raises FileNotFoundError, naming the file, where there is none."""
    path = base / "scenes" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"the configuration's scene {name!r} has no module {path}")
    return _module(f"bench_scene_{name}", path)


def reader(cell: Cell, metric: str):
    """The module ``metrics/<metric>.py``: ``NEEDS`` (what a run must record
    for it: "window", "frames", "trace" or "timed", the last with
    ``FUNCTION``, the program's (module, function) it times) and ``read(run)``,
    the metric's value from a ``harness.Run``, or None where the run holds
    nothing to read."""
    return _module(f"bench_metric_{metric}", cell.base / "metrics" / f"{metric}.py")
