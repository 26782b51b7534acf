"""The readers of the program's own spans and counts (``program_spans.py``
and its metrics) on synthetic records: each metric worked out by hand, and
None where the run recorded nothing or the program has no such span or
count."""

import types

import pytest

import devtrace
import harness
import spec
from conftest import ROOT

FRAMES = 4
# (name, device ms, host ms): two frames' worth of spans, read over FRAMES
RECORDS = [("plume.step", None, 9.0), ("step.emit", 0.5, 0.1), ("step.collide", 0.25, 0.1),
           ("step.advect_velocity", 3.0, 0.4), ("step.forces", 1.5, 0.3),
           ("step.pressure", 6.0, 0.5), ("mg.restrict", 0.75, 0.2), ("mg.prolong", 1.25, 0.2),
           ("mg.restrict", 0.5, 0.2), ("step.project", 1.0, 0.2),
           ("step.advect_scalars", 4.0, 0.5), ("step.mask", 0.75, 0.1),
           ("launch.rbsor_lagged", None, 0.05), ("grow.occupancy", 0.2, 1.0),
           ("grow.rebuild", None, 30.0), ("grow.rebuild", None, 10.0), ("grow.remap", 0.3, 0.4)]
WANT = {"emit_device_ms": 0.5 / FRAMES,
        "advect_device_ms": (3.0 + 4.0) / FRAMES,
        "forces_device_ms": 1.5 / FRAMES,
        "pressure_device_ms": 6.0 / FRAMES,
        "project_device_ms": (0.25 + 1.0 + 0.75) / FRAMES,
        "mg_transfer_device_ms": (0.75 + 1.25 + 0.5) / FRAMES,
        "growth_rebuild_host_ms": (30.0 + 10.0) / FRAMES}
NEW = list(WANT) + ["growth_discard_share"]


def _records(rows):
    return [types.SimpleNamespace(name=n, device_ms=d, host_ms=h) for n, d, h in rows]


def _run(frames=FRAMES):
    return harness.Run([0.01] * frames, 512 * frames, 0.01 * frames, 0, 1.0,
                       devtrace.Record(frames=frames, window_s=0.01 * frames))


def _read(name, run):
    cell = spec.load("plume1024-mg", ROOT / "BENCHMARK.json")
    return spec.reader(cell, name).read(run)


@pytest.fixture
def program(monkeypatch):
    """The program's records and growth counts, set by the test."""
    from hnanosolver_tpu_torch.core import activation
    from hnanosolver_tpu_torch.utils import profiling

    state = {"records": []}
    monkeypatch.setattr(profiling, "records", lambda: list(state["records"]))
    monkeypatch.setattr(activation, "passes", profiling.Count("grow.passes"))
    monkeypatch.setattr(activation, "discarded", profiling.Count("grow.discarded"))
    return types.SimpleNamespace(state=state, activation=activation, profiling=profiling)


@pytest.mark.parametrize("name", list(WANT))
def test_each_reader_sums_its_spans_over_the_traced_frames(program, name):
    program.state["records"] = _records(RECORDS)
    assert _read(name, _run()) == pytest.approx(WANT[name])
    assert _read(name, _run(frames=1)) == pytest.approx(WANT[name] * FRAMES)


@pytest.mark.parametrize("name", list(WANT))
def test_each_reader_gives_none_without_its_spans(program, name):
    assert _read(name, _run()) is None  # nothing recorded (an untraced program)
    program.state["records"] = _records(r for r in RECORDS if r[0] == "launch.rbsor_lagged")
    assert _read(name, _run()) is None  # recorded, but not its spans
    program.state["records"] = _records(RECORDS)
    assert _read(name, _run(frames=0)) is None  # no traced frame


@pytest.mark.parametrize("name", [n for n in WANT if n.endswith("_device_ms")])
def test_device_readers_give_none_without_device_times(program, name):
    """Spans recorded without a card (the CPU) have no device ms: the reader
    says nothing rather than a host number under a device metric's name."""
    program.state["records"] = _records((n, None, h) for n, _, h in RECORDS)
    assert _read(name, _run()) is None


def test_the_discard_share_reads_the_growth_counts(program):
    assert _read("growth_discard_share", _run()) is None  # no pass yet
    program.activation.passes.add(8)
    assert _read("growth_discard_share", _run()) == 0.0
    program.activation.discarded.add(3)
    assert _read("growth_discard_share", _run()) == pytest.approx(37.5)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_spans_or_counts_gives_none(monkeypatch, name):
    """The parent program has no ``records`` and no growth counts: each new
    reader returns None and raises nothing."""
    from hnanosolver_tpu_torch.core import activation
    from hnanosolver_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "records")
    monkeypatch.delattr(activation, "passes")
    monkeypatch.delattr(activation, "discarded")
    assert _read(name, _run()) is None


@pytest.mark.parametrize("name", NEW)
def test_each_new_metric_is_a_traced_reader_of_the_program(name):
    entry = {m["name"]: m for m in spec._load_json(ROOT / "BENCHMARK.json")["per_layer"]}[name]
    assert entry["source"] == ("program_counter" if name == "growth_discard_share"
                               else "program_span")
    assert entry["moves"] == "voxel_updates_per_s"
    for w in entry["workloads"]:
        assert spec.reader(spec.load(w, ROOT / "BENCHMARK.json"), name).NEEDS == "trace"
