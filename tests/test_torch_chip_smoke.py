"""``chip_smoke.py``'s own arithmetic and data on the CPU, without a card.

- ``bound_ms`` / ``ops_per_voxel``: for every kernel key, the bytes one
  launch must move (each input read once, each output written once; B11 the
  27-table values its dloc picks, B1d the dual rows its ldual names) and its
  f32 operations a voxel (PERF.md section 3; ``benchmark/roofline.py``: a
  trilinear sample of n fields 15 + 8 (2 + 2n), a SOR update 11, a residual
  9, the BFECC limiter 19 a field), on small tensors shaped as the step
  passes them.
- The same rule summed over one step's launches at the bench shape equals
  ``benchmark/roofline.py``'s bound a frame (read here, not edited).
- The launches a step that phases 4, 7, 8 and 10 hold exactly equal what one
  bench RBGS-50, multigrid and parity step and one config-4 collider step
  launch, and ``step_counts`` what one plume, fire and collider step
  launch, with the kernel library faked on the CPU: a drift in the
  program's dispatch shows here before a chip run.
"""

import contextlib
import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from hnanosolver_tpu_torch.cells import CELLS
from hnanosolver_tpu_torch.core.topology import build_topology
from hnanosolver_tpu_torch.fields import zeros_state
from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.models import collider, fire, plume
from hnanosolver_tpu_torch.ops import cuda_tables, multigrid, tables

ROOT = pathlib.Path(__file__).resolve().parents[1]
T, V, F32 = 64, 512, 4
SDT = 1.0 / 24.0 / 0.5


def _sample(n: int) -> int:
    """f32 operations of a trilinear sample of n fields (roofline.py)."""
    return 15 + 8 * (2 + 2 * n)


def _f(*shape):
    return torch.zeros(shape)


def _nbr(rows: int = T):
    return torch.zeros((rows, 27), dtype=torch.int32)


def _b(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.fixture(scope="module")
def planned():
    """Two chunks of 512 rows, the second mostly padding, with its chunk
    plans, and eight fields on it (the velocity and five scalars)."""
    tiles = np.array([(x, y, z) for x in range(9) for y in range(9) for z in range(8)])
    topo = build_topology(tiles, capacity=1024, device="cpu", plans=True)
    fields = torch.randn(8, topo.capacity, V)
    return topo, fields


def _b1d_case(planned, mode: str, has_sdf: bool):
    topo, fields = planned
    nb, f_lo = 8, 3
    tbl = tables.build_table_dual(topo, fields if not has_sdf else torch.cat(
        [fields, fields[:1]]))
    ld, vd = topo.chunk_ldual, fields[:3].contiguous()
    rows = ld.shape[0]
    per_chunk = rows // tbl.shape[0]
    named = {(t // per_chunk, int(u)) for t in range(rows) for u in ld[t].tolist()}
    read = len(named) * (nb + has_sdf if mode == "both" else nb - f_lo) * V * F32
    if mode == "both":
        ops = 18 + _sample(nb) + _sample(nb - f_lo) + (2 * (_sample(1) + 1) if has_sdf else 0)
        out = 2 * (nb - f_lo) * rows * V * F32
    else:
        ops = (6 if mode == "back" else 0) + _sample(nb - f_lo)
        out = (nb - f_lo) * rows * V * F32
    args = (tbl, ld, vd, SDT, nb, f_lo, mode, has_sdf)
    return args, {}, out, read + _b(ld, vd) + out, ops, rows


def _b11_case(planned):
    topo, fields = planned
    t27 = tables.build_table(topo, fields)
    dloc = topo.chunk_dloc
    out = cuda_tables.build_table_dual_combine_plain(t27, dloc, 8)
    octant = 64 * F32  # a copied octant of one field
    read = int((dloc != 0).sum()) * 8 * octant + dloc.shape[0] * 8 * 8 * octant
    return (t27, dloc, 8), {}, _b(out), _b(dloc) + read + _b(out), 0.0, t27.shape[0]


def _case(key: str, planned):
    """(args, kwargs, output bytes, bytes moved, ops a voxel, rows) of one
    launch of ``key`` as the step makes it."""
    nbr, p, div, mask = _nbr(), _f(T, V), _f(T, V), _f(T, V)
    vel, f8, sdf = _f(3, T, V), _f(8, T, V), _f(T, V)
    if key == "B1":  # the scalar pass: the velocity and five scalars
        out = 2 * 5 * T * V * F32
        return (nbr, f8, SDT, 3), {}, out, _b(nbr, f8) + out, 18 + _sample(8) + _sample(5), T
    if key == "B1 + SDF":
        out = 2 * 5 * T * V * F32
        return ((nbr, f8, SDT, 3, sdf), {}, out, _b(nbr, f8, sdf) + out,
                18 + _sample(8) + _sample(5) + 2 * (_sample(1) + 1), T)
    if key.startswith("B1d"):
        return _b1d_case(planned, key.split()[1], key.endswith("SDF"))
    if key == "B2":
        phi = [_f(5, T, V) for _ in range(3)]
        out = 5 * T * V * F32
        return (nbr, *phi), {}, out, _b(nbr, *phi) + out, 19.0 * 5, T
    if key == "B3":
        return (nbr, p, div, 5, 1.9, 0.25), {}, _b(p), _b(nbr, p, div, p), 11.0 * 5 + 1, T
    if key == "B4":
        return (nbr, p, div, 0, 1.9, 0.25, mask), {}, _b(p), _b(nbr, p, div, mask, p), 5.5, T
    if key == "B5":
        p0 = _f(T, V)
        return ((nbr, div, 24, 1.9, 0.25), dict(p0=p0, mask=mask), _b(p),
                _b(nbr, div, p0, mask, p), 11.0 * 24, T)
    if key == "B6":
        return (nbr, p, div, 0.5), {}, _b(p), _b(nbr, p, div, p), 9.0, T
    if key == "B7a":
        return (nbr, vel, 2.0), {}, _b(p), _b(nbr, vel, p), 6.0, T
    if key == "B7b":
        return (nbr, vel, p, 2.0), {}, _b(vel), _b(nbr, vel, p, vel), 9.0, T
    if key == "B8":
        d = _f(3, T, V)
        out = 8 * T * V * F32
        return (nbr, f8, d), {}, out, _b(nbr, f8, d) + out, float(_sample(8)), T
    if key == "B11":
        return _b11_case(planned)
    if key == "MR":  # T coarse rows from 8 T fine rows, both masks
        children, fine, fmask = (torch.zeros((T, 8), dtype=torch.int32), _f(8 * T, V),
                                 _f(8 * T, V))
        return ((children, fine, fmask, mask), {}, _b(p), _b(children, fine, fmask, mask, p),
                8.0 + 8 + 1, T)
    if key == "MP":  # T fine rows from T // 8 coarse rows, with p and the mask
        parent, octant = (torch.zeros(T, dtype=torch.int32) for _ in range(2))
        coarse = _f(T // 8, V)
        return ((parent, octant, _nbr(T // 8), coarse, p, mask), {}, _b(p),
                _b(parent, octant, _nbr(T // 8), coarse, p, mask, p), 21.0 + 1 + 1, T)
    if key == "CE":
        return (nbr, vel, sdf, 2.0, 0.1, 1.5), {}, _b(vel), _b(nbr, vel, sdf, vel), 40.0, T
    if key == "EM":  # density, fuel, temperature and the velocity, and the origins
        org, d, f, h = torch.zeros((T, 3), dtype=torch.int32), _f(T, V), _f(T, V), _f(T, V)
        out = _b(d, f, h, vel)
        return ((org, T - 2, d, f, h, vel, (1.0, 2.0, 3.0), 4.0, 0.1, 0.05, 150.0, 8.0), {}, out,
                _b(org) + 2 * out, 15.0, T)
    if key == "VC":  # the velocity read and written once; nbr not counted
        return (nbr, vel, 1 / 24, 2.0, 2.0, 1), {}, _b(vel), 2 * _b(vel), 154.0, T
    raise KeyError(key)


@pytest.mark.parametrize("key", ["B1", "B1 + SDF", "B1d both", "B1d back", "B1d fwd",
                                 "B1d both + SDF", "B2", "B3", "B4", "B5", "B6", "B7a", "B7b",
                                 "B8", "B11", "MR", "MP", "CE", "EM", "VC"])
def test_bound_ms_counts_each_kernels_bytes_and_operations(key, planned):
    args, kwargs, out_bytes, moved, ops, rows = _case(key, planned)
    k = key.split()[0]
    assert chip_smoke.ops_per_voxel(k, args, kwargs) == ops
    ms, by, got = chip_smoke.bound_ms(k, args, kwargs, out_bytes)
    assert got == moved
    t_bytes = moved / chip_smoke.HBM_BYTES_PER_S * 1e3
    t_ops = ops * rows * V / chip_smoke.F32_OPS_PER_S * 1e3
    assert (ms, by) == ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


def test_emit_bound_at_config_5_is_twelve_field_passes():
    """EM at config 5 (269,312 rows) reads six fields and writes six, and
    reads the 12-byte origin of each row: 1.9757 ms of fields at 3.35 TB/s."""
    T5 = 269_312
    fields = 12 * T5 * V * F32
    assert fields == 12 * 551_550_976
    vel, d = torch.empty((3, T5, V)), torch.empty((T5, V))
    args = (torch.empty((T5, 3), dtype=torch.int32), T5 - 209, d, torch.empty_like(d),
            torch.empty_like(d), vel, (512.0, 96.0, 512.0), 80.0, 1 / 12, 1 / 24, 150.0, 8.0)
    ms, by, moved = chip_smoke.bound_ms("EM", args, {}, 6 * T5 * V * F32)
    assert (moved, by) == (fields + T5 * 12, "bytes")
    assert ms == pytest.approx(fields / chip_smoke.HBM_BYTES_PER_S * 1e3, rel=1e-3)
    assert ms == pytest.approx(1.9757, rel=1e-3)


def test_vorticity_bound_at_fire512_is_the_benchmarks(metrics):
    """VC's bound at fire512 (33,792 rows, s = 1) is
    ``benchmark/metrics/vorticity_roofline.py``'s a frame: 415.2 MB, 0.12395
    ms at 3.35 TB/s."""
    T5 = chip_smoke.FIRE512_ROWS[1]
    vel = torch.empty((3, T5, V))
    ms, by, moved = chip_smoke.bound_ms("VC", (_nbr(T5), vel, 1 / 24, 2.0, 2.0, 1), {},
                                        _b(vel))
    assert (moved, by) == (6 * T5 * V * F32, "bytes")
    theirs = importlib.import_module("vorticity_roofline").bound_ms({"T": T5})
    assert ms == pytest.approx(theirs, rel=1e-3)
    assert ms == pytest.approx(0.12395, rel=1e-3)


@pytest.fixture(scope="module")
def metrics():
    """``benchmark/`` and ``benchmark/metrics/`` on the path, as the
    benchmark imports its readers."""
    paths = [str(ROOT / "benchmark"), str(ROOT / "benchmark" / "metrics")]
    sys.path[:0] = paths
    try:
        yield
    finally:
        for p in paths:
            sys.path.remove(p)


@pytest.fixture(scope="module")
def roofline():
    """``benchmark/roofline.py``, imported as the benchmark imports it."""
    bench = str(ROOT / "benchmark")
    sys.path.insert(0, bench)
    try:
        yield importlib.import_module("roofline")
    finally:
        sys.path.remove(bench)


def _step_launches(kind: str, Tb: int, ns: int):
    """One step's launches of ``kind`` at capacity ``Tb`` with ``ns``
    scalars, as the RBGS-50 step (B1, B2, B3) or the multigrid step's fine
    level (B6) makes them: (args, kwargs, output bytes) each."""
    nbr, p, div = _nbr(Tb), _f(Tb, V), _f(Tb, V)
    if kind == "B1":
        return [((nbr, _f(nb, Tb, V), SDT, f_lo), {}, 2 * (nb - f_lo) * Tb * V * F32)
                for nb, f_lo in ((3, 0), (3 + ns, 3))]
    if kind == "B2":
        return [((nbr, _f(n, Tb, V), _f(n, Tb, V), _f(n, Tb, V)), {}, n * Tb * V * F32)
                for n in (3, ns)]
    if kind == "B3":
        return [((nbr, p, div, 5, 1.9, 0.25), {}, _b(p))] * 10
    return [((nbr, p, div, 0.5), {}, _b(p))] * 3  # B6: FMG's fine V-cycle and 2 more


@pytest.mark.parametrize("kind, fn, extra", [
    ("B1", "bfecc_sample_ms", {}), ("B2", "bfecc_tail_ms", {}),
    ("B3", "rbsor_lagged_ms", {"lagged": [(4608, 5, 0, 10)]}),
    ("B6", "residual_ms", {"residual": [(4608, 3)]})])
def test_bounds_summed_over_a_step_equal_the_roofline(kind, fn, extra, roofline):
    Tb, ns = 4608, 5  # the bench: capacity 4608, five scalars
    mine = sum(chip_smoke.bound_ms(kind, a, kw, ob)[0] for a, kw, ob in
               _step_launches(kind, Tb, ns))
    theirs = getattr(roofline, fn)({"T": Tb, "scalars": ns, **extra})
    assert mine == pytest.approx(theirs, rel=1e-3)


class _Library:
    """A kernel library whose every entry returns success and does nothing."""

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.fixture
def faked_library(monkeypatch):
    """The wrappers take their card branch on CPU tensors and launch the
    fake library, so that their launch counters count as on the card."""
    monkeypatch.setattr(build, "on_cpu", lambda device: False)
    monkeypatch.setattr(build, "library", lambda: _Library())
    monkeypatch.setattr(build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    counters = {key: k["counter"] for key, k in chip_smoke.kernel_table().items()}
    for c in counters.values():
        monkeypatch.setattr(c, "n", 0)
    return counters


def _bench_step(cell: str):
    bench = CELLS["bench"]
    topo = bench.topology("cpu")
    params = CELLS[cell].params
    hier = multigrid.hierarchy_for(topo, params)
    return lambda: plume.plume_step(topo, zeros_state(topo), params, bench.plume, hier)


def _parity_step():
    bench = CELLS["bench"]
    topo = bench.topology("cpu")
    params = bench.params.replace(precision="parity")
    return lambda: plume.plume_step(topo, zeros_state(topo), params, bench.plume)


def _collider_step():
    c4 = CELLS["c4"]
    topo = c4.topology("cpu")
    return lambda: collider.collider_step(topo, zeros_state(topo), c4.params, c4.plume,
                                          c4.collider, 0)


def _grown_step(model: str):
    """One step of ``model`` (the plume, the fire or the collider) on the
    bench topology: (step, its parameters, the model's module)."""
    bench = CELLS["bench"]
    topo = bench.topology("cpu")
    if model == "plume":
        p_ = bench.params
        return lambda: plume.plume_step(topo, zeros_state(topo), p_, bench.plume), p_, plume
    if model == "fire":
        p_, cfg = fire.default_params(), fire.FireConfig()
        return lambda: fire.fire_step(topo, zeros_state(topo), p_, cfg), p_, fire
    c4 = CELLS["c4"]
    return (lambda: collider.collider_step(topo, zeros_state(topo), c4.params, c4.plume,
                                           c4.collider, 0), c4.params, collider)


@pytest.mark.parametrize("model", ["plume", "fire", "collider"])
def test_step_counts_are_the_programs(model, faked_library):
    """``step_counts`` with the model's EM launches (``emits``), as phases
    12, 13, 16-18 and 20 hold the steps of a growing or CLI run, against one
    step's dispatch."""
    run, p_, mod = _grown_step(model)
    for c in faked_library.values():
        c.n = 0
    run()
    counts = {key: c.n for key, c in faked_library.items() if c.n}
    want = chip_smoke.step_counts(4608, p_, chip_smoke.emits(mod))
    assert counts == {key: n for key, n in want.items() if n}


@pytest.mark.parametrize("phase, per_step, step", [
    ("4", "RBGS50_STEP", lambda: _bench_step("bench")),
    ("7", "BENCH_MG_STEP", lambda: _bench_step("bench-mg")),
    ("8", "PARITY_STEP", _parity_step),
    ("10", "C4_STEP", _collider_step)])
def test_the_launches_phases_assert_are_the_programs(phase, per_step, step, faked_library):
    run = step()
    for c in faked_library.values():
        c.n = 0
    run()
    counts = {key: c.n for key, c in faked_library.items() if c.n}
    want = {key: n for key, n in getattr(chip_smoke, per_step).items() if n}
    assert counts == want, f"phase {phase}"
