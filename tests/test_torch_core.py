"""The port's core (config, coords, layout, topology, fields, convert)
against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
core is integer bookkeeping and data movement, so every comparison here is
bitwise.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnanosolver_tpu import config as jcfg
from hnanosolver_tpu.core import layout as jlayout
from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu import fields as jfields
from hnanosolver_tpu_torch import config as tcfg
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch import fields as tfields
from hnanosolver_tpu_torch.core import coords as tcoords
from hnanosolver_tpu_torch.core import layout as tlayout
from hnanosolver_tpu_torch.core import topology as ttopo
from hnanosolver_tpu_torch.models.plume import build_plume_envelope

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _tile_sets():
    rng = np.random.default_rng(11)
    box = np.array([(x, y, z) for x in range(5) for y in range(5) for z in range(5)])
    return {
        "dense_box": (box, None),
        "sparse_random": (box[rng.random(len(box)) < 0.5] - 2, None),
        "duplicates_negative": (np.concatenate([box, box]) - 3, 256),
        "plume_envelope": (build_plume_envelope(24, 48, 24, 24), None),
        "empty": (np.zeros((0, 3), np.int32), 16),
    }


@pytest.mark.parametrize("case", sorted(_tile_sets()))
def test_build_topology_bitwise(case):
    tiles, cap = _tile_sets()[case]
    j = jtopo.build_topology(tiles, capacity=cap)
    t = ttopo.build_topology(tiles, capacity=cap, device="cpu")
    # integer tables: exact equality
    np.testing.assert_array_equal(t.keys.numpy(), np.asarray(j.keys))
    np.testing.assert_array_equal(t.origins.numpy(), np.asarray(j.origins))
    np.testing.assert_array_equal(t.nbr.numpy(), np.asarray(j.nbr))
    assert t.n_active == int(j.n_active)
    assert t.capacity == j.capacity
    np.testing.assert_array_equal(
        ttopo.active_mask(t).numpy(), np.asarray(jtopo.active_mask(j)))


def test_build_topology_rejects_what_jax_rejects():
    with pytest.raises(ValueError):
        ttopo.build_topology(np.array([[600, 0, 0]]), device="cpu")
    with pytest.raises(ValueError):
        ttopo.build_topology(np.zeros((20, 3)) + np.arange(20)[:, None], capacity=8,
                            device="cpu")


@pytest.mark.parametrize("pair", ["SolverParams", "CombustionParams"])
def test_params_fields_and_defaults_equal(pair):
    j = getattr(jcfg, pair)
    t = getattr(tcfg, pair)
    jf = [(f.name, f.type) for f in dataclasses.fields(j)]
    tf = [(f.name, f.type) for f in dataclasses.fields(t)]
    assert [n for n, _ in tf] == [n for n, _ in jf]
    jd = dataclasses.asdict(j())
    td = dataclasses.asdict(t())
    assert td == jd


@pytest.mark.parametrize("kw", [
    {}, {"precision": "parity"}, {"halo_lag": 3}, {"voxel_size": 0.1},
    {"voxel_size": 0.25, "precision": "fast"},
])
def test_params_derived_values_equal(kw):
    j = jcfg.SolverParams(**kw)
    t = tcfg.SolverParams(**kw)
    assert t.effective_halo_lag == j.effective_halo_lag
    assert t.omega == j.omega  # same Python float expression, exact
    assert t.inv_voxel_size == j.inv_voxel_size


def test_import_leaves_jax_out():
    """Importing every module of the port pulls in no jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import hnanosolver_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k.startswith('hnanosolver_tpu.') or k == 'hnanosolver_tpu')\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_keys_pack_roundtrip():
    rng = np.random.default_rng(2)
    tc = rng.integers(-512, 512, size=(1000, 3)).astype(np.int32)
    from hnanosolver_tpu.core import coords as jc

    keys = tcoords.pack_keys_np(tc)
    np.testing.assert_array_equal(keys, jc.pack_keys_np(tc))
    np.testing.assert_array_equal(tcoords.unpack_keys_np(keys), tc)


def test_layout_column_coords_equal():
    for t, j in ((tlayout.CX, jlayout.CX), (tlayout.CY, jlayout.CY), (tlayout.CZ, jlayout.CZ)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tlayout.TILE == jlayout.TILE


def test_layout_positions_and_parity_equal():
    tiles, _ = _tile_sets()["sparse_random"]
    j = jtopo.build_topology(tiles)
    t = ttopo.build_topology(tiles, device="cpu")
    for a, b in zip(tlayout.positions_flat(t), jlayout.positions_flat(j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tlayout.parity_flat(t).numpy(),
                                  np.asarray(jlayout.parity_flat(j)))


def test_zeros_and_mask_state_equal():
    tiles, _ = _tile_sets()["sparse_random"]
    j = jtopo.build_topology(tiles)
    t = convert.topology_from_numpy(np.asarray(j.keys), np.asarray(j.origins),
                                    np.asarray(j.nbr), int(j.n_active), device="cpu")
    rng = np.random.default_rng(5)
    T = t.capacity
    vel = rng.standard_normal((3, T, 512)).astype(np.float32)
    sc = {n: rng.standard_normal((T, 512)).astype(np.float32)
          for n in ("density", "fuel")}
    jm = jfields.mask_state(j, jfields.FieldState(
        velocity=jnp.asarray(vel), scalars={k: jnp.asarray(v) for k, v in sc.items()}))
    tm = tfields.mask_state(t, convert.state_from_numpy(vel, sc, device="cpu"))
    tv, ts = convert.state_to_numpy(tm)
    # multiplication by an exact 0/1 mask: bitwise
    np.testing.assert_array_equal(tv, np.asarray(jm.velocity))
    for k in sc:
        np.testing.assert_array_equal(ts[k], np.asarray(jm.scalars[k]))
    z = tfields.zeros_state(t)
    assert z.velocity.shape == (3, T, 512) and z.velocity.dtype == torch.float32
    assert sorted(z.scalars) == sorted(jfields.zeros_state(j).scalars)


def _entry_points():
    from hnanosolver_tpu_torch.models import plume as tplume

    tiles = np.array([(0, 0, 0), (1, 0, 0)], np.int32)
    z = np.zeros((3, 16, 512), np.float32)
    return {
        "build_topology": lambda **kw: ttopo.build_topology(tiles, **kw).nbr,
        "topology_from_numpy": lambda **kw: convert.topology_from_numpy(
            np.zeros(16, np.int32), np.zeros((16, 3), np.int32),
            np.zeros((16, 27), np.int32), 0, **kw).nbr,
        "state_from_numpy": lambda **kw: convert.state_from_numpy(
            z, {"density": z[0]}, **kw).velocity,
        "initial_topology": lambda **kw: tplume.initial_topology(
            tplume.PlumeConfig(radius=4.0), **kw).nbr,
        "run_plume": lambda **kw: tplume.run_plume(
            0, cfg=tplume.PlumeConfig(radius=4.0), **kw)[0].nbr,
    }


@pytest.mark.parametrize("entry", sorted(_entry_points()))
def test_entry_points_default_to_the_card(entry):
    """Without ``device`` an entry point targets CUDA and, where no card is
    present, raises rather than running on the CPU; ``device="cpu"`` runs
    there."""
    fn = _entry_points()[entry]
    assert fn(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert fn().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


@pytest.mark.parametrize("name", ["bench", "bench-mg"])
def test_bench_cells_hold_bench_py_domain(name):
    """The chip scripts' bench cells run bench.py's domain: its plume
    envelope through the JAX package's topology at its tight capacity (4196
    tiles in 4608 rows), bitwise, stepped with bench.py's dt, voxel size and
    halo lag."""
    from bench import build_plume_envelope as bench_envelope
    from hnanosolver_tpu_torch.cells import CELLS

    cell = CELLS[name]
    tiles = bench_envelope(*cell.envelope)
    n = len(np.unique(tiles, axis=0))
    j = jtopo.build_topology(tiles, capacity=((n + 1 + 511) // 512) * 512)
    t = cell.topology("cpu")
    np.testing.assert_array_equal(t.keys.numpy(), np.asarray(j.keys))
    np.testing.assert_array_equal(t.nbr.numpy(), np.asarray(j.nbr))
    assert (t.n_active, t.capacity) == (int(j.n_active), j.capacity) == (4196, 4608)
    bench = jcfg.SolverParams(dt=1.0 / 24.0, iterations=50, voxel_size=0.5)
    for f in ("dt", "voxel_size", "effective_halo_lag", "omega"):
        assert getattr(cell.params, f) == getattr(bench, f)
