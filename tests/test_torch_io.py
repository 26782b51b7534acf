"""The port's file I/O against the JAX package's, on the CPU.

- ``write_vdb`` writes byte-identical files for the same grids, values raw
  and ZIP-framed; ``state_to_vdb`` too, from the port's tensors. The
  port's blosc framing, which the JAX package reads but has no writer
  for, reads back through both packages' readers to the exact grids.
- ``read_vdb`` of a foreign-encoded corpus (``tests/foreign_vdb.py``: the
  layouts real OpenVDB writers emit) returns what the JAX package's reader
  returns, every key of every grid, and the same skipped list.
- ``write_nvdb`` / ``write_state_nvdb`` write byte-identical ``.nvdb``
  files, and ``read_nvdb`` / ``read_nvdb_to_state`` read equal arrays.
- an ``.npz`` checkpoint written by either package loads in the other
  with equal keys, origins, nbr, n_active, fields and params.
- the sparse ``.npz`` round trip gives equal results through the native
  tile builder and through its numpy path, equal to the JAX package's.
- the native library is built under ``build/`` and leaves ``native/``
  unchanged.
"""

import dataclasses
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnanosolver_tpu import config as jcfg
from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.fields import FieldState as JState
from hnanosolver_tpu.io import native as jnative
from hnanosolver_tpu.io import nvdb as jnvdb
from hnanosolver_tpu.io import state as jstate
from hnanosolver_tpu.io import vdb as jvdb
from hnanosolver_tpu_torch import config as tcfg
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch.core import topology as ttopo
from hnanosolver_tpu_torch.io import native as tnative
from hnanosolver_tpu_torch.io import nvdb as tnvdb
from hnanosolver_tpu_torch.io import state as tstate
from hnanosolver_tpu_torch.io import vdb as tvdb
from tests.foreign_vdb import ForeignGrid, write_foreign_vdb

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
NAMES = ("density", "temperature", "collision_sdf")


def _origins(rng, n, spread=600):
    """n distinct leaf origins (voxel coords) spread over several internal
    nodes, negatives included."""
    t = np.unique(rng.integers(-spread // 8, spread // 8, (3 * n, 3)), axis=0)
    return (rng.permutation(t)[:n] * 8).astype(np.int32)


def _grids(mod):
    """The same grids as each package's VdbGrid."""
    rng = np.random.default_rng(20)
    o1, o2 = _origins(rng, 40), _origins(rng, 9, 64)
    return [
        mod.VdbGrid("density", o1, rng.standard_normal((40, 512)).astype(np.float32), 0.5,
                    grid_class="fog volume"),
        mod.VdbGrid("velocity", o1, rng.standard_normal((3, 40, 512)).astype(np.float32), 0.5,
                    grid_class="staggered"),
        mod.VdbGrid("sdf", o2, rng.uniform(-3, 3, (9, 512)).astype(np.float32), 0.25,
                    grid_class="level set", background=3.0),
        mod.VdbGrid("zeros", o2, np.zeros((9, 512), np.float32), 0.25),
    ]


@pytest.mark.parametrize("compress", [False, True])
def test_write_vdb_bytes_equal_jax(tmp_path, compress):
    a, b = tmp_path / "port.vdb", tmp_path / "jax.vdb"
    tvdb.write_vdb(str(a), _grids(tvdb), compress=compress)
    jvdb.write_vdb(str(b), _grids(jvdb), compress=compress)
    assert a.read_bytes() == b.read_bytes()


def test_write_vdb_blosc_reads_back_exactly(tmp_path):
    """The blosc framing (COMPRESS_BLOSC | ACTIVE_MASK, one LZ4 buffer a
    leaf) parses through both readers to the written grids."""
    p = tmp_path / "blosc.vdb"
    grids = _grids(tvdb)
    tvdb.write_vdb(str(p), grids, compress="blosc")
    tvdb.write_vdb(str(tmp_path / "raw.vdb"), grids)
    assert p.stat().st_size < (tmp_path / "raw.vdb").stat().st_size  # the zeros compress
    for back in (tvdb.read_vdb(str(p)), jvdb.read_vdb(str(p))):
        assert [g["name"] for g in back] == [g.name for g in grids]
        for g, r in zip(grids, back):
            order = np.lexsort(r["origins"].T[::-1])  # the reader returns tree order
            want = np.lexsort(g.origins.T[::-1])
            np.testing.assert_array_equal(r["origins"][order], g.origins[want])
            vals = r["values"][..., order, :] if g.is_vec else r["values"][order]
            np.testing.assert_array_equal(vals, g.values[..., want, :] if g.is_vec
                                          else g.values[want])
            assert r["voxel_size"] == g.voxel_size
    with pytest.raises(ValueError):
        tvdb.write_vdb(str(p), grids, compress="lzma")


def _state_pair(n_tiles=30, seed=21):
    """The same topology and state in both packages (three scalars)."""
    rng = np.random.default_rng(seed)
    tiles = np.unique(rng.integers(-6, 6, (3 * n_tiles, 3)), axis=0)[:n_tiles]
    jt = jtopo.build_topology(tiles)
    T, n = jt.capacity, int(jt.n_active)
    m = ((np.arange(T) >= 1) & (np.arange(T) <= n)).astype(np.float32)[:, None]
    vel = rng.standard_normal((3, T, 512)).astype(np.float32) * m
    sc = {k: rng.standard_normal((T, 512)).astype(np.float32) * m for k in NAMES}
    js = JState(jnp.asarray(vel), {k: jnp.asarray(v) for k, v in sc.items()})
    tt = convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                     np.asarray(jt.nbr), n, device="cpu")
    return jt, js, tt, convert.state_from_numpy(vel, sc, device="cpu")


@pytest.mark.parametrize("compress", [False, True])
def test_state_to_vdb_bytes_equal_jax(tmp_path, compress):
    jt, js, tt, ts = _state_pair()
    a, b = tmp_path / "port.vdb", tmp_path / "jax.vdb"
    tvdb.state_to_vdb(str(a), tt, ts, voxel_size=0.5, compress=compress)
    jvdb.state_to_vdb(str(b), jt, js, voxel_size=0.5, compress=compress)
    assert a.read_bytes() == b.read_bytes()


def _corpus_grids(case):
    rng = np.random.default_rng(22)

    def leaves(n=6):
        o = np.unique(rng.integers(-3, 3, (n * 2, 3)), axis=0)[:n] * 8
        return o, rng.normal(size=(len(o), 512)).astype(np.float32)

    o, v = leaves()
    if case.startswith("dense-"):
        return [ForeignGrid("density", o, v, voxel_size=0.5)], case[len("dense-"):]
    if case == "partial-masks":
        codes = [0, 1, 2, 3, 4, 5, 6]
        oo = np.arange(7)[:, None] * np.array([[8, 0, 0]])
        vv = rng.normal(size=(7, 512)).astype(np.float32)
        sel = rng.random((7, 512)) < 0.5
        return [ForeignGrid("sdfish", oo, vv, leaf_masks=rng.random((7, 512)) < 0.6,
                            leaf_codes=codes, background=2.5, grid_class="level set",
                            sel_masks={3: sel[3], 4: sel[4], 5: sel[5]},
                            inactive_vals={2: (7.25,), 4: (-4.5,), 5: (-4.5, 9.0)})], "zip+mask"
    if case == "vec3-double":
        o2 = np.array([[0, 0, 0], [8, 8, 8]])
        vv = rng.normal(size=(2, 512, 3)).astype(np.float32)
        return [ForeignGrid("vel", o2, vv, value_type="vec3s", grid_class="staggered"),
                ForeignGrid("vd", o2, vv.astype(np.float64), value_type="vec3d"),
                ForeignGrid("dd", o2, vv[..., 0].astype(np.float64), value_type="double")
                ], "blosc+mask"
    if case == "half":
        return [ForeignGrid("density", o, v, half=True)], "zip+mask"
    if case == "internal-tiles":
        return [ForeignGrid("density", o[:1], v[:1],
                            int2_tiles=[((8, 0, 0), 3.5), ((0, 8, 0), -1.25)])], "zip+mask"
    if case == "root-tiles":
        return [ForeignGrid("density", o, v, root_tiles=[((4096, 0, 0), 1.5, False)]),
                ForeignGrid("bad", o, v, root_tiles=[((4096, 0, 0), 1.5, True)])], "none"
    if case == "transform":
        return [ForeignGrid("density", o, v, map_type="UniformScaleTranslateMap",
                            voxel_size=0.25, translation=(1.5, -2.0, 3.0))], "none"
    if case == "instancing":
        return [ForeignGrid("density", o, v, unique_suffix="\x1e[0]"),
                ForeignGrid("density", o, v * 0, unique_suffix="\x1e[1]",
                            instance_parent="density\x1e[0]")], "none"
    if case == "unsupported":
        return [ForeignGrid("points", o, v, value_type="int32"),
                ForeignGrid("density", o, v)], "none"
    raise KeyError(case)


CORPUS = ("dense-none", "dense-zip", "dense-blosc", "dense-zip+mask", "dense-blosc+mask",
          "dense-mask", "partial-masks", "vec3-double", "half", "internal-tiles",
          "root-tiles", "transform", "instancing", "unsupported")


def _assert_grid_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        elif k == "metadata":
            assert sorted(a[k]) == sorted(b[k])
            for mk in a[k]:
                np.testing.assert_array_equal(np.asarray(a[k][mk]), np.asarray(b[k][mk]))
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("case", CORPUS)
def test_read_foreign_vdb_equals_jax(tmp_path, case):
    grids, compress = _corpus_grids(case)
    p = str(tmp_path / "f.vdb")
    write_foreign_vdb(p, grids, compress=compress)
    sk_t, sk_j = [], []
    got, want = tvdb.read_vdb(p, skipped=sk_t), jvdb.read_vdb(p, skipped=sk_j)
    assert sk_t == sk_j
    assert len(got) == len(want) and got
    for a, b in zip(got, want):
        _assert_grid_equal(a, b)


def test_nvdb_bytes_and_arrays_equal_jax(tmp_path):
    rng = np.random.default_rng(23)
    tiles = np.unique(rng.integers(-40, 40, (60, 3)), axis=0)[:50]
    for name, vals, cls in (("density", rng.standard_normal((50, 8, 8, 8)), "fog"),
                            ("velocity", rng.standard_normal((50, 8, 8, 8, 3)), "staggered")):
        vals = vals.astype(np.float32)
        a, b = tmp_path / f"{name}_p.nvdb", tmp_path / f"{name}_j.nvdb"
        tnvdb.write_nvdb(str(a), tiles, vals, name=name, voxel_size=0.5, grid_class=cls)
        jnvdb.write_nvdb(str(b), tiles, vals, name=name, voxel_size=0.5, grid_class=cls)
        assert a.read_bytes() == b.read_bytes()
        for x, y in zip(tnvdb.read_nvdb(str(a)), jnvdb.read_nvdb(str(a))):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    jt, js, tt, ts = _state_pair()
    pt = tnvdb.write_state_nvdb(str(tmp_path / "port"), tt, ts, voxel_size=0.5, frame=3)
    pj = jnvdb.write_state_nvdb(str(tmp_path / "jax"), jt, js, voxel_size=0.5, frame=3)
    assert [os.path.basename(p) for p in pt] == [os.path.basename(p) for p in pj]
    for a, b in zip(pt, pj):
        assert Path(a).read_bytes() == Path(b).read_bytes()
    t_topo, t_st, t_vs = tnvdb.read_nvdb_to_state(pt, device="cpu")
    j_topo, j_st, j_vs = jnvdb.read_nvdb_to_state(pj)
    assert t_vs == j_vs and t_topo.n_active == int(j_topo.n_active)
    for f in ("keys", "origins", "nbr"):
        np.testing.assert_array_equal(getattr(t_topo, f).numpy(), np.asarray(getattr(j_topo, f)))
    np.testing.assert_array_equal(t_st.velocity.numpy(), np.asarray(j_st.velocity))
    assert sorted(t_st.scalars) == sorted(j_st.scalars)
    for k in t_st.scalars:
        np.testing.assert_array_equal(t_st.scalars[k].numpy(), np.asarray(j_st.scalars[k]))


def _assert_checkpoint_equal(t_loaded, j_loaded):
    (tt, ts, tp, tf), (jt, js, jp, jf) = t_loaded, j_loaded
    assert tf == jf and tt.n_active == int(jt.n_active) and tt.capacity == jt.capacity
    for f in ("keys", "origins", "nbr"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)))
    np.testing.assert_array_equal(ts.velocity.numpy(), np.asarray(js.velocity))
    assert sorted(ts.scalars) == sorted(js.scalars)
    for k in ts.scalars:
        np.testing.assert_array_equal(ts.scalars[k].numpy(), np.asarray(js.scalars[k]))
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_npz_checkpoint_crosses_packages(tmp_path, writer):
    """A checkpoint written by either package loads in both, equal."""
    jt, js, tt, ts = _state_pair()
    kw = dict(iterations=7, halo_lag=1, pressure_solver="mg", mg_tol=1e-3, has_collision=True)
    p = str(tmp_path / "ck.npz")
    if writer == "jax":
        jstate.save_npz(p, jt, js, jcfg.SolverParams(**kw), frame=5)
    else:
        tstate.save_npz(p, tt, ts, tcfg.SolverParams(**kw), frame=5)
    t_loaded = tstate.load_npz(p, device="cpu")
    _assert_checkpoint_equal(t_loaded, jstate.load_npz(p))
    assert t_loaded[2] == tcfg.SolverParams(**kw)


def test_sparse_npz_native_and_numpy_paths(tmp_path, monkeypatch):
    """save/load_sparse_npz through the native library and through its
    numpy path give the same topology and fields, equal to the JAX
    package's load of the same file and to the state written."""
    assert tnative.have_native()
    jt, js, tt, ts = _state_pair(n_tiles=60, seed=24)
    p = str(tmp_path / "sparse.npz")
    tstate.save_sparse_npz(p, tt, ts, frame=2)
    native = tstate.load_sparse_npz(p, capacity=tt.capacity, device="cpu")
    monkeypatch.setattr(tnative, "_load", lambda: None)
    assert not tnative.have_native()
    tstate.save_sparse_npz(str(tmp_path / "np.npz"), tt, ts, frame=2)
    numpy_path = tstate.load_sparse_npz(p, capacity=tt.capacity, device="cpu")
    jax_load = jstate.load_sparse_npz(p, capacity=tt.capacity)
    with np.load(p) as a, np.load(str(tmp_path / "np.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    for (t2, s2, f2) in (native, numpy_path):
        assert f2 == 2 == jax_load[2]
        for f in ("keys", "origins", "nbr"):
            np.testing.assert_array_equal(getattr(t2, f).numpy(), getattr(tt, f).numpy())
            np.testing.assert_array_equal(getattr(t2, f).numpy(), np.asarray(getattr(jax_load[0], f)))
        np.testing.assert_array_equal(s2.velocity.numpy(), ts.velocity.numpy())
        np.testing.assert_array_equal(s2.velocity.numpy(), np.asarray(jax_load[1].velocity))
        for k in NAMES:
            np.testing.assert_array_equal(s2.scalars[k].numpy(), ts.scalars[k].numpy())


def test_native_builds_under_build_and_leaves_native_alone():
    """The port compiles native/tilebuilder.cpp into build/ (never beside
    the source); the files of native/ keep their names and mtimes."""
    jnative.build_library()  # the JAX package's own library, before the snapshot

    def snapshot():
        d = REPO / "native"
        return {p.name: p.stat().st_mtime_ns for p in d.iterdir()}

    before = snapshot()
    lib = tnative.build_library(force=True)
    assert lib is not None
    assert Path(lib).resolve().parent == (REPO / "build" / "hnanosolver_tpu_torch" / "native")
    assert Path(lib).is_file()
    assert snapshot() == before
    assert tnative.have_native()
    coords = np.random.default_rng(25).integers(-90, 90, (4000, 3)).astype(np.int32)
    coords = np.unique(coords, axis=0)
    for a, b in zip(tnative.build_index(coords), jnative.build_index(coords)):
        np.testing.assert_array_equal(a, b)
