"""Kernel B5's launch shape and its plain version on the multigrid levels it
solves, on the CPU.

- ``cuda_pressure.fused_shape`` (the shape the wrapper passes to
  ``hn_rbsor_fused``, which checks the same rule) for every T from 1 to
  MAX_FUSED_ROWS: each tile has exactly one block, a block's threads hold
  its tiles' columns, the shared memory and the cluster size stay within
  the H100's limits, the main paths' levels at or below CLUSTER_ROWS (T =
  32 and 128) take the cluster form and every T above it (the main paths'
  1024 among them) the grid form.
- ``rbsor_fused_plain`` against the JAX package's ``solve_pressure_fused``
  (its Pallas kernel in interpret mode) on the bench plume's multigrid
  levels 1 (capacity 1024) and 2 (128), with their in-domain masks, at
  dx * 2^k, for 2 and 24 iterations: the smoother's and the coarsest
  solve's counts. Same sweeps in the same order; XLA may contract the SOR
  update into FMAs, so 1e-6 * max|ref| (bitwise is the usual outcome).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.ops import multigrid as jmg
from hnanosolver_tpu.ops import pallas_pressure as jpp
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch.cells import CELLS
from hnanosolver_tpu_torch.models.plume import build_plume_envelope
from hnanosolver_tpu_torch.ops import cuda_pressure as tcp
from hnanosolver_tpu_torch.ops import multigrid as tmg

torch.set_num_threads(1)

TOL = 1e-6  # x max|ref|
ALL_T = range(1, tcp.MAX_FUSED_ROWS + 1)
CLUSTER_PATH_T = (32, 128)  # config 5's level 5, the bench's and config 5's level 2 and 4


def _shapes():
    return [tcp.fused_shape(T) for T in ALL_T]


def test_every_tile_has_exactly_one_block():
    for s in _shapes():
        if s.form == "grid":  # a grid stride over any grid: tile t to block t mod grid
            assert (s.cluster, s.tiles_per_block, s.smem) == (0, 0, 0)
            continue
        # block b owns tiles [b * tpb, (b + 1) * tpb) (csrc/rbsor_fused.cu)
        owners = np.zeros(s.T, np.int64)
        for b in range(s.cluster):
            owners[b * s.tiles_per_block:(b + 1) * s.tiles_per_block] += 1
        assert (owners == 1).all(), s


def test_cluster_shapes_fit_the_card():
    for s in _shapes():
        if s.form == "grid":
            assert s.threads == tcp.GRID_THREADS
            continue
        assert 1 <= s.cluster <= tcp.MAX_CLUSTER and s.cluster & (s.cluster - 1) == 0, s
        assert s.tiles_per_block <= tcp.MAX_TILES_PER_BLOCK, s
        assert s.smem <= tcp.MAX_BLOCK_SMEM, s
        assert s.smem == s.tiles_per_block * tcp.CLUSTER_TILE_BYTES + 2048, s
        assert s.threads == s.tiles_per_block * 64 <= 1024, s  # a thread a column


@pytest.mark.parametrize("T", CLUSTER_PATH_T)
def test_main_path_levels_take_the_cluster_form(T):
    s = tcp.fused_shape(T)
    assert s.form == "cluster" and T <= tcp.CLUSTER_ROWS
    assert s.cluster == tcp.MAX_CLUSTER


@pytest.mark.parametrize("T", [tcp.CLUSTER_ROWS + 1, 1024, tcp.MAX_FUSED_ROWS])
def test_above_the_threshold_takes_the_grid_form(T):
    assert tcp.fused_shape(T).form == "grid"
    assert all(tcp.fused_shape(t).form == "cluster" for t in range(1, tcp.CLUSTER_ROWS + 1))
    assert tcp.CLUSTER_ROWS <= tcp.CLUSTER_CAPACITY


@pytest.mark.parametrize("bad", ["T0", "form", "cluster_too_large"])
def test_fused_shape_rejects(bad):
    call = {
        "T0": lambda: tcp.fused_shape(0),
        "form": lambda: tcp.fused_shape(64, "persistent"),
        "cluster_too_large": lambda: tcp.fused_shape(tcp.CLUSTER_CAPACITY + 1, "cluster"),
    }[bad]
    with pytest.raises(ValueError):
        call()


@functools.lru_cache(maxsize=None)
def _bench_levels():
    """The bench plume's JAX topology and its two multigrid levels."""
    tiles = build_plume_envelope(*CELLS["bench"].envelope)
    n = len(np.unique(tiles, axis=0))
    jt = jtopo.build_topology(tiles, capacity=((n + 1 + 511) // 512) * 512)
    return jt, jmg.build_hierarchy(jt, 2)


@pytest.mark.parametrize("iterations", [2, 24])
@pytest.mark.parametrize("level", [1, 2])
def test_plain_b5_matches_pallas_on_bench_levels(level, iterations):
    jt, jh = _bench_levels()
    lv = jh[level - 1]
    jl, mask = lv.topo, np.array(lv.mask)
    assert jl.capacity == {1: 1024, 2: 128}[level]
    tl = convert.topology_from_numpy(np.asarray(jl.keys), np.asarray(jl.origins),
                                     np.asarray(jl.nbr), int(jl.n_active), device="cpu")
    rng = np.random.default_rng(100 + level)
    div = (rng.standard_normal((jl.capacity, 512)) * mask).astype(np.float32)
    dx = CELLS["bench"].params.voxel_size * 2 ** level
    omega = CELLS["bench"].params.omega
    want = np.asarray(jpp.solve_pressure_fused(jl, jnp.asarray(div), iterations, dx, omega,
                                               interpret=True, mask=jnp.asarray(mask)))
    got = tcp.rbsor_fused(tl.nbr, torch.from_numpy(div), iterations, omega, dx * dx,
                          mask=torch.from_numpy(mask)).numpy()
    assert np.abs(want).max() > 0.01
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    assert not got[mask == 0].any()


def test_port_bench_levels_equal_jax():
    """The port's own hierarchy gives the same level tables and masks that
    the comparison above feeds both sides."""
    jt, jh = _bench_levels()
    tt = convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                     np.asarray(jt.nbr), int(jt.n_active), device="cpu")
    for jl, tl in zip(jh, tmg.build_hierarchy(tt, 2)):
        assert np.array_equal(tl.topo.nbr.numpy(), np.asarray(jl.topo.nbr))
        assert np.array_equal(tl.mask.numpy(), np.asarray(jl.mask))
