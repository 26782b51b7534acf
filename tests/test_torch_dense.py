"""The port's dense oracle (``dense/ops.py``, ``dense/solver.step_dense``)
against the JAX package's, and the port's sparse machinery against the
port's own dense oracle, on the CPU.

- Each ``dense.ops`` function and ``step_dense`` on the same seeded numpy
  inputs, a 24^3 box and a non-cubic 16x24x8 box, against the JAX function
  run op by op under ``jax.disable_jit()`` (jit fuses the SOR update into
  another rounding, an ulp a sweep): within 1e-6 times the reference's
  max|.| (REL). Most come out bitwise; vorticity at s >= 1 differs by
  ~1e-7 (XLA contracts its cross product and sum of squares into FMAs).
- The port's copy of ``tests/test_parity.py``'s seven checks: a sparse
  topology covering exactly a dense box must reproduce the dense oracle,
  the port's sparse ops and ``solver.step`` (the kernels' plain versions on
  the CPU) against the port's ``step_dense``, at JAX's tolerances (1e-5 for
  divergence and advection, 1e-4 for pressure and vorticity, 2e-4 for the
  full step; bitwise for the box <-> tile round trip), and of
  ``tests/test_golden.py``'s five chained steps (5e-4).
- The full step at 64^3 with config 3's vorticity confinement (scale 2,
  s = 1) and traces of up to 2 voxels: the sparse step within the JAX
  test's 2e-4 of ``step_dense`` run in float64. The float32 oracle is the
  less exact side there: its trace positions are absolute (an ulp of
  2^-24 * 64), the confinement's normalisation amplifies that at the box's
  faces, and it lies farther from its own float64 answer than the sparse
  step does (chip_smoke phase 20 gates against the float64 oracle for this
  reason).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnanosolver_tpu.config import CombustionParams as JComb
from hnanosolver_tpu.config import SolverParams as JParams
from hnanosolver_tpu.dense import ops as JD
from hnanosolver_tpu.dense.solver import step_dense as jstep_dense
from hnanosolver_tpu_torch.config import CombustionParams, SolverParams
from hnanosolver_tpu_torch.core import layout as L
from hnanosolver_tpu_torch.core.convert import dense_to_tiles, tiles_to_dense
from hnanosolver_tpu_torch.core.topology import build_topology_dense
from hnanosolver_tpu_torch.dense import ops as D
from hnanosolver_tpu_torch.dense.solver import step_dense
from hnanosolver_tpu_torch.fields import FieldState
from hnanosolver_tpu_torch.ops import advection as adv
from hnanosolver_tpu_torch.ops import pressure as prs
from hnanosolver_tpu_torch.ops import stencil as stn
from hnanosolver_tpu_torch.solver import step
from hnanosolver_tpu_torch.tools import dense_spread as spread

# one thread: at more, this CPU's torch (MKL's vmsSqrt behind torch.sqrt)
# can compute a process's first float32 sqrt wrong in one thread's chunk,
# the confinement's first curl magnitude here (tools/first_sqrt.py,
# ROADMAP.md queue 3)
torch.set_num_threads(1)

REL = 1e-6  # port dense op vs JAX dense op, times the reference's max|.|
SHAPES = ((24, 24, 24), (16, 24, 8))
N = 24  # the parity box: 3x3x3 tiles, crosses tile seams


def smooth_fields(rng, shape=(N, N, N)):
    """``tests/test_parity.py``'s band-limited fields on a box of ``shape``
    (numpy): velocity [*shape, 3] and a Gaussian density."""
    def smooth(a):
        for ax in range(3):
            a = (np.roll(a, 1, ax) + a + np.roll(a, -1, ax)) / 3.0
        return a

    nx, ny, nz = shape
    x, y, z = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    vel = np.stack(
        [
            np.sin(2 * np.pi * y / ny) + 0.3 * smooth(rng.standard_normal(shape)),
            np.cos(2 * np.pi * z / nz) + 0.3 * smooth(rng.standard_normal(shape)),
            np.sin(2 * np.pi * x / nx) * 0.5,
        ],
        axis=-1,
    ).astype(np.float32)
    density = np.exp(
        -((x - nx / 2) ** 2 + (y - ny / 2) ** 2 + (z - nz / 2) ** 2) / (max(shape) / 4) ** 2
    ).astype(np.float32)
    return vel, density


def scalars_of(rho: np.ndarray) -> dict:
    """test_parity.py's combustion scalars from a density."""
    return {"density": rho, "temperature": (30.0 * rho).astype(np.float32),
            "fuel": (rho * 0.3).astype(np.float32), "waste": np.zeros_like(rho),
            "flame": np.zeros_like(rho)}


def _close(got: torch.Tensor, want, rel=REL):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(map(str, s)))
def box(request):
    shape = request.param
    rng = np.random.default_rng(17)
    vel, rho = smooth_fields(rng, shape)
    return shape, vel, rho, rng


def _both(fn_t, fn_j, *args):
    """``fn_t`` on tensors and ``fn_j`` (op by op) on jax arrays of the same
    numpy ``args`` (non-arrays passed as they are)."""
    ta = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
    ja = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    with jax.disable_jit():
        want = fn_j(*ja)
    return fn_t(*ta), want


@pytest.mark.parametrize("off", [(1, 0, 0), (-1, 0, 0), (0, 2, 0), (0, 0, -3), (2, -1, 1)])
def test_shifted_bitwise(box, off):
    _, vel, rho, _ = box
    for f in (rho, vel):
        got, want = _both(D._shifted, JD._shifted, f, *off)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_nearest_bitwise(box):
    shape, vel, rho, rng = box
    coords = rng.integers(-3, max(shape) + 3, (7, 11, 3)).astype(np.int32)
    for f in (rho, vel):
        got, want = _both(D.sample_nearest, JD.sample_nearest, f, coords)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_positions_bitwise(box):
    shape = box[0]
    np.testing.assert_array_equal(D.positions(shape).numpy(), np.asarray(JD.positions(shape)))


def test_sample_trilinear(box):
    """Positions inside, on and past the box's faces."""
    shape, vel, rho, rng = box
    pos = (rng.random((400, 3)) * (np.array(shape) + 4) - 2).astype(np.float32)
    for f in (rho, vel):
        _close(*_both(D.sample_trilinear, JD.sample_trilinear, f, pos))


def test_divergence_neighbor_sum_gradient(box):
    _, vel, rho, _ = box
    _close(*_both(D.divergence, JD.divergence, vel, 2.0))
    _close(*_both(D.neighbor_sum, JD.neighbor_sum, rho))
    _close(*_both(D.subtract_pressure_gradient, JD.subtract_pressure_gradient, vel, rho, 2.0))


@pytest.mark.parametrize("iterations,dx,omega", [(8, 1.0, 1.9), (5, 0.5, 1.0), (0, 1.0, 1.5)])
def test_solve_pressure(box, iterations, dx, omega):
    _, vel, _, _ = box
    div = np.array(JD.divergence(jnp.asarray(vel), 1.0))
    _close(*_both(D.solve_pressure, JD.solve_pressure, div, iterations, dx, omega))


@pytest.mark.parametrize("factor_scale", [0.5, 1.0, 2.0])
def test_vorticity_confinement(box, factor_scale):
    """s = int(factor_scale): 0 gives no gradient, 1 and 2 the offset
    curl magnitudes."""
    _, vel, _, _ = box
    _close(*_both(D.vorticity_confinement, JD.vorticity_confinement, vel, 0.1, 1.0, 2.0,
                  factor_scale))


def test_advect_bfecc(box):
    """A scalar and the velocity itself, traces past tile seams (|u| dt ~ 1)
    and past the box (no clamp in the dense oracle)."""
    _, vel, rho, _ = box
    vel2 = vel * 2.0
    _close(*_both(D.advect_bfecc, JD.advect_bfecc, vel2, rho, 0.5, 1.0))
    _close(*_both(D.advect_bfecc, JD.advect_bfecc, vel2, vel2, 0.5, 1.0))


@pytest.mark.parametrize("factor_scale", [0.5, 1.0])
def test_step_dense_matches_jax(box, factor_scale):
    _, vel, rho, _ = box
    sc = scalars_of(rho)
    comb = dict(factor_scale=factor_scale)
    got_v, got_s = step_dense(
        torch.from_numpy(vel), {k: torch.from_numpy(v) for k, v in sc.items()},
        SolverParams(dt=0.2, iterations=6, combustion=CombustionParams(**comb)))
    with jax.disable_jit():
        want_v, want_s = jstep_dense(
            jnp.asarray(vel), {k: jnp.asarray(v) for k, v in sc.items()},
            JParams(dt=0.2, iterations=6, combustion=JComb(**comb)))
    _close(got_v, want_v)
    assert sorted(got_s) == sorted(want_s)
    for k in sc:
        _close(got_s[k], want_s[k])


# -- the port's copy of tests/test_parity.py: sparse vs the port's dense oracle

def to_flat_scalar(topo, dense):
    return L.scalar_from_blocks(dense_to_tiles(topo, dense))


def to_flat_vec(topo, dense):
    return L.vec_from_blocks(dense_to_tiles(topo, dense))


def from_flat_scalar(topo, flat, shape=(N, N, N)):
    return tiles_to_dense(topo, L.scalar_to_blocks(flat), shape)


def from_flat_vec(topo, flat, shape=(N, N, N)):
    return tiles_to_dense(topo, L.vec_to_blocks(flat), shape)


def _atol(got, want, atol):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=atol)


@pytest.fixture
def setup(rng):
    topo = build_topology_dense((N, N, N), device="cpu")
    vel_np, rho_np = smooth_fields(rng)
    vel_d, rho_d = torch.from_numpy(vel_np), torch.from_numpy(rho_np)
    return topo, vel_d, rho_d, to_flat_vec(topo, vel_d), to_flat_scalar(topo, rho_d)


def test_convert_roundtrip(setup):
    topo, vel_d, rho_d, vel_t, rho_t = setup
    assert torch.equal(from_flat_vec(topo, vel_t), vel_d)
    assert torch.equal(from_flat_scalar(topo, rho_t), rho_d)


def test_divergence_parity(setup):
    topo, vel_d, _, vel_t, _ = setup
    want = D.divergence(vel_d, 2.0)
    _atol(from_flat_scalar(topo, stn.divergence(topo, vel_t, 2.0)), want, 1e-5)


def test_pressure_parity(setup):
    topo, vel_d, _, vel_t, _ = setup
    div_d = D.divergence(vel_d, 1.0)
    div_t = stn.divergence(topo, vel_t, 1.0)
    omega = SolverParams(iterations=8).omega
    want = D.solve_pressure(div_d, 8, 1.0, omega)
    got = from_flat_scalar(topo, prs.solve_pressure(topo, div_t, 8, 1.0, omega))
    _atol(got, want, 1e-4)


def test_advection_parity(setup):
    topo, vel_d, rho_d, vel_t, rho_t = setup
    want = D.advect_bfecc(vel_d, rho_d, 0.5, 1.0)
    _atol(from_flat_scalar(topo, adv.advect_scalar(topo, vel_t, rho_t, 0.5, 1.0)), want, 1e-5)


def test_velocity_advection_parity(setup):
    topo, vel_d, _, vel_t, _ = setup
    want = D.advect_bfecc(vel_d, vel_d, 0.5, 1.0)
    _atol(from_flat_vec(topo, adv.advect_velocity(topo, vel_t, 0.5, 1.0)), want, 1e-5)


def test_full_step_parity(setup):
    topo, vel_d, rho_d, vel_t, _ = setup
    scalars_d = {k: torch.from_numpy(v) for k, v in scalars_of(rho_d.numpy()).items()}
    params = SolverParams(dt=0.2, iterations=6)
    want_v, want_s = step_dense(vel_d, scalars_d, params)
    state = FieldState(velocity=vel_t,
                       scalars={k: to_flat_scalar(topo, v) for k, v in scalars_d.items()})
    out = step(topo, state, params)
    _atol(from_flat_vec(topo, out.velocity), want_v, 2e-4)
    for k in scalars_d:
        _atol(from_flat_scalar(topo, out.scalars[k]), want_s[k], 2e-4)


def test_vorticity_parity(setup):
    topo, vel_d, _, vel_t, _ = setup
    # factor_scale=1 exercises the offset-gradient path
    want = D.vorticity_confinement(vel_d, 0.1, 1.0, 2.0, 1.0)
    got = from_flat_vec(topo, stn.vorticity_confinement(topo, vel_t, 0.1, 1.0, 2.0, 1.0))
    _atol(got, want, 1e-4)


def test_five_step_golden():
    """tests/test_golden.py's five chained full steps, the port's sparse
    ``solver.step`` against the port's ``step_dense`` at 24^3: a buoyant
    blob from rest, dt and temperatures that keep traces under the sparse
    path's clamp (the dense oracle does not clamp). Catches drift that a
    single step cannot show; atol 5e-4, as there."""
    x, y, z = np.meshgrid(*(np.arange(N),) * 3, indexing="ij")
    blob = torch.from_numpy(np.exp(
        -((x - 12) ** 2 + (y - 6) ** 2 + (z - 12) ** 2) / 16.0).astype(np.float32))
    vel_d = torch.zeros((N, N, N, 3), dtype=torch.float32)
    scalars_d = {"density": blob, "temperature": 23.0 + 25.0 * blob, "fuel": 0.5 * blob,
                 "waste": torch.zeros_like(blob), "flame": torch.zeros_like(blob)}
    params = SolverParams(dt=0.1, iterations=8, voxel_size=0.5)
    topo = build_topology_dense((N, N, N), device="cpu")
    state = FieldState(velocity=to_flat_vec(topo, vel_d).contiguous(),
                       scalars={k: to_flat_scalar(topo, v) for k, v in scalars_d.items()})
    for _ in range(5):
        vel_d, scalars_d = step_dense(vel_d, scalars_d, params)
        state = step(topo, state, params)
    _atol(from_flat_vec(topo, state.velocity), vel_d, 5e-4)
    for k in scalars_d:
        _atol(from_flat_scalar(topo, state.scalars[k]), scalars_d[k], 5e-4)
    # physical sanity after 5 steps: the blob rose, every field stayed finite
    assert float(state.velocity[1].max()) > 0.01
    assert all(bool(torch.isfinite(f).all())
               for f in [state.velocity, *state.scalars.values()])


def test_full_step_with_vorticity_against_float64_oracle():
    n = 64
    vel_np, rho_np = smooth_fields(np.random.default_rng(0), (n, n, n))
    params = SolverParams(dt=0.2, iterations=6, halo_lag=1,
                          combustion=CombustionParams(vorticity_scale=2.0, factor_scale=1.0))
    vel_np *= 2.0 / (np.abs(vel_np).max() * params.dt * params.inv_voxel_size)
    vel_d = torch.from_numpy(vel_np)
    scalars_d = {k: torch.from_numpy(v) for k, v in scalars_of(rho_np).items()}
    topo = build_topology_dense((n, n, n), device="cpu")
    state = FieldState(velocity=to_flat_vec(topo, vel_d).contiguous(),
                       scalars={k: to_flat_scalar(topo, v) for k, v in scalars_d.items()})
    out = step(topo, state, params)
    want_v, want_s = step_dense(vel_d.double(), {k: v.double() for k, v in scalars_d.items()},
                                params)
    got_v = from_flat_vec(topo, out.velocity, (n, n, n)).double()
    _atol(got_v, want_v, 2e-4)
    for k in scalars_d:
        _atol(from_flat_scalar(topo, out.scalars[k], (n, n, n)).double(), want_s[k], 2e-4)
    v32, _ = step_dense(vel_d, scalars_d, params)
    assert (got_v - want_v).abs().max() < (v32.double() - want_v).abs().max()


def test_dense_spread_case():
    """``tools/dense_spread``'s case (the sparse step with config 3's
    confinement against the float64 oracle) at 32^3 on the CPU: its fields
    are test_parity.py's, the plain versions' step is bitwise the
    wrappers' (both plain on the CPU), the sparse step lies within the JAX
    parity test's 2e-4 of the oracle, and one float32 rounding of the
    confinement's input moves the oracle by less than that."""
    vel_np, rho_np = spread.smooth_box(32, 0)
    want_v, want_rho = smooth_fields(np.random.default_rng(0), (32, 32, 32))
    np.testing.assert_array_equal(vel_np, want_v)
    np.testing.assert_array_equal(rho_np, want_rho)
    r = spread.case(32, 0, torch.device("cpu"))
    assert r["bitwise_plain"]
    assert max(r["kernels"].values()) <= 2e-4
    assert max(r["one_rounding"].values()) < 2e-4
    assert r["flat_voxels"] >= 0 and len(r["kernels_worst"]["voxel"]) == 3
