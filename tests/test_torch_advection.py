"""The port's BFECC advection against the JAX package on the CPU.

- plain B1 against the Pallas megakernel ``bfecc_sample_fused`` run in
  interpret mode at ``prec="strict"`` with the 24-window (valid for every
  clamped displacement), on a JAX-built topology that carries the chunk
  plan, in velocity and scalar mode, with displacements past the +-7 clamp.
  The megakernel sums hat-weight products through f32 dots in another
  order than the 8-corner sum: the back samples phiF may differ by a few
  ulps of the field's scale (allow 4e-6 * max|phi|). The forward samples
  phiB are taken at the re-trace d + u(back)*sdt, whose position inherits
  that error from u(back); on white-noise fields the gradient reaches
  ~2*max|phi| per voxel, so allow 4e-5 * max|phi| there.
- plain B2 against ``bfecc_tail_fused`` in interpret mode: bitwise (min,
  max and clip are exact, and 0.5*x is exact so FMA contraction cannot
  change pf + 0.5*(phi0 - pb)).
- ``advect_velocity`` / ``advect_scalars_fused`` against the JAX CPU path
  (the 8-corner gather sampler): the same arithmetic, except that XLA may
  contract the re-trace d + u*sdt and the corner sums into FMAs; an ulp in
  a trace position moves a sample by ulps times the field gradient, so
  allow 1e-5 times the field's max. The same holds at trace orders 2-4,
  with and without a collision SDF (the JAX CPU path there is
  ``_advect_chunked`` with the gather sampler, one chunk of the whole
  capacity; it runs op by op under ``jax.disable_jit()``, since XLA takes
  40-60 s on the CPU to compile that path's ``lax.map`` body at each RK
  order, and under a second to run the same ops one by one), for ten scalars (two B1 batches) and for the solver's
  HNanoAdvect / HNanoAdvectVelocity entry points.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnanosolver_tpu import solver as jsolver
from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.ops import advection as jadv
from hnanosolver_tpu.ops import pallas_bfecc as jpb
from hnanosolver_tpu.ops import pallas_tail as jpt
from hnanosolver_tpu_torch import config as tcfg
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch.core.topology import ensure_chunk_plans
from hnanosolver_tpu_torch import solver as tsolver
from hnanosolver_tpu_torch.ops import advection as tadv
from hnanosolver_tpu_torch.ops import cuda_bfecc as tcb
from hnanosolver_tpu_torch.ops import cuda_tail as tct

torch.set_num_threads(1)

TOL_PHIF, TOL_PHIB = 4e-6, 4e-5  # times max|phi|, see the module doc
LIM = 7.0 - 1e-3
NAMES = ("density", "temperature", "fuel", "waste", "flame")
DT, INV_DX = 1 / 24, 2.0


@pytest.fixture(scope="module")
def dom():
    """5^3-tile box, about half the tiles active: missing neighbours on
    every face, as in the JAX package's own megakernel tests."""
    rng = np.random.default_rng(9)
    box = np.array([(x, y, z) for x in range(5) for y in range(5) for z in range(5)])
    jt = jtopo.build_topology(box[rng.random(len(box)) < 0.5])
    tt = convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                     np.asarray(jt.nbr), int(jt.n_active), device="cpu")
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    T = tt.capacity
    # |u| ~ 8 at sdt 0.5: many traces past the clamp
    vel = (rng.standard_normal((3, T, 512)) * 8.0 * m).astype(np.float32)
    scal = (rng.standard_normal((2, T, 512)) * m).astype(np.float32)
    return jt, tt, vel, scal, rng


@pytest.fixture(scope="module")
def jax_b1(dom):
    jt, _, vel, scal, _ = dom
    sdt = 0.5
    d = [jnp.clip(-jnp.asarray(vel[a]) * sdt, -LIM, LIM) for a in range(3)]
    assert float(jnp.max(jnp.abs(d[0]))) > LIM - 1e-3  # the clamp engages
    out = {}
    for mode, fields, f_lo in (("velocity", list(vel), 0),
                               ("scalars", list(vel) + list(scal), 3)):
        pf, pb = jpb.bfecc_sample_fused(
            jt, [jnp.asarray(f) for f in fields], *d, sdt, f_lo, None, "strict",
            interpret=True, win=24)
        out[mode] = (np.stack([np.asarray(a) for a in pf]),
                     np.stack([np.asarray(a) for a in pb]))
    return out


@pytest.mark.parametrize("mode", ["velocity", "scalars"])
def test_plain_b1_matches_megakernel_interpret(dom, jax_b1, mode):
    _, tt, vel, scal, _ = dom
    fields = vel if mode == "velocity" else np.concatenate([vel, scal])
    f_lo = 0 if mode == "velocity" else 3
    pf, pb = tcb.bfecc_sample(tt.nbr, torch.from_numpy(fields), 0.5, f_lo)
    want_f, want_b = jax_b1[mode]
    scale = np.abs(fields[f_lo:]).max()
    np.testing.assert_allclose(pf.numpy(), want_f, rtol=0, atol=TOL_PHIF * scale)
    np.testing.assert_allclose(pb.numpy(), want_b, rtol=0, atol=TOL_PHIB * scale)


@pytest.mark.parametrize("F", [3, 5])
def test_plain_b2_bitwise_vs_pallas_tail(dom, F):
    jt, tt, _, _, rng = dom
    T = tt.capacity
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    phi0, pf, pb = ((rng.standard_normal((F, T, 512)) * m).astype(np.float32)
                    for _ in range(3))
    want = np.asarray(jpt.bfecc_tail_fused(
        jt, jnp.asarray(phi0), jnp.asarray(pf), jnp.asarray(pb), interpret=True))
    got = tct.bfecc_tail(tt.nbr, *(torch.from_numpy(a) for a in (phi0, pf, pb)))
    np.testing.assert_array_equal(got.numpy(), want)


def _smooth_state(rng, T, m, n_scalars):
    """Band-limited random fields: tile-local smoothing of normal noise."""
    def smooth(a):
        a = a.reshape(a.shape[:-1] + (8, 8, 8))
        for ax in (-1, -2, -3):
            a = (np.roll(a, 1, ax) + a + np.roll(a, -1, ax)) / 3.0
        return a.reshape(a.shape[:-3] + (512,))

    vel = (smooth(rng.standard_normal((3, T, 512))) * 3.0 * m).astype(np.float32)
    sc = (smooth(rng.standard_normal((n_scalars, T, 512))) * m).astype(np.float32)
    return vel, sc


def test_advect_velocity_matches_jax(dom):
    jt, tt, _, _, rng = dom
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    vel, _ = _smooth_state(rng, tt.capacity, m, 1)
    dt, inv_dx = 1 / 24, 2.0
    want = np.asarray(jadv.advect_velocity(jt, jnp.asarray(vel), dt, inv_dx))
    got = tadv.advect_velocity(tt, torch.from_numpy(vel), dt, inv_dx).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_advect_scalars_fused_matches_jax(dom):
    jt, tt, _, _, rng = dom
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    vel, sc = _smooth_state(rng, tt.capacity, m, 3)
    names = ("temperature", "density", "fuel")  # unsorted on purpose
    dt, inv_dx = 1 / 24, 2.0
    want = jadv.advect_scalars_fused(
        jt, jnp.asarray(vel), {n: jnp.asarray(s) for n, s in zip(names, sc)}, dt, inv_dx)
    got = tadv.advect_scalars_fused(
        tt, torch.from_numpy(vel), {n: torch.from_numpy(s) for n, s in zip(names, sc)},
        dt, inv_dx)
    assert sorted(got) == sorted(want)
    for n in names:
        w = np.asarray(want[n])
        np.testing.assert_allclose(got[n].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_advection_rejects_unported_options(dom, monkeypatch):
    """Of the advection stage of a step, what still raises: the table
    sampler (``INTERP = "vmem"``) on tables above ``TABLE_BYTES_BUDGET``,
    which the JAX package samples in chunk slices (not ported). Vorticity
    confinement at int(factor_scale) >= 1, which raised here before, runs
    (RK2-4 traces and the collision SDF are ported)."""
    _, tt, vel, _, _ = dom
    T = tt.capacity
    st = convert.state_from_numpy(vel, {n: np.zeros((T, 512), np.float32) for n in NAMES},
                                  device="cpu")
    params = tcfg.SolverParams(combustion=tcfg.CombustionParams(factor_scale=1.0))
    out = tsolver.step(tt, st, params)
    assert torch.isfinite(out.velocity).all()
    monkeypatch.setattr(tadv, "INTERP", "vmem")
    monkeypatch.setattr(tadv, "TABLE_BYTES_BUDGET", 1024)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsolver.step(ensure_chunk_plans(tt), st, params)


@pytest.mark.parametrize("nb,f_lo", [(4, 0), (3, 3), (12, 3), (2, 0)])
def test_b1_wrapper_rejects_unsupported_modes(dom, nb, f_lo):
    _, tt, vel, _, _ = dom
    fields = torch.zeros((nb, tt.capacity, 512))
    with pytest.raises(ValueError):
        tcb.bfecc_sample(tt.nbr, fields, 0.5, f_lo)


def test_b2_wrapper_rejects_mismatched_shapes(dom):
    _, tt, _, _, _ = dom
    a = torch.zeros((3, tt.capacity, 512))
    with pytest.raises(ValueError):
        tct.bfecc_tail(tt.nbr, a, a[:2], a)
    with pytest.raises(ValueError):
        tct.bfecc_tail(tt.nbr, a, a, a.double())


def _sphere_sdf(jt, m, center, radius):
    """Index-space sphere SDF, masked as ``mask_state`` leaves it (the
    null tile then reads 0)."""
    org = np.asarray(jt.origins)[:, None, :] * 8
    col = np.arange(512)
    pos = org + np.stack([col // 64, (col // 8) % 8, col % 8], -1)[None]
    d = np.linalg.norm(pos - np.asarray(center, np.float64), axis=-1) - radius
    return (d * m).astype(np.float32)


def _assert_fields_close(got, want):
    w = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("with_sdf", [False, True])
@pytest.mark.parametrize("order", [2, 3, 4])
def test_rk_advection_matches_jax(dom, order, with_sdf):
    """RK2 (midpoint), RK3 (Ralston), RK4 backtraces through the sampler
    B8/B9 and B2, with and without SDF trace rejection, against the JAX
    CPU path: velocity self-advection and three scalars."""
    jt, tt, _, _, _ = dom
    rng = np.random.default_rng(20 + order)
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    vel, sc = _smooth_state(rng, tt.capacity, m, 3)
    vel = vel * 4.0  # traces of about a voxel
    sdf = _sphere_sdf(jt, m, (20.0, 18.0, 21.0), 8.0) if with_sdf else None
    jsdf = None if sdf is None else jnp.asarray(sdf)
    tsdf = None if sdf is None else torch.from_numpy(sdf)
    with jax.disable_jit():  # see the module doc
        want = jadv.advect_velocity(jt, jnp.asarray(vel), DT, INV_DX, sdf=jsdf,
                                    trace_order=order)
    got = tadv.advect_velocity(tt, torch.from_numpy(vel), DT, INV_DX, sdf=tsdf,
                               trace_order=order)
    _assert_fields_close(got, want)
    names = NAMES[:3]
    with jax.disable_jit():
        want = jadv.advect_scalars_fused(jt, jnp.asarray(vel),
                                         {n: jnp.asarray(s) for n, s in zip(names, sc)},
                                         DT, INV_DX, sdf=jsdf, trace_order=order)
    got = tadv.advect_scalars_fused(tt, torch.from_numpy(vel),
                                    {n: torch.from_numpy(s) for n, s in zip(names, sc)},
                                    DT, INV_DX, sdf=tsdf, trace_order=order)
    for n in names:
        _assert_fields_close(got[n], want[n])


def test_advect_ten_scalars_matches_jax(dom):
    """Ten scalars: more than B1 takes in one launch, so two batches (the
    JAX package advects any count)."""
    jt, tt, _, _, _ = dom
    rng = np.random.default_rng(31)
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    vel, sc = _smooth_state(rng, tt.capacity, m, 10)
    names = [f"s{i:02d}" for i in range(10)]
    want = jadv.advect_scalars_fused(jt, jnp.asarray(vel),
                                     {n: jnp.asarray(s) for n, s in zip(names, sc)}, DT, INV_DX)
    got = tadv.advect_scalars_fused(tt, torch.from_numpy(vel),
                                    {n: torch.from_numpy(s) for n, s in zip(names, sc)},
                                    DT, INV_DX)
    assert sorted(got) == names
    for n in names:
        _assert_fields_close(got[n], want[n])


def test_solver_advect_entry_points_match_jax(dom):
    """HNanoAdvect / HNanoAdvectVelocity (``solver.advect_scalars`` /
    ``advect_velocity``)."""
    jt, tt, _, _, _ = dom
    rng = np.random.default_rng(32)
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    vel, sc = _smooth_state(rng, tt.capacity, m, 2)
    names = ("density", "temperature")
    voxel_size = 0.5
    want = jsolver.advect_scalars(jt, jnp.asarray(vel),
                                  {n: jnp.asarray(s) for n, s in zip(names, sc)}, DT, voxel_size)
    got = tsolver.advect_scalars(tt, torch.from_numpy(vel),
                                 {n: torch.from_numpy(s) for n, s in zip(names, sc)},
                                 DT, voxel_size)
    for n in names:
        _assert_fields_close(got[n], want[n])
    _assert_fields_close(tsolver.advect_velocity(tt, torch.from_numpy(vel), DT, voxel_size),
                         jsolver.advect_velocity(jt, jnp.asarray(vel), DT, voxel_size))
    # the single-field form
    _assert_fields_close(
        tadv.advect_scalar(tt, torch.from_numpy(vel), torch.from_numpy(sc[0]), DT, INV_DX),
        jadv.advect_scalar(jt, jnp.asarray(vel), jnp.asarray(sc[0]), DT, INV_DX))
