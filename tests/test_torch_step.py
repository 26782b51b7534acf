"""The port's full step and plume frames against the JAX package on the CPU.

On the CPU the JAX ``solve_pressure`` runs the textbook per-colour sweep
whatever ``halo_lag`` says, so the port is compared at
``SolverParams(halo_lag=1)``, where it runs the same textbook form.
Tolerance 1e-5 * max|ref| per field: both sides do the same f32 operations
in the same order, except that XLA on the CPU contracts some multiply-adds
into FMAs (ulp-level differences per op) which the pressure solve and the
advection carry through the frames.

The lag-5 blocks of kernel B3 (the bench domain's solve, above
MAX_FUSED_ROWS) are another relaxation order: they are compared with the
textbook solve by pressure residual.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnanosolver_tpu import config as jcfg
from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.fields import FieldState as JState
from hnanosolver_tpu.models import plume as jplume
from hnanosolver_tpu.solver import step as jstep
from hnanosolver_tpu_torch import config as tcfg
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch.core.topology import ensure_chunk_plans
from hnanosolver_tpu_torch.models import collider as tcollider
from hnanosolver_tpu_torch.models import plume as tplume
from hnanosolver_tpu_torch.ops import advection as tadv
from hnanosolver_tpu_torch.ops import combustion as tcomb
from hnanosolver_tpu_torch.ops import cuda_pressure as tcp
from hnanosolver_tpu_torch.ops import pressure as tprs
from hnanosolver_tpu_torch.ops import stencil as tstn
from hnanosolver_tpu_torch.solver import step as tstep

torch.set_num_threads(1)

NAMES = ("density", "temperature", "fuel", "waste", "flame")
REL = 1e-5
N = 24  # 3x3x3 tiles


def _port_topo(jt):
    return convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                       np.asarray(jt.nbr), int(jt.n_active), device="cpu")


def _jax_state(vel, sc):
    return JState(velocity=jnp.asarray(vel), scalars={k: jnp.asarray(v) for k, v in sc.items()})


def _dense_to_flat(jt, dense):
    """[N,N,N,...] grid (origin 0) -> [T, 512, ...] rows of the topology."""
    org = np.asarray(jt.origins)
    out = np.zeros((jt.capacity, 512) + dense.shape[3:], np.float32)
    for r in range(1, int(jt.n_active) + 1):
        x, y, z = org[r] * 8
        out[r] = dense[x:x + 8, y:y + 8, z:z + 8].reshape((512,) + dense.shape[3:])
    return out


def _assert_state_close(tstate, jstate):
    tv, ts = convert.state_to_numpy(tstate)
    want = np.asarray(jstate.velocity)
    np.testing.assert_allclose(tv, want, rtol=0, atol=REL * np.abs(want).max())
    assert sorted(ts) == sorted(jstate.scalars)
    for k, v in ts.items():
        w = np.asarray(jstate.scalars[k])
        np.testing.assert_allclose(v, w, rtol=0, atol=REL * np.abs(w).max(), err_msg=k)


@pytest.fixture(scope="module")
def box():
    """The 24^3 dense box of tests/test_parity.py with smooth fields."""
    rng = np.random.default_rng(0)
    jt = jtopo.build_topology_dense((N, N, N))
    x, y, z = np.meshgrid(*(np.arange(N),) * 3, indexing="ij")
    vel = np.stack([np.sin(2 * np.pi * y / N), np.cos(2 * np.pi * z / N),
                    0.5 * np.sin(2 * np.pi * x / N)], -1)
    vel = vel + 0.1 * rng.standard_normal(vel.shape)
    rho = np.exp(-((x - N / 2) ** 2 + (y - N / 2) ** 2 + (z - N / 2) ** 2) / (N / 4) ** 2)
    velf = np.moveaxis(_dense_to_flat(jt, vel), -1, 0).copy()
    sc = {"density": rho, "temperature": 30.0 * rho, "fuel": 0.3 * rho,
          "waste": 0.1 * rho, "flame": np.zeros_like(rho)}
    scf = {k: _dense_to_flat(jt, v) for k, v in sc.items()}
    kw = dict(dt=0.2, iterations=6, halo_lag=1)
    want = jstep(jt, _jax_state(velf, scf), jcfg.SolverParams(**kw))
    return jt, velf, scf, kw, want


def test_step_box_matches_jax(box):
    jt, velf, scf, kw, want = box
    got = tstep(_port_topo(jt), convert.state_from_numpy(velf, scf, device="cpu"),
                tcfg.SolverParams(**kw))
    _assert_state_close(got, want)


PLUME_KW = dict(dt=1.0 / 24.0, iterations=20, voxel_size=0.5)
CFG_KW = dict(center=(24.0, 12.0, 24.0), radius=8.0)


@pytest.fixture(scope="module")
def plume():
    """3 plume frames from rest on a 148-tile envelope, JAX side."""
    jt = jtopo.build_topology(tplume.build_plume_envelope(24, 64, 24, 24))
    params = jcfg.SolverParams(halo_lag=1, **PLUME_KW)
    cfg = jplume.PlumeConfig(**CFG_KW)
    T = jt.capacity
    s = _jax_state(np.zeros((3, T, 512), np.float32),
                   {n: np.zeros((T, 512), np.float32) for n in NAMES})
    frames = []
    for _ in range(3):
        s = jplume.plume_step(jt, s, params, cfg)
        frames.append(s)
    return jt, frames


def test_plume_frames_match_jax(plume):
    jt, frames = plume
    tt = _port_topo(jt)
    assert 100 <= tt.n_active <= 300
    params = tcfg.SolverParams(halo_lag=1, **PLUME_KW)
    cfg = tplume.PlumeConfig(**CFG_KW)
    got = []
    tplume.run_plume(3, params, cfg, topo=tt, grow_every=0,
                     on_frame=lambda f, t, s: got.append(s))
    assert len(got) == len(frames)
    for s, want in zip(got, frames):
        _assert_state_close(s, want)
    assert float(s.scalars["density"].max()) > 0 and float(s.velocity[1].max()) > 0


def test_default_lag_residual_within_textbook(plume, monkeypatch):
    """The default lag 5 as B3 blocks keeps the pressure residual within
    1.5x of the textbook solve's, on the divergence of a developed plume
    step; and a whole step taking that path (the plume's 256 rows counted
    as above MAX_FUSED_ROWS, as the bench's 4608 are) stays finite with a
    zero background."""
    jt, frames = plume
    tt = _port_topo(jt)
    params = tcfg.SolverParams(**PLUME_KW).replace(iterations=50)
    assert params.effective_halo_lag == 5
    cfg = tplume.PlumeConfig(**CFG_KW)
    v, sc = (np.asarray(frames[-1].velocity),
             {k: np.asarray(x) for k, x in frames[-1].scalars.items()})
    s = tplume.emit(tt, convert.state_from_numpy(v, sc, device="cpu"), cfg, params.dt)
    inv_dx, c = params.inv_voxel_size, params.combustion
    u = tadv.advect_velocity(tt, s.velocity, params.dt, inv_dx)
    div = tstn.divergence(tt, u, inv_dx)
    div = tcomb.combustion_oxygen(s.scalars["fuel"], s.scalars["waste"],
                                  s.scalars["temperature"], s.scalars["flame"], div,
                                  c.temperature_release, c.expansion_rate)[-1]

    def rl2(p):
        return float(torch.linalg.vector_norm(tprs.residual(tt, p, div, params.voxel_size)))

    lag, dx2 = params.effective_halo_lag, params.voxel_size ** 2
    p = torch.zeros_like(div)
    for _ in range(params.iterations // lag):
        p = tcp.rbsor_lagged(tt.nbr, p, div, lag, params.omega, dx2)
    r_lag = rl2(p)
    r_text = rl2(tprs.solve_pressure(tt, div, params.iterations, params.voxel_size,
                                     params.omega, halo_lag=1))
    assert r_lag <= 1.5 * r_text, (r_lag, r_text)
    monkeypatch.setattr(tcp, "MAX_FUSED_ROWS", 16)
    out = tplume.plume_step(tt, convert.state_from_numpy(v, sc, device="cpu"), params, cfg)
    for f in [out.velocity] + list(out.scalars.values()):
        assert torch.isfinite(f).all()
        assert not f[..., 0, :].any() and not f[..., tt.n_active + 1:, :].any()


def test_step_rejects_unported_branches(box, monkeypatch):
    """Nothing raises any more in the plume and collider frame loops: the
    table sampler (``INTERP = "vmem"``) on a topology with chunk plans runs
    under any ``TABLE_BYTES_BUDGET``, as the JAX package's does. This box
    is one chunk, which ``tables.pick_slices`` never splits (JAX's
    ``_pick_slices``: at most nc slices), so a budget below its tables gives
    bitwise the frame of the default budget (sliced tables:
    tests/test_torch_tables.py). Growth between frames, which raised here
    before, is ported (tests/test_torch_growth.py)."""
    jt, _, _, _, _ = box
    tt = ensure_chunk_plans(_port_topo(jt))
    assert tt.chunk_dsrc.shape[0] == 1
    monkeypatch.setattr(tadv, "INTERP", "vmem")
    runs = []
    for budget in (tadv.TABLE_BYTES_BUDGET, 1024):
        monkeypatch.setattr(tadv, "TABLE_BYTES_BUDGET", budget)
        runs.append([run(1, topo=tt, grow_every=1)
                     for run in (tplume.run_plume, tcollider.run_collider)])
    for (ta, sa), (tb, sb) in zip(*runs):
        assert torch.equal(ta.keys, tb.keys)
        assert torch.equal(sa.velocity, sb.velocity)
        assert all(torch.equal(sa.scalars[k], sb.scalars[k]) for k in sa.scalars)