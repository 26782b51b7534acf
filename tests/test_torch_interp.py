"""The port's ``ops/interp.py`` (the one-hot trilinear contractions),
``ops/pressure.jacobi_pressure`` and the advection under each of the JAX
package's ``INTERP`` names, against the JAX package on the CPU.

- ``hat_weights`` and ``assemble_blocks`` select and move values: bitwise.
- ``trilinear_mxu`` contracts in true f32 on both sides (JAX's
  ``Precision.HIGHEST`` dot, the port's ``torch.bmm``), but the sums run in
  another order: within 1e-6 times the field's max.
- ``jacobi_pressure`` against JAX's op by op (``jax.disable_jit()``): the
  same arithmetic, within 1e-6 times the reference's max.
- ``advect_velocity`` and ``advect_scalars_fused`` with ``INTERP`` set to
  None, "gather", "mxu" and "pallas" in both packages, on a sparse
  topology with traces past the +-7 clamp: the port's one sampling path
  (B1 at order 1, B8/B9 at orders 2-4, under every name) against JAX's
  sampler of the same name (the 8-corner gather, the one-hot contractions,
  or the per-tile Pallas kernel in interpret mode), within 1e-5 times the
  field's max (the allowance of tests/test_torch_advection.py: an ulp in a
  re-trace position moves a sample by the field's gradient). JAX runs op
  by op except under "pallas". Against JAX's "mxu" also with a collision
  SDF (the probes and the no-slip tail) at trace orders 1 and 3 (JAX's RK
  stages sample through the contractions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.ops import advection as jadv
from hnanosolver_tpu.ops import interp as jint
from hnanosolver_tpu.ops import pressure as jprs
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch.ops import advection as tadv
from hnanosolver_tpu_torch.ops import interp as tint
from hnanosolver_tpu_torch.ops import pressure as tprs

torch.set_num_threads(1)

REL = 1e-6
REL_ADV = 1e-5
NAMES = ("density", "temperature", "fuel")


@pytest.fixture(scope="module")
def dom():
    """A 4^3-tile box, about 60% of the tiles active: missing neighbours on
    every face; |u| ~ 6 at sdt 0.5, so some traces reach the clamp."""
    rng = np.random.default_rng(23)
    box = np.array([(x, y, z) for x in range(4) for y in range(4) for z in range(4)])
    jt = jtopo.build_topology(box[rng.random(len(box)) < 0.6])
    tt = convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                     np.asarray(jt.nbr), int(jt.n_active), device="cpu")
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    T = tt.capacity
    vel = (rng.standard_normal((3, T, 512)) * 6.0 * m).astype(np.float32)
    scal = (rng.standard_normal((len(NAMES), T, 512)) * m).astype(np.float32)
    return jt, tt, vel, scal, rng


def _close(got: torch.Tensor, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rel * np.abs(want).max())


def test_hat_weights_and_blocks_bitwise(dom):
    _, _, _, _, rng = dom
    local = (rng.random((5, 512)) * 22.0 + 0.5).astype(np.float32)
    np.testing.assert_array_equal(tint.hat_weights(torch.from_numpy(local)).numpy(),
                                  np.asarray(jint.hat_weights(jnp.asarray(local))))
    table = rng.standard_normal((5, 27 * 512)).astype(np.float32)
    np.testing.assert_array_equal(tint.assemble_blocks(torch.from_numpy(table)).numpy(),
                                  np.asarray(jint.assemble_blocks(jnp.asarray(table))))


def test_trilinear_mxu(dom):
    """Two fields' 27-tables of a chunk at clamped displacements."""
    _, _, _, _, rng = dom
    C = 6
    tables = [rng.standard_normal((C, 27 * 512)).astype(np.float32) for _ in range(2)]
    d = [np.clip(rng.standard_normal((C, 512)) * 4.0, -6.999, 6.999).astype(np.float32)
         for _ in range(3)]
    got = tint.trilinear_mxu([torch.from_numpy(t) for t in tables],
                             *[torch.from_numpy(x) for x in d])
    want = jint.trilinear_mxu([jnp.asarray(t) for t in tables], *[jnp.asarray(x) for x in d])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _close(g, w, REL)


@pytest.mark.parametrize("iterations,dx,weight", [(6, 1.0, 1.0), (4, 0.5, 2.0 / 3.0)])
def test_jacobi_pressure(dom, iterations, dx, weight):
    jt, tt, vel, _, _ = dom
    div = vel[0] * 0.1
    got = tprs.jacobi_pressure(tt, torch.from_numpy(div), iterations, dx, weight)
    with jax.disable_jit():
        want = jprs.jacobi_pressure(jt, jnp.asarray(div), iterations, dx, weight)
    _close(got, want, REL)
    assert not got[0].any() and not got[tt.n_active + 1:].any()


@pytest.mark.parametrize("interp", [None, "gather", "mxu", "pallas"])
def test_advection_under_each_interp(dom, interp, monkeypatch):
    jt, tt, vel, scal, _ = dom
    monkeypatch.setattr(jadv, "INTERP", interp)
    monkeypatch.setattr(tadv, "INTERP", interp)
    dt, inv_dx = 0.25, 2.0
    jscal = {n: jnp.asarray(scal[i]) for i, n in enumerate(NAMES)}
    tscal = {n: torch.from_numpy(scal[i]) for i, n in enumerate(NAMES)}
    got_v = tadv.advect_velocity(tt, torch.from_numpy(vel), dt, inv_dx)
    got_s = tadv.advect_scalars_fused(tt, torch.from_numpy(vel), tscal, dt, inv_dx)
    if interp == "pallas":  # a pallas_call runs in interpret mode under jit
        want_v = jadv.advect_velocity(jt, jnp.asarray(vel), dt, inv_dx)
        want_s = jadv.advect_scalars_fused(jt, jnp.asarray(vel), jscal, dt, inv_dx)
    else:
        with jax.disable_jit():
            want_v = jadv.advect_velocity(jt, jnp.asarray(vel), dt, inv_dx)
            want_s = jadv.advect_scalars_fused(jt, jnp.asarray(vel), jscal, dt, inv_dx)
    _close(got_v, want_v, REL_ADV)
    for n in NAMES:
        _close(got_s[n], want_s[n], REL_ADV)


@pytest.mark.parametrize("order", [1, 3])
def test_mxu_with_sdf_and_rk(dom, order, monkeypatch):
    """The port runs "mxu" on its one sampling path, with a collision SDF
    (the probes rejecting traces that enter a sphere, the velocity pass's
    no-slip tail) and at trace orders 1 and 3: bitwise the default (None),
    and within REL_ADV of JAX's "gather" op by op, the same formulation
    (B1 at order 1, B8/B9 at the RK stages). At order 1 also within REL_ADV
    of JAX's "mxu" op by op. At order 3 JAX's "mxu" sums the RK stages'
    samples in another order than its own "gather", and the two differ by
    more than REL_ADV of the max on a few voxels: another rounding of the
    same samples, which the port does not copy."""
    jt, tt, vel, scal, _ = dom
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    org = np.asarray(jt.origins)[:, None, :] * 8
    col = np.arange(512)
    pos = org + np.stack([col // 64, (col // 8) % 8, col % 8], -1)[None]
    sdf = ((np.linalg.norm(pos - np.array([16.0, 15.0, 17.0]), axis=-1) - 6.0) * m)
    sdf = sdf.astype(np.float32)
    vel = vel * 0.5

    def port(interp):
        monkeypatch.setattr(tadv, "INTERP", interp)
        return (tadv.advect_velocity(tt, torch.from_numpy(vel), 0.25, 2.0,
                                     torch.from_numpy(sdf), trace_order=order),
                tadv.advect_scalar(tt, torch.from_numpy(vel), torch.from_numpy(scal[0]), 0.25,
                                   2.0, torch.from_numpy(sdf), trace_order=order))

    def ref(interp):
        monkeypatch.setattr(jadv, "INTERP", interp)
        with jax.disable_jit():
            return (jadv.advect_velocity(jt, jnp.asarray(vel), 0.25, 2.0, jnp.asarray(sdf),
                                         trace_order=order),
                    jadv.advect_scalar(jt, jnp.asarray(vel), jnp.asarray(scal[0]), 0.25, 2.0,
                                       jnp.asarray(sdf), trace_order=order))

    got = port("mxu")
    for g, d in zip(got, port(None)):
        assert torch.equal(g, d)
    for g, w in zip(got, ref("gather")):
        _close(g, w, REL_ADV)
    if order == 1:
        for g, w in zip(got, ref("mxu")):
            _close(g, w, REL_ADV)


def test_unknown_interp_raises(dom, monkeypatch):
    _, tt, vel, _, _ = dom
    monkeypatch.setattr(tadv, "INTERP", "texture")
    with pytest.raises(ValueError):
        tadv.advect_velocity(tt, torch.from_numpy(vel), 0.25, 2.0)


def test_disp_limit_is_jax_value():
    assert tadv.DISP_LIMIT == jadv.DISP_LIMIT
