"""The port's shifts, combustion, stencils and emitter against the JAX
package on the CPU, on a sparse topology with missing neighbours.

Tolerances: data movement (views, gathers, masks) is compared bitwise.
Where the JAX expression has a multiply feeding an add, XLA on the CPU
contracts it into one FMA while PyTorch rounds the product first, so those
results may differ by an ulp: they are held to rtol 1e-6 (a few float32
ulps) plus an atol of 1e-6 times the field's scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.fields import FieldState as JState
from hnanosolver_tpu.models import plume as jplume
from hnanosolver_tpu.ops import combustion as jcomb
from hnanosolver_tpu.ops import pressure as jprs
from hnanosolver_tpu.ops import shifts as jsh
from hnanosolver_tpu.ops import stencil as jstn
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch.models import plume as tplume
from hnanosolver_tpu_torch.ops import combustion as tcomb
from hnanosolver_tpu_torch.ops import pressure as tprs
from hnanosolver_tpu_torch.ops import shifts as tsh
from hnanosolver_tpu_torch.ops import stencil as tstn

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dom():
    rng = np.random.default_rng(7)
    box = np.array([(x, y, z) for x in range(4) for y in range(4) for z in range(3)])
    jt = jtopo.build_topology(box[rng.random(len(box)) < 0.6])
    tt = convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                     np.asarray(jt.nbr), int(jt.n_active), device="cpu")
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    T = tt.capacity
    f = (rng.standard_normal((T, 512)) * m).astype(np.float32)
    vel = (rng.standard_normal((3, T, 512)) * m).astype(np.float32)
    return jt, tt, f, vel, rng


def _close(got, want, scale=1.0):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("off", jsh.FACE_DIRS)
def test_shifted_view_bitwise(dom, off):
    jt, tt, f, _, _ = dom
    got = tsh.shifted_view(tt, torch.from_numpy(f), off).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsh.shifted_view(jt, jnp.asarray(f), off)))


def test_face_views_multi_and_neighbor_sum_bitwise(dom):
    jt, tt, _, vel, _ = dom
    got = tsh.face_views_multi(tt, torch.from_numpy(vel)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsh.face_views_multi(jt, jnp.asarray(vel))))
    # six adds, same left-to-right order, no products: bitwise
    got = tsh.neighbor_sum(tt, torch.from_numpy(vel[0])).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsh.neighbor_sum(jt, jnp.asarray(vel[0]))))


def test_table_index_equal():
    c = np.arange(-8, 16, dtype=np.int32)
    cx, cy, cz = np.meshgrid(c, c, c, indexing="ij")
    got = tsh.table_index(*(torch.from_numpy(a.copy()) for a in (cx, cy, cz))).numpy()
    want = np.asarray(jsh.table_index(jnp.asarray(cx), jnp.asarray(cy), jnp.asarray(cz)))
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0 and got.max() == 27 * 512 - 1


def test_combustion_oxygen_matches(dom):
    _, _, _, _, rng = dom
    shape = (64, 512)
    fuel = np.where(rng.random(shape) < 0.2, 0.0005, rng.random(shape)).astype(np.float32)
    waste = (rng.random(shape) * 0.8).astype(np.float32)  # some oxygen < 0
    temp = (rng.random(shape) * 100).astype(np.float32)
    flame = rng.random(shape).astype(np.float32)
    div = rng.standard_normal(shape).astype(np.float32)
    args = (fuel, waste, temp, flame, div)
    want = jcomb.combustion_oxygen(*map(jnp.asarray, args), 0.5, 0.1)
    got = tcomb.combustion_oxygen(*map(torch.from_numpy, args), 0.5, 0.1)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w), 100.0)


def test_temperature_buoyancy_matches(dom):
    _, _, _, vel, rng = dom
    temp = (rng.random(vel.shape[1:]) * 60).astype(np.float32)
    want = jcomb.temperature_buoyancy(jnp.asarray(vel), jnp.asarray(temp), 1 / 24, 23.0, 1.0)
    v = torch.from_numpy(vel)
    got = tcomb.temperature_buoyancy(v, torch.from_numpy(temp), 1 / 24, 23.0, 1.0)
    _close(got.numpy(), np.asarray(want), 10.0)
    np.testing.assert_array_equal(v.numpy(), vel)  # input left unchanged


def test_divergence_matches(dom):
    jt, tt, _, vel, _ = dom
    want = np.asarray(jstn.divergence(jt, jnp.asarray(vel), 2.0))
    got = tstn.divergence(tt, torch.from_numpy(vel), 2.0).numpy()
    _close(got, want, np.abs(want).max())


def test_subtract_pressure_gradient_matches(dom):
    jt, tt, f, vel, _ = dom
    want = np.asarray(jstn.subtract_pressure_gradient(jt, jnp.asarray(vel), jnp.asarray(f), 2.0))
    got = tstn.subtract_pressure_gradient(tt, torch.from_numpy(vel), torch.from_numpy(f), 2.0)
    _close(got.numpy(), want, np.abs(want).max())


def test_residual_matches(dom):
    jt, tt, f, vel, _ = dom
    want = np.asarray(jprs.residual(jt, jnp.asarray(f), jnp.asarray(vel[0]), 0.5))
    got = tprs.residual(tt, torch.from_numpy(f), torch.from_numpy(vel[0]), 0.5).numpy()
    _close(got, want, np.abs(want).max())


def test_vorticity_confinement_s0_identity_and_s1_raises(dom):
    """s = 0 returns the velocity itself; s = 1 (ported; it raised before)
    matches the JAX package (tests/test_torch_fire.py holds s = 1 and 2 on
    a sparse box)."""
    jt, tt, _, vel, _ = dom
    v = torch.from_numpy(vel)
    assert tstn.vorticity_confinement(tt, v, 0.1, 2.0, 1.0, 0.5) is v
    want = np.asarray(jstn.vorticity_confinement(jt, jnp.asarray(vel), 0.1, 2.0, 1.0, 1.0))
    _close(tstn.vorticity_confinement(tt, v, 0.1, 2.0, 1.0, 1.0).numpy(), want,
           np.abs(want).max())


def test_emit_matches():
    cfg_kw = dict(center=(20.0, 12.0, 20.0), radius=9.0)
    tiles = tplume.build_plume_envelope(24, 48, 20, 20)
    jt = jtopo.build_topology(tiles)
    tt = convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                     np.asarray(jt.nbr), int(jt.n_active), device="cpu")
    rng = np.random.default_rng(3)
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    T = tt.capacity
    vel = (rng.standard_normal((3, T, 512)) * m).astype(np.float32)
    sc = {n: (rng.random((T, 512)) * m * 200).astype(np.float32)
          for n in ("density", "temperature", "fuel", "waste", "flame")}
    js = jplume.emit(jt, JState(velocity=jnp.asarray(vel),
                                scalars={k: jnp.asarray(v) for k, v in sc.items()}),
                     jplume.PlumeConfig(**cfg_kw), 1 / 24)
    ts = tplume.emit(tt, convert.state_from_numpy(vel, sc, device="cpu"),
                     tplume.PlumeConfig(**cfg_kw), 1 / 24)
    tv, tsc = convert.state_to_numpy(ts)
    np.testing.assert_array_equal(tv, np.asarray(js.velocity))
    for k in sc:
        _close(tsc[k], np.asarray(js.scalars[k]), 200.0)
    np.testing.assert_array_equal(tplume.emitter_tiles(tplume.PlumeConfig(**cfg_kw)),
                                  jplume.emitter_tiles(jplume.PlumeConfig(**cfg_kw)))
