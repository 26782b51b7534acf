"""The port's fire scenario (``models/fire.py``) and vorticity confinement
at ``int(factor_scale)`` >= 1 against the JAX package on the CPU.

- ``offset_view`` reads values (no arithmetic): bitwise equal to the JAX
  ``offset_view`` for offsets up to 8 voxels.
- ``curl`` and ``vorticity_confinement`` at s = 1 and 2 on a sparse
  topology (missing neighbours on every face): the same f32 operations in
  the same order, except that XLA on the CPU may contract a multiply-add
  (|omega|'s sum of squares, the cross product) into an FMA: 1e-5 times
  the field's max.
- ``emit``: the swirl takes ``rsqrt(r^2 + 1)``, which XLA and PyTorch
  compute by different routines (a few ulps): 1e-6 times the field's max.
- ``run_fire`` with its defaults (growth every frame, confinement at s =
  1) for 3 frames on a small burner: the same tile keys every frame and
  the fields within 1e-5 * max|ref|, as tests/test_torch_growth.py holds
  ``run_plume`` (JAX op by op under ``jax.disable_jit()``, ``halo_lag=1``).
  A scalar is held at no finer a scale than 1, the scale of the emitted
  fuel and soot it comes from: the burn leaves fuel at ~1e-7 of the 0.17 a
  frame emits, by cancellation, where an ulp of the inputs is all of it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.fields import FieldState as JState
from hnanosolver_tpu.models import fire as jfire
from hnanosolver_tpu.ops import shifts as jsh
from hnanosolver_tpu.ops import stencil as jstn
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch.models import fire as tfire
from hnanosolver_tpu_torch.ops import shifts as tsh
from hnanosolver_tpu_torch.ops import stencil as tstn

torch.set_num_threads(1)

REL = 1e-5
NAMES = ("density", "temperature", "fuel", "waste", "flame")


def _port_topo(jt):
    return convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                       np.asarray(jt.nbr), int(jt.n_active), device="cpu")


def _close(got, want, rel=REL, floor=0.0):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), floor))


@pytest.fixture(scope="module")
def sparse():
    rng = np.random.default_rng(71)
    box = np.array([(x, y, z) for x in range(4) for y in range(4) for z in range(4)])
    jt = jtopo.build_topology(box[rng.random(len(box)) < 0.6])
    m = np.asarray(jtopo.active_mask(jt))[None, :, None]
    vel = (rng.standard_normal((3, jt.capacity, 512)) * m).astype(np.float32)
    return jt, _port_topo(jt), vel


@pytest.mark.parametrize("off", [(1, 0, 0), (0, -1, 0), (2, 1, 0), (-1, 0, 3), (0, 0, -8),
                                 (8, -8, 5)])
def test_offset_view_bitwise(sparse, off):
    jt, tt, vel = sparse
    want = np.array(jsh.offset_view(jt, jnp.asarray(vel[0]), off))
    assert torch.equal(tsh.offset_view(tt, torch.from_numpy(vel[0]), off), torch.from_numpy(want))


def test_curl_matches(sparse):
    jt, tt, vel = sparse
    _close(tstn.curl(tt, torch.from_numpy(vel), 1.25), jstn.curl(jt, jnp.asarray(vel), 1.25))


@pytest.mark.parametrize("factor_scale", [1.0, 1.7, 2.0])
def test_vorticity_confinement_matches(sparse, factor_scale):
    """s = int(factor_scale): 1.7 truncates to 1, as the reference does."""
    jt, tt, vel = sparse
    want = jstn.vorticity_confinement(jt, jnp.asarray(vel), 0.1, 2.0, 2.0, factor_scale)
    got = tstn.vorticity_confinement(tt, torch.from_numpy(vel), 0.1, 2.0, 2.0, factor_scale)
    _close(got, want)
    assert not torch.equal(got, torch.from_numpy(vel))  # the force acts


def test_config_and_burner_match():
    assert dataclasses.asdict(tfire.FireConfig()) == dataclasses.asdict(jfire.FireConfig())
    assert (dataclasses.asdict(tfire.default_params())
            == dataclasses.asdict(jfire.default_params()))
    for pad in (0, 1, 2):
        np.testing.assert_array_equal(tfire.burner_tiles(tfire.FireConfig(), pad),
                                      jfire.burner_tiles(jfire.FireConfig(), pad))


CFG_KW = dict(center=(12.0, 8.0, 12.0), radius=7.0, height=3.0)


def test_emit_matches():
    jt, _ = jfire.initial(jfire.FireConfig(**CFG_KW))
    tt = _port_topo(jt)
    rng = np.random.default_rng(73)
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    vel = (rng.standard_normal((3, jt.capacity, 512)) * m).astype(np.float32)
    sc = {k: (rng.uniform(0, 1, (jt.capacity, 512)) * m).astype(np.float32) for k in NAMES}
    js = JState(velocity=jnp.asarray(vel), scalars={k: jnp.asarray(v) for k, v in sc.items()})
    want = jfire.emit(jt, js, jfire.FireConfig(**CFG_KW), 0.1)
    got = tfire.emit(tt, convert.state_from_numpy(vel, sc, device="cpu"),
                     tfire.FireConfig(**CFG_KW), 0.1)
    _close(got.velocity, want.velocity, 1e-6)
    assert float((got.velocity - torch.from_numpy(vel)).abs().max()) > 0  # the swirl acts
    for k in NAMES:
        _close(got.scalars[k], want.scalars[k], 1e-6)


def test_run_fire_grows_like_jax():
    params_kw = dict(iterations=8, halo_lag=1)
    frames = []

    def keep_jax(f, topo, st):
        frames.append((np.asarray(topo.keys).copy(), np.asarray(st.velocity).copy(),
                       {k: np.asarray(v).copy() for k, v in st.scalars.items()}))

    with jax.disable_jit():
        jfire.run_fire(3, jfire.default_params().replace(**params_kw),
                       jfire.FireConfig(**CFG_KW), on_frame=keep_jax)
    got = []
    tfire.run_fire(3, tfire.default_params().replace(**params_kw), tfire.FireConfig(**CFG_KW),
                   device="cpu", on_frame=lambda f, t, s: got.append((t, s)))
    assert len(got) == 3
    for (tt, ts), (keys, vel, sc) in zip(got, frames):
        np.testing.assert_array_equal(tt.keys.numpy(), keys)
        assert tt.capacity <= 2048
        _close(ts.velocity, vel)
        for k, v in ts.scalars.items():
            _close(v, sc[k], floor=1.0)
    assert got[-1][0].n_active > len(tfire.burner_tiles(tfire.FireConfig(**CFG_KW)))
    assert float(got[-1][1].scalars["flame"].max()) > 0  # combustion burnt
