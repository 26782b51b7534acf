"""Kernels B7a (divergence) and B7b (u - grad p): the port's plain versions
against the JAX package on the CPU, on a 5^3-tile box with about half the
tiles active (missing neighbours on every face).

- plain B7a against ``divergence_fused`` (Pallas, interpret mode) and
  against ``ops/stencil.divergence``'s XLA form: bitwise. Both sides take
  the same three differences, add them left to right and multiply once, so
  there is nothing for XLA to contract into an FMA.
- plain B7b against ``subtract_gradient_fused`` (interpret mode) and the
  XLA form: within ``_close`` of tests/test_torch_ops.py (rtol 1e-6, atol
  1e-6 times the scale), since XLA on the CPU may contract vel - g*s into
  an FMA where the port rounds g*s first.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.ops import pallas_stencil as jps
from hnanosolver_tpu.ops import stencil as jstn
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch.ops import cuda_stencil as tcs
from hnanosolver_tpu_torch.ops import stencil as tstn

torch.set_num_threads(1)

INV_DX = [2.0, 1.0 / 0.3]  # an exact scale of 1 and an inexact one


@pytest.fixture(scope="module")
def dom():
    rng = np.random.default_rng(11)
    box = np.array([(x, y, z) for x in range(5) for y in range(5) for z in range(5)])
    jt = jtopo.build_topology(box[rng.random(len(box)) < 0.5])
    tt = convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                     np.asarray(jt.nbr), int(jt.n_active), device="cpu")
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    T = tt.capacity
    vel = (rng.standard_normal((3, T, 512)) * 3.0 * m).astype(np.float32)
    p = (rng.standard_normal((T, 512)) * m).astype(np.float32)
    return jt, tt, vel, p


def _close(got, want, scale):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("inv_dx", INV_DX)
def test_plain_b7a_bitwise_vs_pallas_and_xla(dom, inv_dx):
    jt, tt, vel, _ = dom
    got = tcs.divergence(tt.nbr, torch.from_numpy(vel), inv_dx).numpy()
    pallas = np.asarray(jps.divergence_fused(jt, jnp.asarray(vel), inv_dx, interpret=True))
    xla = np.asarray(jstn.divergence(jt, jnp.asarray(vel), inv_dx))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)
    # the op the step calls is the B7a wrapper
    np.testing.assert_array_equal(tstn.divergence(tt, torch.from_numpy(vel), inv_dx).numpy(), got)


@pytest.mark.parametrize("inv_dx", INV_DX)
def test_plain_b7b_vs_pallas_and_xla(dom, inv_dx):
    jt, tt, vel, p = dom
    got = tcs.subtract_gradient(tt.nbr, torch.from_numpy(vel), torch.from_numpy(p),
                                inv_dx).numpy()
    pallas = np.asarray(jps.subtract_gradient_fused(jt, jnp.asarray(vel), jnp.asarray(p),
                                                    inv_dx, interpret=True))
    xla = np.asarray(jstn.subtract_pressure_gradient(jt, jnp.asarray(vel), jnp.asarray(p),
                                                     inv_dx))
    _close(got, pallas, np.abs(pallas).max())
    _close(got, xla, np.abs(xla).max())
    np.testing.assert_array_equal(
        tstn.subtract_pressure_gradient(tt, torch.from_numpy(vel), torch.from_numpy(p),
                                        inv_dx).numpy(), got)


def test_stencil_wrappers_reject_bad_inputs(dom):
    _, tt, vel, p = dom
    v, q = torch.from_numpy(vel), torch.from_numpy(p)
    bad = {
        "b7a_shape": lambda: tcs.divergence(tt.nbr, v[:2], 2.0),
        "b7a_dtype": lambda: tcs.divergence(tt.nbr, v.double(), 2.0),
        "b7a_strided": lambda: tcs.divergence(
            tt.nbr, v.permute(1, 0, 2).contiguous().permute(1, 0, 2), 2.0),
        "b7b_p_shape": lambda: tcs.subtract_gradient(tt.nbr, v, q[:, :64], 2.0),
        "b7b_device": lambda: tcs.subtract_gradient(tt.nbr, v.to("meta"), q, 2.0),
    }
    for name, call in bad.items():
        with pytest.raises(ValueError):
            call()
