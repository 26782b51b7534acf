"""The port's pressure solve against the JAX package on the CPU.

- The lagged-halo blocks (plain B3) against the Pallas kernel run in
  interpret mode, with its packed-plane halo and with its full-face halo
  (PLANES_HALO both ways). Same sweeps in the same order; XLA may contract
  the SOR update into FMAs, so allow 1e-6 * max|p| (an ulp-scale drift over
  the sweeps) where bitwise is the usual outcome.
- The textbook per-colour form against JAX ``solve_pressure``, which takes
  that path on the CPU: same allowance, same reason.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.ops import pallas_pressure as jpp
from hnanosolver_tpu.ops import pressure as jprs
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch.ops import cuda_pressure as tcp
from hnanosolver_tpu_torch.ops import pressure as tprs

torch.set_num_threads(1)

ITERS, LAG, DX, OMEGA = 10, 5, 0.25, 1.17


@pytest.fixture(scope="module")
def dom():
    rng = np.random.default_rng(21)
    tiles = [(x, y, z) for x in range(4) for y in range(3) for z in range(3)
             if (x + 2 * y + z) % 7 != 5]
    jt = jtopo.build_topology(np.array(tiles, np.int32), capacity=64)
    tt = convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                     np.asarray(jt.nbr), int(jt.n_active))
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    div = (rng.standard_normal((tt.capacity, 512)) * m).astype(np.float32)
    return jt, tt, div


@pytest.fixture(scope="module")
def jax_lagged(dom):
    jt, _, div = dom
    out = {}
    old = jpp.PLANES_HALO
    try:
        for planes in (True, False):
            jpp.PLANES_HALO = planes
            out[planes] = np.asarray(jpp.solve_pressure_lagged(
                jt, jnp.asarray(div), ITERS, DX, OMEGA, LAG, interpret=True))
    finally:
        jpp.PLANES_HALO = old
    return out


@pytest.mark.parametrize("planes", [True, False], ids=["planes_halo", "full_face"])
def test_plain_b3_matches_pallas_interpret(dom, jax_lagged, planes):
    _, tt, div = dom
    want = jax_lagged[planes]
    got = tprs.solve_pressure(tt, torch.from_numpy(div), ITERS, DX, OMEGA,
                              halo_lag=LAG).numpy()
    assert np.abs(want).max() > 0.01
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    # the background invariant: null and padding rows stay exactly 0
    assert not got[0].any() and not got[tt.n_active + 1:].any()


def test_one_launch_is_one_lag_block(dom, jax_lagged):
    """solve_pressure at lag 5 is exactly two wrapper calls of 5 pairs."""
    _, tt, div = dom
    d = torch.from_numpy(div)
    p = torch.zeros_like(d)
    for _ in range(ITERS // LAG):
        p = tcp.rbsor_lagged(tt.nbr, p, d, LAG, OMEGA, DX * DX)
    want = tprs.solve_pressure(tt, d, ITERS, DX, OMEGA, halo_lag=LAG)
    assert torch.equal(p, want)


def test_textbook_matches_jax(dom):
    jt, tt, div = dom
    want = np.asarray(jprs.solve_pressure(jt, jnp.asarray(div), 6, DX, OMEGA))
    got = tprs.solve_pressure(tt, torch.from_numpy(div), 6, DX, OMEGA, halo_lag=1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_remainder_runs_textbook_after_blocks(dom):
    """On the CPU, iterations % halo_lag sweeps follow the lagged blocks as
    textbook sweeps (the TPU's B4 remainder)."""
    _, tt, div = dom
    d = torch.from_numpy(div)
    lagged = tprs.solve_pressure(tt, d, 5, DX, OMEGA, halo_lag=5)
    want = tprs.solve_pressure(tt, d, 2, DX, OMEGA, p0=lagged, halo_lag=1)
    got = tprs.solve_pressure(tt, d, 7, DX, OMEGA, halo_lag=5)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["dtype", "shape", "nbr_dtype", "pairs", "device"])
def test_b3_wrapper_rejects_bad_input(dom, bad):
    _, tt, div = dom
    p = torch.zeros(div.shape)
    d = torch.from_numpy(div)
    nbr = tt.nbr
    pairs = 5
    if bad == "dtype":
        p = p.double()
    elif bad == "shape":
        p = p[:, :256]
    elif bad == "nbr_dtype":
        nbr = nbr.long()
    elif bad == "pairs":
        pairs = 0
    else:
        p = p.to("meta")
    with pytest.raises(ValueError):
        tcp.rbsor_lagged(nbr, p, d, pairs, OMEGA, DX * DX)


def test_solve_pressure_rejects_lag_zero(dom):
    _, tt, div = dom
    with pytest.raises(ValueError):
        tprs.solve_pressure(tt, torch.from_numpy(div), 4, DX, OMEGA, halo_lag=0)
