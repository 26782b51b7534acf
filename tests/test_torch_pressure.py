"""The port's pressure kernels and solve against the JAX package on the CPU.

- Each kernel's plain version against its Pallas kernel run in interpret
  mode: B3 (lagged blocks, packed-plane and full-face halos, with and
  without the multigrid in-domain mask), B4 (per-colour sweeps), B5 (the
  whole textbook solve) and B6 (the residual). Same sweeps in the same
  order; XLA may contract the SOR update into FMAs, so allow 1e-6 *
  max|ref| (an ulp-scale drift over the sweeps) where bitwise is the usual
  outcome.
- ``solve_pressure``'s dispatch (B5 at T <= MAX_FUSED_ROWS, else B3 blocks
  plus B4 remainder, else B4) and its agreement with JAX ``solve_pressure``
  on the CPU (the textbook form): same allowance, same reason.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.ops import pallas_pressure as jpp
from hnanosolver_tpu.ops import pallas_stencil as jps
from hnanosolver_tpu.ops import pressure as jprs
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch.ops import cuda_pressure as tcp
from hnanosolver_tpu_torch.ops import cuda_stencil as tcs
from hnanosolver_tpu_torch.ops import pressure as tprs

torch.set_num_threads(1)

ITERS, LAG, DX, OMEGA = 10, 5, 0.25, 1.17
TOL = 1e-6  # x max|ref|


@pytest.fixture(scope="module")
def dom():
    rng = np.random.default_rng(21)
    tiles = [(x, y, z) for x in range(4) for y in range(3) for z in range(3)
             if (x + 2 * y + z) % 7 != 5]
    jt = jtopo.build_topology(np.array(tiles, np.int32), capacity=64)
    tt = convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                     np.asarray(jt.nbr), int(jt.n_active), device="cpu")
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    div = (rng.standard_normal((tt.capacity, 512)) * m).astype(np.float32)
    # a multigrid-style in-domain mask and a start value that is non-zero
    # outside it (the solvers must zero those voxels and keep them at 0)
    mask = (rng.random((tt.capacity, 512)) > 0.3).astype(np.float32) * m
    p0 = (rng.standard_normal((tt.capacity, 512)) * m).astype(np.float32)
    return jt, tt, div, mask, p0


@pytest.fixture
def above_fused(monkeypatch):
    """Make the 64-row test domain count as large: solve_pressure then
    takes its B3/B4 branches, as the bench domain (4608 rows) does."""
    monkeypatch.setattr(tcp, "MAX_FUSED_ROWS", 16)


def _close(got, want):
    assert np.abs(want).max() > 0.01
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def _lagged(tt, d, iters, lag, p=None, mask=None):
    """The lagged solve as B3 wrapper calls, one per block."""
    p = torch.zeros_like(d) if p is None else p
    if mask is not None:
        p = p * mask
    for _ in range(iters // lag):
        p = tcp.rbsor_lagged(tt.nbr, p, d, lag, OMEGA, DX * DX, mask)
    return p


@pytest.fixture(scope="module")
def jax_lagged(dom):
    jt, _, div, mask, p0 = dom
    out = {}
    old = jpp.PLANES_HALO
    try:
        for planes in (True, False):
            jpp.PLANES_HALO = planes
            out[planes] = np.asarray(jpp.solve_pressure_lagged(
                jt, jnp.asarray(div), ITERS, DX, OMEGA, LAG, interpret=True))
            out[planes, "mask"] = np.asarray(jpp.solve_pressure_lagged(
                jt, jnp.asarray(div), ITERS, DX, OMEGA, LAG, p0=jnp.asarray(p0),
                interpret=True, mask=jnp.asarray(mask)))
    finally:
        jpp.PLANES_HALO = old
    return out


@pytest.mark.parametrize("planes", [True, False], ids=["planes_halo", "full_face"])
def test_plain_b3_matches_pallas_interpret(dom, jax_lagged, planes):
    _, tt, div, _, _ = dom
    want = jax_lagged[planes]
    got = _lagged(tt, torch.from_numpy(div), ITERS, LAG).numpy()
    _close(got, want)
    # the background invariant: null and padding rows stay exactly 0
    assert not got[0].any() and not got[tt.n_active + 1:].any()


@pytest.mark.parametrize("planes", [True, False], ids=["planes_halo", "full_face"])
def test_plain_masked_b3_matches_pallas_interpret(dom, jax_lagged, planes):
    _, tt, div, mask, p0 = dom
    want = jax_lagged[planes, "mask"]
    m = torch.from_numpy(mask)
    got = _lagged(tt, torch.from_numpy(div), ITERS, LAG, torch.from_numpy(p0), m).numpy()
    _close(got, want)
    assert not got[mask == 0].any()


def test_one_launch_is_one_lag_block(dom, above_fused):
    """Above MAX_FUSED_ROWS, solve_pressure at lag 5 is exactly two B3
    wrapper calls of 5 pairs."""
    _, tt, div, _, _ = dom
    d = torch.from_numpy(div)
    want = tprs.solve_pressure(tt, d, ITERS, DX, OMEGA, halo_lag=LAG)
    assert torch.equal(_lagged(tt, d, ITERS, LAG), want)


def test_textbook_matches_jax(dom):
    jt, tt, div, _, _ = dom
    want = np.asarray(jprs.solve_pressure(jt, jnp.asarray(div), 6, DX, OMEGA))
    got = tprs.solve_pressure(tt, torch.from_numpy(div), 6, DX, OMEGA, halo_lag=1).numpy()
    _close(got, want)


def test_small_domain_lag_runs_textbook_like_jax(dom):
    """At T <= MAX_FUSED_ROWS the solve is textbook whatever halo_lag says
    (B5), as in the JAX package on every backend; a lagged solve here
    would differ from JAX by far more than the allowance."""
    jt, tt, div, _, _ = dom
    want = np.asarray(jprs.solve_pressure(jt, jnp.asarray(div), ITERS, DX, OMEGA,
                                          halo_lag=LAG))
    d = torch.from_numpy(div)
    got = tprs.solve_pressure(tt, d, ITERS, DX, OMEGA, halo_lag=LAG).numpy()
    _close(got, want)
    lagged = _lagged(tt, d, ITERS, LAG).numpy()
    assert np.abs(lagged - want).max() > 100 * TOL * np.abs(want).max()


def test_remainder_runs_textbook_after_blocks(dom, above_fused):
    """Above MAX_FUSED_ROWS, iterations % halo_lag pairs follow the lagged
    blocks as textbook colour sweeps (B4)."""
    _, tt, div, _, _ = dom
    d = torch.from_numpy(div)
    lagged = tprs.solve_pressure(tt, d, 5, DX, OMEGA, halo_lag=5)
    want = tprs.solve_pressure(tt, d, 2, DX, OMEGA, p0=lagged, halo_lag=1)
    got = tprs.solve_pressure(tt, d, 7, DX, OMEGA, halo_lag=5)
    assert torch.equal(got, want)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_plain_b4_matches_pallas_interpret(dom, masked):
    jt, tt, div, mask, p0 = dom
    m = mask if masked else None
    want = np.asarray(jpp.solve_pressure_pallas(
        jt, jnp.asarray(div), 4, DX, OMEGA, p0=jnp.asarray(p0), interpret=True,
        mask=None if m is None else jnp.asarray(m)))
    d = torch.from_numpy(div)
    tm = None if m is None else torch.from_numpy(m)
    p = torch.from_numpy(p0.copy()) if m is None else torch.from_numpy(p0) * tm
    for _ in range(4):
        for color in (0, 1):
            out = tcp.rbsor_color(tt.nbr, p, d, color, OMEGA, DX * DX, tm)
            assert out is p  # in place
    _close(p.numpy(), want)
    if masked:
        assert not p.numpy()[mask == 0].any()


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "mask"])
def test_plain_b5_matches_pallas_interpret(dom, masked):
    jt, tt, div, mask, p0 = dom
    m = mask if masked else None
    want = np.asarray(jpp.solve_pressure_fused(
        jt, jnp.asarray(div), 5, DX, OMEGA, p0=jnp.asarray(p0), interpret=True,
        mask=None if m is None else jnp.asarray(m)))
    got = tcp.rbsor_fused(tt.nbr, torch.from_numpy(div), 5, OMEGA, DX * DX,
                          p0=torch.from_numpy(p0),
                          mask=None if m is None else torch.from_numpy(m)).numpy()
    _close(got, want)
    if masked:
        assert not got[mask == 0].any()


@pytest.mark.parametrize("dx", [0.25, 0.3])
def test_plain_b6_matches_pallas_interpret(dom, dx):
    """The residual at a power-of-two dx^2 and at one that is not."""
    jt, tt, div, _, p0 = dom
    want = np.asarray(jps.residual_fused(jt, jnp.asarray(p0), jnp.asarray(div), dx,
                                         interpret=True))
    got = tcs.residual(tt.nbr, torch.from_numpy(p0), torch.from_numpy(div), dx).numpy()
    _close(got, want)
    xla = np.asarray(jprs.residual(jt, jnp.asarray(p0), jnp.asarray(div), dx))
    _close(got, xla)


@pytest.mark.parametrize("case", ["small_lag5", "small_lag1", "lag5_rem2", "lag1",
                                  "pair_blocks", "pair_blocks_lag2_rem1"])
def test_solve_pressure_dispatch(dom, monkeypatch, case):
    """Which kernel wrapper solve_pressure calls, and how often."""
    _, tt, div, _, _ = dom
    iters, kw, small = {
        "small_lag5": (7, {"halo_lag": 5}, True),
        "small_lag1": (3, {}, True),
        "lag5_rem2": (7, {"halo_lag": 5}, False),
        "lag1": (3, {}, False),
        "pair_blocks": (3, {"pair_blocks": True}, False),
        "pair_blocks_lag2_rem1": (5, {"pair_blocks": True, "halo_lag": 2}, False),
    }[case]
    want = {
        "small_lag5": {"fused": [7]},
        "small_lag1": {"fused": [3]},
        "lag5_rem2": {"lagged": [5], "color": [0, 1, 0, 1]},
        "lag1": {"color": [0, 1] * 3},
        "pair_blocks": {"lagged": [1, 1, 1]},
        "pair_blocks_lag2_rem1": {"lagged": [2, 2], "color": [0, 1]},
    }[case]
    if not small:
        monkeypatch.setattr(tcp, "MAX_FUSED_ROWS", 16)
    calls = {}
    for name, arg in (("fused", 2), ("lagged", 3), ("color", 3)):
        fn = getattr(tcp, f"rbsor_{name}")

        def spy(*a, _fn=fn, _name=name, _arg=arg, **k):
            calls.setdefault(_name, []).append(a[_arg])
            return _fn(*a, **k)

        monkeypatch.setattr(tcp, f"rbsor_{name}", spy)
    tprs.solve_pressure(tt, torch.from_numpy(div), iters, DX, OMEGA, **kw)
    assert calls == want


def test_solve_pressure_leaves_p0_alone(dom, above_fused):
    """The in-place colour sweeps work on a copy of the caller's p0."""
    _, tt, div, _, p0 = dom
    p = torch.from_numpy(p0.copy())
    tprs.solve_pressure(tt, torch.from_numpy(div), 2, DX, OMEGA, p0=p)
    assert np.array_equal(p.numpy(), p0)


@pytest.mark.parametrize("bad", ["dtype", "shape", "nbr_dtype", "pairs", "device"])
def test_b3_wrapper_rejects_bad_input(dom, bad):
    _, tt, div, _, _ = dom
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


@pytest.mark.parametrize("bad", ["b4_color", "b4_mask_shape", "b5_iterations",
                                 "b5_mask_dtype", "b5_shape", "b5_p0_shape", "b6_shape",
                                 "b6_device"])
def test_b4_b5_b6_wrappers_reject_bad_input(dom, bad):
    _, tt, div, mask, _ = dom
    d = torch.from_numpy(div)
    p = torch.zeros_like(d)
    m = torch.from_numpy(mask)
    call = {
        "b4_color": lambda: tcp.rbsor_color(tt.nbr, p, d, 2, OMEGA, DX * DX),
        "b4_mask_shape": lambda: tcp.rbsor_color(tt.nbr, p, d, 0, OMEGA, DX * DX, m[:8]),
        "b5_iterations": lambda: tcp.rbsor_fused(tt.nbr, d, -1, OMEGA, DX * DX),
        "b5_mask_dtype": lambda: tcp.rbsor_fused(tt.nbr, d, 2, OMEGA, DX * DX,
                                                 mask=m.double()),
        "b5_shape": lambda: tcp.rbsor_fused(tt.nbr, d[:, :256].contiguous(), 2, OMEGA,
                                            DX * DX),
        "b5_p0_shape": lambda: tcp.rbsor_fused(tt.nbr, d, 2, OMEGA, DX * DX, p0=p[:32]),
        "b6_shape": lambda: tcs.residual(tt.nbr, p[:, :64], d, DX),
        "b6_device": lambda: tcs.residual(tt.nbr, p.to("meta"), d, DX),
    }[bad]
    with pytest.raises(ValueError):
        call()


def test_solve_pressure_rejects_lag_zero(dom):
    _, tt, div, _, _ = dom
    with pytest.raises(ValueError):
        tprs.solve_pressure(tt, torch.from_numpy(div), 4, DX, OMEGA, halo_lag=0)
