"""Kernel B8/B9 (sample at displacement) and B1 with a collision SDF: the
port's plain versions against the JAX package's Pallas kernels, run in
interpret mode on the CPU, on a 5^3-tile box with about half the tiles
active (missing neighbours on every face).

- plain ``sample_at`` against B8 (``pallas_interp2.sample_tables``,
  ``prec="strict"``) and B9 (``pallas_interp.sample_fields_pallas``), with
  displacements up to the +-7 clamp. Both Pallas kernels sum hat-weight
  products through f32 dots in another order than the 8-corner sum, so
  allow 4e-6 of the field's scale (a few ulps), as for B1 in
  tests/test_torch_advection.py.
- plain B1 with an SDF against ``bfecc_sample_fused(..., sdf, "strict",
  interpret=True, win=24)`` in velocity and scalar mode, with traces
  rejected at both probes: phiF within 4e-6 and phiB within 4e-5 of the
  field's scale (the module doc of tests/test_torch_advection.py says why).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.ops import pallas_bfecc as jpb
from hnanosolver_tpu.ops import pallas_interp as jpi
from hnanosolver_tpu.ops import pallas_interp2 as jpi2
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch.ops import cuda_bfecc as tcb
from hnanosolver_tpu_torch.ops import cuda_sample as tsa

torch.set_num_threads(1)

TOL_PHIF, TOL_PHIB = 4e-6, 4e-5  # times max|phi|, see the module doc
LIM = 7.0 - 1e-3
SDT = 0.5


@pytest.fixture(scope="module")
def dom():
    rng = np.random.default_rng(13)
    box = np.array([(x, y, z) for x in range(5) for y in range(5) for z in range(5)])
    jt = jtopo.build_topology(box[rng.random(len(box)) < 0.5])
    tt = convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                     np.asarray(jt.nbr), int(jt.n_active), device="cpu")
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    T = tt.capacity
    vel = (rng.standard_normal((3, T, 512)) * 8.0 * m).astype(np.float32)
    scal = (rng.standard_normal((3, T, 512)) * m).astype(np.float32)
    d = np.clip(rng.uniform(-9.0, 9.0, (3, T, 512)), -LIM, LIM).astype(np.float32)
    # a sphere SDF in the box, masked as mask_state leaves it (null tile 0)
    org = np.asarray(jt.origins)[:, None, :] * 8
    col = np.arange(512)
    pos = org + np.stack([col // 64, (col // 8) % 8, col % 8], -1)[None]
    sdf = ((np.linalg.norm(pos - np.array([19.5, 20.5, 18.0]), axis=-1) - 9.0) * m)
    return jt, tt, vel, scal, d, sdf.astype(np.float32)


@pytest.mark.parametrize("n", [1, 3])
def test_plain_sample_at_matches_b8(dom, n):
    jt, tt, vel, scal, d, _ = dom
    fields = np.concatenate([vel, scal])[:n]
    tables = jpi2.build_tables(jt, [jnp.asarray(f) for f in fields])
    want = np.stack([np.asarray(a) for a in jpi2.sample_tables(
        jt, tables, 0, n, *(jnp.asarray(a) for a in d), "strict", interpret=True)])
    got = tsa.sample_at(tt.nbr, torch.from_numpy(fields), torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_PHIF * np.abs(fields).max())


@pytest.mark.parametrize("n", [1, 3])
def test_plain_sample_at_matches_b9(dom, n):
    jt, tt, vel, scal, d, _ = dom
    fields = np.concatenate([scal, vel])[:n]
    want = np.stack([np.asarray(a) for a in jpi.sample_fields_pallas(
        jt.nbr, [jnp.asarray(f) for f in fields], *(jnp.asarray(a) for a in d),
        interpret=True)])
    got = tsa.sample_at(tt.nbr, torch.from_numpy(fields), torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL_PHIF * np.abs(fields).max())


def test_sample_at_zero_displacement_is_exact(dom):
    """At d = 0 the sample is the field itself, bitwise (one corner of
    weight 1, seven of weight 0): a trace rejected to d = 0 leaves a field
    unchanged."""
    _, tt, vel, scal, d, _ = dom
    fields = torch.from_numpy(np.concatenate([vel, scal]))
    got = tsa.sample_at(tt.nbr, fields, torch.zeros_like(torch.from_numpy(d)))
    np.testing.assert_array_equal(got.numpy(), fields.numpy())


def _rejections(tt, fields, sdf):
    """(traces rejected at the back probe, at the re-trace probe), counted
    with the plain samplers as B1 runs them."""
    nbr, f, s = tt.nbr, torch.from_numpy(fields), torch.from_numpy(sdf)[None]
    d = torch.clamp(-f[:3] * SDT, -LIM, LIM)
    hit = tsa.sample_at_plain(nbr, s, d)[0] < 0
    d = torch.where(hit, 0.0, d)
    d2 = torch.clamp(d + tsa.sample_at_plain(nbr, f[:3], d) * SDT, -LIM, LIM)
    hit2 = tsa.sample_at_plain(nbr, s, d2)[0] < 0
    act = slice(1, tt.n_active + 1)
    return int(hit[act].sum()), int(hit2[act].sum())


@pytest.mark.parametrize("mode", ["velocity", "scalars"])
def test_plain_b1_sdf_matches_megakernel_interpret(dom, mode):
    jt, tt, vel, scal, _, sdf = dom
    fields = vel if mode == "velocity" else np.concatenate([vel, scal[:2]])
    f_lo = 0 if mode == "velocity" else 3
    back, fwd = _rejections(tt, fields, sdf)
    assert back > 100 and fwd > 100, (back, fwd)
    d = [jnp.clip(-jnp.asarray(vel[a]) * SDT, -LIM, LIM) for a in range(3)]
    pf, pb = jpb.bfecc_sample_fused(jt, [jnp.asarray(f) for f in fields], *d, SDT, f_lo,
                                    jnp.asarray(sdf), "strict", interpret=True, win=24)
    want_f = np.stack([np.asarray(a) for a in pf])
    want_b = np.stack([np.asarray(a) for a in pb])
    got_f, got_b = tcb.bfecc_sample(tt.nbr, torch.from_numpy(fields), SDT, f_lo,
                                    torch.from_numpy(sdf))
    scale = np.abs(fields[f_lo:]).max()
    np.testing.assert_allclose(got_f.numpy(), want_f, rtol=0, atol=TOL_PHIF * scale)
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=0, atol=TOL_PHIB * scale)
    # the SDF changed the result: rejection is not a no-op here
    plain_f, _ = tcb.bfecc_sample(tt.nbr, torch.from_numpy(fields), SDT, f_lo)
    assert not torch.equal(plain_f, got_f)


def test_sample_at_wrapper_rejects_bad_inputs(dom):
    _, tt, vel, _, d, _ = dom
    f, dd = torch.from_numpy(vel), torch.from_numpy(d)
    bad = {
        "no_fields": lambda: tsa.sample_at(tt.nbr, f[:0], dd),
        "d_shape": lambda: tsa.sample_at(tt.nbr, f, dd[:2]),
        "d_dtype": lambda: tsa.sample_at(tt.nbr, f, dd.double()),
        "fields_2d": lambda: tsa.sample_at(tt.nbr, f[0], dd),
        "sdf_shape": lambda: tcb.bfecc_sample(tt.nbr, f, SDT, 0, f[0, :, :64]),
    }
    for name, call in bad.items():
        with pytest.raises(ValueError):
            call()
