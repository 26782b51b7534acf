"""The port's table sampler against the JAX package on the CPU.

- Chunk plans (``chunk_uniq/lnbr/dsrc/ldual/dloc``): equal to the JAX
  package's arrays, on a sparse 5^3 box, a dense 16^3 box and a two-chunk
  box.
- ``tables.build_table`` / ``build_table_dual`` and B11's plain version:
  bitwise equal to the JAX package's XLA ``build_table`` /
  ``build_table_dual`` (they copy values, no arithmetic), and B11 bitwise
  equal to ``build_table_dual``.
- The dual-table B1's plain version against the Pallas megakernel
  ``bfecc_sample_fused(..., win=16, dual=True)`` in interpret mode at
  ``prec="strict"``, modes "both" (with and without the SDF), "back" and
  "fwd". The megakernel sums hat-weight products through f32 dots in
  another order than the 8-corner sum, so samples differ by ulps of the
  field's scale: 4e-6 * max|phi| for samples at given positions, 4e-5 *
  max|phi| for samples at the in-kernel re-trace (whose position inherits
  the back sample's error), as in tests/test_torch_advection.py. Against
  the nbr-form B1 and B8/B9 the dual B1 is bitwise: the same trilinear on
  the same corner values.
- ``advection`` with ``INTERP = "vmem"`` in the narrow, mixed and wide
  bands against the JAX package's ``_advect_vmem`` (same tolerances), with
  ``COMBINE_TBL`` on and off bitwise equal to each other; against the
  port's nbr path bitwise in the narrow band.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.ops import advection as jadv
from hnanosolver_tpu.ops import pallas_bfecc as jpb
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch.core import topology as ttopo
from hnanosolver_tpu_torch.core.layout import positions_flat
from hnanosolver_tpu_torch.ops import advection as tadv
from hnanosolver_tpu_torch.ops import cuda_bfecc as tcb
from hnanosolver_tpu_torch.ops import cuda_sample as tcs
from hnanosolver_tpu_torch.ops import cuda_tables as tct
from hnanosolver_tpu_torch.ops import tables as ttab

torch.set_num_threads(1)

TOL_AT, TOL_RETRACE = 4e-6, 4e-5  # times max|phi|, see the module doc
PLANS = ("chunk_uniq", "chunk_lnbr", "chunk_dsrc", "chunk_ldual", "chunk_dloc")


def _sparse_tiles():
    rng = np.random.default_rng(9)
    box = np.array([(x, y, z) for x in range(5) for y in range(5) for z in range(5)])
    return box[rng.random(len(box)) < 0.5], None


def _dense_tiles():
    return np.array([(x, y, z) for x in range(2) for y in range(2) for z in range(2)]), None


def _two_chunk_tiles():
    """648 tiles at capacity 1024: two sampling chunks, the second part
    padding."""
    return np.array([(x, y, z) for x in range(9) for y in range(9) for z in range(8)]), 1024


BOXES = {"sparse5": _sparse_tiles, "dense16": _dense_tiles, "two_chunks": _two_chunk_tiles}


def _pair(name):
    """(JAX topology with chunk_dloc, port topology with its plans)."""
    tiles, cap = BOXES[name]()
    jt = jtopo.ensure_dual_local(jtopo.build_topology(tiles, capacity=cap))
    tt = ttopo.build_topology(tiles, capacity=cap, device="cpu", plans=True)
    return jt, tt


@pytest.fixture(scope="module")
def sparse():
    jt, tt = _pair("sparse5")
    rng = np.random.default_rng(31)
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    fields = (rng.standard_normal((12, tt.capacity, 512)) * m).astype(np.float32)
    return jt, tt, fields, m


@pytest.mark.parametrize("name", sorted(BOXES))
def test_chunk_plans_equal_jax(name):
    jt, tt = _pair(name)
    for f in PLANS:
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)),
                                      err_msg=f)
    # on demand from a plain topology, and carried across by convert (with
    # chunk_dloc, or without it as the JAX package builds its plans)
    args = (np.asarray(jt.keys), np.asarray(jt.origins), np.asarray(jt.nbr), int(jt.n_active))
    bare = convert.topology_from_numpy(*args, device="cpu")
    assert bare.chunk_dsrc is None and bare.chunk_dloc is None
    late = ttopo.ensure_chunk_plans(bare)
    carried = convert.topology_from_numpy(
        *args, device="cpu", **{f: np.asarray(getattr(jt, f)) for f in PLANS})
    no_dloc = convert.topology_from_numpy(
        *args, device="cpu", **{f: np.asarray(getattr(jt, f)) for f in PLANS[:4]})
    for f in PLANS:
        assert torch.equal(getattr(late, f), getattr(tt, f)), f
        assert torch.equal(getattr(carried, f), getattr(tt, f)), f
        assert torch.equal(getattr(no_dloc, f), getattr(tt, f)), f
    assert ttopo.ensure_chunk_plans(tt) is tt
    with pytest.raises(TypeError):  # the plans come all or none
        convert.topology_from_numpy(*args, device="cpu", chunk_dsrc=np.asarray(jt.chunk_dsrc))


def test_plain_build_leaves_plans_out():
    tiles, _ = _sparse_tiles()
    tt = ttopo.build_topology(tiles, device="cpu")
    assert all(getattr(tt, f) is None for f in PLANS)
    planned = ttopo.build_topology(tiles, device="cpu", plans=True)
    assert all(getattr(planned, f) is not None for f in PLANS)  # chunk_dloc with the rest
    assert ttopo.ensure_chunk_plans(planned) is planned


@pytest.mark.parametrize("nf", [1, 3, 5, 9])
def test_tables_bitwise_equal_jax(sparse, nf):
    """nf = 9: eight base fields and the SDF, the scalar pass's table with a
    collider."""
    jt, tt, fields, _ = sparse
    f = fields[:nf]
    jf = [jnp.asarray(a) for a in f]
    tf = torch.from_numpy(f)
    t27 = ttab.build_table(tt, tf)
    np.testing.assert_array_equal(t27.numpy(), np.asarray(jpb.build_table(jt, jf)))
    tdual = ttab.build_table_dual(tt, tf)
    np.testing.assert_array_equal(tdual.numpy(), np.asarray(jpb.build_table_dual(jt, jf)))
    comb = tct.build_table_dual_combine(t27, tt.chunk_dloc, nf)
    assert torch.equal(comb, tdual)


def test_b11_plain_bitwise_on_two_chunks():
    _, tt = _pair("two_chunks")
    rng = np.random.default_rng(5)
    m = ttopo.active_mask(tt)[:, None].numpy()
    f = torch.from_numpy((rng.standard_normal((4, tt.capacity, 512)) * m).astype(np.float32))
    comb = tct.build_table_dual_combine(ttab.build_table(tt, f), tt.chunk_dloc, 4)
    assert torch.equal(comb, ttab.build_table_dual(tt, f))
    # row 0 of every chunk is the all-null dual row
    assert not comb.reshape(2, -1, 4, 512)[:, 0].any()


def test_b11_wrapper_rejects_bad_shapes(sparse):
    _, tt, fields, _ = sparse
    t27 = ttab.build_table(tt, torch.from_numpy(fields[:3]))
    with pytest.raises(ValueError):
        tct.build_table_dual_combine(t27, tt.chunk_dloc, 0)
    with pytest.raises(ValueError):
        tct.build_table_dual_combine(t27[:, :-1], tt.chunk_dloc, 3)  # rows not a multiple of nf
    with pytest.raises(ValueError):
        tct.build_table_dual_combine(t27, tt.chunk_dloc.long(), 3)


CASES = {  # mode, f_lo, nb, sdf
    "both velocity": ("both", 0, 3, False),
    "both scalars": ("both", 3, 8, False),
    "both scalars sdf": ("both", 3, 6, True),
    "back": ("back", 0, 5, False),
    "fwd": ("fwd", 3, 5, False),
}


def _case_inputs(sparse, mode, nb, has_sdf):
    """(fields [nb,T,512] whose first three are the velocity, sdf or None,
    the pass's displacement d): |d| up to just under the mode's window
    bound, clamp(-u*sdt) for "both"/"back", any d for "fwd"."""
    _, tt, fields, m = sparse
    sdt = 0.35
    cap = (tcb.CFL_LIMIT if mode == "both" else tcb.CFL_MID) - 0.05
    rng = np.random.default_rng(41)
    vel = (rng.uniform(-1, 1, (3, tt.capacity, 512)) * (cap / sdt) * m).astype(np.float32)
    base = np.concatenate([vel, fields[3:nb]])
    sdf = None
    if has_sdf:  # a plane a third of the way up the box: probes reject both ways
        py = positions_flat(tt)[1].numpy().astype(np.float32)
        sdf = ((py - 12.3) * m).astype(np.float32)
    d = np.clip(-vel * sdt, -tcb.DISP_LIMIT, tcb.DISP_LIMIT)
    if mode == "fwd":
        d = (rng.uniform(-1, 1, d.shape) * cap).astype(np.float32)
    return sdt, base, sdf, d


def _port_dual(tt, sdt, base, sdf, d, mode, nb, f_lo, fn=tcb.bfecc_sample_dual):
    tab = base if sdf is None else np.concatenate([base, sdf[None]])
    tbl = ttab.build_table_dual(tt, torch.from_numpy(tab))
    vd = torch.from_numpy(d if mode == "fwd" else base[:3].copy())
    out = fn(tbl, tt.chunk_ldual, vd, sdt, nb, f_lo, mode, sdf is not None)
    return list(out) if mode == "both" else [out]


@pytest.mark.parametrize("case", sorted(CASES))
def test_dual_b1_plain_matches_megakernel_interpret(sparse, case):
    mode, f_lo, nb, has_sdf = CASES[case]
    jt, tt, _, _ = sparse
    sdt, base, sdf, d = _case_inputs(sparse, mode, nb, has_sdf)
    out = jpb.bfecc_sample_fused(
        jt, [jnp.asarray(a) for a in base], *[jnp.asarray(a) for a in d], sdt, f_lo,
        None if sdf is None else jnp.asarray(sdf), "strict", interpret=True, win=16,
        dual=True, mode=mode)
    want = [np.stack([np.asarray(a) for a in part]) for part in out]
    got = _port_dual(tt, sdt, base, sdf, d, mode, nb, f_lo)
    scale = np.abs(base[f_lo:]).max()
    for g, w, tol in zip(got, want, [TOL_AT, TOL_RETRACE]):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dual_b1_bitwise_vs_nbr_b1(sparse, case):
    """Inside the window the dual table and nbr give the same corner values:
    the dual B1 equals the nbr-form B1 ("both") and B8/B9 ("back", "fwd")."""
    mode, f_lo, nb, has_sdf = CASES[case]
    _, tt, _, _ = sparse
    sdt, base, sdf, d = _case_inputs(sparse, mode, nb, has_sdf)
    got = _port_dual(tt, sdt, base, sdf, d, mode, nb, f_lo)
    f = torch.from_numpy(base)
    if mode == "both":
        want = tcb.bfecc_sample(tt.nbr, f, sdt, f_lo, None if sdf is None else torch.from_numpy(sdf))
    else:
        want = [tcs.sample_at(tt.nbr, f[f_lo:].contiguous(), torch.from_numpy(d))]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", ["both", "back", "fwd"])
def test_dual_b1_refuses_displacements_outside_the_window(sparse, mode):
    _, tt, _, _ = sparse
    sdt, base, _, d = _case_inputs(sparse, mode, 4, False)
    f_lo = 3 if mode != "back" else 0
    over = 2.0 if mode == "both" else 4.0  # voxels, past CFL_LIMIT / CFL_MID
    if mode == "fwd":
        d = d.copy()
        d[0, 1, 0] = over
    else:
        base = base.copy()
        base[0, 1, 0] = -over / sdt
    with pytest.raises(ValueError, match="window"):
        _port_dual(tt, sdt, base, None, d, mode, 4, f_lo)


def test_dual_b1_wrapper_rejects_bad_modes(sparse):
    _, tt, fields, _ = sparse
    sdt, base, sdf, d = _case_inputs(sparse, "back", 4, False)
    tbl = ttab.build_table_dual(tt, torch.from_numpy(base))
    vel = torch.from_numpy(base[:3].copy())
    for kw in (dict(mode="sideways"), dict(mode="back", has_sdf=True),
               dict(nb=4, f_lo=0, mode="both"), dict(nb=3, f_lo=3, mode="fwd")):
        args = dict(nb=4, f_lo=0, mode="back", has_sdf=False)
        args.update(kw)
        with pytest.raises(ValueError):
            tcb.bfecc_sample_dual(tbl, tt.chunk_ldual, vel, sdt, **args)


def _band_inputs(cfl, kind, with_sdf):
    """Dense 16^3 box: velocity whose max|u|*sdt is ``cfl`` (smooth, or
    white noise, whose re-trace leaves the narrow window), two scalars and
    optionally a plane SDF."""
    jt, tt = _pair("dense16")
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    px, py, pz = (p.numpy().astype(np.float32) for p in positions_flat(tt))
    rng = np.random.default_rng(53)
    if kind == "smooth":
        vel = np.stack([np.sin(py / 9.0 + 0.3), np.cos(pz / 11.0 - px / 13.0),
                        np.sin(px / 10.0 + pz / 12.0)])
    else:
        vel = rng.uniform(-1, 1, (3,) + px.shape)
    sdt = 0.5
    vel = (vel / np.abs(vel * m).max() * (cfl / sdt) * m).astype(np.float32)
    scal = (rng.standard_normal((2,) + px.shape) * m).astype(np.float32)
    sdf = ((py - 7.3) * m).astype(np.float32) if with_sdf else None
    return jt, tt, vel, scal, sdf, sdt


BAND_CASES = {  # cfl, velocity, SDF, branches taken by the scalar pass
    "narrow": (1.5, "smooth", False, {"narrow": 1}),
    "narrow sdf": (1.5, "smooth", True, {"narrow": 1}),
    "mixed fwd narrow": (3.0, "smooth", False, {"mixed": 1, "mixed fwd narrow": 1}),
    "mixed fwd wide": (3.0, "noise", False, {"mixed": 1, "mixed fwd wide": 1}),
    "wide": (5.0, "smooth", False, {"wide": 1}),
    "wide sdf": (3.0, "smooth", True, {"wide": 1}),
}


def _port_samples(monkeypatch, tt, fields, sdt, f_lo, sdf, combine):
    monkeypatch.setattr(tadv, "INTERP", "vmem")
    monkeypatch.setattr(tct, "COMBINE_TBL", combine)
    tadv.BANDS.clear()
    out = tadv._bfecc_samples(tt, fields, sdt, f_lo, sdf, 1)
    return out, dict(tadv.BANDS)


@pytest.mark.parametrize("case", sorted(BAND_CASES))
def test_table_sampler_bands(monkeypatch, case):
    """Each band's branch is taken; COMBINE_TBL on and off give bitwise the
    same samples; so does the nbr path (the same trilinear on the same
    corner values, the mixed band's torch re-trace in the kernel's op
    order)."""
    cfl, kind, with_sdf, bands = BAND_CASES[case]
    _, tt, vel, scal, sdf, sdt = _band_inputs(cfl, kind, with_sdf)
    fields = torch.from_numpy(np.concatenate([vel, scal]))
    s = None if sdf is None else torch.from_numpy(sdf)
    off, taken = _port_samples(monkeypatch, tt, fields, sdt, 3, s, False)
    assert taken == bands
    on, _ = _port_samples(monkeypatch, tt, fields, sdt, 3, s, True)
    nbr = tcb.bfecc_sample(tt.nbr, fields, sdt, 3, s)
    for a, b, c in zip(off, on, nbr):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("case", ["narrow", "mixed fwd narrow", "wide"])
def test_table_sampler_matches_jax_advect_vmem(monkeypatch, case):
    """The scalar and the velocity pass against ``_advect_vmem`` (interpret
    mode, strict)."""
    cfl, kind, with_sdf, _ = BAND_CASES[case]
    jt, tt, vel, scal, _, sdt = _band_inputs(cfl, kind, with_sdf)
    for f_lo, fields in ((3, np.concatenate([vel, scal])), (0, vel)):
        want = jadv._advect_vmem(jt, jnp.asarray(vel), [jnp.asarray(a) for a in fields[f_lo:]],
                                 sdt, None, fields_are_velocity=f_lo == 0)[:2]
        got, _ = _port_samples(monkeypatch, tt, torch.from_numpy(fields), sdt, f_lo, None, False)
        scale = np.abs(fields[f_lo:]).max()
        for g, w, tol in zip(got, want, (TOL_AT, TOL_RETRACE)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol * scale)


def test_table_sampler_raises_above_the_table_budget(monkeypatch):
    """The sliced at-scale table path is not ported: it raises, no fallback."""
    _, tt, vel, scal, _, sdt = _band_inputs(1.5, "smooth", False)
    monkeypatch.setattr(tadv, "TABLE_BYTES_BUDGET", 1024)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port_samples(monkeypatch, tt, torch.from_numpy(np.concatenate([vel, scal])), sdt, 3,
                      None, False)


def test_table_sampler_needs_plans(monkeypatch):
    """A topology without chunk plans takes the nbr path under "vmem", as
    the JAX package's sampler does without a chunk plan."""
    _, tt, vel, scal, _, sdt = _band_inputs(1.5, "smooth", False)
    bare = ttopo.Topology(keys=tt.keys, origins=tt.origins, nbr=tt.nbr, n_active=tt.n_active)
    fields = torch.from_numpy(np.concatenate([vel, scal]))
    got, taken = _port_samples(monkeypatch, bare, fields, sdt, 3, None, False)
    assert taken == {}
    for a, b in zip(got, tcb.bfecc_sample(tt.nbr, fields, sdt, 3)):
        assert torch.equal(a, b)


def test_every_c_entry_has_its_signature():
    """Each ``extern "C"`` entry of csrc/*.cu is bound in build.SIGNATURES
    with as many arguments as the C function takes (ctypes would cut an
    unbound pointer to 32 bits)."""
    import re

    from hnanosolver_tpu_torch.kernels import build

    found = {}
    for cu in build.CSRC.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (hn_\w+)\(([^)]*)\)', cu.read_text()):
            found[name] = len(params.split(","))
    assert found and set(found) == set(build.SIGNATURES)
    for name, n in found.items():
        assert len(build.SIGNATURES[name]) == n, name
