"""The port's public API and core helpers against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages: the
tensor forms of ``core/coords``, the topology lookups (``lookup_tiles``,
``lookup_voxels``, ``voxel_positions``), the dense and dilated builders,
``core/convert``, the layout block views, ``fields.source_into`` and
``ops/advection.cfl_clamped_count``, and ``utils/debug``. All of it is integer bookkeeping, data
movement or a single add, so every comparison is exact: integer outputs
bitwise, float outputs equal. Lookups get out-of-range coords and the
sentinel origins of the null and padding rows (``1 << 20``), which must not
alias a valid key; the CFL count gets velocities on both sides of its
trigger, 2*|u|*dt/dx = DISP_LIMIT. The public signatures are held to
JAX's (positional order, keywords), and the names the port gained for that
parity (``ops/shifts``, ``ops/halo``, ``core/topology``) to JAX's values.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hnanosolver_tpu as jpkg
from hnanosolver_tpu.core import convert as jconv
from hnanosolver_tpu.core import coords as jc
from hnanosolver_tpu.core import layout as jlayout
from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.fields import FieldState as JState
from hnanosolver_tpu.fields import source_into as jsource_into
from hnanosolver_tpu.ops.advection import DISP_LIMIT, cfl_clamped_count as jcfl
import hnanosolver_tpu_torch as tpkg
from hnanosolver_tpu_torch import config as tcfg
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch.core import convert as tconv
from hnanosolver_tpu_torch.core import coords as tc
from hnanosolver_tpu_torch.core import layout as tlayout
from hnanosolver_tpu_torch.core import topology as ttopo
from hnanosolver_tpu_torch.fields import FieldState as TState
from hnanosolver_tpu_torch.fields import source_into as tsource_into
from hnanosolver_tpu_torch.models.plume import build_plume_envelope
from hnanosolver_tpu_torch.ops.advection import cfl_clamped_count as tcfl

torch.set_num_threads(1)

SENTINEL = 1 << 20  # the null and padding rows' origins


def _tiles(case: str):
    rng = np.random.default_rng(3)
    box = np.array([(x, y, z) for x in range(5) for y in range(5) for z in range(5)])
    return {
        "sparse_random": box[rng.random(len(box)) < 0.5] - 2,
        "plume_envelope": build_plume_envelope(24, 48, 24, 24),
        "edges": np.array([[-512, -512, -512], [511, 511, 511], [0, 0, 0], [-1, 5, 511]]),
    }[case]


CASES = ("sparse_random", "plume_envelope", "edges")


def _pair(case: str, capacity=None):
    tiles = _tiles(case)
    return (jtopo.build_topology(tiles, capacity=capacity),
            ttopo.build_topology(tiles, capacity=capacity, device="cpu"))


def _query_tiles(jt) -> np.ndarray:
    """Every row's origin (sentinels included), their neighbours, random
    coords and coords just outside the packable range."""
    rng = np.random.default_rng(4)
    org = np.asarray(jt.origins)
    return np.concatenate([
        org, org + 1, org - 1,
        rng.integers(-600, 600, (500, 3)),
        np.array([[512, 0, 0], [0, -513, 0], [0, 0, 1024], [SENTINEL, SENTINEL, SENTINEL],
                  [SENTINEL, 0, 0], [-SENTINEL, 3, 3]]),
    ]).astype(np.int32)


def _eq(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


COORD_FNS = {
    "pack_keys": (tc.pack_keys, jc.pack_keys),
    "unpack_keys": (tc.unpack_keys, jc.unpack_keys),
    "voxel_to_tile": (tc.voxel_to_tile, jc.voxel_to_tile),
    "voxel_to_local": (tc.voxel_to_local, jc.voxel_to_local),
    "local_flat_index": (tc.local_flat_index, jc.local_flat_index),
}


@pytest.mark.parametrize("fn", sorted(COORD_FNS))
def test_coords_tensor_forms(fn):
    """Bitwise, on coords in and out of range (out-of-range keys wrap as
    int32 arithmetic does in both packages)."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.integers(-600, 600, (2000, 3)),
                        rng.integers(-5000, 5000, (200, 3)),
                        np.array([[SENTINEL] * 3, [-512] * 3, [511] * 3])]).astype(np.int32)
    if fn == "unpack_keys":
        x = np.concatenate([tc.pack_keys_np(np.clip(x, -512, 511)).ravel(),
                            np.array([tc.NULL_KEY, tc.PAD_KEY], np.int32)])
    if fn == "local_flat_index":
        x = x & 7
    t_fn, j_fn = COORD_FNS[fn]
    got = t_fn(torch.from_numpy(x))
    want = np.asarray(j_fn(jnp.asarray(x)))
    assert got.dtype == torch.int32
    _eq(got, want)


@pytest.mark.parametrize("case", CASES)
def test_lookup_tiles_and_voxels(case):
    jt, tt = _pair(case, capacity=None)
    q = _query_tiles(jt)
    _eq(ttopo.lookup_tiles(tt, q), jtopo.lookup_tiles(jt, jnp.asarray(q)))
    # a [n, k, 3] query through a tensor
    q3 = q[: (len(q) // 4) * 4].reshape(-1, 4, 3)
    _eq(ttopo.lookup_tiles(tt, torch.from_numpy(q3)), jtopo.lookup_tiles(jt, jnp.asarray(q3)))
    rng = np.random.default_rng(6)
    vox = np.concatenate([q * 8 + rng.integers(0, 8, q.shape),
                          rng.integers(-4200, 4200, (500, 3))]).astype(np.int32)
    _eq(ttopo.lookup_voxels(tt, vox), jtopo.lookup_voxels(jt, jnp.asarray(vox)))
    # sentinel origins never alias a valid tile
    assert int(ttopo.lookup_tiles(tt, np.full((1, 3), SENTINEL))[0]) == 0


@pytest.mark.parametrize("case", CASES)
def test_voxel_positions(case):
    jt, tt = _pair(case)
    got = ttopo.voxel_positions(tt)
    assert got.shape == (tt.capacity, 8, 8, 8, 3) and got.dtype == torch.int32
    _eq(got, jtopo.voxel_positions(jt))


def _same_topology(t, j):
    assert t.capacity == j.capacity and t.n_active == int(j.n_active)
    for f in ("keys", "origins", "nbr"):
        _eq(getattr(t, f), getattr(j, f))


@pytest.mark.parametrize("shape,origin,capacity", [
    ((16, 16, 16), (0, 0, 0), None),
    ((8, 24, 16), (-16, 8, -8), None),
    ((32, 8, 8), (4064, 0, -4096), 64),
])
def test_build_topology_dense(shape, origin, capacity):
    _same_topology(ttopo.build_topology_dense(shape, origin, capacity, device="cpu"),
                   jtopo.build_topology_dense(shape, origin, capacity))


def test_build_topology_dense_rejects_unaligned():
    with pytest.raises(ValueError):
        ttopo.build_topology_dense((12, 8, 8), device="cpu")


@pytest.mark.parametrize("case,radius,capacity", [
    ("sparse_random", 1, None), ("sparse_random", 2, 1024), ("plume_envelope", 1, None),
])
def test_dilate_topology(case, radius, capacity):
    jt, tt = _pair(case)
    _same_topology(ttopo.dilate_topology(tt, radius, capacity),
                   jtopo.dilate_topology(jt, radius, capacity))


@pytest.mark.parametrize("ch", [(), (3,)])
@pytest.mark.parametrize("origin", [(0, 0, 0), (-8, 16, -24)])
def test_dense_tiles_roundtrip(ch, origin):
    """A box partly outside a sparse topology: dense_to_tiles and
    tiles_to_dense equal to the JAX package's."""
    jt, tt = _pair("sparse_random")
    rng = np.random.default_rng(8)
    dense = rng.standard_normal((24, 32, 16) + ch).astype(np.float32)
    tiles_t = tconv.dense_to_tiles(tt, dense, origin)
    tiles_j = jconv.dense_to_tiles(jt, jnp.asarray(dense), origin)
    _eq(tiles_t, tiles_j)
    assert not bool(tiles_t[0].any())
    _eq(tconv.tiles_to_dense(tt, tiles_t, dense.shape[:3], origin),
        jconv.tiles_to_dense(jt, tiles_j, dense.shape[:3], origin))


def test_layout_block_views():
    rng = np.random.default_rng(9)
    s = rng.standard_normal((7, 512)).astype(np.float32)
    v = rng.standard_normal((3, 7, 512)).astype(np.float32)
    _eq(tlayout.scalar_to_blocks(torch.from_numpy(s)), jlayout.scalar_to_blocks(jnp.asarray(s)))
    _eq(tlayout.vec_to_blocks(torch.from_numpy(v)), jlayout.vec_to_blocks(jnp.asarray(v)))
    vb = np.array(jlayout.vec_to_blocks(jnp.asarray(v)))
    _eq(tlayout.vec_from_blocks(torch.from_numpy(vb)), v)
    _eq(tlayout.scalar_from_blocks(tlayout.scalar_to_blocks(torch.from_numpy(s))), s)
    st = TState.from_blocks(vb, {"density": s.reshape(7, 8, 8, 8)})
    assert st.capacity == 7 and st.velocity.is_contiguous()
    _eq(st.velocity, v)
    _eq(st.velocity_blocks(), vb)
    _eq(st.scalar_blocks("density"), s.reshape(7, 8, 8, 8))
    assert st.replace(scalars={}).scalars == {} and st.scalars


def test_source_into():
    """The SDF is replaced, other fields summed, a source-only field
    created, the velocity summed."""
    rng = np.random.default_rng(10)

    def f():
        return rng.standard_normal((16, 512)).astype(np.float32)

    state = {"density": f(), "fuel": f(), "collision_sdf": f()}
    source = {"density": f(), "temperature": f(), "collision_sdf": f()}
    vs, vsrc = f()[None].repeat(3, 0), f()[None].repeat(3, 0)
    j = jsource_into(JState(jnp.asarray(vs), {k: jnp.asarray(v) for k, v in state.items()}),
                     JState(jnp.asarray(vsrc), {k: jnp.asarray(v) for k, v in source.items()}))
    t = tsource_into(convert.state_from_numpy(vs, state, device="cpu"),
                     convert.state_from_numpy(vsrc, source, device="cpu"))
    assert sorted(t.scalars) == sorted(j.scalars)
    _eq(t.velocity, j.velocity)
    for k in j.scalars:
        _eq(t.scalars[k], j.scalars[k])
    _eq(t.scalars["collision_sdf"], source["collision_sdf"])


@pytest.mark.parametrize("dt", [1.0 / 24.0, 0.7, 1.5])
def test_cfl_clamped_count(dt):
    """Speeds straddle the trigger 2*|u|*dt/dx = DISP_LIMIT, on active and
    inactive rows; the count is a 0-d int32 tensor equal to JAX's."""
    jt, tt = _pair("plume_envelope")
    rng = np.random.default_rng(12)
    inv_dx = 2.0
    edge = DISP_LIMIT / (2.0 * dt * inv_dx)  # |u| at the trigger
    vel = (rng.uniform(0.9, 1.1, (3, tt.capacity, 512)) * edge
           * rng.choice([-1.0, 1.0], (3, tt.capacity, 512))).astype(np.float32)
    vel[:, tt.n_active + 1:] = 5 * edge  # padding rows never count
    got = tcfl(tt, torch.from_numpy(vel), dt, inv_dx)
    want = int(jcfl(jt, jnp.asarray(vel), dt, inv_dx))
    assert got.dim() == 0 and got.dtype == torch.int32
    assert int(got) == want and 0 < want < tt.n_active * 512


def test_all_covers_jax():
    assert set(jpkg.__all__) <= set(tpkg.__all__)
    for name in tpkg.__all__:
        assert hasattr(tpkg, name), name


def _debug_pair(nan_at=None, bg_at=None, speed=1.0):
    """A developed-looking state on a 16^3 box in both packages, with an
    optional NaN on an active row, a non-zero background row and a speed."""
    rng = np.random.default_rng(13)
    jt = jtopo.build_topology_dense((16, 16, 16))
    tt = convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                     np.asarray(jt.nbr), int(jt.n_active), device="cpu")
    T, n = tt.capacity, tt.n_active
    m = ((np.arange(T) >= 1) & (np.arange(T) <= n)).astype(np.float32)[:, None]
    vel = (rng.uniform(-1, 1, (3, T, 512)) * speed * m).astype(np.float32)
    sc = {"density": (rng.random((T, 512)) * m).astype(np.float32)}
    if nan_at is not None:
        sc["density"][nan_at] = np.nan
    if bg_at is not None:
        vel[1, bg_at] = 1.0
    js = JState(jnp.asarray(vel), {k: jnp.asarray(v) for k, v in sc.items()})
    return jt, js, tt, convert.state_from_numpy(vel, sc, device="cpu")


@pytest.mark.parametrize("case", ["clean", "nan", "background", "fast"])
def test_debug_utils_agree_with_jax(case):
    """utils/debug on the port's tensors raises where the JAX package's
    raises, reports the same finite fractions and CFL counts."""
    from hnanosolver_tpu.utils import debug as jdbg
    from hnanosolver_tpu_torch.utils import debug as tdbg

    jt, js, tt, ts = _debug_pair(nan_at=(1, 5) if case == "nan" else None,
                                 bg_at=0 if case == "background" else None,
                                 speed=5.0 if case == "fast" else 1.0)
    for fn, err in ((lambda m, t, s: m.assert_finite_state(s, "here"), FloatingPointError),
                    (lambda m, t, s: m.nan_guard({"a": [s.velocity, s.scalars]}), FloatingPointError),
                    (lambda m, t, s: m.check_background_invariant(t, s), AssertionError)):
        raised = []
        for m, t, s in ((jdbg, jt, js), (tdbg, tt, ts)):
            try:
                fn(m, t, s)
                raised.append(None)
            except err:
                raised.append(err)
        assert raised[0] == raised[1]
    assert tdbg.finite_fraction(ts) == pytest.approx(jdbg.finite_fraction(js), abs=0)
    params = tcfg.SolverParams(dt=1.0, voxel_size=0.5)  # dt/dx = 2; both read dt, dx only
    assert tdbg.check_cfl(tt, ts, params) == jdbg.check_cfl(jt, js, params)
    if case == "fast":
        assert tdbg.check_cfl(tt, ts, params) > 0
        with pytest.raises(RuntimeError):
            tdbg.check_cfl(tt, ts, params, raise_on_clamp=True)


def test_check_determinism():
    from hnanosolver_tpu_torch.utils import debug as tdbg

    _, _, tt, ts = _debug_pair()
    tdbg.check_determinism(lambda s: tsource_into(s, s), ts)
    calls = []

    def drifting(s):
        calls.append(1)
        return s.with_scalar("density", s.scalars["density"] + len(calls))
    with pytest.raises(AssertionError):
        tdbg.check_determinism(drifting, ts)


# The JAX package's public functions the port leaves out, with the reason
# (ROADMAP "Not to port"): none since the dense oracle, ops/interp and
# jacobi_pressure were ported.
NOT_PORTED: dict = {}


def _common_modules():
    """(relative name, JAX module, port module) for every module both
    packages define."""
    import importlib
    import pkgutil

    def names(pkg):
        return {m.name[len(pkg.__name__) + 1:]
                for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}

    for rel in sorted(names(jpkg) & names(tpkg)):
        yield (rel, importlib.import_module(f"{jpkg.__name__}.{rel}"),
               importlib.import_module(f"{tpkg.__name__}.{rel}"))


def _jax_public_functions(mod):
    """name -> the function behind each public name that ``mod`` defines
    (through ``jax.jit``'s wrapper), re-exports left out."""
    import inspect

    out = {}
    for name, obj in vars(mod).items():
        fn = getattr(obj, "__wrapped__", obj)
        if (not name.startswith("_") and inspect.isfunction(fn)
                and fn.__module__ == mod.__name__):
            out[name] = fn
    return out


def _signature_mismatches() -> tuple[list, int]:
    import inspect

    positional = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
    bad, checked = [], 0
    for rel, jmod, tmod in _common_modules():
        for name, jfn in _jax_public_functions(jmod).items():
            if (rel, name) in NOT_PORTED:
                continue
            tfn = getattr(tmod, name, None)
            if tfn is None:
                bad.append(f"{rel}.{name}: missing")
                continue
            jps = inspect.signature(jfn).parameters.values()
            tps = inspect.signature(tfn).parameters.values()
            jpos = [p.name for p in jps if p.kind in positional]
            tpos = [p.name for p in tps if p.kind in positional]
            if tpos[:len(jpos)] != jpos:
                bad.append(f"{rel}.{name}: positional {jpos} vs {tpos}")
            if not any(p.kind == p.VAR_KEYWORD for p in tps):
                tnames = {p.name for p in tps}
                missing = [p.name for p in jps if p.kind != p.VAR_POSITIONAL
                           and p.kind != p.VAR_KEYWORD and p.name not in tnames]
                if missing:
                    bad.append(f"{rel}.{name}: keywords {missing} rejected")
            checked += 1
    return bad, checked


@pytest.mark.parametrize("case", ["signatures", "advect_scalar_chunk", "solve_pressure_xla"])
def test_public_signatures_match_jax(case, monkeypatch):
    """A JAX-shaped call binds the same parameters on the port.

    - signatures: for every public function of a module both packages
      define, JAX's positional names are a prefix of the port's and every
      JAX keyword is accepted (``NOT_PORTED`` aside).
    - advect_scalar_chunk: the positional ``advect_scalar(..., None, 1024)``
      is JAX's chunk 1024 at trace order 1: bitwise the order-1 call (not
      the RK4 a mis-bound ``trace_order=1024`` would run).
    - solve_pressure_xla: ``backend="xla"`` (7th positional) is the
      textbook per-colour solve whatever ``halo_lag`` says, also above
      MAX_FUSED_ROWS: equal to JAX's CPU solve within 1e-6 * max|ref|
      (tests/test_torch_pressure.py's allowance, for XLA's FMAs)."""
    from hnanosolver_tpu.ops import pressure as jprs
    from hnanosolver_tpu_torch.ops import advection as tadv
    from hnanosolver_tpu_torch.ops import cuda_pressure as tcp
    from hnanosolver_tpu_torch.ops import pressure as tprs

    if case == "signatures":
        bad, checked = _signature_mismatches()
        assert not bad, "\n".join(bad)
        assert checked > 150
        shared = {rel for rel, _, _ in _common_modules()}
        assert {"dense.ops", "dense.solver", "ops.interp"} <= shared
        return
    jt, tt = _pair("sparse_random")
    rng = np.random.default_rng(11)
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    if case == "advect_scalar_chunk":
        vel = torch.from_numpy((rng.standard_normal((3, tt.capacity, 512)) * 20 * m[None])
                               .astype(np.float32))
        f = torch.from_numpy((rng.random((tt.capacity, 512)) * m).astype(np.float32))
        args = (tt, vel, f, 0.1, 2.0)
        got = tadv.advect_scalar(*args, None, 1024)
        assert torch.equal(got, tadv.advect_scalar(*args, trace_order=1))
        assert not torch.equal(got, tadv.advect_scalar(*args, trace_order=4))
        return
    monkeypatch.setattr(tcp, "MAX_FUSED_ROWS", 16)  # B3 blocks unless "xla"
    div = (rng.standard_normal((tt.capacity, 512)) * m).astype(np.float32)
    want = np.asarray(jprs.solve_pressure(jt, jnp.asarray(div), 10, 0.25, 1.17))
    got = tprs.solve_pressure(tt, torch.from_numpy(div), 10, 0.25, 1.17, None, "xla",
                              None, None, 5).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    lagged = tprs.solve_pressure(tt, torch.from_numpy(div), 10, 0.25, 1.17, halo_lag=5).numpy()
    assert not np.array_equal(lagged, got)


@pytest.mark.parametrize("name", ["shifted_views", "face_minmax_multi", "neighbor_table",
                                  "face_shift_views", "center", "ensure_dual_local"])
def test_thin_forms_match_jax(name):
    """The names the port gained for parity (ops/shifts, ops/halo,
    core/topology) give the JAX package's values: data movement and
    min/max, so bitwise."""
    from hnanosolver_tpu.ops import halo as jhalo
    from hnanosolver_tpu.ops import shifts as jsh
    from hnanosolver_tpu_torch.ops import halo as thalo
    from hnanosolver_tpu_torch.ops import shifts as tsh

    jt, tt = _pair("sparse_random")
    rng = np.random.default_rng(12)
    f = (rng.standard_normal((tt.capacity, 512)) * np.asarray(jtopo.active_mask(jt))[:, None]
         ).astype(np.float32)
    tf = torch.from_numpy(f)
    if name == "shifted_views":
        want, got = jsh.shifted_views(jt, jnp.asarray(f)), tsh.shifted_views(tt, tf)
        assert set(got) == set(want)
        for off in want:
            _eq(got[off], want[off])
    elif name == "face_minmax_multi":
        stack = np.stack([f, -2 * f])
        for g, w in zip(tsh.face_minmax_multi(tt, torch.from_numpy(stack)),
                        jsh.face_minmax_multi(jt, jnp.asarray(stack))):
            _eq(g, w)
    elif name == "neighbor_table":
        idx = rng.integers(0, 27 * 512, (tt.capacity, 512)).astype(np.int32)
        table = tsh.neighbor_table(tt, tf)
        _eq(table, jsh.neighbor_table(jt, jnp.asarray(f)))
        _eq(tsh.gather_table(table, torch.from_numpy(idx)),
            jsh.gather_table(jsh.neighbor_table(jt, jnp.asarray(f)), jnp.asarray(idx)))
    elif name == "face_shift_views":
        blocks = f.reshape(-1, 8, 8, 8)
        want = jhalo.face_shift_views(jt, jnp.asarray(blocks))
        got = thalo.face_shift_views(tt, torch.from_numpy(blocks))
        assert set(got) == set(want)
        for off in want:
            _eq(got[off], want[off])
    elif name == "center":
        pad = jhalo.gather_halo(jt, jnp.asarray(f.reshape(-1, 8, 8, 8)), 2)
        _eq(thalo.center(torch.from_numpy(np.array(pad))), jhalo.center(pad))
    else:
        planned = ttopo.build_topology(_tiles("sparse_random"), device="cpu", plans=True)
        bare = dataclasses.replace(planned, chunk_dloc=None)
        got = ttopo.ensure_dual_local(bare).chunk_dloc
        assert torch.equal(got, planned.chunk_dloc)
        jp = jtopo.build_topology(_tiles("sparse_random"))
        _eq(got, jtopo.ensure_dual_local(jp).chunk_dloc)
        assert ttopo.ensure_dual_local(planned) is planned
        with pytest.raises(ValueError):
            ttopo.ensure_dual_local(ttopo.build_topology(_tiles("sparse_random"), device="cpu"))
