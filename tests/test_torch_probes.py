"""The plain versions of the probe kernels PG and PC (``ops/probe.py``)
against the JAX package's TPU probe kernels, run in Pallas interpret mode
on the CPU; the ``cuda_probe`` wrappers and the probe scripts on the CPU.

The JAX probes (``tools/probe_dgather.py``, ``probe_dmabisect.py``,
``probe_dmabisect2.py``, ``probe_dmacost.py``) run ``main()`` at import, so
each kernel body below is restated from its file, at the line cited, and
run with ``pl.pallas_call(..., interpret=True)`` on inputs made with numpy.

Tolerance: bitwise, but for the chain against JAX. The gathers and copies
move values. The chain (P6) multiplies each gathered face by 1e-30 and
adds it; on inputs whose rows lie 30 decades apart the adds change values,
and XLA's CPU compiler contracts some multiply-add pairs into an FMA (one
rounding where the port rounds twice, as its kernel does): 2 of 262,144
values 1 ulp apart at one rep. So the chain is held to JAX within rtol 1e-6
(a few float32 ulps over its 6 * reps adds) and bitwise to the same sums
rounded op by op in numpy. Only what the TPU defines is compared:
the stage rows a kernel writes (interpret mode fills the rest with NaN;
the port's stage starts at 0) and variants whose copies never share a
stage slot. The on-chip source holds ``ops/probe.max_onchip_rows`` rows,
so the on-chip cases take row starts inside it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import bench
from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.ops.pallas_pressure import _DIRS
from hnanosolver_tpu.ops.shifts import d_of
from hnanosolver_tpu_torch.core.topology import build_topology
from hnanosolver_tpu_torch.ops import cuda_probe, probe
from hnanosolver_tpu_torch.tools import (probe_dgather, probe_dmabisect, probe_dmabisect2,
                                         probe_dmacost)

torch.set_num_threads(1)

T = 512  # the bisect probes' source rows
X = np.random.default_rng(3).standard_normal((T, 512)).astype(np.float32)
ROWS3 = (np.arange(64) * 3 % T).astype(np.int32)  # probe_dmabisect.py:35
ROWS37 = (np.arange(64) * 37 % T).astype(np.int32)  # probe_dmabisect2.py:35
BLOCKS = (np.arange(64) * 11 % (T // 8)).astype(np.int32)  # probe_dmabisect2.py:36
R = probe.max_onchip_rows(64)
ONCHIP37 = (np.arange(64) * 37 % R).astype(np.int32)  # v10's rows, inside the on-chip source


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- PG: probe_dgather.py -------------------------------------------------------

@pytest.fixture(scope="module")
def dom():
    """A 68-tile plume envelope at capacity 512: JAX's nbr6 as the probe
    builds it (probe_dgather.py:44-50) and the port's topology."""
    tiles = bench.build_plume_envelope(16, 64)
    n = len(np.unique(tiles, axis=0))
    cap = ((n + 1 + 511) // 512) * 512
    jt = jtopo.build_topology(tiles, capacity=cap)
    tt = build_topology(tiles, capacity=cap, device="cpu")
    nbr6 = np.asarray(jnp.stack([jt.nbr[:, d_of(off)] for off in _DIRS]))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((cap, 512)).astype(np.float32)
    # rows 30 decades apart, so that x[nbr] * 1e-30 moves the sum
    xm = (x * 10.0 ** rng.uniform(-15, 15, (cap, 1))).astype(np.float32)
    return tt, nbr6, {"normal": x, "mixed scales": xm}


def test_face_rows_equal_jax_nbr6(dom):
    tt, nbr6, _ = dom
    got = probe.face_rows(tt.nbr)
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), nbr6)


def k_small(x_ref, i_ref, o_ref):  # probe_dgather.py:55-56
    o_ref[:] = jnp.take_along_axis(x_ref[:], i_ref[:], axis=0)


@pytest.mark.parametrize("kind", ["reversed", "random"])
def test_take_along_rows_matches_k_small(kind):
    if kind == "reversed":  # probe_dgather.py:63-64
        idx = np.broadcast_to(np.arange(7, -1, -1, dtype=np.int32)[:, None], (8, 512))
    else:
        idx = np.random.default_rng(1).integers(0, 8, (8, 512)).astype(np.int32)
    want = pl.pallas_call(k_small, out_shape=jax.ShapeDtypeStruct((8, 512), jnp.float32),
                          interpret=True)(jnp.asarray(X[:8]), jnp.asarray(idx))
    got = probe.take_along_rows(_t(X[:8]), _t(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d", range(6))
def test_take_rows_matches_k_full(dom, d):
    tt, nbr6, xs = dom
    Tc = tt.capacity

    def k_full(x_ref, i_ref, o_ref):  # probe_dgather.py:74-76
        idx = jnp.broadcast_to(i_ref[:].reshape(Tc, 1), (Tc, 512))
        o_ref[:] = jnp.take_along_axis(x_ref[:], idx, axis=0)

    x = xs["normal"]
    want = pl.pallas_call(k_full, out_shape=jax.ShapeDtypeStruct((Tc, 512), jnp.float32),
                          interpret=True)(jnp.asarray(x), jnp.asarray(nbr6[d]))
    got = probe.take_rows(_t(x), probe.face_rows(tt.nbr)[d])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("reps", [1, 4])
@pytest.mark.parametrize("inp", ["normal", "mixed scales"])
def test_take_chain_matches_k_time(dom, reps, inp):
    tt, nbr6, xs = dom
    Tc = tt.capacity

    def k_time(reps, x_ref, n_ref, o_ref):  # probe_dgather.py:99-106
        def body(_, acc):
            s = acc
            for d in range(6):
                idx = jnp.broadcast_to(n_ref[d].reshape(Tc, 1), (Tc, 512))
                s = s + jnp.take_along_axis(x_ref[:], idx, axis=0) * 1e-30
            return s
        o_ref[:] = jax.lax.fori_loop(0, reps, body, x_ref[:])

    x = xs[inp]
    want = np.asarray(pl.pallas_call(
        functools.partial(k_time, reps), out_shape=jax.ShapeDtypeStruct((Tc, 512), jnp.float32),
        interpret=True)(jnp.asarray(x), jnp.asarray(nbr6)))
    got = probe.take_chain(_t(x), probe.face_rows(tt.nbr), reps).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    s = x.copy()
    for _ in range(reps):
        for d in range(6):
            s = s + x[nbr6[d]] * np.float32(1e-30)  # float32 ops, each rounded
    np.testing.assert_array_equal(got, s)
    if inp == "mixed scales":
        assert (got != x).mean() > 0.005  # the adds changed values


# -- PC: probe_dmabisect.py, probe_dmabisect2.py ----------------------------------

def v0(rows_ref, x_ref, o_ref, stage, sem):  # probe_dmabisect.py:64-68
    cp = pltpu.make_async_copy(x_ref.at[pl.ds(0, 8)], stage.at[pl.ds(0, 8)], sem)
    cp.start()
    cp.wait()
    o_ref[:] = stage[0:8]


def v1(rows_ref, x_ref, o_ref, stage, sem):  # probe_dmabisect.py:73-78
    r = rows_ref[0]
    cp = pltpu.make_async_copy(x_ref.at[pl.ds(r, 8)], stage.at[pl.ds(0, 8)], sem)
    cp.start()
    cp.wait()
    o_ref[:] = stage[0:8]


def v1b(rows_ref, x_ref, o_ref, stage, sem):  # probe_dmabisect.py:83-88
    r = rows_ref[0]
    cp = pltpu.make_async_copy(x_ref.at[pl.ds(r, 1)], stage.at[pl.ds(0, 1)], sem)
    cp.start()
    cp.wait()
    o_ref[:] = stage[0:8]


def v2(rows_ref, x_ref, o_ref, stage, sem):  # probe_dmabisect.py:93-109
    def issue(i, c):
        pltpu.make_async_copy(
            x_ref.at[pl.ds(rows_ref[i], 1)], stage.at[pl.ds(i, 1)], sem
        ).start()
        return c

    jax.lax.fori_loop(0, 64, issue, 0)

    def drain(i, c):
        pltpu.make_async_copy(
            x_ref.at[pl.ds(rows_ref[i], 1)], stage.at[pl.ds(i, 1)], sem
        ).wait()
        return c

    jax.lax.fori_loop(0, 64, drain, 0)
    o_ref[:] = stage[0:8]


def v3(rows_ref, x_ref, o_ref, stage, sem):  # probe_dmabisect.py:114-132
    def issue(i, c):
        pltpu.make_async_copy(
            x_ref.at[pl.ds(rows_ref[i], 1)],
            stage.at[pl.ds((i * 3) % 64, 1)], sem
        ).start()
        return c

    jax.lax.fori_loop(0, 64, issue, 0)

    def drain(i, c):
        pltpu.make_async_copy(
            x_ref.at[pl.ds(rows_ref[i], 1)],
            stage.at[pl.ds((i * 3) % 64, 1)], sem
        ).wait()
        return c

    jax.lax.fori_loop(0, 64, drain, 0)
    o_ref[:] = stage[0:8]


def v6(rows_ref, x_ref, o_ref, stage, sem, xv):  # probe_dmabisect.py:153-161
    cp = pltpu.make_async_copy(x_ref, xv, sem)
    cp.start()
    cp.wait()
    cp2 = pltpu.make_async_copy(xv.at[pl.ds(rows_ref[0], 8)],
                                stage.at[pl.ds(0, 8)], sem)
    cp2.start()
    cp2.wait()
    o_ref[:] = stage[0:8]


def v7(rows_ref, x_ref, o_ref, stage, sem):  # probe_dmabisect2.py:52-57
    cp = pltpu.make_async_copy(
        x_ref.at[rows_ref[0]], stage.at[0], sem)
    cp.start()
    cp.wait()
    o_ref[:] = stage[:]


def v8(blk_ref, x_ref, o_ref, stage, sem):  # probe_dmabisect2.py:75-79
    cp = pltpu.make_async_copy(x_ref.at[blk_ref[0]], stage.at[0], sem)
    cp.start()
    cp.wait()
    o_ref[:] = stage[0]


def v9(rows_ref, x_ref, o_ref, stage, sem):  # probe_dmabisect2.py:97-111
    def issue(i, c):
        pltpu.make_async_copy(
            x_ref.at[rows_ref[i]], stage.at[i], sem).start()
        return c

    jax.lax.fori_loop(0, 64, issue, 0)

    def drain(i, c):
        pltpu.make_async_copy(
            x_ref.at[rows_ref[i]], stage.at[i], sem).wait()
        return c

    jax.lax.fori_loop(0, 64, drain, 0)
    o_ref[:] = stage[:]


def v10(rows_ref, x_ref, o_ref, xv, stage, sem):  # probe_dmabisect2.py:129-147
    cp0 = pltpu.make_async_copy(x_ref, xv, sem)
    cp0.start()
    cp0.wait()

    def issue(i, c):
        pltpu.make_async_copy(
            xv.at[rows_ref[i]], stage.at[i], sem).start()
        return c

    jax.lax.fori_loop(0, 64, issue, 0)

    def drain(i, c):
        pltpu.make_async_copy(
            xv.at[rows_ref[i]], stage.at[i], sem).wait()
        return c

    jax.lax.fori_loop(0, 64, drain, 0)
    o_ref[:] = stage[:]


def v11(cnt_ref, rows_ref, x_ref, o_ref, stage, sem):  # probe_dmabisect2.py:166-182
    n = cnt_ref[0]

    def issue(i, c):
        pltpu.make_async_copy(
            x_ref.at[rows_ref[i]], stage.at[i], sem).start()
        return c

    jax.lax.fori_loop(0, n, issue, 0, unroll=False)

    def drain(i, c):
        pltpu.make_async_copy(
            x_ref.at[rows_ref[i]], stage.at[i], sem).wait()
        return c

    jax.lax.fori_loop(0, n, drain, 0, unroll=False)
    o_ref[:] = stage[:]


def _stage(rows=64):
    return [pltpu.VMEM((rows, 512), jnp.float32), pltpu.SemaphoreType.DMA]


_one = np.zeros(1, np.int32)
# name -> (kernel, scratch, output rows, JAX inputs, the port's arguments,
# the output rows the TPU defines)
BISECT = {
    "v0_static8": (v0, _stage(), 8, (ROWS3, X), dict(rows=_one, n=1, span=8), 8),
    "v1_dynsrc8": (v1, _stage(), 8, (ROWS3, X), dict(rows=ROWS3, n=1, span=8), 8),
    "v1b_dynsrc1": (v1b, _stage(), 8, (ROWS3, X), dict(rows=ROWS3, n=1), 1),
    "v2_fori64": (v2, _stage(), 8, (ROWS3, X), dict(rows=ROWS3, n=64), 8),
    "v3_moddst": (v3, _stage(), 8, (ROWS3, X), dict(rows=ROWS3, n=64, step=3), 8),
    "v6_preload": (v6, _stage() + [pltpu.VMEM((T, 512), jnp.float32)], 8, (ROWS3, X),
                   dict(rows=ROWS3, n=1, span=8, onchip_rows=R), 8),
    "v7_at_row": (v7, _stage(8), 8, (ROWS37, X), dict(rows=ROWS37, n=1), 1),
    "v8_at_block8": (v8, [pltpu.VMEM((1, 8, 512), jnp.float32), pltpu.SemaphoreType.DMA], 8,
                     (BLOCKS, X.reshape(T // 8, 8, 512)), dict(rows=BLOCKS * 8, n=1, span=8), 8),
    "v9_fori_at": (v9, _stage(), 64, (ROWS37, X), dict(rows=ROWS37, n=64), 64),
    "v10_vmem_src": (v10, [pltpu.VMEM((T, 512), jnp.float32)] + _stage(), 64, (ONCHIP37, X),
                     dict(rows=ONCHIP37, n=64, onchip_rows=R), 64),
    "v11_dyntrip": (v11, _stage(), 64, (np.array([32], np.int32), ROWS37, X),
                    dict(rows=ROWS37, n=0, count=np.array([32], np.int32)), 32),
}


@pytest.mark.parametrize("name", sorted(BISECT))
def test_row_copy_matches_bisect_kernel(name):
    kernel, scratch, out_rows, args, kw, defined = BISECT[name]
    want = np.asarray(pl.pallas_call(
        kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] * (len(args) - 1)
        + [pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((out_rows, 512), jnp.float32),
        scratch_shapes=scratch, interpret=True)(*(jnp.asarray(a) for a in args)))
    kw = {k: _t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    stage, _ = probe.row_copy(_t(X), **kw)
    np.testing.assert_array_equal(stage[:defined].numpy(), want[:defined])


# -- PC: probe_dmacost.py ----------------------------------------------------------

def _dmacost(n, L, reps, src_hbm):  # probe_dmacost.py:49-100 (kernel :50-81)
    def kernel(rows_ref, x_ref, o_ref, stage, sem, xv=None):
        src = x_ref if xv is None else xv
        if xv is not None:
            # preload HBM x into a VMEM scratch once for the V->V case
            cp = pltpu.make_async_copy(x_ref, xv, sem)
            cp.start()
            cp.wait()

        def outer(r, acc):
            def issue(i, c):
                row = rows_ref[i]
                pltpu.make_async_copy(
                    src.at[pl.ds(row, L)],
                    stage.at[pl.ds((i * L) % 2048, L)],
                    sem,
                ).start()
                return c

            jax.lax.fori_loop(0, n, issue, 0)

            def drain(i, c):
                pltpu.make_async_copy(
                    src.at[pl.ds(rows_ref[i], L)],
                    stage.at[pl.ds((i * L) % 2048, L)],
                    sem,
                ).wait()
                return c

            jax.lax.fori_loop(0, n, drain, 0)
            return acc + stage[r % 2048, r % 512]

        o_ref[0, 0] = jax.lax.fori_loop(0, reps, outer, 0.0)

    scratch = [pltpu.VMEM((2048 + 8, 512), jnp.float32), pltpu.SemaphoreType.DMA]
    if not src_hbm:
        scratch.append(pltpu.VMEM((COST_T, 512), jnp.float32))
    return pl.pallas_call(
        kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        scratch_shapes=scratch, interpret=True)


def dyn_kernel(cnt_ref, rows_ref, x_ref, o_ref, stage, sem):  # probe_dmacost.py:114-131
    def issue(i, c):
        pltpu.make_async_copy(
            x_ref.at[pl.ds(rows_ref[i], 1)],
            stage.at[pl.ds(i % 2048, 1)], sem).start()
        return c

    n = cnt_ref[0]
    jax.lax.fori_loop(0, n, issue, 0, unroll=False)

    def drain(i, c):
        pltpu.make_async_copy(
            x_ref.at[pl.ds(rows_ref[i], 1)],
            stage.at[pl.ds(i % 2048, 1)], sem).wait()
        return c

    jax.lax.fori_loop(0, n, drain, 0, unroll=False)
    o_ref[0, 0] = stage[0, 0]


COST_T = 64
_crng = np.random.default_rng(11)
COST_X = _crng.standard_normal((COST_T, 512)).astype(np.float32)
# starts inside the on-chip source for L = 8 (R - 8 + 1 rows), so that both
# sources read the same rows
COST_ROWS = _crng.integers(0, R - 7, 64).astype(np.int32)


@pytest.mark.parametrize("src_hbm", [True, False])
@pytest.mark.parametrize("L,n", [(1, 64), (8, 8)])  # n * L <= 64: no slot written twice
def test_row_copy_matches_dmacost_kernel(src_hbm, L, n):
    want = np.asarray(_dmacost(n, L, 2, src_hbm)(jnp.asarray(COST_ROWS), jnp.asarray(COST_X)))
    stage, acc = probe.row_copy(_t(COST_X), _t(COST_ROWS), n, span=L, reps=2,
                                onchip_rows=0 if src_hbm else R)
    assert acc.shape == (1,)
    np.testing.assert_array_equal(acc.numpy(), want[0])
    np.testing.assert_array_equal(stage[:n * L].numpy(),
                                  COST_X[(COST_ROWS[:n, None] + np.arange(L)).reshape(-1)])


@pytest.mark.parametrize("cnt", [64, 5])
def test_row_copy_device_count_matches_dyn_kernel(cnt):
    want = np.asarray(pl.pallas_call(
        dyn_kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        scratch_shapes=[pltpu.VMEM((2048, 512), jnp.float32), pltpu.SemaphoreType.DMA],
        interpret=True)(jnp.asarray([cnt], jnp.int32), jnp.asarray(COST_ROWS),
                        jnp.asarray(COST_X)))
    stage, acc = probe.row_copy(_t(COST_X), _t(COST_ROWS), 0,
                                count=torch.tensor([cnt], dtype=torch.int32))
    np.testing.assert_array_equal(acc.numpy(), want[0])
    np.testing.assert_array_equal(stage[:cnt].numpy(), COST_X[COST_ROWS[:cnt]])


# -- the plain version's order, the wrappers and the probe scripts ------------------------

def test_row_copy_last_writer_and_reps():
    """Copies that share a slot leave the last writer's row; every rep reads
    its value after the same copies; reps 0 or n 0 leave the stage at 0."""
    x = _t(X)
    rows = _t((np.arange(200) * 7 % (T - 8)).astype(np.int32))
    stage, acc = probe.row_copy(x, rows, 200, span=8, reps=3, ctas=4)
    want = np.zeros((64, 512), np.float32)
    for i in range(200):
        r = int(rows[i])
        want[(8 * i) % 64:(8 * i) % 64 + 8] = X[r:r + 8]
    np.testing.assert_array_equal(stage.numpy(), want)
    a = np.float32(0)
    for r in range(3):
        a = np.float32(a + want[r, r])
    np.testing.assert_array_equal(acc.numpy(), np.full(4, a, np.float32))
    for n, reps in ((0, 2), (5, 0)):
        s, a = probe.row_copy(x, rows, n, reps=reps)
        assert not s.any() and not a.any()


def test_row_copy_rejects_what_no_block_holds():
    x, rows = _t(X), _t(ROWS3)
    with pytest.raises(ValueError, match="shared memory"):
        probe.row_copy(x, rows, 1, onchip_rows=R + 1)
    with pytest.raises(ValueError, match="not prime"):
        probe.row_copy(x, rows, 1, step=2)
    with pytest.raises(ValueError, match="span"):
        probe.row_copy(x, rows, 65)


def test_wrappers_run_the_plain_versions_on_cpu(dom):
    """On CPU tensors each wrapper returns its plain version's result and
    counts no launch."""
    tt, _, xs = dom
    x, nbr6 = _t(xs["mixed scales"]), probe.face_rows(tt.nbr)
    idx = _t(np.random.default_rng(2).integers(0, 8, (8, 512)).astype(np.int32))
    before = (cuda_probe.launches_gather.n, cuda_probe.launches_copy.n)
    pairs = [
        (cuda_probe.take_along_rows(x[:8], idx), probe.take_along_rows(x[:8], idx)),
        (cuda_probe.take_rows(x, nbr6[3]), probe.take_rows(x, nbr6[3])),
        (cuda_probe.take_chain(x, nbr6, 2), probe.take_chain(x, nbr6, 2)),
    ]
    kw = dict(n=40, span=8, reps=2, onchip_rows=R, ctas=3)
    pairs += list(zip(cuda_probe.row_copy(_t(X), _t(ROWS37), **kw),
                      probe.row_copy(_t(X), _t(ROWS37), **kw)))
    for got, want in pairs:
        assert torch.equal(got, want)
    assert (cuda_probe.launches_gather.n, cuda_probe.launches_copy.n) == before
    with pytest.raises(ValueError):
        cuda_probe.take_rows(x, nbr6[3].long())
    with pytest.raises(ValueError):
        cuda_probe.take_chain(x, nbr6[:5].contiguous(), 1)


@pytest.mark.parametrize("mod", [probe_dmabisect, probe_dmabisect2])
def test_probe_cases_equal_their_expected_values(mod):
    """Every bisect variant of the probe scripts, v0-v12 (v4, v5 and v12 too, which
    the JAX kernels leave undefined or unordered), is the plain version's
    output."""
    x = probe_dmabisect.source(torch.device("cpu"))
    for name, kw, pick, want in mod.cases(x):
        assert torch.equal(pick(*probe.row_copy(x, **kw)), want), name


def test_probe_scripts_run_on_cpu(dom, capsys):
    probe_dmabisect.main(["--device", "cpu"])
    probe_dmabisect2.main(["--device", "cpu", "--rounds", "1"])
    probe_dmacost.main(["--device", "cpu", "--rounds", "1"])
    probe_dgather.main(["--device", "cpu", "--rounds", "0"])  # the bench domain, checks only
    res = probe_dgather.measure(dom[0], rounds=1)  # the timing loop on the small domain
    assert res["T"] == 512 and set(res["chain_ms_per_iter"]) == {"PG", "plain", "torch take6"}
    out = capsys.readouterr().out
    for line in ("v6_preload: OK", "v12: OK", "hbm_L8_n512: max|diff| vs plain=0.0e+00",
                 "T=4608 (4196 tiles)", "chain(reps (4, 24)): max|diff|=0.00e+00",
                 "host clock on the CPU, not a device time", "one drain: issue"):
        assert line in out, line


@pytest.mark.parametrize("mod", [probe_dgather, probe_dmabisect, probe_dmabisect2,
                                 probe_dmacost])
def test_probe_scripts_default_to_the_card(mod):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probe script would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run()
