"""The dual-table B1 (B1d, ``csrc/bfecc_sample.cu``'s dual form) on the
CPU: its launch shape, its window check and its cost script, and its plain
version on the topologies chip_smoke holds the kernel on.

- The launch shape: mode "both" runs in the nbr form's shape (256 threads,
  two voxels a thread; 512 with the SDF probes), the split modes in
  PassShape (128 threads, four voxels a thread, for at most three fields;
  else 256), as ``build.block_threads`` reports them; every instance's
  threads times its voxels cover a tile once.
- ``bfecc_sample_dual`` (its plain version on the CPU) bitwise equal to the
  nbr-form B1 ("both", with and without the SDF) and to B8 ("back",
  "fwd") on a capacity of 102 rows (one chunk below 512), on two chunks
  whose second is mostly padding rows, and on the bench plume's topology.
- ``tools/b1d_cost.py``: refuses the CPU, and its inputs, one-chunk tables
  and table-byte counts at a small cell.
"""

import dataclasses

import numpy as np
import pytest
import torch

from hnanosolver_tpu_torch import cells
from hnanosolver_tpu_torch.core import topology as ttopo
from hnanosolver_tpu_torch.core.layout import positions_flat
from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.models.plume import build_plume_envelope
from hnanosolver_tpu_torch.ops import cuda_bfecc as tcb
from hnanosolver_tpu_torch.ops import cuda_sample as tcs
from hnanosolver_tpu_torch.ops import tables as ttab
from hnanosolver_tpu_torch.tools import b1d_cost

torch.set_num_threads(1)


@pytest.mark.parametrize("instance,threads,voxels", [
    ("bfecc_dual_kernel<3, 0, false>", 256, 2),
    ("bfecc_dual_kernel<8, 3, false>", 256, 2),
    ("bfecc_dual_kernel<8, 3, true>", 512, 1),
    ("sample_dual_kernel<1, false>", 128, 4),
    ("sample_dual_kernel<3, true>", 128, 4),
    ("sample_dual_kernel<4, false>", 256, 2),
    ("sample_dual_kernel<8, true>", 256, 2),
    ("sample_dual_kernel<11, false>", 256, 2),
])
def test_launch_shape(instance, threads, voxels):
    assert build.block_threads(instance) == threads
    assert threads * voxels == 512  # each voxel of the block's tile once


def _box(n, keep, seed):
    rng = np.random.default_rng(seed)
    box = np.array([(x, y, z) for x in range(n) for y in range(n) for z in range(n)])
    return box[rng.random(len(box)) < keep]


def _topo(name):
    if name == "bench":
        tiles = build_plume_envelope(*cells.CELLS["bench"].envelope)
        n = len(np.unique(tiles, axis=0))
        cap = ((n + 1 + 511) // 512) * 512
    elif name == "ragged_102":
        tiles, cap = _box(5, 0.8, 3)[:101], 102
    else:  # two chunks, the second mostly padding rows
        tiles, cap = np.array([(x, y, z) for x in range(9) for y in range(9)
                               for z in range(8)]), 1024
    return ttopo.build_topology(tiles, capacity=cap, device="cpu", plans=True)


CASES = {  # mode, f_lo, nb, sdf
    "both velocity": ("both", 0, 3, False),
    "both scalars": ("both", 3, 8, False),
    "both scalars sdf": ("both", 3, 6, True),
    "back": ("back", 0, 5, False),
    "fwd": ("fwd", 3, 5, False),
}


@pytest.mark.parametrize("name", ["ragged_102", "two_chunks_padding", "bench"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dual_b1_bitwise_vs_nbr_path(name, case):
    mode, f_lo, nb, has_sdf = CASES[case]
    topo = _topo(name)
    T = topo.capacity
    m = ttopo.active_mask(topo)[:, None].numpy()
    rng = np.random.default_rng(17)
    sdt = 0.35
    cap = (tcb.CFL_LIMIT if mode == "both" else tcb.CFL_MID) - 0.05
    vel = (rng.uniform(-1, 1, (3, T, 512)) * (cap / sdt) * m).astype(np.float32)
    base = torch.from_numpy(np.concatenate(
        [vel, (rng.standard_normal((nb - 3, T, 512)) * m).astype(np.float32)]))
    sdf = None
    if has_sdf:  # a plane through the domain: both probes reject some traces
        py = positions_flat(topo)[1].numpy().astype(np.float32)
        sdf = torch.from_numpy((py - float(np.median(py[m[:, 0] > 0]))) * m)
    tbl = ttab.build_table_dual(topo, base if sdf is None else torch.cat([base, sdf[None]]))
    if mode == "fwd":
        vd = torch.from_numpy((rng.uniform(-1, 1, vel.shape) * cap).astype(np.float32))
    else:
        vd = torch.from_numpy(vel)
    got = tcb.bfecc_sample_dual(tbl, topo.chunk_ldual, vd, sdt, nb, f_lo, mode, has_sdf)
    if mode == "both":
        want = tcb.bfecc_sample(topo.nbr, base, sdt, f_lo, sdf)
    else:
        d = vd if mode == "fwd" else torch.clamp(-vd * sdt, -tcb.DISP_LIMIT, tcb.DISP_LIMIT)
        got, want = [got], [tcs.sample_at(topo.nbr, base[f_lo:].contiguous(), d)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_b1d_cost_refuses_the_cpu():
    with pytest.raises(SystemExit, match="the card only"):
        b1d_cost.main(["--device", "cpu"])


@pytest.fixture(scope="module")
def small_inputs():
    bench = cells.CELLS["bench"]
    cells.CELLS["bench"] = dataclasses.replace(bench, envelope=(16, 64), develop=2)
    try:
        return b1d_cost.inputs(torch.device("cpu"))
    finally:
        cells.CELLS["bench"] = bench


def test_b1d_cost_inputs_and_launches(small_inputs):
    inp = small_inputs
    topo, sdt = inp["topo"], inp["sdt"]
    for band, cfl in b1d_cost.BANDS:
        vb, f8 = inp[band]
        assert f8.shape == (8, topo.capacity, 512) and torch.equal(f8[:3], vb)
        assert abs(float(vb.abs().max()) * sdt - cfl) < 1e-5
    runs = b1d_cost.launches(inp)
    assert [(b, mode, nb, sdf) for b, _, _, _, _, nb, _, mode, sdf in runs] == [
        ("narrow", "both", 3, False), ("narrow", "both", 3, True), ("narrow", "both", 8, False),
        ("narrow", "both", 8, True), ("mixed", "back", 3, False), ("mixed", "fwd", 3, False),
        ("mixed", "back", 8, False), ("mixed", "fwd", 8, False)]
    for _, _, tbl, ld, vd, nb, f_lo, mode, sdf in runs:  # the wrapper's checks accept each
        tcb.bfecc_sample_dual(tbl, ld, vd, sdt, nb, f_lo, mode, sdf)


def test_one_chunk_repeats_chunk_zero():
    topo = _topo("two_chunks_padding")
    f = torch.from_numpy(np.random.default_rng(2).standard_normal((3, topo.capacity, 512))
                         .astype(np.float32))
    tbl = ttab.build_table_dual(topo, f)
    one_tbl, one_ld, one_vd = b1d_cost.one_chunk(tbl, topo.chunk_ldual, f)
    assert one_tbl.shape == (1,) + tbl.shape[1:] and torch.equal(one_tbl[0], tbl[0])
    assert torch.equal(one_ld[512:], topo.chunk_ldual[:512])
    assert torch.equal(one_vd[:, 512:], f[:, :512])


def test_read_bytes_counts_the_named_rows_and_fields():
    topo = _topo("two_chunks_padding")
    ld = topo.chunk_ldual
    nc, Ud = topo.chunk_dsrc.shape[:2]
    named = sum(len(np.unique(ld[c * 512:(c + 1) * 512].numpy())) for c in range(nc))
    tbl = torch.zeros(nc, Ud * 9, 8, 64)  # 8 fields and the SDF
    assert b1d_cost.read_bytes(tbl, ld, 8, 3, "both", True) == named * 9 * 2048
    tbl = torch.zeros(nc, Ud * 8, 8, 64)
    assert b1d_cost.read_bytes(tbl, ld, 8, 3, "fwd", False) == named * 5 * 2048
    assert b1d_cost.read_bytes(tbl, ld, 8, 0, "back", False) == named * 8 * 2048
    assert named < nc * Ud  # the padding dual rows are not read
