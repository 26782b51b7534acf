"""The launch shapes of the probe kernels PG and PC (``csrc/probe_gather.cu``,
``csrc/probe_copy.cu``) and the host side of their cost tool, on the CPU.

- P4's form is a function of the source's rows alone: the slab form while
  one block's shared memory (``probe.SMEM_BYTES``) holds 8 columns of every
  row, the direct form above; the wrappers run the plain version on the CPU
  on either side of the limit.
- P6's block (its six neighbour rows for each of its rows) fits a block's
  shared memory, and three blocks an SM.
- PC's copies go from one lane where a copy holds 8 rows or more, else
  from a warp.
- PC skips zeroing its stage when the first batch of copies covers it:
  ``probe.first_batch_covers`` against a slot map built by brute force over
  every copy of every batch, and against the stage the plain version fills.
- ``tools/pc_cost.py``: its cases, designs and arithmetic, and that it
  refuses the CPU (it times launches).
"""

import math

import numpy as np
import pytest
import torch

from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.ops import cuda_probe, probe
from hnanosolver_tpu_torch.tools import pc_cost

torch.set_num_threads(1)


def test_slab_limit_is_what_one_block_holds():
    assert probe.SLAB_MAX_ROWS == probe.SMEM_BYTES // (probe.SLAB_COLS * 4) == 7264
    assert cuda_probe.slab_smem_bytes(probe.SLAB_MAX_ROWS) <= probe.SMEM_BYTES
    assert cuda_probe.slab_smem_bytes(probe.SLAB_MAX_ROWS + 1) > probe.SMEM_BYTES
    assert probe.SLAB_COLS * 4 == 32  # one sector of a row


@pytest.mark.parametrize("Rx,form", [(1, "slab"), (8, "slab"), (4608, "slab"),
                                     (probe.SLAB_MAX_ROWS, "slab"),
                                     (probe.SLAB_MAX_ROWS + 1, "direct"), (8192, "direct")])
def test_along_rows_form_by_source_rows(Rx, form):
    assert cuda_probe.along_rows_form(Rx) == form
    assert form in cuda_probe.ALONG_ROWS_FORMS


@pytest.mark.parametrize("Rx", [probe.SLAB_MAX_ROWS, probe.SLAB_MAX_ROWS + 1])
def test_take_along_rows_runs_the_plain_version_on_either_side_of_the_limit(Rx):
    rng = np.random.default_rng(Rx)
    x = torch.from_numpy(rng.standard_normal((Rx, 512), dtype=np.float32))
    idx = torch.from_numpy(rng.integers(0, Rx, (16, 512)).astype(np.int32))
    got = cuda_probe.take_along_rows(x, idx)
    want = x.numpy()[idx.numpy(), np.arange(512)]
    assert np.array_equal(got.numpy(), want)


def test_chain_block_fits_shared_memory():
    smem = cuda_probe.chain_smem_bytes()
    assert smem == cuda_probe.CHAIN_ROWS * 6 * probe.ROW_BYTES <= probe.SMEM_BYTES
    assert build.block_threads("take_chain_kernel") == cuda_probe.CHAIN_ROWS * 32
    # three blocks an SM: 18 rows, so the bench's 4608 rows take two waves of 132 SMs
    assert 3 * (smem + build.BLOCK_SHARED_RESERVED) <= build.SM_SHARED
    assert 4 * (smem + build.BLOCK_SHARED_RESERVED) > build.SM_SHARED
    assert math.ceil(4608 / (3 * cuda_probe.CHAIN_ROWS * 132)) == 2


@pytest.mark.parametrize("name,regs,dynamic,warps", [
    ("take_chain_kernel", 40, cuda_probe.chain_smem_bytes(), 18),  # 3 blocks of 6 warps
    ("take_slab_kernel", 32, cuda_probe.slab_smem_bytes(4608), 32),  # 1 block of 32 warps
    ("row_copy_kernel", 32, probe.copy_smem_bytes(0, 4096), 8),  # 1 block of 8 warps
])
def test_resident_warps_count_dynamic_shared_memory(name, regs, dynamic, warps):
    r = build.KernelResources(name, regs, 0, 0, 0, build.block_threads(name))
    assert r.resident_warps(dynamic) == warps
    assert f"+ {dynamic} B dynamic" in r.line(dynamic)


@pytest.mark.parametrize("n_rows", [1, 64, 512, 4096])
def test_copy_smem_bytes_bounds_the_on_chip_source(n_rows):
    R = probe.max_onchip_rows(n_rows)
    assert probe.copy_smem_bytes(R, n_rows) <= probe.SMEM_BYTES
    assert probe.copy_smem_bytes(R + 1, n_rows) > probe.SMEM_BYTES


@pytest.mark.parametrize("span,lanes", [(1, 32), (2, 32), (4, 32), (8, 1), (16, 1), (64, 1)])
def test_copy_issue_lanes_by_span(span, lanes):
    assert cuda_probe.copy_issue_lanes(span) == lanes
    # one lane issues only batches of at most 8 copies
    assert lanes == 32 or probe.STAGE_ROWS // span <= 8


def _written_by_every_copy(n, span, step, reps):
    """The stage rows written by every copy of every batch of a rep, slot by
    slot as the kernel issues them."""
    hit = np.zeros(probe.STAGE_ROWS, bool)
    if reps:
        per_batch = probe.STAGE_ROWS // span
        for b0 in range(0, n, per_batch):
            slots = [i * step * span % probe.STAGE_ROWS
                     for i in range(b0, min(b0 + per_batch, n))]
            assert len(set(slots)) == len(slots)  # a batch's slots are distinct
            for s in slots:
                hit[s:s + span] = True
    return hit


@pytest.mark.parametrize("span", [1, 2, 4, 8, 16, 32, 64])
def test_first_batch_covers_against_a_brute_force_slot_map(span):
    per_batch = probe.STAGE_ROWS // span
    steps = [s for s in (1, 3, 5, 37, 64) if math.gcd(s, per_batch) == 1]
    for step in steps:
        for n in sorted({0, 1, 2, per_batch - 1, per_batch, per_batch + 1, 3 * per_batch + 5}):
            for reps in (0, 1, 3):
                first = _written_by_every_copy(min(n, per_batch), span, step, reps)
                every = _written_by_every_copy(n, span, step, reps)
                assert np.array_equal(first, every)  # later batches write no new row
                assert probe.first_batch_covers(n, span, reps) == bool(every.all()), \
                    (n, span, step, reps)


@pytest.mark.parametrize("n,span,step", [(0, 1, 1), (5, 1, 3), (63, 1, 5), (64, 1, 1),
                                         (3, 8, 3), (8, 8, 1), (1, 64, 1), (100, 2, 5)])
def test_first_batch_covers_the_plain_stage(n, span, step):
    src = torch.ones(256, 512)
    rows = torch.arange(128, dtype=torch.int32)
    for reps in (0, 1):
        stage, _ = probe.row_copy(src, rows, n, span=span, step=step, reps=reps)
        assert bool(stage.bool().all()) == probe.first_batch_covers(n, span, reps)


def test_pc_cost_cases_and_designs():
    cases = pc_cost.cases(torch.device("cpu"))
    assert list(cases) == ["v5", "v2", "JSON launch"]
    (x5, v5), (x2, v2), (xj, js) = cases.values()
    assert v5["n"] == 0 and v2["n"] == 64 and v2.get("span", 1) == 1
    assert (js["n"], js["span"], js["reps"], js["rows"].numel()) == (512, 8, 8, 4096)
    assert x5.shape == x2.shape == (512, 512) and xj.shape == (4608, 512)
    designs = pc_cost.designs()
    assert designs["before"] == pc_cost.BEFORE == 0
    assert designs["design"] == pc_cost.DESIGN == 31
    assert sorted(designs[f"+{k}"] for k in pc_cost.PARTS) == [1, 2, 4, 8, 16]
    assert sorted(designs[f"-{k}"] for k in pc_cost.PARTS) == [15, 23, 27, 29, 30]
    assert len(set(designs.values())) == len(designs) == 12
    assert pc_cost.EMPTY & pc_cost.DESIGN == 0
    sweep = pc_cost.sweep(torch.device("cpu"))
    assert list(sweep) == list(pc_cost.SWEEP_N)
    for n, (x, kw) in sweep.items():  # every point checks against the plain version
        stage, acc = probe.row_copy(x, **dict(kw, ctas=2))
        assert stage.bool().all(1).sum() == n and acc.shape == (2,)


def test_pc_cost_parts_and_line():
    t = {"before": 6.0, "design": 2.5, "+warp issue": 5.5, "+set-up sized to n": 5.0,
         "+bulk write-out": 4.0, "+plain launch": 5.75, "+attribute once": 6.0,
         "-warp issue": 3.0, "-set-up sized to n": 2.5, "-bulk write-out": 4.5,
         "-plain launch": 2.25, "-attribute once": 2.5}
    parts = pc_cost.parts_us(t)
    assert parts == {"warp issue": (0.5, 0.5), "set-up sized to n": (1.0, 0.0),
                     "bulk write-out": (2.0, 2.0), "plain launch": (0.25, -0.25),
                     "attribute once": (0.0, 0.0)}
    b = {"device": t, "parts": parts, "span": {"before": 7.0, "design": 3.0},
         "empty": {"plain": 1.5, "cluster": 2.0},
         "host": {"wrapper": 30.0, "C entry": 5.0, "C entry, before": 6.0}}
    line = pc_cost.line("v5, 1 block", b)
    assert line.startswith("v5, 1 block: device us a launch 6.00 before, 2.50 the design")
    assert "bulk write-out 2.00 / 2.00" in line and "plain launch 0.25 / -0.25" in line
    assert "empty launch plain 1.50, cluster 2.00" in line


def test_pc_cost_device_times_take_the_median_of_passes_in_turn(monkeypatch):
    order, times = [], iter([3.0, 10.0, 1.0, 20.0, 2.0, 30.0])
    monkeypatch.setattr(pc_cost, "device_us", lambda c: (order.append(c()), next(times))[1])
    got = pc_cost.device_times({"a": lambda: "a", "b": lambda: "b"}, 3)
    assert got == {"a": 2.0, "b": 20.0} and order == ["a", "b"] * 3


def test_pc_cost_refuses_the_cpu():
    with pytest.raises(SystemExit, match="the card only"):
        pc_cost.main(["--device", "cpu"])


def test_pc_cost_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pc_cost.main([])
