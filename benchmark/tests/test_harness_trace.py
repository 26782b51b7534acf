"""The per-layer readers on a synthetic trace: busy time as the union of
device operations, idle gaps labelled by the innermost open host
operation, device ms by kernel name, rooflines only with the cell's
shapes and never from nothing."""

import pytest

import devtrace
import harness
import roofline
import spec
from conftest import ROOT

# two frames: B1 and a PyTorch kernel overlapping in the first, B6 alone in
# the second; the host's frame span holds an inner op during one gap
DEVICE = [("void hn::bfecc_sample_kernel<3, 0, false>(float*)", 0.0, 1000.0),
          ("void at::native::vectorized_elementwise_kernel<4>(int)", 500.0, 1500.0),
          ("void hn::residual_kernel(float*)", 3000.0, 3500.0)]
HOST = [("plume_step", 0.0, 4000.0), ("aten::mul", 1600.0, 2900.0)]


def _run(shapes=None):
    rec = devtrace.Record(device_ops=list(DEVICE), host_ops=list(HOST), frames=2,
                          window_s=0.004, enqueue_s=[0.001, 0.003, 0.002], shapes=shapes)
    return harness.Run([0.002, 0.002], 2 * 512, 0.004, 0, 1.0, rec)


def _read(name, run):
    cell = spec.load("plume1024-mg", ROOT / "BENCHMARK.json")
    return spec.reader(cell, name).read(run)


def test_busy_idle_and_device_ms():
    run = _run()
    assert run.rec.busy_s() == pytest.approx(0.002)
    assert _read("step_device_ms", run) == pytest.approx(2500.0 / 1e3 / 2)
    assert _read("torch_op_device_ms", run) == pytest.approx(1000.0 / 1e3 / 2)
    assert _read("device_idle_share", run) == pytest.approx(50.0)
    assert _read("enqueue_ms", run) == pytest.approx(2.0)
    b = devtrace.breakdown(run.rec)
    assert b["idle_gaps"] == [["aten::mul", pytest.approx(0.0015)]]
    assert b["device_ops"][0][0].startswith("void hn::bfecc_sample_kernel")


def test_rooflines_need_shapes_and_their_kernel():
    assert _read("B6_roofline", _run()) is None
    shapes = {"T": 1024, "scalars": 5, "lagged": [], "residual": [(1024, 1)]}
    got = _read("B6_roofline", _run(shapes))
    assert got == pytest.approx(100.0 * roofline.residual_ms(shapes) / (500.0 / 1e3 / 2))
    assert _read("B3_roofline", _run(shapes)) is None  # no B3 ran, and no bound
    assert _read("growth_ms", _run()) is None  # nothing timed
