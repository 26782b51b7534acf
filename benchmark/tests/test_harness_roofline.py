"""The roofline bounds reckoned from a cell's shapes reproduce the bound
column of PERF.md's kernel table at config 5 within 5%, and count the
launches chip_smoke counts there."""

import pytest

import inputs
import roofline
import spec
from conftest import ROOT

# ms a frame at BASELINE config 5 (PERF.md, the bring-up table's bound column)
PERF_BOUNDS = {"rbgs50": {"bfecc_sample_ms": 4.463, "bfecc_tail_ms": 5.286,
                          "rbsor_lagged_ms": 5.026},
               "mg5": {"bfecc_sample_ms": 4.463, "bfecc_tail_ms": 5.286, "residual_ms": 1.915}}


@pytest.mark.parametrize("workload", ["plume1024-rbgs50", "plume1024-mg"])
def test_config5_bounds_match_perf_md(workload):
    cell = spec.load(workload, ROOT / "BENCHMARK.json")
    tiles, _ = inputs.start_tiles(cell)
    shapes = roofline.cell_shapes(cell, tiles)
    mg = cell.traffic["pressure"]["solver"] == "mg"
    for fn, want in PERF_BOUNDS["mg5" if mg else "rbgs50"].items():
        got = getattr(roofline, fn)(shapes)
        assert abs(got / want - 1.0) < 0.05, (fn, got, want)
    if mg:
        # chip_smoke phase 9: 48 B3 and 25 B6 launches a config-5 MG step
        assert sum(c for *_, c in shapes["lagged"]) == 48
        assert sum(c for _, c in shapes["residual"]) == 25
    else:
        assert shapes["lagged"] == [(269312, 5, 0, 10)]
