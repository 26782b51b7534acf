"""The seeded inputs: the same seed gives the same inputs, another seed
others on the same voxels; the tile lists are the program's own domains."""

import numpy as np
import pytest
import torch

import inputs
import spec
from conftest import ROOT
from reference import topology as rt

BENCH_FILE = ROOT / "BENCHMARK.json"


@pytest.mark.parametrize("kind", ["fixed", "grow"])
def test_same_seed_same_inputs_other_seed_other_inputs(toy, kind):
    cell = toy(kind)
    tiles, cap = inputs.start_tiles(cell)
    topo = rt.build(tiles, cap, "cpu")
    seed = 2 ** 33 + 5  # more than 32 bits
    a = inputs.start_fields(cell, topo, seed, "cpu")
    b = inputs.start_fields(cell, topo, seed, "cpu")
    c = inputs.start_fields(cell, topo, seed + 1, "cpu")
    d = inputs.start_fields(cell, topo, seed, "cpu", cook=1)  # the run's next cook
    assert set(a) == {"velocity", "density", "temperature", "fuel", "waste", "flame"}
    for k in a:
        assert torch.equal(a[k], b[k])
        assert a[k].dtype == torch.float32 and torch.isfinite(a[k]).all()
        # the null and padding rows hold zeros
        assert not a[k][..., 0, :].any() and not a[k][..., topo.n_active + 1:, :].any()
        for other in (c, d):
            assert not torch.equal(a[k], other[k])
            assert torch.equal(a[k] != 0, other[k] != 0)  # the same voxels hold values
    assert float(a["velocity"][1].max()) > 1.0 and float(a["temperature"].max()) > 50.0


@pytest.mark.parametrize("workload", ["plume256-rbgs50", "plume1024-mg"])
def test_tile_lists_are_the_program_cells(workload):
    from hnanosolver_tpu_torch.cells import CELLS

    cell = spec.load(workload, BENCH_FILE)
    tiles, cap = inputs.start_tiles(cell)
    want = CELLS["bench" if workload.startswith("plume256") else "c5"].topology("cpu")
    assert cap == want.capacity == cell.config["capacity"]
    assert len(tiles) == want.n_active == cell.config["active_tiles"]
    assert np.array_equal(rt.build(tiles, cap, "cpu").keys, want.keys.numpy())


def test_grown_start_is_the_program_emitter():
    from hnanosolver_tpu_torch.models.plume import PlumeConfig, initial_topology

    cell = spec.load("plume256-grow", BENCH_FILE)
    tiles, cap = inputs.start_tiles(cell)
    em = cell.config["emitter"]
    want = initial_topology(PlumeConfig(center=tuple(em["center"]), radius=em["radius"]),
                            device="cpu")
    assert cap == want.capacity
    assert np.array_equal(rt.build(tiles, cap, "cpu").keys, want.keys.numpy())
