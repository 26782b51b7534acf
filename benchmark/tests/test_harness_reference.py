"""The plain reference agrees with the port's plain CPU path on a toy
envelope: RBGS-50 as the textbook solve and as lagged-halo blocks,
multigrid, and a grown cook. In float32 it repeats the port's arithmetic;
in float64 it lies within float32's rounding of it."""

import numpy as np
import pytest
import torch

import harness
import inputs
from reference import ops, step
from reference import topology as rt

SEED = 2 ** 31 + 99
TOL32 = 1e-6  # float32 reference: the port's op order, the CPU's vector paths aside
TOL64 = 1e-5  # float64 reference: float32 rounding over one frame


def _gap(a: dict, b: dict) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max())
               / max(float(b[k].abs().max()), 1e-30) for k in b)


def _port_and_reference(cell, frames: int):
    dev = torch.device("cpu")
    prep = harness.prepare(cell, dev)
    prog, topo, ref_topo = prep.prog, prep.topo, rt.with_index(prep.rows, dev)
    start = inputs.start_fields(cell, prep.rows, SEED, dev)
    state = prog.state(start)
    hier = prog.hierarchy(topo)
    for i in range(frames):
        state = prog.step(topo, state, hier, i)
    sp, em = cell.solver(), cell.config["emitter"]
    out = {}
    for dtype in (torch.float32, torch.float64):
        f = {k: v.to(dtype) for k, v in start.items()}
        levels = step.levels_for(ref_topo, sp, dtype)
        for _ in range(frames):
            f = step.frame(ref_topo, f, sp, em, levels)
        out[dtype] = f
    return prog.fields(state), out


@pytest.mark.parametrize("kind,fused_rows", [("fixed", 2048), ("fixed", 64), ("mg", 64)])
def test_reference_agrees_with_the_port(toy, monkeypatch, kind, fused_rows):
    from hnanosolver_tpu_torch.ops import cuda_pressure

    # at most fused_rows rows the textbook solve; above, the lagged blocks
    monkeypatch.setattr(cuda_pressure, "MAX_FUSED_ROWS", fused_rows)
    monkeypatch.setattr(ops, "MAX_FUSED_ROWS", fused_rows)
    port, ref = _port_and_reference(toy(kind), frames=2)
    assert _gap(port, ref[torch.float32]) < TOL32
    assert _gap(port, ref[torch.float64]) < TOL64


def test_reference_grown_cook_agrees_with_the_port(toy):
    cell = toy("grow")
    dev = torch.device("cpu")
    prep = harness.prepare(cell, dev)
    start = inputs.start_fields(cell, prep.rows, SEED, dev)
    seen = []
    prep.prog.cook(4, prep.topo, prep.prog.state(start),
                   lambda f, t, s: seen.append((t.keys.numpy(), prep.prog.fields(s))), None)
    sp, em = cell.solver(), cell.config["emitter"]
    topo, f = rt.with_index(prep.rows, dev), {k: v.double() for k, v in start.items()}
    caps = set()
    for keys, port in seen:
        f = step.frame(topo, f, sp, em, [])
        topo, f = step.grow(topo, f, em)
        caps.add(topo.capacity)
        assert np.array_equal(keys, topo.keys)
        assert _gap(port, f) < TOL64
    assert len(caps) > 1 and topo.n_active > prep.rows.n_active  # it grew


def test_growth_keeps_values_by_key():
    tiles = np.array([[0, 0, 0], [1, 0, 0]], np.int32)
    old = rt.build(tiles, 16, "cpu")
    state = {"density": torch.arange(16 * 512, dtype=torch.float64).reshape(16, 512)}
    state["density"][0] = 0
    state["density"][3:] = 0
    new = rt.build(np.concatenate([tiles, [[0, 1, 0]]]), 16, "cpu")
    out = step.remap(old, new, state)
    for r_new, key in enumerate(new.keys[:new.n_active + 1]):
        r_old = np.nonzero(old.keys[:old.n_active + 1] == key)[0]
        want = state["density"][r_old[0]] if len(r_old) and r_new else torch.zeros(512)
        assert torch.equal(out["density"][r_new], want.double())
