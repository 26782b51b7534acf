"""The output check fails what it must: a run whose frame path is broken
underneath (the check for a card skipped, the rest of the run driven on the CPU)
comes out not correct, once for each fault a cell can have, and the
bfloat16 control fails the limits the sound program passes."""

import dataclasses

import pytest
import torch

import calibrate
import harness

SEED = 2 ** 31 + 2024


def _unchanged(real):
    return lambda topo, state, *a, **k: state


def _half_rows(real):
    """Half of the active tiles left out: their rows keep the input's values."""
    def step(topo, state, *a, **k):
        out = real(topo, state, *a, **k)
        h = topo.n_active // 2 + 1
        vel = out.velocity.clone()
        vel[:, h:] = state.velocity[:, h:]
        scalars = {n: torch.cat([v[:h], state.scalars[n][h:]]) for n, v in out.scalars.items()}
        return dataclasses.replace(out, velocity=vel, scalars=scalars)
    return step


def _altered(real):
    """One answer altered where it is produced: one voxel's density off by
    1% of the field's largest value."""
    def step(topo, state, *a, **k):
        out = real(topo, state, *a, **k)
        d = out.scalars["density"].clone()
        d[1, 0] += 0.01 * float(d.abs().max())
        return out.with_scalar("density", d)
    return step


FAULTS = {"unchanged": _unchanged, "half_rows": _half_rows, "altered": _altered}


@pytest.mark.parametrize("kind", ["fixed", "mg", "grow"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_frame_path_is_not_correct(toy, monkeypatch, kind, fault):
    from hnanosolver_tpu_torch.models import plume

    cell = toy(kind)
    monkeypatch.setattr(plume, "plume_step", FAULTS[fault](plume.plume_step))
    out = harness.run(cell, SEED, 0.3, False, "cpu", 0.0)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_growth_left_out_is_not_correct(toy, monkeypatch):
    from hnanosolver_tpu_torch.models import plume

    monkeypatch.setattr(plume, "expand_for_state", lambda topo, state, **kw: (topo, state))
    out = harness.run(toy("grow"), SEED, 0.3, False, "cpu", 0.0)
    assert out["correct"] is False
    assert out["checks"]["last_tiles_off"]["value"] > 0


@pytest.mark.parametrize("kind", ["fixed", "grow"])
def test_the_sound_program_passes_and_the_control_fails(toy, kind):
    cell = toy(kind)
    r = calibrate.readings(cell, torch.device("cpu"), seeds=2, control_seeds=1, seconds=0.3,
                           frames=3, first_seed=SEED)
    for name, s in r["summary"].items():
        limit = cell.limits[name]
        assert s["program_max"] <= limit, (name, s)
        if name.endswith("_gap"):
            assert s["control_min"] > limit, (name, s)
