"""``bench_torch.py``, the port's bench, against ``bench.py`` on the CPU.

- The chain-slope estimator: the port's ``slope_estimate`` is bench.py's
  without the 5 ms floor, so it equals ``bench.slope_estimate(...,
  floor_s=0.0)`` on tests/test_bench_estimator.py's cases and on drawn
  positive samples, and gives the whole-chain bound t_hi_min / k_hi where
  the slope is not positive.
- The chain: ``make_chain`` (eager on the CPU) from a developed state
  against bench.py's ``_make_chain`` on the same topology and state, at a
  small plume envelope with ``halo_lag=1`` (on the CPU the JAX solve runs
  the textbook sweep whatever halo_lag says: tests/test_torch_step.py),
  every field within 1e-5 of its max (REL, as there).
- The JSON line: ``measure`` at that envelope prints one line with
  bench.py's keys (bench.py:254-279) less the tunnel's and plus the port's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import bench
import bench_torch
from hnanosolver_tpu import config as jcfg
from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.fields import FieldState as JState
from hnanosolver_tpu.models import plume as jplume
from hnanosolver_tpu_torch import config as tcfg
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch.cells import Cell
from hnanosolver_tpu_torch.models import plume as tplume

torch.set_num_threads(1)

K_LO, K_HI = 2, 12
REL = 1e-5
NAMES = ("density", "temperature", "fuel", "waste", "flame")
# a 148-tile plume envelope (capacity 512) and its emitter
ENVELOPE = (24, 64, 24, 24)
PARAMS_KW = dict(dt=1.0 / 24.0, iterations=20, voxel_size=0.5, halo_lag=1)
CFG_KW = dict(center=(24.0, 12.0, 24.0), radius=8.0)
CELL = Cell(envelope=ENVELOPE, plume=tplume.PlumeConfig(**CFG_KW),
            params=tcfg.SolverParams(**PARAMS_KW), develop=bench_torch.DEVELOP)
# bench.py:254-279's keys without the tunnel's (quiet_ref_ms, congested),
# with the port's develop_steps, eager_step_ms, eager_round_samples_s, device
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "domain_radius_height_vox",
             "active_tiles", "active_voxels", "capacity_tiles", "step_ms",
             "pressure_iterations", "round_samples_s", "develop_steps", "eager_step_ms",
             "eager_round_samples_s", "device"}


def _clean(step, overhead=0.6):
    return (overhead + K_LO * step, overhead + K_HI * step)


_GOOD = _clean(0.04)
# tests/test_bench_estimator.py's cases: clean rounds, one-sided noise, a
# deflated and an inverted round, near-equal chains, a mixed anchor
CANNED = {
    "clean": [_GOOD] * 3,
    "one_sided_noise": [(_GOOD[0] + 1.7, _GOOD[1] + 0.3), (_GOOD[0] + 0.2, _GOOD[1] + 2.4),
                        _GOOD],
    "deflated_and_inverted": [_GOOD, (_GOOD[1] - 0.005, _GOOD[1]), (_GOOD[1] + 0.3, _GOOD[1])],
    "near_equal_chains": [(2.0 - 0.001, 2.0), (2.0, 2.0 + 0.002)],
    "mixed_anchor": [_clean(0.04, 0.5), (0.5 + K_LO * 0.04 - 0.1, 2.0)],
}


def _reference(samples):
    """bench.py's estimator without its floor; where that gives no positive
    slope, the whole long chain over its length."""
    want = bench.slope_estimate(samples, K_LO, K_HI, floor_s=0.0)
    return want if want > 0 else min(t for _, t in samples) / K_HI


@pytest.mark.parametrize("case", sorted(CANNED))
def test_slope_matches_bench_without_floor(case):
    samples = CANNED[case]
    assert bench_torch.slope_estimate(samples, K_LO, K_HI) == _reference(samples)


def test_slope_keeps_sub_5ms_steps():
    """bench.py's floor would turn a true 1 ms step into the whole-chain
    bound; the port keeps it."""
    samples = [_clean(1e-3, 0.05)] * 2
    assert bench_torch.slope_estimate(samples, K_LO, K_HI) == pytest.approx(1e-3, rel=1e-9)
    assert bench.slope_estimate(samples, K_LO, K_HI) == pytest.approx(samples[0][1] / K_HI)


@pytest.mark.parametrize("samples", [[(2.0, 1.9), (2.1, 2.0)], [(1.5, 1.5)],
                                     [(2.0, 1.0), (1.5, 1.8)]],
                         ids=["negative", "zero", "negative_anchor"])
def test_slope_not_positive_gives_whole_chain_bound(samples):
    want = min(t for _, t in samples) / K_HI
    assert bench_torch.slope_estimate(samples, K_LO, K_HI) == want


_TIME = st.floats(min_value=1e-6, max_value=10.0, allow_nan=False, allow_infinity=False)


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(st.lists(st.tuples(_TIME, _TIME), min_size=1, max_size=8))
def test_slope_matches_bench_on_drawn_samples(samples):
    got = bench_torch.slope_estimate(samples, K_LO, K_HI)
    assert got == _reference(samples)
    assert got > 0


def _jax_state(vel, sc):
    return JState(velocity=jnp.asarray(vel), scalars={k: jnp.asarray(v) for k, v in sc.items()})


def _assert_state_close(tstate, jstate):
    tv, ts = convert.state_to_numpy(tstate)
    want = np.asarray(jstate.velocity)
    np.testing.assert_allclose(tv, want, rtol=0, atol=REL * np.abs(want).max())
    assert sorted(ts) == sorted(jstate.scalars)
    for k, v in ts.items():
        w = np.asarray(jstate.scalars[k])
        np.testing.assert_allclose(v, w, rtol=0, atol=REL * np.abs(w).max(), err_msg=k)


@pytest.fixture(scope="module")
def jax_chain():
    """bench.py's chain on the small envelope at bench.py's tight capacity:
    the fields developed by DEVELOP steps from rest, then a 2-chain from
    them (one executable: k is traced)."""
    tiles = tplume.build_plume_envelope(*ENVELOPE)
    n = len(np.unique(tiles, axis=0))
    jt = jtopo.build_topology(tiles, capacity=((n + 1 + 511) // 512) * 512)
    chain = bench._make_chain(jax, jt, jcfg.SolverParams(**PARAMS_KW),
                              jplume.PlumeConfig(**CFG_KW))
    T = jt.capacity
    rest = _jax_state(np.zeros((3, T, 512), np.float32),
                      {n_: np.zeros((T, 512), np.float32) for n_ in NAMES})
    developed = chain(rest, jnp.asarray(bench_torch.DEVELOP))
    return jt, developed, chain(developed, jnp.asarray(K_LO))


def test_develop_matches_bench(jax_chain):
    jt, developed, _ = jax_chain
    topo, state = bench_torch.develop(CELL, device="cpu")
    assert torch.equal(topo.keys, torch.from_numpy(np.array(jt.keys)))
    assert topo.capacity == jt.capacity == 512 and topo.n_active == int(jt.n_active) == 148
    _assert_state_close(state, developed)


def test_make_chain_matches_bench(jax_chain):
    jt, developed, want = jax_chain
    topo = convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                       np.asarray(jt.nbr), int(jt.n_active), device="cpu")
    state = convert.state_from_numpy(
        np.asarray(developed.velocity),
        {k: np.asarray(v) for k, v in developed.scalars.items()}, device="cpu")
    chain = bench_torch.make_chain(topo, CELL.params, CELL.plume, state, K_LO)
    got = chain()
    _assert_state_close(got, want)
    again = chain()  # every call starts from the same state
    assert torch.equal(again.velocity, got.velocity)
    assert all(torch.equal(again.scalars[k], got.scalars[k]) for k in got.scalars)
    assert float(got.scalars["density"].max()) > float(state.scalars["density"].max())


def test_measure_prints_one_line_with_bench_keys(capsys, monkeypatch):
    """One round of one repeat, the long chain cut to 4 steps (a plain step
    on the CPU takes about a second here)."""
    for name, value in (("CHAIN", 4), ("REPEATS", 1), ("ROUNDS", 1)):
        monkeypatch.setattr(bench_torch, name, value)
    rec = bench_torch.measure(CELL, device="cpu")
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == LINE_KEYS
    assert line == json.loads(json.dumps(rec))
    assert line["metric"] == "active_voxel_updates_per_sec_full_step_256plume"
    assert line["unit"] == "voxel_updates/s/chip"
    assert line["domain_radius_height_vox"] == [24, 64]
    assert (line["active_tiles"], line["active_voxels"], line["capacity_tiles"]) == (
        148, 148 * 512, 512)
    assert line["develop_steps"] == 2 and line["pressure_iterations"] == 20
    assert line["device"] == "cpu"
    for key in ("round_samples_s", "eager_round_samples_s"):
        assert len(line[key]) == 1 and len(line[key][0]) == 2
    assert line["step_ms"] > 0 and line["eager_step_ms"] > 0
    want = line["active_voxels"] / (line["step_ms"] / 1e3)
    assert line["value"] == pytest.approx(want, abs=0.05)
    # bench.py's baseline: the reference byte model (3324 B/voxel at 50
    # iterations, 48 B a voxel less for each iteration fewer) at 1008 GB/s
    assert line["vs_baseline"] == pytest.approx(want / (1008e9 / 1884), abs=5e-5)
    assert "reference byte model" in err and "1884 B/voxel" in err


def test_measure_raises_without_a_card(monkeypatch):
    """The bench's default is the card; with none it raises, never falling
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.measure()
