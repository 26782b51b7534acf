"""The port's profiling utilities (``utils/timers.py``,
``utils/phase_profile.py``, ``utils/profiling.py``) and the CLI's viewer
and profiling subcommands against the JAX package's, on the CPU.

- The byte model, ``TimerRecord``'s strings and ``markdown_table`` equal
  the JAX package's exactly (integer and string bookkeeping).
- ``phase_functions``: the same phase names in the same order; one
  application of each body on a developed 16^3 plume state (made with
  numpy from a seed) within 1e-5 * max|ref| of JAX's (the step tolerance
  of tests/test_torch_step.py), the pressure body at the JAX package's
  default halo lag of 1 (the textbook solve on both sides at T = 16); the
  precision tier changes no body (the port samples f32 at every tier).
- The timers return positive host-clock seconds on the CPU (no device
  metric is claimed from them here); ``device_trace`` writes a Chrome
  trace.
- The CLI: every subcommand and option of the JAX package's parser, with
  its defaults, plus ``--device``; ``bench-report --size 16 --frames 1
  --chain 3`` prints the 8 rows; ``turntable`` of a JAX-written ``.npz``
  writes PNGs and an APNG within 1/255 of JAX's ``render_turntable``;
  ``plume --render`` writes the port's ``render_state`` of its checkpoint
  byte for byte; ``view`` without a file or ``--live`` exits as JAX's does;
  ``--device cuda`` without a card raises.
"""

import argparse
import json
import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnanosolver_tpu import cli as jcli
from hnanosolver_tpu import config as jcfg
from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.fields import FieldState as JState
from hnanosolver_tpu.io import state as jstate
from hnanosolver_tpu.utils import phase_profile as jpp
from hnanosolver_tpu.utils import timers as jtim
from hnanosolver_tpu.viewer import render as jr
from hnanosolver_tpu_torch import cli as tcli
from hnanosolver_tpu_torch import config as tcfg
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch.io import state as tstate
from hnanosolver_tpu_torch.utils import phase_profile as tpp
from hnanosolver_tpu_torch.utils import profiling as tprof
from hnanosolver_tpu_torch.utils import timers as ttim
from hnanosolver_tpu_torch.viewer import render as tr

torch.set_num_threads(1)

REL = 1e-5  # times max|ref|: one application of a phase body


@pytest.mark.parametrize("iterations", [0, 1, 20, 50, 200])
def test_full_step_bytes_per_voxel_equals_jax(iterations):
    assert ttim.REFERENCE_BYTES_PER_VOXEL == jtim.REFERENCE_BYTES_PER_VOXEL
    for ns in (1, 5):
        assert (ttim.full_step_bytes_per_voxel(iterations, ns)
                == jtim.full_step_bytes_per_voxel(iterations, ns))
    assert ttim.full_step_bytes_per_voxel(50) == 3324


def test_timer_record_strings_equal_jax():
    for args in (("step", 0.0123), ("adv", 0.0021, 2_148_352), ("p", 1e-4, 4096, 48),
                 ("zero", 0.0, 10, 10)):
        t, j = ttim.TimerRecord(*args), jtim.TimerRecord(*args)
        assert str(t) == str(j)
        assert t.voxel_updates_per_s == j.voxel_updates_per_s
        assert t.modeled_gb_per_s == j.modeled_gb_per_s


def test_markdown_table_equals_jax():
    times = {"advect_velocity (BFECC)": 0.00123, "pressure (20 RBGS iters)": 0.004567,
             "FULL STEP": 0.0081}
    assert tpp.markdown_table(times, 2_148_352) == jpp.markdown_table(times, 2_148_352)
    del times["FULL STEP"]
    assert tpp.markdown_table(times, 512) == jpp.markdown_table(times, 512)


def test_timers_and_trace_on_the_cpu(tmp_path, capsys):
    """Host-clock seconds on the CPU: positive, and a scope's record
    printed in TimerRecord's form; device_trace writes a Chrome trace with
    the program span's range in it."""
    x = torch.ones(64, 64)
    prof = ttim.Profiler(verbose=True)
    with prof.scope("matmul", voxels=4096, bytes_per_voxel=8) as out:
        out["result"] = x @ x
    assert len(prof.records) == 1 and prof.total("matmul") > 0
    assert capsys.readouterr().out.startswith("matmul Time: ")
    assert ttim.time_fn(torch.matmul, x, x, iters=3) > 0
    assert ttim.time_chained(lambda v: v * 0.5 + 1.0, x, n_steps=4, repeats=2) > 0
    assert tpp.time_chained(lambda v: (v[0] + 1.0, v[1]), (x, x), 2, 4, 2) > 0
    with tprof.device_trace(str(tmp_path / "tr")) as d:
        with tprof.span("phase:matmul"):
            (x @ x).sum()
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    trace = json.loads((tmp_path / "tr" / files[0]).read_text())
    assert any(e.get("name") == "phase:matmul" for e in trace["traceEvents"])


@pytest.fixture(scope="module")
def developed():
    """A 16^3 dense box in both packages with a developed-looking state:
    smooth velocity and the five scalars (temperature above ambient)."""
    jt = jtopo.build_topology_dense((16, 16, 16))
    T = jt.capacity
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    org = np.asarray(jt.origins)[:, None, :] * 8
    ijk = np.stack(np.meshgrid(*([np.arange(8)] * 3), indexing="ij"), -1).reshape(1, 512, 3)
    p = (org + ijk).astype(np.float32) / 16.0
    rng = np.random.default_rng(12)
    vel = np.stack([np.sin(6 * p[..., 1]), np.cos(5 * p[..., 2]), np.sin(4 * p[..., 0])])
    vel = ((vel * 8.0 + rng.standard_normal(vel.shape)) * m).astype(np.float32)
    blob = np.exp(-((p - 0.5) ** 2).sum(-1) * 8)
    sc = {"density": blob, "fuel": 0.6 * blob, "waste": 0.1 * blob,
          "temperature": 23.0 + 40.0 * blob, "flame": 0.2 * blob}
    sc = {k: (v * m).astype(np.float32) for k, v in sc.items()}
    js = JState(velocity=jnp.asarray(vel), scalars={k: jnp.asarray(v) for k, v in sc.items()})
    tt = convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                     np.asarray(jt.nbr), int(jt.n_active), device="cpu")
    return jt, js, tt, convert.state_from_numpy(vel, sc, device="cpu")


def _np_tree(x):
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in _np_tree(v)]
    return [np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()]


def test_phase_functions_equal_jax(developed):
    jt, js, tt, ts = developed
    kw = dict(dt=1.0 / 24.0, voxel_size=0.5, iterations=6)
    jph = jpp.phase_functions(jt, js, jcfg.SolverParams(**kw))
    tph = tpp.phase_functions(tt, ts, tcfg.SolverParams(**kw))
    assert [n for n, _, _ in tph] == [n for n, _, _ in jph]
    assert len(tph) == 7
    fast = tpp.phase_functions(tt, ts, tcfg.SolverParams(precision="fast", **kw))
    parity = tpp.phase_functions(tt, ts, tcfg.SolverParams(precision="parity", **kw))
    for (name, tf, tx), (_, jf, jx), (_, ff, _), (_, pf, _) in zip(tph, jph, fast, parity):
        got, want = _np_tree(tf(tx)), _np_tree(jf(jx))
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=REL * max(np.abs(w).max(), 1e-30),
                                       err_msg=name)
        for a, b in zip(_np_tree(ff(tx)), _np_tree(pf(tx))):
            assert np.array_equal(a, b), name


def _parsers(main, argv):
    """{subcommand: {option: default}} of the parser ``main`` builds
    (positionals under their dest)."""
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise SystemExit(0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(SystemExit):
            main(argv)
    sub = next(a for a in seen["parser"]._actions if isinstance(a, argparse._SubParsersAction))
    out = {}
    for name, p in sub.choices.items():
        opts = {}
        for a in p._actions:
            if isinstance(a, argparse._HelpAction):
                continue
            key = a.option_strings[0] if a.option_strings else a.dest
            opts[key] = (a.default, a.nargs, a.type, tuple(a.choices or ()))
        out[name] = opts
    return out


def test_cli_accepts_every_jax_option():
    """Every subcommand and option of the JAX package's CLI, with the same
    default, nargs, type and choices; the port adds only ``--device``."""
    jp, tp = _parsers(jcli.main, ["plume"]), _parsers(tcli.main, ["plume"])
    assert sorted(tp) == sorted(jp)
    for name, opts in jp.items():
        extra = set(tp[name]) - set(opts)
        assert extra == {"--device"}, (name, extra)
        assert tp[name]["--device"][0] == "cuda"
        for opt, spec in opts.items():
            assert tp[name][opt] == spec, (name, opt)


def _png_pixels(data: bytes, frame: int = 0) -> np.ndarray:
    """The RGB8 pixels of frame ``frame`` of a PNG/APNG written with
    filter 0 on every row (as both packages' writers do)."""
    w, h = struct.unpack(">II", data[16:24])
    pos, frames = 8, []
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IDAT":
            frames.append(body)
        elif tag == b"fdAT":
            frames.append(body[4:])
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(frames[frame]), np.uint8).reshape(h, 1 + 3 * w)
    assert not raw[:, 0].any()
    return raw[:, 1:].reshape(h, w, 3)


def test_bench_report_prints_every_phase(capsys):
    tcli.main(["bench-report", "--size", "16", "--frames", "1", "--chain", "3", "--iterations",
               "4", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "| phase | ms | % of step | Mvox/s |"
    names = [row.split("|")[1].strip() for row in lines[2:]]
    assert names == ["advect_velocity (BFECC)", "vorticity_confinement", "divergence",
                     "combustion+buoyancy", "pressure (4 RBGS iters)",
                     "subtract_pressure_gradient", "advect_scalars (5 fields, fused)",
                     "FULL STEP"]


def test_turntable_of_a_jax_checkpoint_matches_jax(tmp_path, developed):
    jt, js, _, _ = developed
    ck = str(tmp_path / "frame_0003.npz")
    jstate.save_npz(ck, jt, js, jcfg.SolverParams(), frame=3)
    out = tmp_path / "turn"
    tcli.main(["turntable", "--ckpt", ck, "--frames", "2", "--size", "24", "--view-box", "16",
               "16", "16", "--out", str(out), "--device", "cpu"])
    want = jr.render_turntable(jt, js, (16, 16, 16), frames=2, size=(24, 24))
    apng = (out / "turntable.apng").read_bytes()
    for i, w in enumerate(want):
        w8 = np.clip(w * 255.0, 0, 255).astype(np.uint8).astype(int)
        for got in (_png_pixels((out / f"turn_{i:03d}.png").read_bytes()),
                    _png_pixels(apng, i)):
            assert np.abs(got.astype(int) - w8).max() <= 1
    i = apng.index(b"acTL")
    assert struct.unpack(">II", apng[i + 4:i + 12]) == (2, 0)


def test_plume_render_writes_render_state_of_its_checkpoint(tmp_path):
    out = tmp_path / "o"
    tcli.main(["plume", "--frames", "1", "--iterations", "2", "--center", "24", "8", "24",
               "--radius", "6", "--ckpt-every", "1", "--render", "--view-box", "48", "48", "48",
               "--out", str(out), "--device", "cpu"])
    topo, st, _, frame = tstate.load_npz(str(out / "frame_0001.npz"), device="cpu")
    assert frame == 1
    tr.write_png(str(tmp_path / "want.png"), tr.render_state(topo, st, (48, 48, 48)))
    got = (out / "frame_0001.png").read_bytes()
    assert got == (tmp_path / "want.png").read_bytes()
    img = _png_pixels(got).astype(int).sum(-1)
    assert img[24, 8] > img[2, 40]  # smoke at the emitter (x, y) = (24, 8), not in a corner


def test_view_without_a_source_exits_like_jax():
    with pytest.raises(SystemExit) as t:
        tcli.main(["view", "--device", "cpu"])
    with pytest.raises(SystemExit) as j:
        jcli.main(["view"])
    assert t.value.code == j.value.code == "view: pass a volume file or --live plume|fire"


def test_device_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        tcli.main(["bench-report", "--size", "8", "--device", "cuda"])
    with pytest.raises(RuntimeError):
        tcli.main(["view", "--live", "plume", "--view-box", "32", "32", "32"])
