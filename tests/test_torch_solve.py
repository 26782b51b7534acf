"""The port's cook on user VDB files (``models/solve.py``) and its CLI
against the JAX package's, on the CPU.

The inputs are ``tests/test_cli_solve.py``'s 16^3 feedback (a density blob
rising at 1.5 voxels/s, no combustion fields) plus a second Vec3 grid that
must pass through unchanged, a source (density, temperature, fuel and a
velocity over the lower tiles) and a collision sphere SDF with a positive
background, all made from a seed with numpy.

- ``load_inputs``, ``domain_topology`` (keys and capacity bitwise) and
  ``initial_state`` equal the JAX package's; ``strict=True`` raises as
  JAX's does.
- a 2-frame cook with source and collision, through each package's CLI
  (``solve ... --ckpt-every 1``), frame by frame: the same tile keys and
  every field within ``REL`` of its max (the tolerance of
  tests/test_torch_growth.py), the SDF within 1e-5 absolute. The JAX side
  runs op by op under ``jax.disable_jit()`` (compiling its step with SDF
  probes costs XLA far more than running its ops); its domains stay at T
  <= 2048, where the port's pressure dispatch takes JAX's CPU path (the
  textbook solve).
- the CLI's files (``solve``, ``advect``, ``advect-velocity``,
  ``project``, ``project --outdiv``, the ``.npz`` resume of ``solve`` and
  the ``resume`` subcommand) against JAX's: the same grid names in the
  same order, the same leaves, values within the same tolerance. A
  checkpoint of the port resumes to its own uninterrupted output bitwise.
- the SDF is not zeroed on output; the CFL warning's text is JAX's.
- the interrupter: the drivers take ``interrupter=`` (a repaired fault:
  the JAX call raised TypeError on the port), and ``run_solve`` stops at
  it without raising.
"""

import os

import jax
import numpy as np
import pytest
import torch

from hnanosolver_tpu import cli as jcli
from hnanosolver_tpu import config as jcfg
from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.io import state as jstate
from hnanosolver_tpu.io.vdb import read_vdb as jread_vdb
from hnanosolver_tpu.models import collider as jcol
from hnanosolver_tpu.models import plume as jplume
from hnanosolver_tpu.models import solve as jsolve
from hnanosolver_tpu.utils.interrupt import Interrupter as JInterrupter
from hnanosolver_tpu_torch import cli as tcli
from hnanosolver_tpu_torch import config as tcfg
from hnanosolver_tpu_torch.core import topology as ttopo
from hnanosolver_tpu_torch.fields import COLLISION_FIELD
from hnanosolver_tpu_torch.io import state as tstate
from hnanosolver_tpu_torch.io.vdb import VdbGrid, read_vdb, write_vdb
from hnanosolver_tpu_torch.models import collider as tcol
from hnanosolver_tpu_torch.models import plume as tplume
from hnanosolver_tpu_torch.models import solve as tsolve
from hnanosolver_tpu_torch.utils.interrupt import Interrupter

torch.set_num_threads(1)

REL = 1e-5
SDF_ATOL = 1e-5
SDF_NAME = "collider"
ITERATIONS = 6  # pressure iterations of the CPU cooks (op by op, JAX's are slow)
IJK = np.stack(np.meshgrid(*([np.arange(8)] * 3), indexing="ij"), -1).reshape(512, 3)


def _box(lo, hi):
    """Leaf origins (voxel coords) of the tiles in [lo, hi)."""
    t = np.stack(np.meshgrid(*[np.arange(a, b) for a, b in zip(lo, hi)], indexing="ij"),
                 -1).reshape(-1, 3)
    return (t * 8).astype(np.int32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cook")
    rng = np.random.default_rng(30)
    org = _box((0, 0, 0), (2, 2, 2))
    pos = org[:, None, :] + IJK[None]
    blob = np.exp(-((pos - [8, 6, 8]) ** 2).sum(-1) / 12.0).astype(np.float32)
    vel = np.zeros((3, len(org), 512), np.float32)
    vel[1] = 1.5
    extra = rng.standard_normal((3, 4, 512)).astype(np.float32)
    write_vdb(str(d / "feedback.vdb"), [
        VdbGrid("density", org, blob, 0.5, grid_class="fog volume"),
        VdbGrid("velocity", org, vel, 0.5, grid_class="staggered"),
        VdbGrid("vel2", _box((4, 0, 0), (6, 2, 1)), extra, 0.5)])
    sorg = _box((0, 0, 0), (2, 1, 2))
    sb = np.exp(-((sorg[:, None, :] + IJK[None] - [8, 3, 8]) ** 2).sum(-1) / 6.0)
    svel = np.zeros((3, len(sorg), 512), np.float32)
    svel[1] = 0.5 * sb
    write_vdb(str(d / "source.vdb"), [
        VdbGrid("density", sorg, (0.5 * sb).astype(np.float32), 0.5),
        VdbGrid("temperature", sorg, (30.0 * sb).astype(np.float32), 0.5),
        VdbGrid("fuel", sorg, (0.2 * sb).astype(np.float32), 0.5),
        VdbGrid("velocity", sorg, svel, 0.5)])
    corg = _box((1, 1, 0), (3, 3, 2))
    sdf = np.sqrt(((corg[:, None, :] + IJK[None] - [16, 14, 8]) ** 2).sum(-1)) - 4.0
    write_vdb(str(d / "collision.vdb"), [
        VdbGrid(SDF_NAME, corg, sdf.astype(np.float32), 0.5, grid_class="level set",
                background=3.0)])
    return {k: str(d / f"{k}.vdb") for k in ("feedback", "source", "collision")} | {"dir": d}


def _inputs(files):
    return [files["feedback"], "--source", files["source"], "--collision", files["collision"],
            "--iterations", str(ITERATIONS)]


def _spy(module, frames):
    """module.run_solve recording (keys, velocity, scalars) after each frame."""
    real = module.run_solve

    def run_solve(*a, on_frame=None, **kw):
        def both(f, topo, st):
            frames.append((np.array(topo.keys), np.array(st.velocity),
                           {k: np.array(v) for k, v in st.scalars.items()}))
            if on_frame is not None:
                on_frame(f, topo, st)
        return real(*a, on_frame=both, **kw)
    return run_solve


NODES = {
    "advect": ["advect"],
    "advect-velocity": ["advect-velocity"],
    "project": ["project", "--iterations", "20"],
    "project-outdiv": ["project", "--outdiv"],
}


@pytest.fixture(scope="module")
def jax_ref(files, tmp_path_factory):
    """The JAX package's CLI, op by op: the 2-frame cook (frames recorded),
    its checkpoints, the operator nodes on its output, and the ``resume``
    subcommand on its frame-1 checkpoint."""
    d = tmp_path_factory.mktemp("jax")
    frames = []
    mp = pytest.MonkeyPatch()
    mp.setattr(jsolve, "run_solve", _spy(jsolve, frames))
    out = {"solve": str(d / "out.vdb")}
    with jax.disable_jit():
        jcli.main(["solve", *_inputs(files), "--frames", "2", "--ckpt-every", "1",
                   "--out", out["solve"]])
        mp.undo()
        for name, argv in NODES.items():
            out[name] = str(d / f"{name}.vdb")
            jcli.main([argv[0], out["solve"], *argv[1:], "--out", out[name]])
        (d / "resumed").mkdir()
        jcli.main(["resume", "--ckpt", str(d / "solve_0001.npz"), "--frames", "1",
                   "--out", str(d / "resumed")])
    return dict(frames=frames, out=out, dir=d)


@pytest.fixture(scope="module")
def port_run(files, tmp_path_factory):
    """The port's CLI on the CPU: the same cook, its frames recorded."""
    d = tmp_path_factory.mktemp("port")
    frames = []
    mp = pytest.MonkeyPatch()
    mp.setattr(tsolve, "run_solve", _spy(tsolve, frames))
    try:
        tcli.main(["solve", *_inputs(files), "--frames", "2", "--ckpt-every", "1",
                   "--out", str(d / "out.vdb"), "--device", "cpu"])
    finally:
        mp.undo()
    return dict(frames=frames, out=str(d / "out.vdb"), dir=d)


def _assert_fields_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        atol = SDF_ATOL if k in (COLLISION_FIELD, SDF_NAME) else REL * float(np.abs(w).max())
        np.testing.assert_allclose(got[k], w, rtol=0, atol=atol, err_msg=k)


def _assert_vdb_close(got_path: str, want_path: str):
    got, want = read_vdb(got_path), jread_vdb(want_path)
    assert [g["name"] for g in got] == [g["name"] for g in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["origins"], b["origins"], err_msg=a["name"])
        assert a["voxel_size"] == b["voxel_size"]
    _assert_fields_close({g["name"]: g["values"] for g in got},
                         {g["name"]: g["values"] for g in want})


# ---------------------------------------------------------------------------
# inputs, domain, initial state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("padding", [1, 3, 9])
def test_inputs_domain_and_initial_state_equal_jax(files, padding):
    args = (files["feedback"], files["source"], files["collision"])
    ji = jsolve.load_inputs(*args, warn=lambda m: None)
    ti = tsolve.load_inputs(*args, warn=lambda m: None)
    assert ti.voxel_size == ji.voxel_size and ti.has_source == ji.has_source
    for field in ("scalars", "source_scalars"):
        assert list(getattr(ti, field)) == list(getattr(ji, field))
    pairs = ([(ti.velocity, ji.velocity), (ti.source_velocity, ji.source_velocity),
              (ti.sdf, ji.sdf)] + list(zip(ti.extra_vecs, ji.extra_vecs))
             + [(ti.scalars[k], ji.scalars[k]) for k in ji.scalars]
             + [(ti.source_scalars[k], ji.source_scalars[k]) for k in ji.source_scalars])
    assert len(ti.extra_vecs) == len(ji.extra_vecs) == 1
    for a, b in pairs:
        for k in ("origins", "values", "leaf_masks", "background"):
            np.testing.assert_array_equal(a[k], b[k])
    jt = jsolve.domain_topology(ji, padding)
    tt = tsolve.domain_topology(ti, padding, device="cpu")
    assert tt.capacity == jt.capacity and tt.capacity % 512 == 0
    assert tt.n_active == int(jt.n_active)
    for f in ("keys", "origins", "nbr"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)))
    jw, tw = [], []
    js = jsolve.initial_state(jt, ji, warn=jw.append)
    ts = tsolve.initial_state(tt, ti, warn=tw.append)
    assert tw == jw == ["adding zero combustion fields: ['waste', 'flame']"]
    np.testing.assert_array_equal(ts.velocity.numpy(), np.asarray(js.velocity))
    assert list(ts.scalars) == list(js.scalars)
    for k in js.scalars:
        np.testing.assert_array_equal(ts.scalars[k].numpy(), np.asarray(js.scalars[k]))
    # the SDF reads its background on uncovered active rows, 0 on the rest
    sdf = ts.scalars[COLLISION_FIELD]
    assert float(sdf[0].abs().max()) == 0.0 and bool((sdf[tt.n_active + 1:] == 0).all())
    np.testing.assert_array_equal(
        tsolve._source_state(tt, ti).velocity.numpy(),
        np.asarray(jsolve._source_state(jt, ji).velocity))


def test_strict_raises_like_jax(files):
    ji = jsolve.load_inputs(files["feedback"])
    ti = tsolve.load_inputs(files["feedback"])
    jt = jsolve.domain_topology(ji, 1)
    tt = tsolve.domain_topology(ti, 1, device="cpu")
    with pytest.raises(ValueError) as je:
        jsolve.initial_state(jt, ji, strict=True)
    with pytest.raises(ValueError) as te:
        tsolve.initial_state(tt, ti, strict=True)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError):
        tcli.main(["solve", files["feedback"], "--strict", "--device", "cpu",
                   "--out", str(files["dir"] / "strict.vdb")])


# ---------------------------------------------------------------------------
# the cook, frame by frame, and the CLI's files
# ---------------------------------------------------------------------------


def test_run_solve_matches_jax_frame_by_frame(jax_ref, port_run):
    assert len(port_run["frames"]) == len(jax_ref["frames"]) == 2
    sizes = []
    for (tk, tv, ts), (jk, jv, js) in zip(port_run["frames"], jax_ref["frames"]):
        np.testing.assert_array_equal(tk, jk)
        assert len(tk) <= 2048
        sizes.append(int((tk != tk[-1]).sum()))
        _assert_fields_close({"velocity": tv, **ts}, {"velocity": jv, **js})
    assert sizes[1] > sizes[0]  # the domain grew


@pytest.mark.parametrize("node", ["solve", *NODES])
def test_cli_files_match_jax(files, jax_ref, port_run, node, tmp_path):
    """The port's CLI file against JAX's (the operator nodes on JAX's cook
    output, so both read the same file)."""
    if node == "solve":
        got = port_run["out"]
    else:
        got = str(tmp_path / f"{node}.vdb")
        argv = NODES[node]
        tcli.main([argv[0], jax_ref["out"]["solve"], *argv[1:], "--out", got,
                   "--device", "cpu"])
    _assert_vdb_close(got, jax_ref["out"][node])
    names = [g["name"] for g in read_vdb(got)]
    if node == "solve":
        assert names[0] == "velocity" and names[-1] == "vel2" and SDF_NAME in names
    if node == "project-outdiv":
        assert names == ["divergence"]


def test_solve_resumes_from_either_packages_checkpoint(files, jax_ref, port_run, tmp_path):
    """``solve <frame-1 .npz> --frames 1``: from the port's checkpoint, the
    port's uninterrupted output bitwise (every grid but the passthrough,
    which only a .vdb feedback carries); from JAX's checkpoint, JAX's
    output within REL."""
    for src, tag in ((port_run["dir"], "port"), (jax_ref["dir"], "jax")):
        out = str(tmp_path / f"resumed_{tag}.vdb")
        tcli.main(["solve", str(src / "solve_0001.npz"), "--source", files["source"],
                   "--collision", files["collision"], "--iterations", str(ITERATIONS),
                   "--frames", "1", "--out", out, "--device", "cpu"])
        got = read_vdb(out)
        if tag == "port":
            want = [g for g in read_vdb(port_run["out"]) if g["name"] != "vel2"]
            assert [g["name"] for g in got] == [g["name"] for g in want]
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a["origins"], b["origins"])
                np.testing.assert_array_equal(a["values"], b["values"], err_msg=a["name"])
        else:
            want = [g for g in jread_vdb(jax_ref["out"]["solve"]) if g["name"] != "vel2"]
            assert [g["name"] for g in got] == [g["name"] for g in want]
            _assert_fields_close({g["name"]: g["values"] for g in got},
                                 {g["name"]: g["values"] for g in want})


def test_resume_subcommand_matches_jax(jax_ref, tmp_path):
    """``resume --ckpt`` (the plume scenario from a checkpoint) on JAX's
    frame-1 checkpoint: the written frame-2 checkpoint equals JAX's."""
    tcli.main(["resume", "--ckpt", str(jax_ref["dir"] / "solve_0001.npz"), "--frames", "1",
               "--out", str(tmp_path), "--device", "cpu"])
    tt, ts, tp, tf = tstate.load_npz(str(tmp_path / "frame_0002.npz"), device="cpu")
    jt, js, jp, jf = jstate.load_npz(str(jax_ref["dir"] / "resumed" / "frame_0002.npz"))
    assert tf == jf == 2
    np.testing.assert_array_equal(tt.keys.numpy(), np.asarray(jt.keys))
    _assert_fields_close({"velocity": ts.velocity.numpy(),
                          **{k: v.numpy() for k, v in ts.scalars.items()}},
                         {"velocity": np.asarray(js.velocity),
                          **{k: np.asarray(v) for k, v in js.scalars.items()}})


def test_sdf_not_zeroed_on_output(files, port_run):
    """The SDF leaves under its input name, equal to the input grid
    re-scattered onto the final topology (its fill on uncovered rows)."""
    ti = tsolve.load_inputs(None, collision_path=files["collision"])
    g = {x["name"]: x for x in read_vdb(port_run["out"])}[SDF_NAME]
    topo = tstate.load_npz(str(port_run["dir"] / "solve_0002.npz"), device="cpu")[0]
    want = tsolve.scatter_scalar(topo, ti.sdf["origins"], ti.sdf["values"], fill=3.0)
    rows = ttopo.lookup_tiles(topo, g["origins"] // 8)  # the file holds leaves in tree order
    assert bool((rows > 0).all()) and len(rows) == topo.n_active
    np.testing.assert_array_equal(g["values"], want[rows].numpy())
    assert g["values"].min() < -3.0 and (g["values"] == 3.0).any()


def test_cfl_warning_text_equals_jax(files):
    """A dt that pushes 2*|u|*dt/dx past DISP_LIMIT: the same warning as
    JAX's, before the first step (the run stops at it here)."""
    class Stop(Exception):
        pass

    def run(mod, params, **kw):
        said = []

        def warn(msg):
            said.append(msg)
            if "CFL" in msg:
                raise Stop
        with pytest.raises(Stop):
            mod.run_solve(mod.load_inputs(files["feedback"], files["source"]), params, 1,
                          warn=warn, **kw)
        return said

    j = run(jsolve, jcfg.SolverParams(dt=2.0, iterations=2))
    t = run(tsolve, tcfg.SolverParams(dt=2.0, iterations=2), device="cpu")
    assert t == j and "CFL clamp engaged" in t[-1]


# ---------------------------------------------------------------------------
# the interrupter
# ---------------------------------------------------------------------------


PLUME_KW = dict(dt=1.0 / 24.0, iterations=2, voxel_size=0.5, halo_lag=1)
CFG_KW = dict(center=(12.0, 6.0, 12.0), radius=4.0)
COL_KW = dict(center0=(12.0, 20.0, 12.0), velocity=(48.0, 0.0, 0.0), radius=3.0)


@pytest.mark.parametrize("driver", ["plume", "collider"])
def test_drivers_take_interrupter(driver, jax_ref):
    """An Interrupter that trips after frame 1 stops a 3-frame run after
    exactly 1 frame, without raising, in both packages; the states agree.
    The topology is the driver's default tile set at the cook's capacity
    (512): the JAX side then reuses the cook's compiled ops."""
    def run(pkg_cfg, plume_mod, col_mod, topo_mod, interrupter_cls, **dev):
        params = pkg_cfg.SolverParams(**PLUME_KW)
        cfg = plume_mod.PlumeConfig(**CFG_KW)
        tiles = [plume_mod.emitter_tiles(cfg, pad=1)]
        args = [3, params, cfg]
        if driver == "collider":
            col = col_mod.ColliderConfig(**COL_KW)
            tiles.append(col_mod.collider_tiles(col, 0, params.dt))
            args.append(col)
        topo = topo_mod.build_topology(np.concatenate(tiles), capacity=512, **dev)
        fn = col_mod.run_collider if driver == "collider" else plume_mod.run_plume
        seen = []
        intr = interrupter_cls(poll=lambda: len(seen) >= 1)
        topo, st = fn(*args, topo=topo, on_frame=lambda f, t, s: seen.append(f),
                      interrupter=intr)
        return seen, topo, st

    with jax.disable_jit():
        j_seen, jt, js = run(jcfg, jplume, jcol, jtopo, JInterrupter)
    t_seen, tt, ts = run(tcfg, tplume, tcol, ttopo, Interrupter, device="cpu")
    assert t_seen == j_seen == [0]
    np.testing.assert_array_equal(tt.keys.numpy(), np.asarray(jt.keys))
    _assert_fields_close({"velocity": ts.velocity.numpy(),
                          **{k: v.numpy() for k, v in ts.scalars.items()}},
                         {"velocity": np.asarray(js.velocity),
                          **{k: np.asarray(v) for k, v in js.scalars.items()}})


def test_run_solve_stops_at_the_interrupter(files, jax_ref):
    """run_solve with a poll-based Interrupter (signal handlers need the
    main thread) that trips after frame 1 of 2 returns the frame-1 state."""
    inp = tsolve.load_inputs(files["feedback"], files["source"], files["collision"])
    seen = []
    intr = Interrupter(poll=lambda: len(seen) >= 1)
    topo, st = tsolve.run_solve(inp, tcfg.SolverParams(iterations=ITERATIONS), 2,
                                interrupter=intr,
                                on_frame=lambda f, t, s: seen.append(f), warn=lambda m: None,
                                device="cpu")
    assert seen == [0] and intr.was_interrupted()
    jk, jv, js = jax_ref["frames"][0]
    np.testing.assert_array_equal(topo.keys.numpy(), jk)
    _assert_fields_close({"velocity": st.velocity.numpy(),
                          **{k: v.numpy() for k, v in st.scalars.items()}},
                         {"velocity": jv, **js})


def test_entry_points_need_the_card_by_default(files):
    """Without a card, the new entry points raise unless given the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    inp = tsolve.load_inputs(files["feedback"])
    with pytest.raises(RuntimeError):
        tsolve.domain_topology(inp, 1)
    with pytest.raises(RuntimeError):
        tcli.main(["advect", files["feedback"], "--out", os.devnull])


@pytest.mark.parametrize("cmd,fmt", [("plume", "vdb"), ("collide", "npz"), ("fire", "nvdb"),
                                     ("plume", "vdbz")])
def test_scenario_subcommands_write_their_frames(cmd, fmt, tmp_path):
    """plume / collide / fire through the port's CLI on the CPU, one frame
    with --debug, its checkpoint in each --format read back."""
    out = tmp_path / "o"
    tcli.main([cmd, "--frames", "1", "--iterations", "2", "--ckpt-every", "1", "--format", fmt,
               "--out", str(out), "--debug", "--device", "cpu"])
    stem = "fire" if cmd == "fire" else "frame"
    if fmt == "npz":
        topo, st, params, frame = tstate.load_npz(str(out / f"{stem}_0001.npz"), device="cpu")
        assert frame == 1 and params.iterations == 2 and topo.n_active > 0
        assert COLLISION_FIELD in st.scalars
    elif fmt == "nvdb":
        from hnanosolver_tpu_torch.io.nvdb import read_nvdb_to_state

        paths = sorted(str(p) for p in (out / f"{stem}_0001").iterdir())
        topo, st, vs = read_nvdb_to_state(paths, device="cpu")
        assert vs == 0.5 and float(st.scalars["temperature"].max()) > 23.0
    else:
        names = [g["name"] for g in read_vdb(str(out / f"{stem}_0001.vdb"))]
        assert names[0] == "velocity" and "density" in names
