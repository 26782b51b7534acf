"""The port's viewer (``viewer/render.py``, ``viewer/webapp.py``) against
the JAX package's, on the CPU.

Volumes and states are made from a seed with numpy and handed to both
packages. The renderers do the same f32 operations in the same order (the
orthographic composite slice by slice, the raymarch step by step with the
JAX package's ``linspace``, ``cross`` and ``norm``), but XLA may contract a
multiply-add into an FMA, so the float images are held to 1e-5 absolute
(pixel values lie in [0, 1]); PNG bytes are compared only for one array
written by both packages' writers, which are byte-identical. Sizes stay
small: 24-32 voxels a side, images of 24^2-32^2 pixels, at most 32 ray
steps.

- ``render_orthographic`` (emission and a solid, two axes),
  ``render_perspective``, ``render_state`` (flame and ``collision_sdf``,
  both modes) and ``render_turntable``;
- ``write_png`` / ``write_apng`` bytes; ``PAGE`` character for character;
- the server's endpoints (/, /meta, /volume, /step) on a free port (port
  0: JAX's own test binds a fixed port and may run at the same time);
- ``file_source`` on ``.npz``, ``.nvdb`` (scalar and vector) and ``.vdb``
  (scalar and vector): the same dense arrays as JAX's, bitwise;
- ``live_source``: after one ``/step`` at a 32^3 view box (capacity 512),
  the density volume within 1e-5 * its max of JAX's (the step tolerance of
  tests/test_torch_step.py; JAX jit-compiles its step at 512 tiles).
"""

import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hnanosolver_tpu import config as jcfg
from hnanosolver_tpu.core import topology as jtopo
from hnanosolver_tpu.fields import FieldState as JState
from hnanosolver_tpu.io import state as jstate
from hnanosolver_tpu.viewer import render as jr
from hnanosolver_tpu.viewer import webapp as jw
from hnanosolver_tpu_torch import convert
from hnanosolver_tpu_torch.core import topology as ttopo
from hnanosolver_tpu_torch.io import nvdb as tnvdb
from hnanosolver_tpu_torch.io import vdb as tvdb
from hnanosolver_tpu_torch.viewer import render as tr
from hnanosolver_tpu_torch.viewer import webapp as tw

torch.set_num_threads(1)

ATOL = 1e-5  # absolute, on images in [0, 1]
REL = 1e-5  # times max|ref|: a volume after one step


def _blob(shape, seed, centre=(0.4, 0.55, 0.5)):
    """A smooth blob plus noise, >= 0, over a box of ``shape`` voxels."""
    axes = [np.linspace(0, 1, n) for n in shape]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    r2 = (x - centre[0]) ** 2 + (y - centre[1]) ** 2 + (z - centre[2]) ** 2
    noise = np.random.default_rng(seed).random(shape)
    return (3.0 * np.exp(-r2 * 12) + 0.2 * noise).astype(np.float32)


@pytest.mark.parametrize("axis", [0, 2])
def test_render_orthographic_equals_jax(axis):
    shape = (24, 28, 32)
    dens, emit = _blob(shape, 1), _blob(shape, 2, (0.5, 0.3, 0.5))
    solid = _blob(shape, 3, (0.6, 0.6, 0.3)) > 2.0
    assert 0 < solid.mean() < 0.2
    kw = dict(axis=axis, emission=emit, solid=solid)
    got = tr.render_orthographic(dens, device="cpu", **kw)
    want = jr.render_orthographic(dens, **kw)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the solid occludes: some pixel differs from the render without it
    assert np.abs(got - tr.render_orthographic(dens, axis=axis, emission=emit,
                                               device="cpu")).max() > 0.05


def test_render_perspective_equals_jax():
    dens = _blob((20, 24, 28), 4)
    kw = dict(cam_pos=(1.6, 1.2, -0.7), size=(24, 32), steps=32, fov_deg=50.0)
    got = tr.render_perspective(dens, device="cpu", **kw)
    want = jr.render_perspective(dens, **kw)
    assert got.shape == (24, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert got.std() > 0.01  # not a blank frame


def test_renderers_take_tensors_and_need_a_device():
    dens = _blob((24, 24, 24), 5)
    t = torch.from_numpy(dens)
    assert np.array_equal(tr.render_orthographic(t), tr.render_orthographic(dens, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # arrays go to the card by default
            tr.render_orthographic(dens)


@pytest.fixture(scope="module")
def scene():
    """A dense 2x2x2-tile (16^3) state in both packages: density, flame and
    a collision SDF (a sphere), as (JAX topo, JAX state, port topo, port
    state)."""
    jt = jtopo.build_topology_dense((16, 16, 16))
    T = jt.capacity
    rng = np.random.default_rng(6)
    m = np.asarray(jtopo.active_mask(jt))[:, None]
    org = np.asarray(jt.origins)[:, None, :] * 8
    ijk = np.stack(np.meshgrid(*([np.arange(8)] * 3), indexing="ij"), -1).reshape(1, 512, 3)
    pos = (org + ijk).astype(np.float32)
    r = np.linalg.norm(pos - np.array([6.0, 9.0, 8.0]), axis=-1)
    sc = {"density": (np.exp(-r ** 2 / 20) * 2 + 0.1 * rng.random((T, 512))) * m,
          "flame": np.exp(-r ** 2 / 6) * m,
          "collision_sdf": (np.linalg.norm(pos - np.array([12.0, 4.0, 11.0]), axis=-1) - 3.5) * m}
    sc = {k: v.astype(np.float32) for k, v in sc.items()}
    vel = (rng.standard_normal((3, T, 512)) * m).astype(np.float32)
    js = JState(velocity=jnp.asarray(vel), scalars={k: jnp.asarray(v) for k, v in sc.items()})
    tt = convert.topology_from_numpy(np.asarray(jt.keys), np.asarray(jt.origins),
                                     np.asarray(jt.nbr), int(jt.n_active), device="cpu")
    return jt, js, tt, convert.state_from_numpy(vel, sc, device="cpu")


@pytest.mark.parametrize("mode", ["ortho", "persp"])
def test_render_state_equals_jax(scene, mode):
    jt, js, tt, ts = scene
    kw = {} if mode == "ortho" else dict(size=(24, 24), steps=24)
    got = tr.render_state(tt, ts, (16, 16, 24), mode=mode, **kw)
    want = jr.render_state(jt, js, (16, 16, 24), mode=mode, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_render_turntable_equals_jax(scene):
    jt, js, tt, ts = scene
    kw = dict(frames=3, size=(24, 24), steps=16)
    got = tr.render_turntable(tt, ts, (16, 16, 16), **kw)
    want = jr.render_turntable(jt, js, (16, 16, 16), **kw)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)


def test_png_and_apng_bytes_equal_jax(tmp_path):
    rng = np.random.default_rng(7)
    frames = [rng.uniform(-0.1, 1.1, (24, 32, 3)).astype(np.float32) for _ in range(3)]
    tr.write_png(str(tmp_path / "t.png"), frames[0])
    jr.write_png(str(tmp_path / "j.png"), frames[0])
    tr.write_apng(str(tmp_path / "t.apng"), frames, delay_ms=40)
    jr.write_apng(str(tmp_path / "j.apng"), frames, delay_ms=40)
    for ext in ("png", "apng"):
        assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()


def test_page_equals_jax():
    assert tw.PAGE == jw.PAGE


# no proxy: the server is on this host
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _get(base, path):
    with _OPENER.open(base + path, timeout=30) as r:
        return r.status, r.read()


def test_webapp_endpoints(scene):
    """A state's volumes served on a free port: the page, the meta, the
    u8 volumes (equal to JAX's payload of the same state), 404s for an
    unknown field and for /step on a static source."""
    jt, js, tt, ts = scene
    src = tw.state_source(tt, ts, (16, 16, 16))
    jsrc = jw.state_source(jt, js, (16, 16, 16))
    assert sorted(src.volumes) == ["density", "flame"]
    httpd, thread = tw.serve(src, port=0, block=False)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        assert _get(base, "/") == (200, jw.PAGE.encode())
        meta = json.loads(_get(base, "/meta")[1])
        assert meta == jsrc.meta()
        for f in ("density", "flame"):
            assert _get(base, f"/volume?field={f}") == (200, jsrc.payload(f))
        for bad in ("/volume?field=nope", "/step?n=1", "/elsewhere"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(base, bad)
            assert e.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_file_source_equals_jax(tmp_path, scene):
    """``.npz`` (a JAX checkpoint), ``.nvdb`` and ``.vdb`` files, scalar
    and vector grids, on tiles away from the origin: the same dense volumes
    as JAX's file_source."""
    jt, js, _, _ = scene
    npz = str(tmp_path / "state.npz")
    jstate.save_npz(npz, jt, js, jcfg.SolverParams(), frame=3)
    paths = [npz]
    tiles = np.array([(1, 0, 0), (2, 0, 0), (1, 1, -1), (3, 2, 1)])
    tt = ttopo.build_topology(tiles, device="cpu")
    rng = np.random.default_rng(8)
    m = ttopo.active_mask(tt)[:, None].numpy()
    st = convert.state_from_numpy((rng.standard_normal((3, tt.capacity, 512)) * m).astype(
        np.float32), {"density": (rng.random((tt.capacity, 512)) * m).astype(np.float32)},
        device="cpu")
    paths += tnvdb.write_state_nvdb(str(tmp_path / "nvdb"), tt, st, voxel_size=0.5)
    org = (tt.origins[1:len(tiles) + 1].numpy() * 8).astype(np.int32)
    for name, vals in (("velocity", st.velocity[:, 1:len(tiles) + 1].numpy()),
                       ("density", st.scalars["density"][1:len(tiles) + 1].numpy())):
        p = str(tmp_path / f"{name}.vdb")
        tvdb.write_vdb(p, [tvdb.VdbGrid(name, org, vals, 0.5)])
        paths.append(p)
    assert len(paths) == 5
    for p in paths:
        got = tw.file_source(p, device="cpu").volumes
        want = jw.file_source(p).volumes
        assert sorted(got) == sorted(want), p
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=p)
            assert got[k].max() > 0


def test_live_source_step_matches_jax():
    """The live plume at a 32^3 view box: one /step through the server,
    then the density volume against JAX's live_source after one step."""
    src = tw.live_source("plume", shape=(32, 32, 32), device="cpu")
    assert src.live and src.frame == 0
    httpd, thread = tw.serve(src, port=0, block=False)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        status, body = _get(base, "/step?n=1")
        assert status == 200 and json.loads(body) == {"frame": 1}
        meta = json.loads(_get(base, "/meta")[1])
        assert meta["frame"] == 1 and meta["live"] and meta["step_ms"] > 0
    finally:
        httpd.shutdown()
        httpd.server_close()
    thread.join(timeout=10)
    jsrc = jw.live_source("plume", shape=(32, 32, 32))
    jsrc.step(1)
    want = jsrc.volumes["density"]
    assert want.max() > 0
    np.testing.assert_allclose(src.volumes["density"], want, rtol=0,
                               atol=REL * np.abs(want).max())
