"""The port's user examples (``hnanosolver_tpu_torch/examples/``) against the
JAX package's (``examples/*.py``) on the CPU: each runs for one frame with
the example's own configuration, and the state it saves is held to what the
JAX example saves from the same run (the JAX side op by op under
``jax.disable_jit()``: its jit of each new capacity would take minutes on
the CPU).

- fireball: ``run_fire`` is wrapped in both example modules so that the one
  frame run counts as frame 12, where the example checkpoints (it saves
  every 12 frames); the npz's topology bitwise, its fields within 1e-5
  times max(max|ref|, 1) (tests/test_torch_fire.py's allowance for a
  growing fire), and a PNG beside it.
- smoke_to_nvdb: ``--frames 1 --export-every 1``; each .nvdb grid's leaves
  bitwise, its values within 1e-5 times max|ref| (tests/test_torch_growth.py's
  allowance for a plume step), and the preview PNG.
- view_and_export: ``--frames 1 --port 0``; final.vdb and final_zip.vdb
  (ZIP) read back with the port's reader, leaves bitwise and values within
  1e-5 times max|ref|. The port's example runs in a thread until its
  viewer serves; the test reads the page over HTTP and shuts the server
  down, and the thread ends. The JAX example's ``webapp.serve`` is
  replaced by a no-op.
"""

import glob
import importlib.util
import os
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

import hnanosolver_tpu.viewer.webapp as jwebapp
from hnanosolver_tpu_torch.examples import fireball, smoke_to_nvdb, view_and_export
from hnanosolver_tpu_torch.io.nvdb import read_nvdb
from hnanosolver_tpu_torch.io.vdb import read_vdb
from hnanosolver_tpu_torch.viewer import webapp as twebapp

torch.set_num_threads(1)

REL = 1e-5
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # localhost direct
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(mod, argv, monkeypatch):
    monkeypatch.setattr("sys.argv", [mod.__file__] + argv)
    with jax.disable_jit():
        mod.main()


def _close(got, want, floor=0.0):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=REL * max(np.abs(want).max(), floor))


def _as_frame(mod, name: str, shift: int, monkeypatch):
    """Wrap ``mod.<name>`` (a frame loop) so that frame f reaches
    ``on_frame`` as frame f + shift."""
    real = getattr(mod, name)

    def shifted(*a, on_frame, **kw):
        return real(*a, on_frame=lambda f, t, s: on_frame(f + shift, t, s), **kw)

    monkeypatch.setattr(mod, name, shifted)


def test_fireball_matches_jax(tmp_path, monkeypatch):
    jmod = _jax_example("fireball")
    for mod in (jmod, fireball):
        _as_frame(mod, "run_fire", 11, monkeypatch)
    _run_jax(jmod, ["--frames", "1", "--out", str(tmp_path / "jax")], monkeypatch)
    fireball.main(["--frames", "1", "--out", str(tmp_path / "port"), "--device", "cpu"])
    want = np.load(tmp_path / "jax" / "fire_0012.npz")
    got = np.load(tmp_path / "port" / "fire_0012.npz")
    assert os.path.getsize(tmp_path / "port" / "fire_0012.png") > 0
    assert sorted(got.files) == sorted(want.files)
    for k in ("keys", "origins", "nbr"):
        np.testing.assert_array_equal(got[k], want[k])
    _close(got["velocity"], want["velocity"])
    for k in got.files:
        if k.startswith("scalar_"):
            _close(got[k], want[k], floor=1.0)


def test_smoke_to_nvdb_matches_jax(tmp_path):
    jmod = _jax_example("smoke_to_nvdb")
    argv = ["--frames", "1", "--export-every", "1"]
    with pytest.MonkeyPatch.context() as mp:
        _run_jax(jmod, argv + ["--out", str(tmp_path / "jax")], mp)
    smoke_to_nvdb.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    names = sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "jax" / "*.nvdb")))
    assert len(names) == 3  # velocity, density, temperature
    assert names == sorted(os.path.basename(p)
                           for p in glob.glob(str(tmp_path / "port" / "*.nvdb")))
    for n in names:
        g_name, g_vs, g_org, g_val, g_mask = read_nvdb(str(tmp_path / "port" / n))
        w_name, w_vs, w_org, w_val, w_mask = read_nvdb(str(tmp_path / "jax" / n))
        assert (g_name, g_vs) == (w_name, w_vs)
        np.testing.assert_array_equal(g_org, w_org)
        np.testing.assert_array_equal(g_mask, w_mask)
        _close(g_val, w_val)
    assert os.path.getsize(tmp_path / "port" / "preview_0001.png") > 0


def test_view_and_export_matches_jax_and_serves(tmp_path, monkeypatch):
    jmod = _jax_example("view_and_export")
    monkeypatch.setattr(jwebapp, "serve", lambda *a, **kw: None)
    argv = ["--frames", "1", "--port", "0"]
    _run_jax(jmod, argv + ["--out", str(tmp_path / "jax")], monkeypatch)

    servers = []

    class Recorded(twebapp.ThreadingHTTPServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    monkeypatch.setattr(twebapp, "ThreadingHTTPServer", Recorded)
    errors = []

    def run():
        try:
            view_and_export.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
        except BaseException as e:  # re-raised in the test's thread below
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.monotonic() + 300
    while not servers and t.is_alive() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not errors, errors
    assert servers, "the example never started its viewer"
    httpd = servers[0]
    try:
        port = httpd.server_address[1]
        with _OPENER.open(f"http://127.0.0.1:{port}/", timeout=30) as r:
            assert r.status == 200 and b"<canvas" in r.read()
        with _OPENER.open(f"http://127.0.0.1:{port}/meta", timeout=30) as r:
            assert r.status == 200
    finally:
        httpd.shutdown()
        httpd.server_close()
    t.join(timeout=30)
    assert not t.is_alive()
    assert not errors, errors

    for name in ("final.vdb", "final_zip.vdb"):
        got = {g["name"]: g for g in read_vdb(str(tmp_path / "port" / name))}
        want = {g["name"]: g for g in read_vdb(str(tmp_path / "jax" / name))}
        assert sorted(got) == sorted(want)
        for n, w in want.items():
            np.testing.assert_array_equal(got[n]["origins"], w["origins"])
            _close(got[n]["values"], w["values"])
