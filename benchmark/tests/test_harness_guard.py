"""The import guard: nothing the benchmark loads is JAX or the JAX package
(top-level names compared whole), and the reference loads nothing of the
program. A run without a card, or without the program, prints no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import guard
from conftest import BENCH, ROOT


def test_forbidden_names_are_compared_whole():
    assert guard.forbidden_loaded(["hnanosolver_tpu_torch", "hnanosolver_tpu_torch.ops",
                                   "jaxtyping", "numpy"]) == []
    assert guard.forbidden_loaded(["hnanosolver_tpu.ops.advection", "jax.numpy", "flax",
                                   "jaxlib.xla_client"]) == ["flax", "hnanosolver_tpu", "jax",
                                                             "jaxlib"]


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _top_levels(code: str, cwd) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=cwd, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_imports_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {str(BENCH)!r})\n"
            "import reference.ops, reference.multigrid, reference.step, reference.topology\n"
            "import compare, inputs, roofline, spec\n"
            f"spec.scene(__import__('pathlib').Path({str(BENCH)!r}), 'plume')")
    names = _top_levels(code, BENCH)
    assert not names & {"hnanosolver_tpu_torch", "hnanosolver_tpu", "jax", "jaxlib", "flax"}


def test_a_run_loads_no_jax(tmp_path):
    from conftest import make_toy

    make_toy(tmp_path, "fixed")
    code = (f"import sys; sys.path[:0] = [{str(tmp_path / 'benchmark')!r}, {str(ROOT)!r}]\n"
            "import spec, harness\n"
            f"cell = spec.load('toy-fixed', __import__('pathlib').Path({str(tmp_path)!r}) / "
            "'BENCHMARK.json')\n"
            "out = harness.run(cell, 5, 0.2, False, 'cpu', 0.0)\n"
            "assert out['correct'], out")
    names = _top_levels(code, tmp_path)
    assert "hnanosolver_tpu_torch" in names
    assert not names & guard.FORBIDDEN


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "plume256-rbgs50",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's folder (a
    card faked present) fails before it could print a line."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "sys.argv = ['benchmark/run.py', '--workload', 'plume256-rbgs50', '--seed', '1',"
            " '--seconds', '1', '--trace', '0']\n"
            "sys.path.insert(0, 'benchmark')\n"
            "runpy.run_path('benchmark/run.py', run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "hnanosolver_tpu_torch" in out.stderr


@pytest.mark.card
def test_a_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "plume256-rbgs50",
                          "--seed", str(2 ** 31 + 3), "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
