"""The repeat tool (``tools/repeat_check.py``) and the reproducer of the
CPU's one differing op (``tools/first_sqrt.py``), on the CPU in one thread.

- Both modes of the repeat tool at a 16^3 box print their JSON line with no
  differing stage or repeat, and no stored output changed.
- The narrowed mode's magnitude is the step's: ``curl_mag_parts``'s
  ``sqrt`` is bitwise ``cuda_vorticity.curl_mag_at_offset`` at each of the six
  offsets, and the clones it keeps equal what it returns.
- The narrowed mode tells the two faults apart when they are made on
  purpose: a ``torch.sqrt`` whose first call computes another answer (the
  first repeat is the odd one) and one whose first output is overwritten
  by a later call (a stored output changed).
- The reproducer, in fresh processes of numpy and torch alone, finds no
  hit in one thread, in torch and in numpy, and imports nothing of this
  package.
"""

import ast
import inspect
import json

import pytest
import torch

from hnanosolver_tpu_torch.ops import cuda_vorticity
from hnanosolver_tpu_torch.tools import first_sqrt, repeat_check

# one thread: at more, this CPU's torch can compute a process's first
# float32 sqrt wrong in one thread's chunk (MKL's vmsSqrt, which torch.sqrt
# runs there; tools/first_sqrt.py, ROADMAP.md queue 3), and the repeat
# tool would then report it
torch.set_num_threads(1)

N = 16  # the box: 2x2x2 tiles
OFFSETS = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]
PARTS = ([f"g{i}" for i in range(4)] + ["wx"] + [f"g{i}" for i in range(4, 8)] + ["wy"]
         + [f"g{i}" for i in range(8, 12)] + ["wz", "sum of squares", "sqrt"])


def last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def case():
    topo, state, p = repeat_check.inputs(N, 0, torch.device("cpu"))
    return topo, state.velocity, 0.5 * p.inv_voxel_size


def test_repeat_check_stages_repeat(capsys):
    assert repeat_check.main(["--device", "cpu", "--n", str(N)]) == 0
    assert last_json(capsys) == {"n": N, "threads": 1, "differing": {}}


def test_repeat_check_narrow_repeats(capsys):
    assert repeat_check.main(["--device", "cpu", "--n", str(N), "--narrow", "4"]) == 0
    r = last_json(capsys)
    assert (r["n"], r["repeats"], r["threads"]) == (N, 4, 1)
    assert r["differing"] == {} and r["stored_changed"] == []
    assert r["odd_first"] is False and r["sqrt_rel"] == 0.0


@pytest.mark.parametrize("off", OFFSETS)
def test_curl_mag_parts_is_the_confinement_magnitude(case, off):
    topo, u, f = case
    held = {}
    parts = repeat_check.curl_mag_parts(topo, u, off, f, held)
    assert list(parts) == PARTS == list(held)
    assert torch.equal(parts["sqrt"], cuda_vorticity.curl_mag_at_offset(topo, u, off, f))
    assert all(torch.equal(parts[k], held[k]) for k in PARTS)
    assert float(parts["sqrt"].max()) > 0


def test_difference_names_the_chunk():
    a = torch.arange(4096, dtype=torch.float32).reshape(8, 512)
    b = a.clone()
    b.view(-1)[1027:1536] += 0.5  # in chunk 2 of 8 (512 values each)
    d = repeat_check.difference(a, b, 8)
    assert (d["count"], d["flat"], d["chunks"], d["chunk"]) == (509, [1027, 1535], [2], 512)
    assert d["max"] == 0.5 and 1027 <= d["at"][0] * 512 + d["at"][1] <= 1535
    assert repeat_check.difference(a, a.clone(), 8) is None


def test_narrow_finds_an_odd_first_sqrt(case, monkeypatch):
    """A sqrt whose first call is 2^-12 off in the second half of its
    range: every later repeat differs from the first in ``sqrt`` alone,
    they agree among themselves, and nothing stored changed."""
    topo, u, f = case
    real, calls = torch.sqrt, []

    def sqrt(x):
        out = real(x)
        if not calls:
            out.view(-1)[out.numel() // 2:] *= 1 + 2 ** -12
        calls.append(out)
        return out

    monkeypatch.setattr(torch, "sqrt", sqrt)
    res = repeat_check.narrow(topo, u, f, 4, say=lambda line: None)
    assert res["differing"] == {1: "sqrt", 2: "sqrt", 3: "sqrt"}
    assert res["odd_first"] is True and res["stored_changed"] == []
    assert 2 ** -13 < res["sqrt_rel"] < 2 ** -11


def test_narrow_finds_a_later_overwrite(case, monkeypatch):
    """A sqrt whose second call writes into the first call's output: the
    first repeat's ``sqrt`` is reported as changed after it was made."""
    topo, u, f = case
    real, calls = torch.sqrt, []

    def sqrt(x):
        out = real(x)
        if len(calls) == 1:
            calls[0].view(-1)[:512] += 1.0
        calls.append(out)
        return out

    monkeypatch.setattr(torch, "sqrt", sqrt)
    res = repeat_check.narrow(topo, u, f, 3, say=lambda line: None)
    assert res["stored_changed"] == ["sqrt"]
    assert res["differing"] == {1: "sqrt", 2: "sqrt"}


@pytest.mark.parametrize("lib", ["torch", "numpy"])
def test_first_sqrt_repeats_in_one_thread(capsys, monkeypatch, lib):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert first_sqrt.main(["--runs", "2", "--rows", "64", "--lib", lib]) == 0
    r = last_json(capsys)
    assert (r["op"], r["shape"], r["runs"], r["threads"]) == (f"{lib}.sqrt", [64, 512], 2, 1)
    assert r["hits"] == 0 and r["hit_runs"] == []
    if lib == "torch":
        assert r["second_rel"] <= 2 ** -23  # within an ulp of the correctly rounded root
        assert r["second_is_vml_ha"] in (True, None)


def test_first_sqrt_imports_nothing_of_the_port():
    """The tool and the code its children run import only the standard
    library, numpy and torch."""
    names = set()
    for tree in (ast.parse(inspect.getsource(first_sqrt)), ast.parse(first_sqrt.CHILD)):
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "argparse", "ctypes", "json", "numpy", "os", "subprocess",
                     "sys", "torch"}, names
