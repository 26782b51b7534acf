"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the repository root. They run on the CPU; those marked ``card`` need the
CUDA card and skip without it (the test decides, never the module)."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


import json  # noqa: E402
import shutil  # noqa: E402

import pytest  # noqa: E402

# a toy plume small enough for the CPU: 70 tiles at capacity 512
TOY_ENVELOPE = {"radius_vox": 16, "height_vox": 64, "center_x": 32, "center_z": 32}
TOY_EMITTER = {"center": [32.0, 8.0, 32.0], "radius": 6.0}
TOY_TRAFFIC = {"fixed": "rbgs50", "mg": "mg5", "grow": "grow48"}
TOY_LIMITS = {"fixed": "plume256-rbgs50", "mg": "plume1024-mg", "grow": "plume256-grow"}


def make_toy(tmp: Path, kind: str) -> Path:
    """A copy of the benchmark under ``tmp`` with one cell ``toy`` added as
    new files: a toy configuration, a traffic file (the named traffic with
    shorter cooks; multigrid at 2 levels) and the limits of the real cell of
    the same kind. Returns the copy's BENCHMARK.json."""
    if not (tmp / "benchmark").exists():
        shutil.copytree(BENCH, tmp / "benchmark",
                        ignore=shutil.ignore_patterns("out", "__pycache__", "tests"))
    cfg = json.loads((BENCH / "configs" / "plume256.json").read_text())
    cfg["envelope"] = dict(TOY_ENVELOPE)
    cfg["emitter"].update(TOY_EMITTER)
    (tmp / "benchmark" / "configs" / "toy.json").write_text(json.dumps(cfg))
    tr = json.loads((BENCH / "traffic" / f"{TOY_TRAFFIC[kind]}.json").read_text())
    tr["frames_per_cook"] = 4 if kind == "grow" else 3
    if kind == "mg":
        tr["pressure"]["levels"] = 2
    (tmp / "benchmark" / "traffic" / f"toy-{kind}.json").write_text(json.dumps(tr))
    shutil.copy(BENCH / "checks" / f"{TOY_LIMITS[kind]}.json",
                tmp / "benchmark" / "checks" / f"toy-{kind}.json")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "a toy plume for the CPU",
                             "file": "benchmark/configs/toy.json", "reduced": [],
                             "why": "CPU tests"})
    bench["workloads"].append({"name": f"toy-{kind}", "config": "toy",
                               "traffic": f"toy-{kind}", "chips": 1, "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(f"toy-{kind}")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp / "BENCHMARK.json"


@pytest.fixture
def toy(tmp_path):
    """``toy(kind)`` -> the loaded toy cell of that kind ("fixed", "mg",
    "grow"), run on the CPU with one thread."""
    import spec
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)

    def make(kind: str):
        return spec.load(f"toy-{kind}", make_toy(tmp_path, kind))

    yield make
    torch.set_num_threads(threads)
