"""Whether a process's first float32 ``torch.sqrt`` repeats itself: the
repeat tool's (``tools/repeat_check.py``) differing stage reduced to one
torch call, with nothing of this package in the process that makes it.

Each run is a fresh Python process (``python -c`` on ``CHILD`` below: numpy
and torch only) that makes a ``[rows, 512]`` float32 tensor from a fixed
seed, with values in [0, 50) (the curl magnitudes' squares at 128^3 lie
there), runs one parallel elementwise op on it (so that the thread pool is
up and waiting, as it is by the confinement in a step), then takes
``torch.sqrt`` of it twice. A run is a hit when the first result is not
bitwise the second. For each hit the child reports how many values
differ, which of the ``threads`` equal chunks of the flat range they lie in
(torch's parallel loop gives each thread one chunk), and the first result's
largest error relative to the correctly rounded square root (float64
``sqrt`` rounded to float32). It also reports whether the second result is
bitwise MKL's ``vmsSqrt`` in its high-accuracy mode, called through ctypes
on torch's own library (null where that library exports no such entry),
and that result's own largest relative error.

``--warm`` first takes the sqrt of 8 values in the calling thread alone;
``--lib numpy`` repeats ``numpy.sqrt`` instead. The children inherit the
environment: ``OMP_NUM_THREADS`` sets their threads, ``ATEN_CPU_CAPABILITY``
(avx512, avx2, default) the kernels ATen dispatches to, and
``MKL_ENABLE_INSTRUCTIONS`` MKL's own. The last line is one JSON object:
the op, shape, threads, capability, those variables, runs, hits and the
hit runs' details.

Run: [OMP_NUM_THREADS=N] [ATEN_CPU_CAPABILITY=avx2]
     python -m hnanosolver_tpu_torch.tools.first_sqrt [--runs 20] [--rows 6144]
     [--warm] [--lib torch|numpy]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# argv: rows, warm (0/1), lib (torch/numpy)
CHILD = r"""
import json, sys
import numpy as np
rows, warm, lib = int(sys.argv[1]), sys.argv[2] == "1", sys.argv[3]
x = np.random.default_rng(0).random((rows, 512), dtype=np.float32) * np.float32(50)
if lib == "numpy":
    a, b = np.sqrt(x), np.sqrt(x)
    print(json.dumps({"differ": int((a != b).sum()), "threads": 1, "capability": None}))
    raise SystemExit
import torch
t = torch.from_numpy(x)
t * 1.0
if warm:
    torch.sqrt(t[0, :8])
a = torch.sqrt(t)
b = torch.sqrt(t)
ref = torch.sqrt(t.double())
def rel(y):
    return float(((y.double() - ref) / ref.clamp_min(1e-30)).abs().max())
d = (a != b).reshape(-1).nonzero().reshape(-1)
n = torch.get_num_threads()
chunk = -(-t.numel() // n)
vml = None
try:
    import ctypes, os
    lib_ = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib", "libtorch_cpu.so"))
    f = lib_.vmsSqrt
    f.argtypes = [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    f.restype = None
    r = torch.empty_like(t)
    # VML_HA | VML_FTZDAZ_OFF | VML_ERRMODE_IGNORE, as ATen passes them
    f(t.numel(), t.data_ptr(), r.data_ptr(), 0x2 | 0x140000 | 0x100)
    vml = bool(torch.equal(r, b))
except (OSError, AttributeError):
    pass
print(json.dumps({"differ": int(d.numel()), "chunks": sorted(set((d // chunk).tolist())),
                  "first_rel": rel(a), "second_rel": rel(b), "second_is_vml_ha": vml,
                  "threads": n, "capability": torch.backends.cpu.get_cpu_capability()}))
"""

ENV_SHOWN = ("ATEN_CPU_CAPABILITY", "OMP_NUM_THREADS", "OMP_WAIT_POLICY", "MKL_NUM_THREADS",
             "MKL_ENABLE_INSTRUCTIONS", "MKL_CBWR")


def run_child(rows: int, warm: bool, lib: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, str(rows), "1" if warm else "0", lib],
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--rows", type=int, default=6144, help="tile rows (6144 at 128^3)")
    ap.add_argument("--warm", action="store_true")
    ap.add_argument("--lib", choices=("torch", "numpy"), default="torch")
    args = ap.parse_args(argv)
    hits, last = [], {}
    for _ in range(args.runs):
        last = run_child(args.rows, args.warm, args.lib)
        if last["differ"]:
            hits.append({k: last[k] for k in ("differ", "chunks", "first_rel")})
    print(json.dumps({
        "op": f"{args.lib}.sqrt", "dtype": "float32", "shape": [args.rows, 512],
        "threads": last.get("threads"), "capability": last.get("capability"),
        "warm": args.warm, "env": {k: os.environ[k] for k in ENV_SHOWN if k in os.environ},
        "runs": args.runs, "hits": len(hits), "hit_runs": hits,
        "second_rel": last.get("second_rel"), "second_is_vml_ha": last.get("second_is_vml_ha")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
