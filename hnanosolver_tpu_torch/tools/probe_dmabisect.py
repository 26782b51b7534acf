"""Asynchronous row copies on the card, kernel PC, part 1: the port of the
JAX package's ``tools/probe_dmabisect.py``.

On the TPU that probe bisected which DMA construct broke the Mosaic
compile, v0 (a static 8-row copy) up to v6 (a source preloaded into VMEM).
Here ``nvcc`` builds every variant with the rest, so each becomes "runs,
and equals its expected value": the same variants, by the same names, on
a ``[512, 512]`` source with a 64-row stage. v1b and v7 leave stage rows
unwritten, and v5 reads a stage it never wrote: the TPU left those
undefined; the port zeroes the stage first, and they read 0. v6's on-chip
source is rows ``[0, R)`` beside the stage in one block's shared memory
(``ops/probe.py::max_onchip_rows``; the TPU preloaded all 512 rows).

Run: python -m hnanosolver_tpu_torch.tools.probe_dmabisect [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from hnanosolver_tpu_torch.core.topology import resolve_device
from hnanosolver_tpu_torch.ops import cuda_probe, probe
from hnanosolver_tpu_torch.tools import SEED, max_err, parser

T = 512  # source rows
N = 64  # row starts


def source(dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(SEED).standard_normal((T, 512), dtype=np.float32)).to(dev)


def cases(x: torch.Tensor) -> list:
    """``(name, row_copy arguments, output of (stage, acc), expected)`` for
    v0-v6 (``probe_dmabisect.py:63-161``)."""
    dev = x.device
    rows = (torch.arange(N, dtype=torch.int32, device=dev) * 3) % T
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    R = probe.max_onchip_rows(N)
    z7 = torch.zeros(7, 512, device=dev)
    r0 = int(rows[0])
    # v3's slot (3 i) mod 64 holds copy i: slot s holds copy 43 s mod 64
    v3 = rows[(torch.arange(8, device=dev) * 43) % N].long()
    stage8 = lambda s, a: s[:8]  # noqa: E731
    acc = lambda s, a: a  # noqa: E731
    return [
        ("v0_static8", dict(rows=zero, n=1, span=8), stage8, x[0:8]),
        ("v1_dynsrc8", dict(rows=rows, n=1, span=8), stage8, x[r0:r0 + 8]),
        ("v1b_dynsrc1", dict(rows=rows, n=1, span=1), stage8, torch.cat([x[r0:r0 + 1], z7])),
        ("v2_fori64", dict(rows=rows, n=N), stage8, x[rows[:8].long()]),
        ("v3_moddst", dict(rows=rows, n=N, step=3), stage8, x[v3]),
        ("v4_smem_out", dict(rows=zero, n=1, span=8), acc, x[0, :1]),
        ("v5_dynread_vmem", dict(rows=rows, n=0), acc, torch.zeros(1, device=dev)),
        ("v6_preload", dict(rows=rows, n=1, span=8, onchip_rows=R), stage8,
         x[r0 % (R - 7):r0 % (R - 7) + 8]),
    ]


def check(x: torch.Tensor, case_list: list, say=print) -> dict:
    """Run each case through PC and print its max |diff| from the expected
    value; raise on any difference."""
    errs = {}
    for name, kw, pick, want in case_list:
        errs[name] = max_err(pick(*cuda_probe.row_copy(x, **kw)), want)
        onchip = kw.get("onchip_rows", 0)
        say(f"{name}: {'DIFFERS' if errs[name] else 'OK'} max|diff|={errs[name]:.1e}"
            + (f" (stage {probe.STAGE_ROWS} rows, on-chip source {onchip} rows)" if onchip else ""))
    bad = {k: v for k, v in errs.items() if v}
    if bad:
        raise AssertionError(f"PC differs from the expected values: {bad}")
    return errs


def run(device=None, say=print) -> dict:
    x = source(resolve_device(device))
    return check(x, cases(x), say)


def main(argv=None) -> None:
    args = parser(__doc__, timed=False).parse_args(argv)
    run(args.device)


if __name__ == "__main__":
    main()
