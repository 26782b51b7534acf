"""Asynchronous row copies on the card, kernel PC, part 2: the port of the
JAX package's ``tools/probe_dmabisect2.py``.

On the TPU that probe tried leading-index DMAs (``.at[i]``): v7 one row,
v8 one 8-row block, v9 a loop of 64 row copies, v10 the same from a VMEM
source, v11 a loop whose trip count is read on the device, and v12 the
cost per row copy: 512 copies into a 64-row stage (slot i mod 64), the
slope between 2 and 18 reps. Here each variant runs through PC and is
checked against its expected value (rows a variant never writes read 0;
v10's on-chip source is rows ``[0, R)`` in shared memory beside the
stage), and v12 is timed with one block (the TPU's one core) and with one
block per SM, beside ``torch.index_select`` of the same 512 rows. The
slope over reps leaves out the first rep, so its copies read the 1 MB of
rows from the L2: ``probe_dmacost`` times copies from a cold L2.

Run: python -m hnanosolver_tpu_torch.tools.probe_dmabisect2 [--device cpu]
"""

from __future__ import annotations

import torch

from hnanosolver_tpu_torch.core.topology import resolve_device
from hnanosolver_tpu_torch.ops import cuda_probe, probe
from hnanosolver_tpu_torch.timing import median_ms
from hnanosolver_tpu_torch.tools import clock, ctas_all, parser
from hnanosolver_tpu_torch.tools.probe_dmabisect import N, T, check, source

V12_N = 512  # row copies per rep
V12_REPS = (2, 18)  # the slope is over their difference


def v12_rows(dev: torch.device) -> torch.Tensor:
    return (torch.arange(V12_N, dtype=torch.int32, device=dev) * 37) % T


def cases(x: torch.Tensor) -> list:
    """``(name, row_copy arguments, output of (stage, acc), expected)`` for
    v7-v12 (``probe_dmabisect2.py:50-230``; v12 at 2 reps)."""
    dev = x.device
    rows = (torch.arange(N, dtype=torch.int32, device=dev) * 37) % T
    blocks = (torch.arange(N, dtype=torch.int32, device=dev) * 11) % (T // 8)
    R = probe.max_onchip_rows(N)
    b0 = 8 * int(blocks[0])
    big = v12_rows(dev)
    last = x[big[V12_N - probe.STAGE_ROWS:].long()]  # slot s: copy 448 + s wrote it
    stage = lambda s, a: s  # noqa: E731
    return [
        ("v7_at_row", dict(rows=rows, n=1), lambda s, a: s[:8],
         torch.cat([x[rows[:1].long()], torch.zeros(7, 512, device=dev)])),
        ("v8_at_block8", dict(rows=blocks * 8, n=1, span=8), lambda s, a: s[:8], x[b0:b0 + 8]),
        ("v9_fori_at", dict(rows=rows, n=N), stage, x[rows.long()]),
        ("v10_vmem_src", dict(rows=rows, n=N, onchip_rows=R), stage, x[rows.long() % R]),
        ("v11_dyntrip", dict(rows=rows, n=0, count=torch.tensor([32], dtype=torch.int32,
                                                                device=dev)),
         stage, torch.cat([x[rows[:32].long()], torch.zeros(N - 32, 512, device=dev)])),
        ("v12", dict(rows=big, n=V12_N, reps=V12_REPS[0]),
         lambda s, a: torch.cat([s.reshape(-1), a[:1]]),
         torch.cat([last.reshape(-1), (last[0, 0] + last[1, 1]).reshape(1)])),
    ]


def run(device=None, rounds: int = 3, say=print) -> dict:
    """Check v7-v12, then time v12; returns the errors, the ns per row copy
    of each round by (source, L, blocks), as ``probe_dmacost.run``, and
    ``index_select``'s ns per row."""
    dev = resolve_device(device)
    x = source(dev)
    res = {"errs": check(x, cases(x), say)}
    big = v12_rows(dev)
    copies = (V12_REPS[1] - V12_REPS[0]) * V12_N
    out = torch.empty(V12_N, 512, device=dev)
    res["ns_per_copy"], res["index_select_ns_per_row"] = {}, {}
    for r in range(rounds):
        parts = []
        for g in (1, ctas_all(dev)):
            lo, hi = (median_ms(lambda k=k: cuda_probe.row_copy(x, big, V12_N, reps=k, ctas=g),
                                device=dev) for k in V12_REPS)
            ns = (hi - lo) * 1e6 / copies
            res["ns_per_copy"].setdefault(("hbm warm", 1, g), []).append(ns)
            parts.append(f"{g} block{'s' * (g > 1)} {ns:.1f}")
        lib = median_ms(lambda: torch.index_select(x, 0, big, out=out), device=dev) * 1e6 / V12_N
        res["index_select_ns_per_row"].setdefault((1, "warm"), []).append(lib)
        say(f"round {r}: issue+drain ns/row-copy per block: {', '.join(parts)}; "
            f"index_select {lib:.2f} ns/row ({clock(dev)})")
    return res


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    run(args.device, args.rounds)


if __name__ == "__main__":
    main()
