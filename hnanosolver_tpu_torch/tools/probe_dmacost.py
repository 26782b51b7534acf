"""The cost of one asynchronous row copy on the card, kernel PC, part 3: the
port of the JAX package's ``tools/probe_dmacost.py``, the go/no-go number
for a pressure halo assembled on chip.

Each launch makes 8 reps of n copies of span L (rows ``[rows[i], +L)`` of
a ``[4608, 512]`` source, 4096 random row starts), waits for them, and
reads one stage value per rep; the source is device memory ("hbm") or
rows ``[0, R)`` staged in the block's shared memory ("onchip"). Each
variant (L in {1, 8}, n in {64, 512}) is checked against the plain
version, and a loop whose count is read on the device against the row it
must copy. The ns per copy is the slope over n, (t(512) - t(64)) / (448
reps), with one block (the TPU's one core) and one block per SM, the
device-memory source with the L2 warm (8 reps) and cold (the L2 flushed
with a 128 MB write before each launch, 1 rep, so that every copy reads
device memory), beside ``torch.index_select`` of the same rows.

That slope holds a drain of the mbarrier after every batch of 64 / L
copies (8 drains a rep at L = 1, 64 at L = 8), where the TPU kernels drain
once. So the copies are timed a second way, "one drain": n <= 64 / L
copies a rep, all in flight together and drained once. Their cost a rep,
c(n), is a slope over reps (8 -> 72) at two n (8 and 64 at L = 1, 1 and
8 at L = 8), and c(n) = drain + n * issue parts the cost of issuing a copy
(the slope over n) from the cost of a drain (what is left at n = 0: the
wait for the last copy, the barrier and the one read a rep).

Cut from the TPU probe: its stage of 2048 + 8 rows (4 MB) fits no block's
shared memory (227 KB), so the stage holds 64 rows, filled in batches of
64 / L copies; the on-chip source holds R rows beside it, and a copy's row
start is taken mod R - L + 1.

Run: python -m hnanosolver_tpu_torch.tools.probe_dmacost [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from hnanosolver_tpu_torch.core.topology import resolve_device
from hnanosolver_tpu_torch.ops import cuda_probe, probe
from hnanosolver_tpu_torch.timing import median_ms
from hnanosolver_tpu_torch.tools import SEED, clock, ctas_all, l2_flush, max_err, parser

T = 4608  # source rows
N_ROWS = 4096  # row starts
SPANS = (1, 8)
NS = (64, 512)  # the slope is over their difference
REPS = 8
# the timed variants: (name, on-chip source, reps, flush the L2 first)
TIMED = (("hbm warm", False, REPS, False), ("hbm cold", False, 1, True),
         ("onchip", True, REPS, False))
# one drain a rep: two n of at most 64 / L copies for each L, the slope
# over reps; the sources of TIMED with the L2 warm
ONE_DRAIN_NS = {1: (8, 64), 8: (1, 8)}
ONE_DRAIN_REPS = (8, 72)


def inputs(dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The source ``[4608, 512]`` and 4096 row starts in ``[0, 4600)``."""
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((T, 512), dtype=np.float32)
    rows = rng.integers(0, T - 8, N_ROWS).astype(np.int32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(rows).to(dev)


def cases(x: torch.Tensor, rows: torch.Tensor) -> list:
    """``(name, row_copy arguments)`` of the checked variants: the source,
    L and n of ``probe_dmacost.py:102-111``, 8 reps."""
    out = []
    for tag, R in (("hbm", 0), ("onchip", probe.max_onchip_rows(rows.numel()))):
        for L in SPANS:
            for n in NS:
                out.append((f"{tag}_L{L}_n{n}",
                            dict(rows=rows, n=n, span=L, reps=REPS, onchip_rows=R)))
    return out


def run(device=None, rounds: int = 3, say=print) -> dict:
    """Check every variant and the device-side count, then time the copies;
    returns the errors, the ns per copy of each round by (source, L,
    blocks), the one-drain (issue ns a copy, drain ns a rep) of each round
    by (source, L, blocks) and ``index_select``'s ns per row by (L, L2 warm
    or cold)."""
    dev = resolve_device(device)
    x, rows = inputs(dev)
    R = probe.max_onchip_rows(rows.numel())
    say(f"T={x.shape[0]}, {rows.numel()} row starts, stage {probe.STAGE_ROWS} rows, "
        f"on-chip source {R} rows")
    res = {"errs": {}}
    for name, kw in cases(x, rows):
        got = cuda_probe.row_copy(x, **kw)
        want = probe.row_copy(x, **kw)
        res["errs"][name] = max(max_err(g, w) for g, w in zip(got, want))
        say(f"{name}: max|diff| vs plain={res['errs'][name]:.1e}")
    count = torch.tensor([64], dtype=torch.int32, device=dev)
    got = cuda_probe.row_copy(x, rows, 0, count=count)[1]
    res["errs"]["dynamic count"] = max_err(got, x[rows[:1].long(), 0])
    say(f"dynamic-count copy loop: diff={res['errs']['dynamic count']:.1e}")
    bad = {k: v for k, v in res["errs"].items() if v}
    if bad:
        raise AssertionError(f"PC differs from its reference: {bad}")

    flush = l2_flush(dev)
    res["ns_per_copy"], res["one_drain"], res["index_select_ns_per_row"] = {}, {}, {}
    for r in range(rounds):
        parts = []
        for L in SPANS:
            for tag, onchip, reps, cold in TIMED:
                for g in (1, ctas_all(dev)):
                    kw = dict(span=L, reps=reps, onchip_rows=R if onchip else 0, ctas=g)
                    t = [median_ms(lambda n=n: cuda_probe.row_copy(x, rows, n, **kw),
                                   before=flush if cold else None, device=dev) for n in NS]
                    ns = (t[1] - t[0]) * 1e6 / ((NS[1] - NS[0]) * reps)
                    res["ns_per_copy"].setdefault((tag, L, g), []).append(ns)
                    parts.append(f"{tag}_L{L} {g} block{'s' * (g > 1)}={ns:.1f}ns/cp")
                    if cold:
                        continue
                    issue, drain = one_drain(x, rows, L, R if onchip else 0, g)
                    res["one_drain"].setdefault((tag, L, g), []).append((issue, drain))
                    parts.append(f"(one drain: issue {issue:.1f}ns/cp, drain {drain:.1f}ns/rep)")
            spans = (rows[:NS[1], None] + torch.arange(L, device=dev)).reshape(-1)
            out = torch.empty(spans.numel(), 512, device=dev)
            for temp, before in (("warm", None), ("cold", flush)):
                lib = median_ms(lambda: torch.index_select(x, 0, spans, out=out),
                                before=before, device=dev) * 1e6 / spans.numel()
                res["index_select_ns_per_row"].setdefault((L, temp), []).append(lib)
                parts.append(f"index_select_L{L} {temp}={lib:.2f}ns/row")
        say(f"round {r}: " + " ".join(parts) + f" ({clock(dev)})")
    return res


def one_drain(x: torch.Tensor, rows: torch.Tensor, L: int, onchip_rows: int,
              ctas: int) -> tuple[float, float]:
    """(issue ns a copy, drain ns a rep) of copies of span ``L`` drained
    once a rep: c(n), the slope of a launch's time over reps, at the two n
    of ``ONE_DRAIN_NS[L]``, fitted as drain + n * issue."""
    dev = x.device
    c = []
    for n in ONE_DRAIN_NS[L]:
        t = [median_ms(lambda k=k: cuda_probe.row_copy(x, rows, n, span=L, reps=k,
                                                       onchip_rows=onchip_rows, ctas=ctas),
                       device=dev) for k in ONE_DRAIN_REPS]
        c.append((t[1] - t[0]) * 1e6 / (ONE_DRAIN_REPS[1] - ONE_DRAIN_REPS[0]))
    n_lo, n_hi = ONE_DRAIN_NS[L]
    issue = (c[1] - c[0]) / (n_hi - n_lo)
    return issue, c[0] - n_lo * issue


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    run(args.device, args.rounds)


if __name__ == "__main__":
    main()
