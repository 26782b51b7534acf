"""Cross-row gathers on the card, kernel PG: the port of the JAX package's
``tools/probe_dgather.py``.

That probe asked whether Mosaic's in-kernel ``take_along_axis`` could
gather a pressure solve's cross-tile halo from a VMEM-resident ``[T, 512]``
field. Here it checks PG's three forms at the bench topology (the
4196-tile plume at capacity 4608, ``cells.py``): the 8-row per-element
gather with reversed rows, the T-row row gather through the +x face
neighbours, and the 6-face gather chain at 4 and 24 reps, each against its
plain version. It then times, by the slope (t(24) - t(4)) / 20, the chain
per iteration beside the JAX probe's reference (``torch.index_select`` of
the 6T-row face concatenation, the first T rows added), and one row gather
beside its plain version and ``torch.index_select``.

Run: python -m hnanosolver_tpu_torch.tools.probe_dgather [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from hnanosolver_tpu_torch.cells import CELLS
from hnanosolver_tpu_torch.core.topology import Topology, resolve_device
from hnanosolver_tpu_torch.ops import cuda_probe, probe
from hnanosolver_tpu_torch.timing import median_ms
from hnanosolver_tpu_torch.tools import SEED, clock, max_err, parser

REPS = (4, 24)  # the chain's two lengths; the slope is over their difference


def run(device=None, rounds: int = 3, say=print) -> dict:
    """:func:`measure` at the bench cell's topology."""
    return measure(CELLS["bench"].topology(resolve_device(device)), rounds, say)


def measure(topo: Topology, rounds: int = 3, say=print) -> dict:
    """Check and time PG on ``topo``'s device; returns the errors and
    times (ms) it printed."""
    dev = topo.nbr.device
    T = topo.capacity
    nbr6 = probe.face_rows(topo.nbr)
    x = torch.from_numpy(
        np.random.default_rng(SEED).standard_normal((T, 512), dtype=np.float32)).to(dev)
    say(f"T={T} ({topo.n_active} tiles) on {dev}")

    res = {"T": T}
    idx8 = torch.arange(7, -1, -1, dtype=torch.int32, device=dev)[:, None].expand(8, 512)
    res["small_err"] = max_err(cuda_probe.take_along_rows(x[:8], idx8.contiguous()),
                               x[:8].flip(0))
    say(f"small(8row): max|diff|={res['small_err']:.2e}")
    res["full_err"] = max_err(cuda_probe.take_rows(x, nbr6[0]), probe.take_rows(x, nbr6[0]))
    say(f"full(T-row): max|diff|={res['full_err']:.2e}")
    res["chain_err"] = max(max_err(cuda_probe.take_chain(x, nbr6, k), probe.take_chain(x, nbr6, k))
                           for k in REPS)
    say(f"chain(reps {REPS}): max|diff|={res['chain_err']:.2e}")
    if res["small_err"] or res["full_err"] or res["chain_err"]:
        raise AssertionError(f"PG differs from its reference: {res}")

    nbr_cat = nbr6.reshape(-1)
    scale = torch.tensor(probe.CHAIN_SCALE, dtype=torch.float32, device=dev)

    def take6(k):  # probe_dgather.py:116-123, XLA's take in torch
        q = x
        for _ in range(k):
            q = q + torch.index_select(q, 0, nbr_cat)[:T] * scale
        return q

    chains = {"PG": lambda k: cuda_probe.take_chain(x, nbr6, k),
              "plain": lambda k: probe.take_chain(x, nbr6, k),
              "torch take6": take6}
    rows = {"PG": lambda: cuda_probe.take_rows(x, nbr6[0]),
            "plain": lambda: probe.take_rows(x, nbr6[0]),
            "index_select": lambda: torch.index_select(x, 0, nbr6[0])}
    span = REPS[1] - REPS[0]
    res["chain_ms_per_iter"] = {k: [] for k in chains}
    res["row_ms"] = {k: [] for k in rows}
    for r in range(rounds):
        for name, fn in chains.items():
            lo, hi = (median_ms(lambda k=k: fn(k), device=dev) for k in REPS)
            res["chain_ms_per_iter"][name].append((hi - lo) / span)
        for name, fn in rows.items():
            res["row_ms"][name].append(median_ms(fn, device=dev))
        say(f"round {r}: 6-gather chain "
            + "  ".join(f"{k}={v[-1]:.4f}" for k, v in res["chain_ms_per_iter"].items())
            + " ms/iter; row gather "
            + "  ".join(f"{k}={v[-1]:.4f}" for k, v in res["row_ms"].items())
            + f" ms ({clock(dev)})")
    return res


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    run(args.device, args.rounds)


if __name__ == "__main__":
    main()
