"""Probe scripts: the JAX package's TPU probes (``tools/probe_dgather.py``,
``probe_dmabisect.py``, ``probe_dmabisect2.py``, ``probe_dmacost.py``)
ported to the card, through kernels PG and PC (``ops/cuda_probe.py``).

Each module runs as ``python -m hnanosolver_tpu_torch.tools.<name>``, on
the CUDA card by default (``--device cpu`` runs the plain versions), and
nothing runs at import. Every variant is checked against its expected
value before anything is timed; a difference raises. Times come from CUDA
events on the card and from the host clock on the CPU
(``hnanosolver_tpu_torch/timing.py``), and every timing line names its
clock. The inputs are made from the fixed seed ``SEED``.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional

import torch

L2_FLUSH_BYTES = 128 * 2 ** 20  # more than the H100's 50 MB L2
SEED = 0  # the probes' inputs


def clock(dev: torch.device) -> str:
    return "CUDA events" if dev.type == "cuda" else "host clock on the CPU, not a device time"


def l2_flush(dev: torch.device) -> Optional[Callable[[], object]]:
    """A call that writes 128 MB on the card, so that the next kernel finds
    the L2 cold; None on the CPU."""
    if dev.type != "cuda":
        return None
    buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    return lambda: buf.fill_(1.0)


def ctas_all(dev: torch.device) -> int:
    """One block per SM on the card (132 on an H100 SXM); 2 on the CPU,
    where the plain version only repeats its result per block."""
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).multi_processor_count
    return 2


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


def parser(doc: str, timed: bool = True) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (default: the card; raises without one) or cpu")
    if timed:
        p.add_argument("--rounds", type=int, default=3, help="timing rounds")
    return p
