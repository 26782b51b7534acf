"""Carry topologies and field states between numpy and the port.

The JAX package's arrays convert to numpy with ``np.asarray``; these
helpers turn such arrays into the port's tensors and back, so that both
packages can be fed identical inputs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from hnanosolver_tpu_torch.core.topology import Topology, _dual_local, resolve_device
from hnanosolver_tpu_torch.fields import FieldState


PLAN_FIELDS = ("chunk_uniq", "chunk_lnbr", "chunk_dsrc", "chunk_ldual", "chunk_dloc")


def topology_from_numpy(keys, origins, nbr, n_active, device=None, **plans) -> Topology:
    """Topology on ``device`` (default: the CUDA card) from numpy ``keys
    [T]``, ``origins [T,3]``, ``nbr [T,27]`` (all int32) and the active row
    count. ``plans``: the chunk plans (``PLAN_FIELDS``), carried across as
    given, all or none (None entries count as absent); ``chunk_dloc`` is
    computed when it is the one missing (the JAX package builds it only on
    demand)."""
    device = resolve_device(device)
    plans = {k: v for k, v in plans.items() if v is not None}
    unknown = set(plans) - set(PLAN_FIELDS)
    if unknown:
        raise TypeError(f"unknown plan fields {sorted(unknown)}")
    missing = set(PLAN_FIELDS[:4]) - set(plans)
    if plans and missing:
        raise TypeError(f"chunk plans come all or none: missing {sorted(missing)}")
    if plans and "chunk_dloc" not in plans:
        plans["chunk_dloc"] = _dual_local(np.asarray(plans["chunk_uniq"]),
                                          np.asarray(plans["chunk_dsrc"]))

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)

    return Topology(keys=t(keys), origins=t(origins), nbr=t(nbr), n_active=int(n_active),
                    **{k: t(v) for k, v in plans.items()})


def state_from_numpy(
    velocity: np.ndarray, scalars: Dict[str, np.ndarray], device=None
) -> FieldState:
    """FieldState on ``device`` (default: the CUDA card) from numpy
    ``velocity [3,T,512]`` and ``{name: [T,512]}``."""
    device = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    return FieldState(velocity=t(velocity),
                      scalars={k: t(v) for k, v in scalars.items()})


def state_to_numpy(state: FieldState) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """(velocity [3,T,512], {name: [T,512]}) as float32 numpy arrays."""
    def n(x):
        return x.detach().to("cpu").numpy()

    return n(state.velocity), {k: n(v) for k, v in state.scalars.items()}
