"""FieldState: velocity ``[3, T, 512]`` plus named scalar fields ``[T, 512]``,
float32, on the topology's device. Row 0 (the null tile) and padding rows
stay identically zero; every sampler relies on it."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from hnanosolver_tpu_torch.core.layout import TILE
from hnanosolver_tpu_torch.core.topology import Topology, active_mask

COMBUSTION_FIELDS = ("fuel", "waste", "temperature", "flame")
COLLISION_FIELD = "collision_sdf"


@dataclasses.dataclass(frozen=True)
class FieldState:
    """velocity [3,T,512] + named scalar fields [T,512]."""

    velocity: torch.Tensor
    scalars: Dict[str, torch.Tensor]

    def with_scalar(self, name: str, value: torch.Tensor) -> "FieldState":
        return dataclasses.replace(self, scalars={**self.scalars, name: value})

    def sdf(self) -> Optional[torch.Tensor]:
        """The collision SDF field, or None."""
        return self.scalars.get(COLLISION_FIELD)


def zeros_state(
    topo: Topology,
    scalar_names=("density", "temperature", "fuel", "waste", "flame"),
) -> FieldState:
    """Zero state on the topology's device. The four combustion fields must
    exist even for pure smoke (the full step reads them)."""
    T = topo.capacity
    dev = topo.device
    return FieldState(
        velocity=torch.zeros((3, T, TILE), dtype=torch.float32, device=dev),
        scalars={
            n: torch.zeros((T, TILE), dtype=torch.float32, device=dev)
            for n in scalar_names
        },
    )


def mask_state(topo: Topology, state: FieldState) -> FieldState:
    """Zero out null/padding tile rows, restoring the background invariant."""
    m = active_mask(topo)[:, None]
    return FieldState(
        velocity=state.velocity * m[None],
        scalars={k: v * m for k, v in state.scalars.items()},
    )
