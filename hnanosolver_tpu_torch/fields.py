"""FieldState: velocity ``[3, T, 512]`` plus named scalar fields ``[T, 512]``,
float32, on the topology's device. Row 0 (the null tile) and padding rows
stay identically zero; every sampler relies on it. Block views
``[T,8,8,8]`` / ``[T,8,8,8,3]`` serve the API boundaries (I/O, tests)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from hnanosolver_tpu_torch.core import layout as L
from hnanosolver_tpu_torch.core.layout import TILE
from hnanosolver_tpu_torch.core.topology import Topology, active_mask

COMBUSTION_FIELDS = ("fuel", "waste", "temperature", "flame")
COLLISION_FIELD = "collision_sdf"


@dataclasses.dataclass(frozen=True)
class FieldState:
    """velocity [3,T,512] + named scalar fields [T,512]."""

    velocity: torch.Tensor
    scalars: Dict[str, torch.Tensor]

    def replace(self, **kw) -> "FieldState":
        return dataclasses.replace(self, **kw)

    def with_scalar(self, name: str, value: torch.Tensor) -> "FieldState":
        return dataclasses.replace(self, scalars={**self.scalars, name: value})

    @property
    def capacity(self) -> int:
        return self.velocity.shape[1]

    def sdf(self) -> Optional[torch.Tensor]:
        """The collision SDF field, or None."""
        return self.scalars.get(COLLISION_FIELD)

    def scalar_blocks(self, name: str) -> torch.Tensor:
        return L.scalar_to_blocks(self.scalars[name])

    def velocity_blocks(self) -> torch.Tensor:
        return L.vec_to_blocks(self.velocity)

    @classmethod
    def from_blocks(cls, velocity_blocks, scalar_blocks: Dict[str, torch.Tensor],
                    device=None) -> "FieldState":
        """From ``[T,8,8,8,3]`` and ``{name: [T,8,8,8]}`` (tensors or arrays),
        on ``device`` (default: where the tensors are; arrays go to the
        CPU)."""
        def t(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        return cls(velocity=L.vec_from_blocks(t(velocity_blocks)).contiguous(),
                   scalars={k: L.scalar_from_blocks(t(v)) for k, v in scalar_blocks.items()})


def zeros_state(
    topo: Topology,
    scalar_names=("density", "temperature", "fuel", "waste", "flame"),
    dtype: torch.dtype = torch.float32,
) -> FieldState:
    """Zero state on the topology's device. The four combustion fields must
    exist even for pure smoke (the full step reads them)."""
    T = topo.capacity
    dev = topo.device
    return FieldState(
        velocity=torch.zeros((3, T, TILE), dtype=dtype, device=dev),
        scalars={
            n: torch.zeros((T, TILE), dtype=dtype, device=dev)
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


def source_into(state: FieldState, source: FieldState) -> FieldState:
    """Composite a sourcing state additively (the reference's compSum
    sourcing): the collision SDF is replaced, every other field summed, and
    a field only the source has is created."""
    scalars = dict(state.scalars)
    for k, v in source.scalars.items():
        if k == COLLISION_FIELD:
            scalars[k] = v
        else:
            scalars[k] = scalars.get(k, torch.zeros_like(v)) + v
    return FieldState(velocity=state.velocity + source.velocity, scalars=scalars)
