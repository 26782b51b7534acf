"""Typed solver configuration — field for field the JAX package's
``hnanosolver_tpu/config.py``, with the same names and defaults, so one
parameter set drives both packages.

The port computes in float32 at every precision tier: ``precision`` is kept
for parity of the dataclass and selects only ``effective_halo_lag``.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class CombustionParams:
    """Physics constants for combustion, buoyancy and vorticity."""

    expansion_rate: float = 0.1
    temperature_release: float = 0.5
    buoyancy_strength: float = 1.0
    ambient_temp: float = 23.0
    vorticity_scale: float = 1.0
    factor_scale: float = 0.5


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """Full per-step configuration. ``dt`` defaults to 1/24 (24 fps)."""

    dt: float = 1.0 / 24.0
    voxel_size: float = 0.5
    iterations: int = 20  # red+black SOR pairs per pressure solve
    pressure_solver: str = "rbgs"  # or "mg" (multigrid)
    # Red+black pairs per cross-tile halo refresh; None = by precision tier
    # (1 for "parity", 5 otherwise).
    halo_lag: int | None = None
    precision: str = "balanced"
    mg_pre: int = 2
    mg_post: int = 2
    mg_coarsest: int = 24
    mg_levels: int = 2
    mg_tol: float | None = None
    mg_fmg: bool = True
    combustion: CombustionParams = dataclasses.field(default_factory=CombustionParams)
    has_collision: bool = False

    def replace(self, **kw) -> "SolverParams":
        return dataclasses.replace(self, **kw)

    @property
    def effective_halo_lag(self) -> int:
        """halo_lag resolved by precision tier when unset."""
        if self.halo_lag is not None:
            return self.halo_lag
        return 1 if self.precision == "parity" else 5

    @property
    def inv_voxel_size(self) -> float:
        return 1.0 / self.voxel_size

    @property
    def omega(self) -> float:
        """SOR relaxation factor 2/(1+sin(pi*dx)), with the truncated
        3.14159 of the reference solver."""
        return 2.0 / (1.0 + math.sin(3.14159 * self.voxel_size))
