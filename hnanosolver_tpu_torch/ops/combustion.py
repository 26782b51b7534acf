"""Combustion and buoyancy — elementwise field updates.

- combustion_oxygen: oxygen-limited burn; adds volume expansion into the
  divergence field before the pressure solve.
- temperature_buoyancy: u.y += max(0, T - T_ambient) * buoyancy * dt.
"""

from __future__ import annotations

from typing import Tuple

import torch

FUEL_THRESHOLD = 0.001


def combustion_oxygen(
    fuel: torch.Tensor,
    waste: torch.Tensor,
    temperature: torch.Tensor,
    flame: torch.Tensor,
    div: torch.Tensor,
    temp_gain: float,
    expansion: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (fuel, waste, temperature, flame, divergence) after burning."""
    zero = torch.zeros((), dtype=fuel.dtype, device=fuel.device)
    fuel = torch.where(fuel < FUEL_THRESHOLD, zero, fuel)
    oxygen = 1.0 - fuel - waste
    valid = oxygen >= 0.0  # negative oxygen = invalid state, copy through
    burn = torch.where(valid, torch.minimum(oxygen, fuel), zero)

    new_fuel = fuel - burn
    new_waste = waste + burn * 2.0
    new_flame = torch.where(
        valid, torch.maximum(flame, torch.clamp(burn * 10.0, max=1.0)), flame
    )
    new_temp = temperature + burn * temp_gain
    new_div = div + burn * expansion
    return new_fuel, new_waste, new_temp, new_flame, new_div


def temperature_buoyancy(
    vel: torch.Tensor,
    temperature: torch.Tensor,
    dt: float,
    ambient_temp: float,
    buoyancy_strength: float,
) -> torch.Tensor:
    """Add upward buoyancy where T exceeds ambient (y-up). vel [3,T,512];
    returns a new tensor."""
    lift = torch.clamp(temperature - ambient_temp, min=0.0) * buoyancy_strength * dt
    out = vel.clone()
    out[1] += lift
    return out
