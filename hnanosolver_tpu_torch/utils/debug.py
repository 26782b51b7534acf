"""Numerical-safety checks on the port's tensors, the counterparts of the
JAX package's ``utils/debug.py``:

- NaN/Inf created inside the step (``nan_guard`` / ``assert_finite_state``);
- run-to-run bitwise reproducibility (``check_determinism``), the property
  the reference's red-black colouring exists to protect;
- the background invariant (null and padding rows stay zero), which every
  sampler relies on (``check_background_invariant``);
- where a trace clamp can engage (``check_cfl``).

Each check reads the tensors back to the host (one sync).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Tuple

import torch

from hnanosolver_tpu_torch.core.topology import Topology, active_mask
from hnanosolver_tpu_torch.fields import FieldState


def _leaves(tree, path: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) over a FieldState, dicts (sorted keys), lists, tuples
    and tensors."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, FieldState):
        yield from _leaves(tree.velocity, f"{path}.velocity")
        yield from _leaves(tree.scalars, f"{path}.scalars")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")


def nan_guard(tree, where: str = "") -> None:
    """Raise on any non-finite value in a FieldState or a nest of dicts,
    lists and tuples of tensors."""
    for path, leaf in _leaves(tree):
        bad = int((~torch.isfinite(leaf)).sum())
        if bad:
            raise FloatingPointError(f"{bad} non-finite values in {path} {where}")


def assert_finite_state(state: FieldState, where: str = "") -> None:
    nan_guard(state, where)


def finite_fraction(state: FieldState) -> Dict[str, float]:
    """Fraction of finite entries per field."""
    out = {"velocity": float(torch.isfinite(state.velocity).float().mean())}
    for k, v in state.scalars.items():
        out[k] = float(torch.isfinite(v).float().mean())
    return out


def check_background_invariant(topo: Topology, state: FieldState, atol: float = 0.0):
    """Null tile (row 0) and padding rows must hold exact zeros."""
    bg = active_mask(topo) == 0
    for name, arr in [("velocity", state.velocity)] + list(state.scalars.items()):
        a = (arr[:, bg] if name == "velocity" else arr[bg]).abs()
        if a.numel() and float(a.max()) > atol:
            raise AssertionError(
                f"background invariant violated in {name}: max |v| = {float(a.max())}")


def check_determinism(step_fn: Callable, *args, runs: int = 2) -> None:
    """Run ``step_fn`` ``runs`` times on the same inputs and demand bitwise
    equal outputs (NaNs equal to NaNs): a mismatch means a nondeterministic
    kernel."""
    ref = None
    for _ in range(runs):
        flat = [t.clone() for _, t in _leaves(step_fn(*args))]
        if ref is None:
            ref = flat
            continue
        for a, b in zip(ref, flat):
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            if a.shape != b.shape or not bool(same.all()):
                raise AssertionError("step is not bitwise deterministic")


def check_cfl(topo: Topology, state: FieldState, params, raise_on_clamp: bool = False) -> int:
    """How many active voxels this step may CFL-clamp (the traces clip
    displacements to < 7 voxels where the reference traces arbitrarily
    far). Returns the count; ``raise_on_clamp`` raises instead. The safe
    bound is max|u| * dt / dx < 3.5."""
    from hnanosolver_tpu_torch.ops.advection import cfl_clamped_count

    n = int(cfl_clamped_count(topo, state.velocity, params.dt, params.inv_voxel_size))
    if n and raise_on_clamp:
        raise RuntimeError(
            f"CFL clamp engaged on {n} voxels: |u|*dt/dx exceeds 7; reduce "
            f"dt or voxel velocity (reference semantics diverge here)"
        )
    return n
