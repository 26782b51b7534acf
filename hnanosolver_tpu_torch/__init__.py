"""hnanosolver_tpu_torch — the PyTorch/CUDA port of ``hnanosolver_tpu``.

A sparse volumetric fluid (smoke/fire) solver over 8^3 leaf tiles, with the
module names of the JAX package so each counterpart is easy to find. Plain
tensor code is PyTorch; every Pallas kernel of the main path is a CUDA
kernel written by hand for Hopper (``csrc/``), built on first use
(``kernels/build.py``). On CPU tensors the kernels' plain PyTorch versions
run instead. This package never imports JAX.

Public API (the JAX package's, plus ``zeros_state``):
  - ``SolverParams``, ``CombustionParams``  — typed config
  - ``Topology``, ``build_topology``,
    ``build_topology_dense``, ``dilate_topology`` — sparse tile index
  - ``FieldState``, ``zeros_state``         — named field container
  - ``step``                                — one full simulation step (HNanoSolver)
  - ``advect_scalars``, ``advect_velocity`` — HNanoAdvect, HNanoAdvectVelocity
  - ``project``, ``divergence_only``        — HNanoProjectNonDivergent

The cook on user VDB files is ``models/solve.py`` and
``python -m hnanosolver_tpu_torch.cli``.
"""

from hnanosolver_tpu_torch.config import CombustionParams, SolverParams
from hnanosolver_tpu_torch.core.topology import (
    Topology, build_topology, build_topology_dense, dilate_topology)
from hnanosolver_tpu_torch.fields import FieldState, zeros_state
from hnanosolver_tpu_torch.solver import (
    advect_scalars, advect_velocity, divergence_only, project, step)

__all__ = [
    "SolverParams",
    "CombustionParams",
    "Topology",
    "build_topology",
    "build_topology_dense",
    "dilate_topology",
    "FieldState",
    "zeros_state",
    "step",
    "advect_scalars",
    "advect_velocity",
    "project",
    "divergence_only",
]
