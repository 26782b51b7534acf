"""Multigrid's transfer kernels and their plain PyTorch versions
(``csrc/mg_transfer.cu``; no TPU kernel: XLA computed the transfers):

- MR ``restrict``: ``[Tf,512]`` -> ``[Tc,512]``, the 2x2x2 means of each
  coarse tile's 8 children (``children [Tc,8]``, row 0 where absent), with
  the fine values optionally times ``fine_mask`` first and the result
  times ``coarse_mask`` after. One launch a level.
- MP ``prolong_trilinear``: ``[Tc,512]`` -> ``[Tf,512]``, each fine row's
  trilinear interpolation of its parent's octant (``parent``, ``octant``
  [Tf], the coarse level's ``nbr``), plus ``p`` when given, times ``mask``
  when given. One launch a level.

The plain versions are ``ops/multigrid.restrict_plain`` and
``prolong_trilinear_plain`` (the lane tables of the JAX package) with the
masks and the add as separate ops; each kernel is bitwise equal to its
plain version. On a CPU tensor a wrapper runs the plain version; on a CUDA
tensor it launches the kernel or raises. MP writes a new tensor: ``p`` is
never updated in place.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from hnanosolver_tpu_torch.core.layout import TILE
from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.ops.cuda_pressure import _ptr

launches_restrict = build.LaunchCount("mg_restrict")
launches_prolong = build.LaunchCount("mg_prolong")


def _fields(named: dict, rows: int, device) -> None:
    for name, t in named.items():
        if t is not None:
            build.require(t, name, (rows, TILE), torch.float32, device)


# -- MR ----------------------------------------------------------------------

def restrict(children: torch.Tensor, fine: torch.Tensor,
             fine_mask: torch.Tensor | None = None,
             coarse_mask: torch.Tensor | None = None) -> torch.Tensor:
    """``fine [Tf,512]`` (times ``fine_mask``) restricted to the ``[Tc,512]``
    rows ``children [Tc,8]`` names (times ``coarse_mask``). One launch."""
    Tc, Tf = children.shape[0], fine.shape[0]
    build.require(children, "children", (Tc, 8), torch.int32, fine.device)
    _fields({"fine": fine, "fine_mask": fine_mask}, Tf, fine.device)
    _fields({"coarse_mask": coarse_mask}, Tc, fine.device)
    if build.on_cpu(fine.device):
        return restrict_plain(children, fine, fine_mask, coarse_mask)
    build.require_aligned((fine, fine_mask, coarse_mask), "mg_restrict", 16)  # float4
    out = torch.empty((Tc, TILE), dtype=torch.float32, device=fine.device)
    with torch.cuda.device(fine.device), launches_restrict.launch():
        code = build.library().hn_mg_restrict(
            fine.data_ptr(), children.data_ptr(), _ptr(fine_mask), _ptr(coarse_mask),
            out.data_ptr(), Tc, build.stream_ptr(fine.device))
        build.check(code, "mg_restrict")
    return out


def restrict_plain(children: torch.Tensor, fine: torch.Tensor,
                   fine_mask: torch.Tensor | None = None,
                   coarse_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`restrict`."""
    from hnanosolver_tpu_torch.ops import multigrid  # it imports this module

    if fine_mask is not None:
        fine = fine * fine_mask
    rc = multigrid.restrict_plain(SimpleNamespace(children=children), fine)
    return rc if coarse_mask is None else rc * coarse_mask


# -- MP ----------------------------------------------------------------------

def prolong_trilinear(parent: torch.Tensor, octant: torch.Tensor, nbr: torch.Tensor,
                      coarse: torch.Tensor, p: torch.Tensor | None = None,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """``[Tf,512]``: ``p`` (when given) + the trilinear prolongation of
    ``coarse [Tc,512]`` to the fine rows ``parent``/``octant [Tf]`` map
    (``nbr [Tc,27]`` the coarse level's), times ``mask`` when given. One
    launch."""
    Tf, Tc = parent.shape[0], coarse.shape[0]
    for name, t in (("parent", parent), ("octant", octant)):
        build.require(t, name, (Tf,), torch.int32, coarse.device)
    build.require(nbr, "nbr", (Tc, 27), torch.int32, coarse.device)
    _fields({"coarse": coarse}, Tc, coarse.device)
    _fields({"p": p, "mask": mask}, Tf, coarse.device)
    if build.on_cpu(coarse.device):
        return prolong_trilinear_plain(parent, octant, nbr, coarse, p, mask)
    build.require_aligned((p, mask), "mg_prolong", 16)  # float4 loads
    out = torch.empty((Tf, TILE), dtype=torch.float32, device=coarse.device)
    with torch.cuda.device(coarse.device), launches_prolong.launch():
        code = build.library().hn_mg_prolong(
            coarse.data_ptr(), nbr.data_ptr(), parent.data_ptr(), octant.data_ptr(), _ptr(p),
            _ptr(mask), out.data_ptr(), Tf, build.stream_ptr(coarse.device))
        build.check(code, "mg_prolong")
    return out


def prolong_trilinear_plain(parent: torch.Tensor, octant: torch.Tensor, nbr: torch.Tensor,
                            coarse: torch.Tensor, p: torch.Tensor | None = None,
                            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`prolong_trilinear`."""
    from hnanosolver_tpu_torch.ops import multigrid  # it imports this module

    level = SimpleNamespace(parent=parent, octant=octant, topo=SimpleNamespace(nbr=nbr))
    e = multigrid.prolong_trilinear_plain(level, coarse)
    if p is not None:
        e = p + e
    return e if mask is None else e * mask
