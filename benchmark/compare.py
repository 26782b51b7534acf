"""The output check: one frame of the program against the plain reference
in float64 from the same input: the scene's reference frame and growth rule
(``scenes/<scene>.py``, over ``reference/``), given the frame's index within
its cook.

Numbers compared (each against its own limit in ``checks/<workload>.json``):

- ``<which>_gap``: over the velocity and every scalar, the largest
  max|program - reference| / max|reference| of the field, on the tiles both
  hold;
- ``<which>_tiles_off`` (grown cells): tiles that the activation pass must
  or must not hold and that the program's tile set gets wrong, plus 1 if
  its capacity breaks the growth rule. A tile whose occupancy lies within
  ``band`` of the threshold is left to rounding either way: ``band`` is
  the larger of 1% of the threshold and four times the largest absolute
  field error on the common tiles (the occupancy is a largest |value|, so
  it moves by no more than that error).
"""

from __future__ import annotations

import numpy as np
import torch

from reference import step
from reference import topology as rt

BAND_SHARE = 1e-2
BAND_ERRORS = 4.0


def to64(fields: dict, device) -> dict:
    return {k: v.to(device=device, dtype=torch.float64) for k, v in fields.items()}


def field_gaps(prog: dict, ref: dict, rows_p=None, rows_r=None):
    """({field: gap}, largest absolute error) on the given rows."""
    gaps, abs_err = {}, 0.0
    for k, r in ref.items():
        p = prog[k].to(r.device)
        if rows_p is not None:
            p, r = p.index_select(-2, rows_p), r.index_select(-2, rows_r)
        err = float((p.double() - r).abs().amax())
        scale = float(r.abs().amax())
        gaps[k] = err / scale if scale > 0 else err
        abs_err = max(abs_err, err)
    return gaps, abs_err


def check_frame(cell, topo_in: rt.Topo, inp64: dict, prog_keys: np.ndarray, prog: dict,
                index: int):
    """The reference's frame ``index`` of its cook from ``inp64`` on
    ``topo_in`` against the program's output (its tile keys and fields).
    Returns (gap, tiles_off or None, per-field gaps)."""
    scene = cell.scene
    levels = step.levels_for(topo_in, cell.solver(), torch.float64)
    stepped = scene.frame(cell, topo_in, inp64, levels, index)
    del inp64, levels
    if cell.traffic["topology"] != "grow":
        if not np.array_equal(prog_keys, topo_in.keys):
            raise AssertionError("the program's tile rows are not the reference's")
        gaps, _ = field_gaps(prog, stepped)
        return max(gaps.values()), None, gaps
    occ = scene.occupancy(topo_in, stepped).double().cpu().numpy()
    new, ref = scene.grow(cell, topo_in, stepped, index)
    n_p = int(((prog_keys != rt.NULL_KEY) & (prog_keys != rt.PAD_KEY)).sum())
    keys_p, keys_r = prog_keys[1:n_p + 1], new.keys[1:new.n_active + 1]
    _, i_p, i_r = np.intersect1d(keys_p, keys_r, assume_unique=True, return_indices=True)
    dev = topo_in.device
    gaps, abs_err = field_gaps(prog, ref, torch.from_numpy(i_p + 1).to(dev),
                               torch.from_numpy(i_r + 1).to(dev))
    thr = cell.config["emitter"]["occupancy_threshold"]
    band = max(BAND_SHARE * thr, BAND_ERRORS * abs_err)
    must = set(rt.pack(scene.grown_tiles(cell, topo_in, occ, thr + band, index)).tolist())
    may = set(rt.pack(scene.grown_tiles(cell, topo_in, occ, thr - band, index)).tolist())
    held = set(keys_p.tolist())
    off = len(must - held) + len(held - may)
    off += int(prog_keys.shape[0] != step.grown_capacity(topo_in.capacity, n_p))
    return max(gaps.values()), off, gaps
