"""The table of peaks and the least time a kernel could take for the work a
frame gives it, reckoned from the cell's shapes alone, so that a kernel's
roofline reads the same work whatever implements it.

The rule: each input read once and each output written once, over the
card's HBM rate, or the kernel's float32 operations over the card's
non-tensor-core float32 rate, whichever is longer (chip_smoke.py's
``bound_ms``, re-keyed on shapes). Operations a voxel, counted from the
kernels' arithmetic: a trilinear sample of n fields 15 + 8 (2 + 2n); a SOR
update 11; a residual 9; the BFECC limiter 19 a field.

``shapes`` is :func:`cell_shapes`'s dict: the fine capacity T, the scalars
advected, and the pressure solve's launches by level.
"""

from __future__ import annotations

from reference import topology as rt

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM, HBM3 (data sheet)
F32_OPS_PER_S = 67e12  # NVIDIA H100 SXM, float32 outside the tensor cores
F32, I32 = 4, 4
VOX = 512


def _bound_ms(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def _sample_ops(n: int) -> int:
    return 15 + 8 * (2 + 2 * n)


def _nbr_bytes(T: int) -> int:
    return T * 27 * I32


def bfecc_sample_ms(shapes: dict) -> float:
    """B1 a frame: the velocity pass (3 fields in, both samples of 3 out)
    and the scalar pass (velocity and the scalars in, both samples of the
    scalars out)."""
    T, ns = shapes["T"], shapes["scalars"]
    ms = 0.0
    for nb, f_lo in ((3, 0), (3 + ns, 3)):
        nbytes = (nb + 2 * (nb - f_lo)) * T * VOX * F32 + _nbr_bytes(T)
        ops = (18 + _sample_ops(nb) + _sample_ops(nb - f_lo)) * T * VOX
        ms += _bound_ms(nbytes, ops)
    return ms


def bfecc_tail_ms(shapes: dict) -> float:
    """B2 a frame: phi, phiF, phiB in and the result out, for the velocity
    and for the scalars."""
    T = shapes["T"]
    return sum(_bound_ms(4 * F * T * VOX * F32 + _nbr_bytes(T), 19 * F * T * VOX)
               for F in (3, shapes["scalars"]))


def rbsor_lagged_ms(shapes: dict) -> float:
    """B3 a frame: p and div in, p out, at each lagged block's level and
    pairs (and the coarse levels' mask where there is one)."""
    ms = 0.0
    for T, pairs, masked, count in shapes["lagged"]:
        nbytes = (3 + masked) * T * VOX * F32 + _nbr_bytes(T)
        ms += count * _bound_ms(nbytes, (11 * pairs + 1) * T * VOX)
    return ms


def residual_ms(shapes: dict) -> float:
    """B6 a frame: p and div in, r out, at each level it runs."""
    return sum(count * _bound_ms(3 * T * VOX * F32 + _nbr_bytes(T), 9 * T * VOX)
               for T, count in shapes["residual"])


def cell_shapes(cell, tiles) -> dict:
    """The launches a frame of a fixed cell makes, from its tile list and
    its pressure settings: the capacity of each level (built by the
    reference's own rule) and, per level, the lagged blocks and residuals
    its solve runs."""
    from reference import ops

    n = len(tiles)
    T = rt.tight_capacity(n)
    pr = cell.traffic["pressure"]
    shapes = {"T": T, "scalars": len(cell.config["scalars"]), "lagged": [], "residual": []}
    if pr["solver"] != "mg":
        blocks = pr["iterations"] // pr["halo_lag"] if pr["halo_lag"] > 1 else 0
        if T > ops.MAX_FUSED_ROWS and blocks:
            shapes["lagged"].append((T, pr["halo_lag"], 0, blocks))
        return shapes
    caps, fo = [T], rt.unpack(rt.pack(tiles))
    for _ in range(pr["levels"]):
        fo = rt.unpack(sorted(set(rt.pack(fo >> 1).tolist())))
        caps.append(rt.round_capacity(len(fo)))
    L, cycles = pr["levels"], pr["cycles"]
    # level j's residuals: one in each full-multigrid V-cycle that starts at
    # or above it (j + 1 of them) and one a V-cycle after (``cycles``)
    for j in range(L):
        shapes["residual"].append((caps[j], (j + 1 if pr["fmg"] else 0) + cycles))
        # level j's smoothing: n_pre + n_post one-pair lagged blocks in each
        # of those V-cycles, above MAX_FUSED_ROWS rows
        if caps[j] > ops.MAX_FUSED_ROWS:
            count = ((j + 1 if pr["fmg"] else 0) + cycles) * (pr["pre"] + pr["post"])
            shapes["lagged"].append((caps[j], 1, int(j > 0), count))
    if caps[L] > ops.MAX_FUSED_ROWS:  # the coarsest solves of those V-cycles
        shapes["lagged"].append((caps[L], 1, 1, ((L if pr["fmg"] else 0) + cycles)
                                 * pr["coarsest"]))
    return shapes
