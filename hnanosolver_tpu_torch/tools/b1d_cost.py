"""What a B1d launch (the dual-table B1, ``csrc/bfecc_sample.cu``) costs on
the card, launch by launch, on the table path's inputs.

- The inputs: the bench plume (``cells.CELLS["bench"]``) developed from
  rest by its develop steps, with its chunk plans (9 chunks of 512 tiles);
  its velocity scaled to CFL 1.5 (the narrow band) and 3.0 (the mixed
  band), as chip_smoke's phase 14 does; the scalar pass's fields are the
  velocity and the five scalars (nf = 8); the SDF is the config-4 sphere at
  frame 0 (``cells.CELLS["c4"]``).
- The launches: in the narrow band mode "both" at nf = 3 (the velocity
  pass) and nf = 8 (the scalar pass), each also with the SDF as the
  table's last field; in the mixed band "back" and "fwd" of both passes.
- Each on the full table (the scalar pass's is 154.5 MB, three times the
  L2) and on a one-chunk table the L2 holds: chunk 0's table, with chunk
  0's ldual rows and inputs repeated for every chunk, so that the launch
  has the same tiles and the same work. The gap between the two parts the
  HBM share of a launch from its latency share.
- Per launch: the kernel's ms (:func:`kernel_call`: the C entry called as
  the wrapper calls it, without the wrapper's host check of the window)
  and the wrapper's (with it), medians of ``--rounds`` runs of 10
  back-to-back calls behind the spin (``timing.median_ms``); the bytes
  bound (:func:`bound_ms`) and the share; the instance's ptxas registers,
  spills and resident warps (``build.parse_ptxas``).

Every launch is checked bitwise against its plain version first.

Run: python -m hnanosolver_tpu_torch.tools.b1d_cost [--rounds N]
"""

from __future__ import annotations

import torch

from hnanosolver_tpu_torch.cells import CELLS
from hnanosolver_tpu_torch.core.topology import ensure_chunk_plans, resolve_device
from hnanosolver_tpu_torch.fields import zeros_state
from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.models import collider, plume
from hnanosolver_tpu_torch.ops import cuda_bfecc, tables
from hnanosolver_tpu_torch.timing import median_ms
from hnanosolver_tpu_torch.tools import parser

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3
BANDS = (("narrow", 1.5), ("mixed", 3.0))  # CFL of each band (chip_smoke phase 14)
BATCH = 10  # back-to-back calls a timed run


def inputs(dev: torch.device) -> dict:
    """The developed bench state on its planned topology, scaled into each
    band: {"topo", "sdt", "sdf", band: (vel [3,T,512], f8 [8,T,512])}."""
    bench = CELLS["bench"]
    params, cfg = bench.params, bench.plume
    topo = bench.topology(dev)
    topo, state = plume.run_plume(bench.develop, params, cfg, topo=topo,
                                  state=zeros_state(topo), grow_every=0)
    topo = ensure_chunk_plans(topo)
    sdt = params.dt * params.inv_voxel_size
    vel0 = state.velocity
    cfl0 = float(vel0.abs().max()) * sdt
    scal = torch.stack([state.scalars[k] for k in sorted(state.scalars)])
    col = CELLS["c4"].collider
    m = (torch.arange(topo.capacity, device=dev) >= 1) & (
        torch.arange(topo.capacity, device=dev) <= topo.n_active)
    sdf = collider.sphere_sdf(topo, collider.collider_center(col, 0, params.dt, dev),
                              col.radius) * m[:, None].float()
    out = {"topo": topo, "sdt": sdt, "sdf": sdf}
    for band, cfl in BANDS:
        vb = (vel0 * (cfl / cfl0)).contiguous()
        out[band] = (vb, torch.cat([vb, scal]).contiguous())
    return out


def one_chunk(tbl: torch.Tensor, ldual: torch.Tensor, vd: torch.Tensor):
    """(tbl, ldual, vd) with chunk 0 repeated for every chunk: a one-chunk
    table (the L2 holds it) and the same tiles a launch."""
    nc = tbl.shape[0]
    C = ldual.shape[0] // nc
    return (tbl[:1].contiguous(), ldual[:C].repeat(nc, 1).contiguous(),
            vd[:, :C].repeat(1, nc, 1).contiguous())


def launches(inp: dict) -> list:
    """(band, label, tbl, ldual, vd, nb, f_lo, mode, has_sdf) of each timed
    launch."""
    topo, sdf = inp["topo"], inp["sdf"]
    ld = topo.chunk_ldual
    out = []
    vb, f8 = inp["narrow"]
    for nb, fields in ((3, vb), (8, f8)):
        f_lo = 0 if nb == 3 else 3
        out.append(("narrow", f"both nf={nb}", tables.build_table_dual(topo, fields), ld, vb,
                    nb, f_lo, "both", False))
        out.append(("narrow", f"both nf={nb}+SDF",
                    tables.build_table_dual(topo, torch.cat([fields, sdf[None]])), ld, vb, nb,
                    f_lo, "both", True))
    vb, f8 = inp["mixed"]
    lim = cuda_bfecc.DISP_LIMIT
    for nb, fields in ((3, vb), (8, f8)):
        tv = tables.build_table_dual(topo, fields)
        back = cuda_bfecc.bfecc_sample_dual(tv, ld, vb, inp["sdt"], nb, 0, "back")
        d = torch.clamp(-vb * inp["sdt"], -lim, lim)
        d2 = torch.clamp(d + back[:3] * inp["sdt"], -3.85, 3.85).contiguous()
        f_lo = 0 if nb == 3 else 3
        out.append(("mixed", f"back nb={nb}", tv, ld, vb, nb, 0, "back", False))
        out.append(("mixed", f"fwd nb={nb} f_lo={f_lo}", tv, ld, d2, nb, f_lo, "fwd", False))
    return out


def kernel_call(tbl, ldual, vd, sdt, nb, f_lo, mode="both", has_sdf=False):
    """A call of the C entry as ``bfecc_sample_dual`` makes it, without the
    wrapper's host check of the window (the launch alone), into a fixed
    output. It calls the C entry itself, whose arguments have not changed,
    so that the same file times an older tree's kernel too."""
    T = ldual.shape[0]
    nf = nb + int(has_sdf)
    Ud = tbl.shape[1] // nf
    C = T // tbl.shape[0]
    n = nb - f_lo
    out = torch.empty((2 * n if mode == "both" else n, T, 512), device=vd.device)
    lib, s = build.library(), build.stream_ptr(vd.device)

    def call():
        if mode == "both":
            code = lib.hn_bfecc_sample_dual(tbl.data_ptr(), ldual.data_ptr(), vd.data_ptr(),
                                            out.data_ptr(), T, C, Ud, nb, f_lo, int(has_sdf),
                                            float(sdt), cuda_bfecc.DISP_LIMIT, s)
        else:
            code = lib.hn_sample_dual(tbl.data_ptr(), ldual.data_ptr(), vd.data_ptr(),
                                      out.data_ptr(), T, C, Ud, nf, f_lo, n, int(mode == "back"),
                                      float(sdt), cuda_bfecc.DISP_LIMIT, s)
        build.check(code, "bfecc_sample_dual")
        return out

    return call


def instance(nb, f_lo, mode, has_sdf) -> str:
    """The kernel instance a launch runs (its ptxas name)."""
    if mode == "both":
        return f"bfecc_dual_kernel<{nb}, {f_lo}, {str(has_sdf).lower()}>"
    return f"sample_dual_kernel<{nb - f_lo}, {str(mode == 'back').lower()}>"


def read_bytes(tbl: torch.Tensor, ldual: torch.Tensor, nb: int, f_lo: int, mode: str,
               has_sdf: bool) -> int:
    """The table bytes a launch must read (the data decides them): each dual
    row that some tile's ldual names, once per chunk, times the fields the
    mode samples (all nf in "both"; [f_lo, nb) in "back" and "fwd"), 2 KB a
    field."""
    nc = tbl.shape[0]
    chunk = torch.arange(ldual.shape[0], device=ldual.device) // (ldual.shape[0] // nc)
    rows = torch.unique(chunk[:, None] * tbl.shape[1] + ldual.long()).numel()
    fields = nb + int(has_sdf) if mode == "both" else nb - f_lo
    return rows * fields * 512 * 4


def bound_ms(tbl, ldual, vd, nb, f_lo, mode, has_sdf, out_floats) -> float:
    """The least time of a launch on the card's HBM: :func:`read_bytes`,
    ldual and vd read once, the outputs written once, over 3.35 TB/s."""
    moved = (read_bytes(tbl, ldual, nb, f_lo, mode, has_sdf)
             + sum(x.numel() * x.element_size() for x in (ldual, vd)) + 4 * out_floats)
    return moved / HBM_BYTES_PER_S * 1e3


def main(argv=None) -> int:
    p = parser(__doc__)
    p.set_defaults(rounds=10)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("b1d_cost: the card only (it times the kernel's launches)")
    card = torch.cuda.get_device_name(dev)
    res = {r.name: r for r in build.parse_ptxas(build.build().log)}
    inp = inputs(dev)
    topo, sdt = inp["topo"], inp["sdt"]
    nc, Ud = topo.chunk_dsrc.shape[:2]
    print(f"b1d_cost on {card}: bench topology {topo.n_active} tiles, capacity {topo.capacity},"
          f" {nc} chunks of {topo.capacity // nc}, Ud {Ud}; CUDA events, medians of "
          f"{args.rounds} runs of {BATCH} launches behind the spin", flush=True)
    for band, label, tbl, ld, vd, nb, f_lo, mode, has_sdf in launches(inp):
        kw = dict(nb=nb, f_lo=f_lo, mode=mode, has_sdf=has_sdf)
        want = cuda_bfecc.bfecc_sample_dual_plain(tbl, ld, vd, sdt, **kw)
        want = torch.cat(want) if mode == "both" else want
        kcall = kernel_call(tbl, ld, vd, sdt, **kw)
        if not torch.equal(kcall(), want):
            raise AssertionError(f"B1d {band} {label} differs from its plain version")
        one = one_chunk(tbl, ld, vd)
        ocall = kernel_call(*one, sdt, **kw)
        want1 = cuda_bfecc.bfecc_sample_dual_plain(*one, sdt, **kw)
        want1 = torch.cat(want1) if mode == "both" else want1
        if not torch.equal(ocall(), want1):
            raise AssertionError(f"B1d {band} {label} on one chunk differs from its plain "
                                 "version")
        k_ms = median_ms(kcall, args.rounds, BATCH)
        w_ms = median_ms(lambda: cuda_bfecc.bfecc_sample_dual(tbl, ld, vd, sdt, **kw),
                         args.rounds, BATCH)
        o_ms = median_ms(ocall, args.rounds, BATCH)
        b = bound_ms(tbl, ld, vd, out_floats=want.numel(), **kw)
        b1 = bound_ms(*one, out_floats=want.numel(), **kw)
        r = res.get(instance(nb, f_lo, mode, has_sdf))
        rline = r.line() if r is not None else f"{instance(nb, f_lo, mode, has_sdf)}: no report"
        print(f"B1d {band:6s} {label:18s}: kernel {k_ms:.4f} ms ({b / k_ms:.1%} of its bound "
              f"{b:.4f}), wrapper {w_ms:.4f} ms; one-chunk table {o_ms:.4f} ms (bound "
              f"{b1:.4f}); {rline} | {card}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
