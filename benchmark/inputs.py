"""Every input of a run, made by the benchmark from the cell and ``--seed``:
the tile list and the start fields, handed alike to the program and to the
reference.

The tile list is the scene's (``scenes/<scene>.py``): for the plume, a
fixed cell's is the configuration's developed-plume envelope at bench.py's
tight capacity, and a grown cell starts from the emitter's tiles. The start
fields are a plume in the ranges a developed one holds, drawn on the card
from a ``torch.Generator`` seeded with ``--seed`` in one call: on every
active voxel, with r the distance from the column's axis, y the height,
s = exp(-(r / (share * rc(y)))^2) the column's profile (rc the envelope's
radius at y) and h = max(0, 1 - y / height) the fall-off with height,

- velocity: y jet * s * (0.5 + 0.5 h), x and z a swirl of swirl * s * (2 n - 1);
- temperature: rise * s * h (0 away from the smoke, as a cook from rest
  has it); density: density * s * h; waste: waste * s * h;
- fuel and flame: inside the emitter sphere only;

each but the swirl multiplied by (1 + noise * (2 n - 1)), n uniform in
[0, 1) and drawn for each field and voxel. A start of ``region``
"emitter" (a grown cook) puts s = 1 inside the emitter sphere and 0
outside, h = 1. The scene's own fields, where it has any, are drawn after
these six from the same generator, so that they never change the six's
draws. Every cook of a run draws its own start from the run's seed and
its index, so that a run averages over many starts; another seed gives
other fields on the same voxels: the same work.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import topology as rt


def envelope(cfg: dict) -> np.ndarray:
    e = cfg["envelope"]
    return rt.plume_envelope(e["radius_vox"], e["height_vox"], e["center_x"], e["center_z"])


def start_tiles(cell) -> tuple:
    """(tiles [n, 3], capacity) of the cell's first frame: the scene's
    tiles, at the growth rule's capacity in a grown cell and at bench.py's
    tight capacity in a fixed one."""
    tiles = cell.scene.start_tiles(cell)
    if cell.traffic["topology"] == "grow":
        return tiles, rt.round_capacity(len(np.unique(rt.pack(tiles))))
    return tiles, rt.tight_capacity(len(tiles))


def cook_seed(seed: int, cook: int) -> int:
    """The generator's seed of cook ``cook`` of a run seeded ``seed``."""
    return int(np.random.SeedSequence([int(seed), int(cook)]).generate_state(1, np.uint64)[0])


def start_fields(cell, topo: rt.Topo, seed: int, device, cook: int = 0) -> dict:
    """The start of cook ``cook`` on the rows of ``topo``: float32 tensors
    on ``device``, 0 on the null and padding rows. Drawn a field at a time,
    so that a restart inside the window never holds more than the step
    does."""
    cfg, st = cell.config, cell.traffic["start"]
    env, em = cfg["envelope"], cfg["emitter"]
    g = torch.Generator(device=device)
    g.manual_seed(cook_seed(seed, cook))
    shape = (topo.capacity, 512)

    def uniform():
        return torch.rand(shape, generator=g, device=device)

    def jitter(base):
        return base * (1.0 + st["noise"] * (2.0 * uniform() - 1.0))

    org = torch.from_numpy(topo.origins.astype(np.int64) * 8).to(device)
    lane = torch.arange(512, device=device)
    x = (org[:, 0:1] + lane // 64).float()
    y = (org[:, 1:2] + (lane // 8) % 8).float()
    z = (org[:, 2:3] + lane % 8).float()
    c = em["center"]
    ball = ((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2 < em["radius"] ** 2).float()
    if st["region"] == "column":
        height = float(env["height_vox"])
        rc = env["radius_vox"] * (0.6 + 0.4 * torch.clamp(y / height, 0.0, 1.0))
        s = torch.exp(-((x - env["center_x"]) ** 2 + (z - env["center_z"]) ** 2)
                      / (st["column_share"] * rc) ** 2)
        h = torch.clamp(1.0 - y / height, min=0.0)
        del rc
    elif st["region"] == "emitter":
        s, h = ball, torch.ones_like(ball)
    else:
        raise ValueError(f"start region {st['region']!r}: expected 'column' or 'emitter'")
    del x, y, z
    rows = torch.arange(topo.capacity, device=device)[:, None]
    active = ((rows >= 1) & (rows <= topo.n_active)).float()
    s = s * active
    vel = torch.empty((3,) + shape, device=device)
    vel[0] = st["swirl"] * s * (2.0 * uniform() - 1.0)
    vel[1] = jitter(em["velocity_jet"] * s * (0.5 + 0.5 * h))
    vel[2] = st["swirl"] * s * (2.0 * uniform() - 1.0)
    sh = s * h
    ball = ball * active
    fields = {"velocity": vel,
              "temperature": jitter(st["temperature_rise"] * sh),
              "density": jitter(st["density"] * sh),
              "waste": jitter(st["waste"] * sh),
              "fuel": jitter(st["fuel"] * ball),
              "flame": jitter(st["flame"] * ball)}
    del s, h, sh, ball
    fields.update(cell.scene.extra_fields(cell, topo, g, device))
    return fields
