"""The vorticity confinement's wrapper (``ops/cuda_vorticity.py``, kernel VC)
on the CPU, where it runs its plain version, and its card branch with the
kernel library faked.

- The CPU branch is the composition ``ops/stencil.py`` ran before the
  kernel, written out again here (the curl, |omega| at voxel +- s through
  ``offset_view``, the normalisation and the cross product): bitwise equal
  at s = 1, 2 and -1 on a sparse topology with padding rows, the velocity
  random on every row, and its input left as it was.
- It refuses a velocity of another dtype or shape, an ``nbr`` of another
  dtype or row count, and an offset of 0 or of |s| >= 8 (|omega| at voxel +
  s reads voxel + s +- 1, beyond the tile's 3x3x3 neighbourhood).
- ``stencil.vorticity_confinement`` at offset 0 returns its input itself,
  with no launch and no ``vorticity.applies``; at offset 1 it launches VC
  once (one ``vorticity.applies``) with the float32 values PyTorch's CUDA
  ops cast the plain version's Python scalars to, into a new tensor.
- The kernel's dynamic shared memory a block (``smem_bytes``) fits the
  H100's 227 KB at every offset it takes.
"""

import contextlib

import numpy as np
import pytest
import torch

from hnanosolver_tpu_torch.core.topology import build_topology
from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.ops import cuda_vorticity, stencil
from hnanosolver_tpu_torch.ops.shifts import offset_view

# one thread: the test sandbox's MKL can compute a process's first float32
# sqrt wrong in one thread's chunk (tools/first_sqrt.py, ROADMAP.md queue 3),
# and the two compositions compared here would then differ
torch.set_num_threads(1)

DT, INV_DX, SCALE = 1 / 24, 2.0, 2.0


@pytest.fixture(scope="module")
def case():
    """A sparse topology (absent face, edge and corner neighbours) with six
    padding rows, and a velocity random on every row, the null and padding
    rows too."""
    rng = np.random.default_rng(27)
    box = np.array([(x, y, z) for x in range(4) for y in range(3) for z in range(4)])
    tiles = box[rng.random(len(box)) < 0.6]
    topo = build_topology(tiles, capacity=len(tiles) + 7, device="cpu")
    vel = torch.from_numpy(rng.standard_normal((3, topo.capacity, 512)).astype(np.float32))
    return topo, vel


def _former(topo, vel, s):
    """The confinement as ``ops/stencil.py`` composed it before VC."""
    factor = 0.5 * INV_DX

    def mag(off):
        def v(c, o):
            return offset_view(topo, vel[c], (off[0] + o[0], off[1] + o[1], off[2] + o[2]))

        wx = ((v(2, (0, 1, 0)) - v(2, (0, -1, 0))) - (v(1, (0, 0, 1)) - v(1, (0, 0, -1)))) * factor
        wy = ((v(0, (0, 0, 1)) - v(0, (0, 0, -1))) - (v(2, (1, 0, 0)) - v(2, (-1, 0, 0)))) * factor
        wz = ((v(1, (1, 0, 0)) - v(1, (-1, 0, 0))) - (v(0, (0, 1, 0)) - v(0, (0, -1, 0)))) * factor
        return torch.sqrt(wx * wx + wy * wy + wz * wz)

    omega = stencil.curl(topo, vel, factor)
    g = torch.stack([(mag([s * (a == 0), s * (a == 1), s * (a == 2)])
                      - mag([-s * (a == 0), -s * (a == 1), -s * (a == 2)])) * factor
                     for a in range(3)])
    N = g / (torch.sqrt(torch.sum(g * g, dim=0, keepdim=True)) + 1e-5)
    force = torch.stack([N[1] * omega[2] - N[2] * omega[1], N[2] * omega[0] - N[0] * omega[2],
                         N[0] * omega[1] - N[1] * omega[0]])
    return vel + SCALE * force * DT


@pytest.mark.parametrize("s", [1, 2, -1])
def test_cpu_branch_is_the_former_composition(case, s):
    topo, vel = case
    kept = vel.clone()
    got = cuda_vorticity.vorticity_confinement(topo.nbr, vel, DT, INV_DX, SCALE, s)
    assert torch.equal(got, _former(topo, vel, s))
    assert torch.equal(vel, kept)
    assert float((got - vel).abs().max()) > 0  # the force acts


@pytest.mark.parametrize("what", ["float64 velocity", "velocity of 511 columns",
                                  "velocity of one component", "int64 nbr", "nbr one row short",
                                  "s = 8", "s = -8", "s = 0"])
def test_wrapper_refuses(case, what):
    topo, vel = case
    nbr, s = topo.nbr, 1
    if what == "float64 velocity":
        vel = vel.double()
    elif what == "velocity of 511 columns":
        vel = vel[..., :511].contiguous()
    elif what == "velocity of one component":
        vel = vel[0]
    elif what == "int64 nbr":
        nbr = nbr.long()
    elif what == "nbr one row short":
        nbr = nbr[:-1]
    else:
        s = int(what.split("= ")[1])
    with pytest.raises(ValueError):
        cuda_vorticity.vorticity_confinement(nbr, vel, DT, INV_DX, SCALE, s)


class _Library:
    """A kernel library that records each VC call and does nothing."""

    def __init__(self):
        self.calls = []

    def hn_vorticity_confinement(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def faked(monkeypatch):
    """The wrapper takes its card branch on CPU tensors and calls the fake
    library; its launch count and ``vorticity.applies`` start at 0."""
    lib = _Library()
    monkeypatch.setattr(build, "on_cpu", lambda device: False)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(cuda_vorticity.launches, "n", 0)
    monkeypatch.setattr(stencil.applies, "n", 0)
    return lib


def test_offset_0_returns_the_velocity_itself(case, faked):
    topo, vel = case
    assert stencil.vorticity_confinement(topo, vel, DT, INV_DX, SCALE, 0.5) is vel
    assert (cuda_vorticity.launches.n, stencil.applies.n, faked.calls) == (0, 0, [])


def test_offset_1_launches_once_into_a_new_tensor(case, faked):
    topo, vel = case
    kept = vel.clone()
    out = stencil.vorticity_confinement(topo, vel, 0.1, 2.5, 1.7, 1.9)
    assert (cuda_vorticity.launches.n, stencil.applies.n, len(faked.calls)) == (1, 1, 1)
    assert out is not vel and out.shape == vel.shape and torch.equal(vel, kept)
    (v, n, o, T, s, factor, scale, dt, stream), = faked.calls
    assert (v, n, o, T, s, stream) == (vel.data_ptr(), topo.nbr.data_ptr(), out.data_ptr(),
                                       topo.capacity, 1, 0)
    assert (factor, scale, dt) == tuple(float(np.float32(x)) for x in (1.25, 1.7, 0.1))


def test_shared_memory_fits_the_card_at_every_offset():
    sizes = [cuda_vorticity.smem_bytes(s) for s in range(1, cuda_vorticity.MAX_OFFSET + 1)]
    assert sizes[0] == (3 * 12 ** 3 + 512 + 6 * 64) * 4 == 24_320
    assert sizes == sorted(sizes) and sizes[-1] == 178_688 <= 227 * 1024 - 27 * 4
    assert cuda_vorticity.smem_bytes(-3) == sizes[2]
