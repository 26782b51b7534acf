"""Software volume renderer, the JAX package's ``viewer/render.py`` on
PyTorch: HNanoViewer's picture without OpenGL.

The reference viewer bakes a VDB to a dense 3D texture and raymarches it in
a fragment shader: 256 fixed steps through the unit cube, front-to-back
alpha compositing (``reference/HNanoViewer/shaders/fragment_shader.frag:13-60``,
``HNanoViewer/src/OpenVDBLoader.cpp:19-86``). Here the rays are a pixel
grid of tensors marched step by step with trilinear texture taps, plus an
orthographic path that composites slice by slice, and PNG/APNG writers with
no dependency. Fire renders tint by the flame field; density drives
opacity as the shader's ``density * stepAlpha`` does.

Volumes are tensors on ``device`` (default: the card, or the tensor's own
device); images come back as numpy ``[H, W, 3]`` float arrays. The loops
keep the JAX package's operation order, so the images agree with its to
float rounding (it computes them in XLA).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from hnanosolver_tpu_torch.core.convert import tiles_to_dense
from hnanosolver_tpu_torch.core.topology import resolve_device


def _chunk(tag: bytes, data: bytes) -> bytes:
    c = struct.pack(">I", len(data)) + tag + data
    return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def _rows(rgb: np.ndarray) -> bytes:
    """Filter-0 scanlines of an 8-bit RGB image, deflated."""
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(rgb.shape[0]))
    return zlib.compress(raw, 6)


def _u8(rgb) -> np.ndarray:
    return np.clip(np.asarray(rgb) * 255.0, 0, 255).astype(np.uint8)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Minimal PNG writer (8-bit RGB), no external dependency."""
    rgb = _u8(rgb)
    h, w = rgb.shape[:2]
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _chunk(b"IDAT", _rows(rgb))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def write_apng(path: str, frames, delay_ms: int = 50) -> None:
    """Animated PNG (acTL/fcTL/fdAT chunks): one self-playing animation with
    no external encoder; browsers and most viewers play APNG."""
    frames = [_u8(f) for f in frames]
    h, w = frames[0].shape[:2]
    out = [b"\x89PNG\r\n\x1a\n",
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
           _chunk(b"acTL", struct.pack(">II", len(frames), 0))]  # loop forever
    seq = 0
    for i, f in enumerate(frames):
        out.append(_chunk(b"fcTL", struct.pack(">IIIIIHHbb", seq, w, h, 0, 0, delay_ms, 1000,
                                               0, 0)))
        seq += 1
        z = _rows(f)
        if i == 0:
            out.append(_chunk(b"IDAT", z))
        else:
            out.append(_chunk(b"fdAT", struct.pack(">I", seq) + z))
            seq += 1
    out.append(_chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(b"".join(out))


def _volume(x, device) -> torch.Tensor:
    """``x`` as a float32 tensor on ``device``, or on its own device when it
    is a tensor and no device is given (else the card)."""
    if device is None and isinstance(x, torch.Tensor):
        device = x.device
    return torch.as_tensor(x, device=resolve_device(device)).to(torch.float32)


def _vec(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


# the corners of a trilinear tap in the JAX package's order (dense/ops.py:
# di, then dj, then dk)
_TAP = [(di, dj, dk) for di in (0, 1) for dj in (0, 1) for dk in (0, 1)]


def _sample_dense(tex: torch.Tensor, pos: torch.Tensor, tap: torch.Tensor,
                  dims: torch.Tensor) -> torch.Tensor:
    """Trilinear tap of a dense [Nx,Ny,Nz] texture at float voxel coords,
    zero outside the box (GL_CLAMP_TO_BORDER): the JAX package's
    ``dense/ops.sample_trilinear``, its weight products and its sum over the
    corners in order, with the eight corners read by one gather. ``tap``:
    the [8, 3] int64 corner offsets, ``dims`` the texture's shape as an
    int32 [3], both on the texture's device (no copy from the host here)."""
    fl = torch.floor(pos)
    base = fl.to(torch.int32)
    frac = pos - fl
    one = torch.stack([1 - frac, frac], dim=-1)  # [..., 3, 2]: (1 - t, t) per axis
    w = (one[..., 0, :][..., tap[:, 0]] * one[..., 1, :][..., tap[:, 1]]
         * one[..., 2, :][..., tap[:, 2]])  # [..., 8]
    c = base[..., None, :] + tap.to(torch.int32)  # [..., 8, 3]
    inside = ((c >= 0) & (c < dims)).all(dim=-1)
    c = torch.minimum(torch.clamp(c, min=0), dims - 1).long()
    flat = (c[..., 0] * tex.shape[1] + c[..., 1]) * tex.shape[2] + c[..., 2]
    v = torch.where(inside, tex.reshape(-1)[flat], 0.0) * w
    acc = v[..., 0]
    for k in range(1, 8):
        acc = acc + v[..., k]
    return acc


def render_orthographic(
    density,
    axis: int = 2,
    absorption: float = 4.0,
    emission=None,
    emission_color=(1.0, 0.45, 0.12),
    smoke_color=(0.9, 0.9, 0.95),
    background=(0.05, 0.06, 0.08),
    solid=None,
    solid_color=(0.45, 0.47, 0.5),
    device=None,
) -> np.ndarray:
    """Orthographic front-to-back composite along a grid axis, slice by
    slice: the reference shader's accumulation with the ray fixed to the
    axis. ``emission`` tints by a second volume; ``solid``, a boolean
    volume, renders as an opaque surface (the collider's SDF < 0 cells)."""
    d = _volume(density, device)
    dev = d.device

    def along(x):
        return x if axis == 0 else torch.movedim(x, axis, 0)

    d = along(d)
    e = None if emission is None else along(_volume(emission, dev))
    s = None if solid is None else along(_volume(solid, dev))
    n = d.shape[0]
    step = 1.0 / n
    alpha_step = torch.clamp(d * absorption * step, 0.0, 1.0)
    smoke, emit_c, solid_c = (_vec(c, dev)[None, None]
                              for c in (smoke_color, emission_color, solid_color))
    color = torch.zeros(d.shape[1:] + (3,), dtype=torch.float32, device=dev)
    alpha = torch.zeros(d.shape[1:], dtype=torch.float32, device=dev)
    for i in range(n):
        a = alpha_step[i] * (1.0 - alpha)
        base = smoke * a[..., None]
        if e is not None:
            base = base + emit_c * (e[i][..., None] * step * (1.0 - alpha[..., None]))
        if s is not None:  # an opaque hit absorbs everything still in flight
            a_s = s[i] * (1.0 - alpha - a)
            base = base + solid_c * a_s[..., None]
            a = a + a_s
        color, alpha = color + base, alpha + a
    out = color + _vec(background, dev)[None, None] * (1.0 - alpha[..., None])
    return out.cpu().numpy()


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace`` in float32: start * (1 - s) + stop * s at s = i /
    (num - 1), the last point ``stop``."""
    s = torch.arange(num - 1, dtype=torch.float32, device=device) / float(num - 1)
    out = start * (1 - s) + stop * s
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32, device=device)])


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim=dim, keepdim=keepdim))


def render_perspective(
    density,
    cam_pos=(1.7, 1.3, 1.7),
    look_at=(0.5, 0.5, 0.5),
    fov_deg: float = 40.0,
    size: Tuple[int, int] = (512, 512),
    steps: int = 256,
    absorption: float = 6.0,
    smoke_color=(0.9, 0.9, 0.95),
    background=(0.05, 0.06, 0.08),
    device=None,
) -> np.ndarray:
    """Perspective raymarch: ``steps`` steps through the unit cube,
    front-to-back alpha, the reference fragment shader's loop over every
    pixel at once."""
    tex = _volume(density, device)
    dev = tex.device
    N = torch.tensor(tex.shape, dtype=torch.float32, device=dev)
    H, W = size

    cam = _vec(cam_pos, dev)
    fwd = _vec(look_at, dev) - cam
    fwd = fwd / _norm(fwd)
    right = _cross(fwd, _vec((0.0, 1.0, 0.0), dev))
    right = right / _norm(right)
    up = _cross(right, fwd)
    tanf = np.float32(np.tan(np.radians(fov_deg) / 2))

    ys = (_linspace(1, -1, H, dev) * float(tanf))[:, None, None]
    xs = (_linspace(-1, 1, W, dev) * float(tanf) * float(np.float32(W / H)))[None, :, None]
    dirs = fwd[None, None] + xs * right[None, None] + ys * up[None, None]
    dirs = dirs / _norm(dirs, keepdim=True)  # [H,W,3]

    # ray / unit-cube intersection (slab method)
    inv = 1.0 / torch.where(dirs.abs() < 1e-8, 1e-8, dirs)
    t0 = (0.0 - cam) * inv
    t1 = (1.0 - cam) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    tmin = torch.clamp(tmin, min=0.0)
    hit = (tmax > tmin).to(torch.float32)
    dt = (tmax - tmin) / steps

    smoke = _vec(smoke_color, dev)[None, None]
    tap = torch.tensor(_TAP, dtype=torch.int64, device=dev)
    dims = torch.tensor(tex.shape, dtype=torch.int32, device=dev)
    color = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    alpha = torch.zeros((H, W), dtype=torch.float32, device=dev)
    for i in range(steps):
        t = tmin + (i + 0.5) * dt
        p = cam[None, None] + dirs * t[..., None]  # unit-cube coords
        dens = _sample_dense(tex, p * (N - 1.0)[None, None], tap, dims)
        a = torch.clamp(dens * absorption * dt, 0.0, 1.0) * (1.0 - alpha) * hit
        color = color + smoke * a[..., None]
        alpha = alpha + a
    return (color + _vec(background, dev)[None, None] * (1.0 - alpha[..., None])).cpu().numpy()


def _dense(topo, state, field: str, shape, origin) -> torch.Tensor:
    return tiles_to_dense(topo, state.scalar_blocks(field), shape, origin)


def render_state(topo, state, shape, origin=(0, 0, 0), field: str = "density",
                 mode: str = "ortho", **kw) -> np.ndarray:
    """Densify a field over a view box on the topology's device and render
    it; orthographic renders tint by ``flame`` and draw the collider
    (``collision_sdf`` < 0) where the state holds them."""
    dense = _dense(topo, state, field, shape, origin)
    if mode == "ortho":
        emission = None
        if "flame" in state.scalars:
            emission = _dense(topo, state, "flame", shape, origin)
        if "collision_sdf" in state.scalars and "solid" not in kw:
            kw["solid"] = _dense(topo, state, "collision_sdf", shape, origin) < 0.0
        return render_orthographic(dense, emission=emission, **kw)
    return render_perspective(dense, **kw)


def render_turntable(topo, state, shape, origin=(0, 0, 0), frames: int = 24,
                     elevation: float = 0.9, radius: float = 1.8,
                     size: Tuple[int, int] = (384, 384), field: str = "density", **kw):
    """Orbit the perspective raymarcher around the domain, the offline form
    of dragging HNanoViewer's camera
    (``reference/HNanoViewer/src/HNanoViewer.cpp:106-362``). Returns the
    list of [H,W,3] frames; the field is densified once."""
    dense = _dense(topo, state, field, shape, origin)
    out = []
    for i in range(frames):
        a = 2.0 * np.pi * i / frames
        cam = (0.5 + radius * np.cos(a), elevation, 0.5 + radius * np.sin(a))
        out.append(render_perspective(dense, cam_pos=cam, size=size, **kw))
    return out
