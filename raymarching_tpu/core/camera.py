"""Differentiable camera: look-at rotation, focal length, ray generation.

jnp re-implementation of the reference camera (object.cpp:23-42) and the
per-pixel/SSAA ray setup (render.cpp:82-111), fully vectorized so the whole
H x W x k x k ray grid is produced by a handful of broadcasted ops, and fully
differentiable so camera-pose gradients (position, direction, up, FOV) flow
through ``normalize``/``cross``/``tan`` (north-star config 4).

Geometry spec:
  * screen plane at z=-1 in camera space, width = focal = 2 tan(FOV deg/2),
    height = focal / aspect; top-left corner (-w/2, +h/2) (render.cpp:85-89).
  * pixel (px, py) spans UV [px/W,(px+1)/W] x [py/H,(py+1)/H]; SSAA sample
    (i, j) of a k x k kernel sits at sub-UV ((i+1)/k, (j+1)/k) — biased
    toward the pixel's bottom-right corner, faithfully reproduced
    (render.cpp:104-108; SURVEY §2 fine print).
  * ray = R @ normalize((x, y, -1)); origin = camera position.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..config import RenderConfig
from ..scene.compile import SceneTables

DEG_TO_RAD = jnp.pi / 180.0


def camera_rotation(direction: jnp.ndarray, up: jnp.ndarray) -> jnp.ndarray:
    """3x3 rotation, columns [right, up', -forward] (object.cpp:25-31)."""
    right = jnp.cross(direction, up)
    right = right / jnp.linalg.norm(right)
    up2 = jnp.cross(right, direction)
    up2 = up2 / jnp.linalg.norm(up2)
    forward = direction / jnp.linalg.norm(direction)
    return jnp.stack([right, up2, -forward], axis=1)


def camera_focal(fov_deg: jnp.ndarray) -> jnp.ndarray:
    """focal = 2 tan(FOV/2) (object.cpp:35)."""
    return 2.0 * jnp.tan(fov_deg * DEG_TO_RAD / 2.0)


def generate_rays(tables: SceneTables, cfg: RenderConfig,
                  row_range=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """All primary rays for one frame.

    Returns (origin [3], directions [H, W, S, 3]) with S = ssaa^2 samples in
    (i-major, j-minor) order matching the reference's nested sample loop
    (render.cpp:104-105).

    ``row_range=(r0, n)``: rays for image rows [r0, r0+n) only — the same
    math over a row slice (api.render_tiled streams huge frames through the
    device block by block).  ``r0`` may be a traced scalar; ``n`` is static.
    """
    w = camera_focal(tables.cam_fov)
    h = w / cfg.aspect_ratio
    k = cfg.ssaa

    px = jnp.arange(cfg.width, dtype=jnp.float32)       # column index
    if row_range is None:
        py = jnp.arange(cfg.height, dtype=jnp.float32)  # row index
    else:
        r0, n = row_range
        py = jnp.float32(r0) + jnp.arange(n, dtype=jnp.float32)
    si = (jnp.arange(k, dtype=jnp.float32) + 1.0) / k   # sample offsets
    # Full sub-pixel UV in [0, 1]: u over columns+i, v over rows+j.
    u = (px[None, :, None, None] + si[None, None, :, None]) / cfg.width
    v = (py[:, None, None, None] + si[None, None, None, :]) / cfg.height

    # lerp over the screen rectangle: x in [-w/2, w/2], y in [h/2, -h/2].
    rows = py.shape[0]
    shape = (rows, cfg.width, k, k)
    x = jnp.broadcast_to(w * (u - 0.5), shape)
    y = jnp.broadcast_to(h * (0.5 - v), shape)
    z = jnp.full(shape, -1.0, dtype=x.dtype)

    n = jnp.sqrt(x * x + y * y + 1.0)   # z = -1, so z^2 is exactly 1
    xc, yc, zc = x / n, y / n, -1.0 / n
    R = camera_rotation(tables.cam_direction, tables.cam_up)
    # Rotate into world with ELEMENTWISE mul-adds, not `d @ R.T`: at
    # default precision XLA may run a [*, 3] @ [3, 3] matmul in reduced
    # precision (TF32 on a GPU) — ~1e-3 direction error, a half-pixel
    # warp.  The elementwise form is exact f32 and matches the kernel's
    # formula op for op (ops.pallas_render._raygen_dirs).
    d = jnp.stack([xc * R[0, 0] + yc * R[0, 1] + zc * R[0, 2],
                   xc * R[1, 0] + yc * R[1, 1] + zc * R[1, 2],
                   xc * R[2, 0] + yc * R[2, 1] + zc * R[2, 2]], axis=-1)
    d = d.reshape(rows, cfg.width, k * k, 3)
    return tables.cam_position, d


# pi * (3 - sqrt(5)): successive lens samples land evenly over the disk
# (sunflower / Vogel spiral), so the ssaa^2-sample average converges to the
# lens integral without any RNG — deterministic, jit-friendly, regenerable.
GOLDEN_ANGLE = 2.3999632297286533


def lens_offsets(cfg: RenderConfig) -> jnp.ndarray:
    """[S, 2] deterministic sunflower-disk lens sample offsets, radius
    ``cfg.aperture`` (world units), for thin-lens depth of field."""
    S = cfg.samples_per_pixel
    s = jnp.arange(S, dtype=jnp.float32)
    r = cfg.aperture * jnp.sqrt((s + 0.5) / S)
    th = s * GOLDEN_ANGLE
    return jnp.stack([r * jnp.cos(th), r * jnp.sin(th)], axis=-1)


def generate_rays_dof(tables: SceneTables, cfg: RenderConfig,
                      row_range=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Thin-lens rays -> (origins [rows, W, S, 3], dirs [rows, W, S, 3]).

    Each SSAA sample's origin moves to its lens-disk point (sample index ->
    sunflower offset in the camera's right/up plane) and its direction is
    re-aimed at the pinhole ray's focal point — the intersection with the
    focus plane ``cfg.focus_dist`` along the view axis — so geometry on
    that plane stays sharp and everything else defocuses with circle of
    confusion ~ aperture * |t - F| / t.  The ordinary SSAA average over the
    S samples IS the lens integral (no extra machinery); blur quality
    scales with ``cfg.ssaa``.  Differentiable like generate_rays (pose
    cotangents flow through the lens basis and focal reprojection).

    No reference equivalent (its camera is an ideal pinhole,
    render.cpp:92-101); opt-in via ``cfg.aperture > 0``."""
    o, d = generate_rays(tables, cfg, row_range)        # [3], [r, W, S, 3]
    R = camera_rotation(tables.cam_direction, tables.cam_up)
    right, up2, fwd = R[:, 0], R[:, 1], -R[:, 2]
    off = lens_offsets(cfg)                             # [S, 2]
    off_w = off[:, 0:1] * right + off[:, 1:2] * up2     # [S, 3]
    # elementwise dot (a [*, 3] einsum may run at reduced default
    # precision — see generate_rays' rotation note)
    tf = cfg.focus_dist / (d[..., 0] * fwd[0] + d[..., 1] * fwd[1]
                           + d[..., 2] * fwd[2])
    pf = o + tf[..., None] * d                          # focal points
    origins = jnp.broadcast_to(o, d.shape) + off_w      # [r, W, S, 3]
    dirs = pf - origins
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    return origins, dirs
