"""SDF -> triangle mesh extraction (marching tetrahedra) + OBJ/PLY export.

No reference equivalent (the reference only rasterizes its SDF scene to
images, render.cpp:122-139) — this is the standard companion tool every
SDF framework ships: sample the compiled scene field on a dense grid and
extract the zero isosurface as a watertight triangle mesh, for DCC
interchange, collision proxies, or 3-D printing of fitted scenes.

Host/device split of the work:

  * the expensive part — ``res**3`` scene-field evaluations, each folding
    every primitive — runs on device through the SAME Pallas surface
    kernel the renderer uses (``ops.pallas_march.pallas_surface_eval``),
    chunked so only one block of points is resident at a time; on the
    CPU it falls back to the vectorized jnp fold;
  * the topology pass (tetrahedron case classification, shared-edge vertex
    dedup) is tiny integer bookkeeping over the sign grid and runs
    vectorized in host numpy — exactly the host/device split the scene
    compiler itself uses.

Marching TETRAHEDRA rather than marching cubes: each grid cell splits into
six tetrahedra around its main diagonal, and a tetrahedron's isosurface
cases follow from first principles — the crossing edges are exactly those
whose endpoint signs differ, giving one triangle (1-vs-3 split) or two
(2-vs-2 split).  No 256-entry case table, no ambiguous saddle
configurations, and the result is watertight across cell faces because
neighboring cells share tetrahedron faces exactly.  Triangle winding is
resolved numerically at import time on a canonical positively-oriented
tetrahedron (the sign of ``dot(normal, outward)`` is invariant under the
positive-determinant affine map to any grid tetrahedron), so normals
consistently point from inside (sd < 0) to outside.
"""

from __future__ import annotations

import itertools
import struct
from typing import Optional, Sequence, Tuple

import numpy as np

from ..scene.compile import ScenePlan, SceneTables

# ------------------------------------------------------------------ tables

#: Cube corner c in 0..7 has offset bit layout (x, y, z) = (c&1, c>>1&1, c>>2&1).
_CORNER_OFFSETS = np.array([[c & 1, (c >> 1) & 1, (c >> 2) & 1]
                            for c in range(8)], np.int64)


def _build_tets() -> Tuple[Tuple[int, int, int, int], ...]:
    """Six tetrahedra tiling the unit cube around the 0->7 main diagonal.

    Each axis permutation (the order x/y/z flips from corner 0 to corner 7)
    yields one tetrahedron; vertex order is fixed up to POSITIVE signed
    volume so one winding rule serves all six."""
    tets = []
    for perm in itertools.permutations(range(3)):
        cur = [0, 0, 0]
        verts = [0]
        for axis in perm:
            cur[axis] = 1
            verts.append(cur[0] | (cur[1] << 1) | (cur[2] << 2))
        corners = _CORNER_OFFSETS[verts].astype(np.float64)
        if np.linalg.det(corners[1:] - corners[0]) < 0:
            verts[2], verts[3] = verts[3], verts[2]
        tets.append(tuple(verts))
    return tuple(tets)


def _build_case_table():
    """For each 4-bit inside mask (bit i = tet vertex i has sd < 0): the
    triangles as ((v_in, v_out), ...) edge triplets, wound so normals point
    toward the positive (outside) region."""
    T = np.array([[0., 0., 0.], [1., 0., 0.], [0., 1., 0.], [0., 0., 1.]])
    table = []
    for config in range(16):
        inside = [i for i in range(4) if (config >> i) & 1]
        outside = [i for i in range(4) if not (config >> i) & 1]
        tris = []
        if len(inside) in (1, 3):
            lone = inside[0] if len(inside) == 1 else outside[0]
            others = [v for v in range(4) if v != lone]
            tris = [tuple((lone, o) for o in others)]
        elif len(inside) == 2:
            a, b = inside
            c, d = outside
            quad = ((a, c), (a, d), (b, d), (b, c))
            tris = [(quad[0], quad[1], quad[2]), (quad[0], quad[2], quad[3])]
        fixed = []
        for tri in tris:
            pts = [(T[i] + T[j]) * 0.5 for (i, j) in tri]
            n = np.cross(pts[1] - pts[0], pts[2] - pts[0])
            outward = T[outside].mean(0) - T[inside].mean(0)
            if float(np.dot(n, outward)) < 0.0:
                tri = (tri[0], tri[2], tri[1])
            fixed.append(tuple((i, j) if (config >> i) & 1 else (j, i)
                               for (i, j) in tri))
        table.append(tuple(fixed))
    return tuple(table)


_TETS = _build_tets()
_CASES = _build_case_table()


# ------------------------------------------------------------- extraction

def marching_tetrahedra(values: np.ndarray, origin, spacing
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-isosurface of a sampled field -> (vertices [V, 3] f32,
    faces [F, 3] i32).

    ``values``: [nx, ny, nz] field samples; sample (i, j, k) sits at
    ``origin + spacing * (i, j, k)``.  Inside = value < 0.  Vertices land
    on grid edges at the linear-interpolation zero crossing and are shared
    between adjacent triangles (watertight for surfaces that close inside
    the grid); faces are wound counter-clockwise seen from outside."""
    values = np.asarray(values, np.float32)
    nx, ny, nz = values.shape
    origin = np.asarray(origin, np.float64)
    spacing = np.broadcast_to(np.asarray(spacing, np.float64), (3,))
    neg = values < 0.0
    if not neg.any() or neg.all() or min(nx, ny, nz) < 2:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))

    # Global corner id of grid point (i, j, k) = (i * ny + j) * nz + k.
    ii, jj, kk = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                             np.arange(nz - 1), indexing="ij")
    base = ((ii * ny + jj) * nz + kk).ravel()          # [C] cell corner 0
    # offset of cube corner c relative to corner 0 in flat ids:
    corner_id_off = (_CORNER_OFFSETS[:, 0] * ny * nz
                     + _CORNER_OFFSETS[:, 1] * nz
                     + _CORNER_OFFSETS[:, 2])          # [8]
    flat_neg = neg.ravel()

    tri_a = []   # inside-corner global ids, [N, 3]
    tri_b = []   # outside-corner global ids, [N, 3]
    for tet in _TETS:
        gids = base[:, None] + corner_id_off[list(tet)][None, :]   # [C, 4]
        config = (flat_neg[gids] << np.arange(4)).sum(axis=1)      # [C]
        for cfg_idx in range(1, 15):
            cases = _CASES[cfg_idx]
            if not cases:
                continue
            sel = gids[config == cfg_idx]                          # [S, 4]
            if sel.shape[0] == 0:
                continue
            for tri in cases:
                tri_a.append(np.stack([sel[:, i] for (i, _) in tri], 1))
                tri_b.append(np.stack([sel[:, j] for (_, j) in tri], 1))
    if not tri_a:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    a = np.concatenate(tri_a)            # [F, 3] inside ends
    b = np.concatenate(tri_b)            # [F, 3] outside ends

    # One vertex per crossed grid edge: canonical (min, max) corner key.
    lo = np.minimum(a, b)
    hi = np.maximum(a, b)
    keys = lo.astype(np.int64) * (nx * ny * nz) + hi
    uniq, faces_flat = np.unique(keys, return_inverse=True)
    faces = faces_flat.reshape(-1, 3).astype(np.int32)

    ulo = (uniq // (nx * ny * nz)).astype(np.int64)
    uhi = (uniq % (nx * ny * nz)).astype(np.int64)
    flat_vals = values.ravel()
    va = flat_vals[ulo].astype(np.float64)
    vb = flat_vals[uhi].astype(np.float64)
    # endpoints have opposite sign by construction (inside strictly < 0,
    # outside >= 0), so the denominator is strictly nonzero
    t = va / (va - vb)

    def coords(ids):
        return np.stack([ids // (ny * nz), (ids // nz) % ny, ids % nz],
                        axis=1).astype(np.float64)

    pa, pb = coords(ulo), coords(uhi)
    verts = origin[None, :] + spacing[None, :] * (pa + t[:, None] * (pb - pa))

    # drop exactly-degenerate faces (two corners at the same grid vertex
    # when a sample is exactly 0 can collapse an edge)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return verts.astype(np.float32), faces[good]


# ------------------------------------------------------- field sampling

#: conservative bounding radius of a primitive, in units of prim_aux[0]
#: (sphere radius / fractal size): fractal DEs live inside a few sizes.
_PROC_BOUND = {3: 4.0, 4: 1.5, 5: 1.5}   # MANDELBOX, MANDELBULB, JULIA


def default_bounds(plan: ScenePlan, tables: SceneTables,
                   margin: float = 0.05):
    """Axis-aligned bounds of the scene's SOLID geometry.

    A leaf contributes iff its root-level effective sign is +1 in the
    kernel normal form (``gsign * scale == +1``): that keeps union bodies
    and the base of every DIFFERENCE (its carves lie inside the base), and
    drops carve prims and the inverted ``Bounds`` COMPLEMENT box — whose
    200-unit walls would otherwise swallow the grid resolution.  Deeper
    plans (no kernel form) fall back to all leaves."""
    pos = np.asarray(tables.prim_pos, np.float64)
    aux = np.asarray(tables.prim_aux, np.float64)
    if plan.kernel is not None:
        keep = []
        for g in plan.kernel.groups:
            for off, s in enumerate(g.scales):
                if g.gsign * s == 1:
                    keep.append(g.start + off)
    else:
        keep = list(range(plan.num_primitives))
    if not keep:
        keep = list(range(plan.num_primitives))
    ext = np.empty((len(keep), 3), np.float64)
    for row, leaf in enumerate(keep):
        t = plan.prim_type[leaf]
        if t == 0:                                  # sphere: radius
            ext[row] = aux[leaf, 0]
        elif t in _PROC_BOUND:                      # fractal: size * factor
            ext[row] = aux[leaf, 0] * _PROC_BOUND[t]
        else:                                       # box/cross: size / 2
            ext[row] = aux[leaf] * 0.5
    lo = (pos[keep] - ext).min(axis=0)
    hi = (pos[keep] + ext).max(axis=0)
    pad = margin * float((hi - lo).max())
    return lo - pad, hi + pad


def sample_sdf_grid(plan: ScenePlan, tables: SceneTables, lo, hi,
                    resolution, *, backend: str = "auto",
                    interpret: Optional[bool] = None,
                    fused: bool = False, chunk: int = 1 << 18) -> np.ndarray:
    """Evaluate the scene SDF on a [rx, ry, rz] grid spanning [lo, hi].

    On a GPU (backend "auto") the points stream through the Pallas
    surface kernel in ``chunk``-point blocks (the same exact-table fold
    the renderer marches); on the CPU the vectorized jnp fold.  Returns
    host f32."""
    import jax
    import jax.numpy as jnp

    from ..api import resolve_backend
    from ..core.sdf import scene_sd

    backend = resolve_backend(backend)
    res = np.broadcast_to(np.asarray(resolution, np.int64), (3,))
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    axes = [np.linspace(lo[a], hi[a], int(res[a]), dtype=np.float64)
            for a in range(3)]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"),
                   axis=-1).reshape(-1, 3).astype(np.float32)

    if backend in ("pallas", "mega"):
        from ..config import RenderConfig
        from ..ops.pallas_march import kernel_key, pallas_surface_eval
        cfg = RenderConfig()
        kp = kernel_key(plan)

        @jax.jit
        def eval_block(block):
            sd, _, _ = pallas_surface_eval(
                kp, cfg.fd_h, cfg.ray_block, block, tables,
                with_color=False, with_normal=False, fused=fused,
                interpret=interpret)
            return sd
    else:
        eval_block = jax.jit(lambda block: scene_sd(plan, tables, block))

    n = pts.shape[0]
    out = np.empty(n, np.float32)
    i = 0
    while i < n:
        block = pts[i:i + chunk]
        if block.shape[0] < chunk and i > 0:
            # keep one compiled executable: pad the tail block
            padded = np.concatenate(
                [block, np.broadcast_to(block[-1:],
                                        (chunk - block.shape[0], 3))])
            out[i:i + chunk] = np.asarray(eval_block(
                jnp.asarray(padded)))[:block.shape[0]]
        else:
            out[i:i + block.shape[0]] = np.asarray(
                eval_block(jnp.asarray(block)))
        i += block.shape[0]
    return out.reshape(int(res[0]), int(res[1]), int(res[2]))


def extract_mesh(plan: ScenePlan, tables: SceneTables, *,
                 resolution: int = 96, bounds=None, backend: str = "auto",
                 interpret: Optional[bool] = None, fused: bool = False,
                 chunk: int = 1 << 18) -> Tuple[np.ndarray, np.ndarray]:
    """Compiled scene -> (vertices [V, 3] f32, faces [F, 3] i32).

    ``resolution`` = samples per axis (int or per-axis triple); ``bounds``
    = (lo, hi) world-space corners, default :func:`default_bounds` (the
    scene's solid geometry, excluding the inverted Bounds walls)."""
    if bounds is None:
        lo, hi = default_bounds(plan, tables)
    else:
        lo, hi = (np.asarray(bounds[0], np.float64),
                  np.asarray(bounds[1], np.float64))
    res = np.broadcast_to(np.asarray(resolution, np.int64), (3,))
    values = sample_sdf_grid(plan, tables, lo, hi, res, backend=backend,
                             interpret=interpret, fused=fused, chunk=chunk)
    spacing = (hi - lo) / np.maximum(res - 1, 1)
    return marching_tetrahedra(values, lo, spacing)


# ------------------------------------------------------------------ export

def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Wavefront OBJ (ascii; 1-based face indices)."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64) + 1
    with open(path, "w") as f:
        f.write("# raymarching_tpu mesh export\n")
        for v in verts:
            f.write(f"v {v[0]:.7g} {v[1]:.7g} {v[2]:.7g}\n")
        for t in faces:
            f.write(f"f {t[0]} {t[1]} {t[2]}\n")


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Binary little-endian PLY."""
    verts = np.asarray(verts, "<f4")
    faces = np.asarray(faces, "<i4")
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(verts)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {len(faces)}\n"
              "property list uchar int vertex_indices\nend_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(np.ascontiguousarray(verts).tobytes())
        f.write(b"".join(struct.pack("<B3i", 3, *t)
                         for t in faces.tolist()))


def save_mesh(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Dispatch on extension: .obj (ascii) or .ply (binary)."""
    lower = path.lower()
    if lower.endswith(".obj"):
        save_obj(path, verts, faces)
    elif lower.endswith(".ply"):
        save_ply(path, verts, faces)
    else:
        raise ValueError(f"unsupported mesh format: {path} (obj, ply)")
