"""Fused Pallas march kernels (Triton route, one ray per GPU thread).

The hot loop of the whole framework: sphere-trace a block of rays against
the compiled CSG scene.  This replaces the reference's GLSL compute kernel
(shader.comp:226-297) — but where the GLSL walks the CSG tree with a
divergent per-thread stack interpreter (SURVEY §3.4), this kernel is
generated from the static ScenePlan at trace time:

  * Rays live as 1-D f32 vectors of ``ray_block`` lanes (a power of two,
    RenderConfig.ray_block) — every thread of the program owns a ray;
    march state rides loop-carried vectors in registers.
  * Primitive parameters sit in ONE global-memory table ref
    (``memory_space=pl.ANY``) read by scalar loads and broadcast into the
    vector ops (the analogue of the reference's read-only SSBO broadcast,
    render.cpp:439-445) — the [rays, prims] distance matrix that makes the
    XLA jnp path memory-bound is never materialized.
  * The CSG fold is compiled structure: a static Python loop over groups and
    same-type runs, ``lax.fori_loop`` over primitives within a run, running
    min in registers.
  * Early exit is per-BLOCK (march_values): converged rays freeze
    (mask semantics identical to the reference's per-ray break,
    scene.cpp:36-40) and the block stops stepping as soon as every lane
    converged.

Grid: 1-D over ray blocks.  Every ``pallas_call`` names the Triton route
(``backend="triton"``); on a CPU host the same kernels run in the Pallas
interpreter (resolve_interpret).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..config import RenderConfig
from ..core.march import MAX_STEP, MarchResult
from ..scene.compile import (MIN, KernelPlan, ScenePlan, SceneTables,
                             iter_bvh_chunks)
from ..scene.csg import PrimType



def resolve_interpret(interpret=None) -> bool:
    """THE interpret-mode rule for every kernel of the package: ``None``
    means "interpret exactly when the default JAX backend is the CPU".
    A kernel never runs in the interpreter on a GPU."""
    on_cpu = jax.default_backend() == "cpu"
    if interpret is None:
        return on_cpu
    if interpret and not on_cpu:
        raise ValueError("interpret=True off the CPU: kernels run compiled "
                         "on an accelerator")
    return bool(interpret)


def _check_block(ray_block: int) -> None:
    if ray_block < 32 or ray_block & (ray_block - 1):
        raise ValueError(f"ray_block={ray_block}: the Triton lowering needs "
                         "a power of two >= 32")


def _num_warps(ray_block: int) -> int:
    """One ray per thread, capped at 8 warps (untuned beyond the
    PERF.md sweep)."""
    return max(1, min(8, ray_block // 32))


def _kernel_call(kernel, num_blocks: int, ray_block: int, in_specs,
                 out_shape, interpret: bool):
    """pallas_call on the Triton route with 1-D ray-block specs for every
    output; ``in_specs`` entries are ``"ray"`` (a per-ray stream) or
    ``"any"`` (a whole-array global-memory ref read by scalar loads)."""
    ray = pl.BlockSpec((ray_block,), lambda i: (i,))
    glob = pl.BlockSpec(memory_space=pl.ANY)
    return pl.pallas_call(
        kernel,
        grid=(num_blocks,),
        in_specs=[ray if s == "ray" else glob for s in in_specs],
        out_specs=tuple(ray for _ in out_shape),
        out_shape=tuple(out_shape),
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=_num_warps(ray_block), num_stages=1),
        interpret=interpret,
    )


def _all_lanes(mask):
    """Scalar: is ``mask`` true on every lane of the block?  (A min over
    an int view — the Triton lowering has no boolean and-reduce.)"""
    return jnp.min(jnp.where(mask, 1, 0)) > 0


def _round_clip1(x):
    """``clip(round(x), -1, 1)`` (round half to even) from compares: the
    Triton lowering has no ``round``.  Equal for every finite x: |x| <= 0.5
    rounds to 0, anything beyond rounds to a value the clip pins at ±1."""
    return jnp.where(x > 0.5, 1.0, jnp.where(x < -0.5, -1.0, 0.0))


def kernel_key(plan: ScenePlan):
    """The static argument the kernels key/compile on: the two-level
    KernelPlan when the scene is depth<=2 (fast path with per-tile cull),
    else the full ScenePlan — ANY grammar-expressible tree runs on the
    kernel path via the generic post-order evaluator (SURVEY §7's
    per-level unrolling; the GLSL stack interpreter, shader.comp:226-265,
    is what this replaces)."""
    return plan.kernel if plan.kernel is not None else plan


def _med3(a, b, c):
    """Median of three via a min/max sorting network.

    Mathematically equal to the reference's ``sum - min - max``
    (body.cpp:51-57) but built ONLY from exactly-rounded min/max ops: 4
    vector ops instead of 8, and EXACTLY monotone per argument in f32 — the
    property _menger_carve_lattice's bitwise-collapse proof requires (the
    sum form's intermediate rounding varies with its arguments).  Used
    identically in the jnp oracle (core.sdf._med3); deviation from the
    C++ sum form is ulp-scale rounding only."""
    return jnp.maximum(jnp.minimum(a, b),
                       jnp.minimum(jnp.maximum(a, b), c))


def _mandelbox_sd(tbl, i, px, py, pz, mscale: float, iters: int):
    """Mandelbox distance estimate of leaf ``i`` — the box-fold/sphere-fold
    iteration of core.sdf.mandelbox_sd, unrolled at trace time (``mscale``/
    ``iters`` are run-type statics, see compile run_type).  Same operation
    order as the jnp oracle so the two stay bit-identical."""
    cx, cy, cz = tbl[i, 0], tbl[i, 1], tbl[i, 2]
    size = tbl[i, 3]
    q0x, q0y, q0z = (px - cx) / size, (py - cy) / size, (pz - cz) / size
    qx, qy, qz = q0x, q0y, q0z
    dr = jnp.ones_like(px)
    for _ in range(iters):
        qx = jnp.clip(qx, -1.0, 1.0) * 2.0 - qx
        qy = jnp.clip(qy, -1.0, 1.0) * 2.0 - qy
        qz = jnp.clip(qz, -1.0, 1.0) * 2.0 - qz
        r2 = qx * qx + qy * qy + qz * qz
        f = jnp.where(r2 < 1.0, 1.0 / jnp.maximum(r2, 0.25), 1.0)
        sf = mscale * f
        qx, qy, qz = sf * qx + q0x, sf * qy + q0y, sf * qz + q0z
        dr = abs(mscale) * f * dr + 1.0
    return size * jnp.sqrt(qx * qx + qy * qy + qz * qz) / dr


def _mandelbox_sd_grad(tbl, i, px, py, pz, mscale: float, iters: int):
    """(sd, d sd/dp) of Mandelbox leaf ``i`` — hand-derived forward-mode
    sweep: the full 3x3 Jacobian dq/dp plus the 3-vector d(dr)/dp ride
    along the unrolled iteration (box fold scales Jacobian ROWS by ±1;
    sphere fold is a rank-one update through df/dr2).  Matches jax.grad of
    core.sdf.mandelbox_sd a.e. (clip/branch boundaries are measure zero).
    ~19 live vector registers — heavier than the 3 dense prim types, but
    one pass instead of 6 FD evaluations of an ``iters``-deep field."""
    cx, cy, cz = tbl[i, 0], tbl[i, 1], tbl[i, 2]
    size = tbl[i, 3]
    s0 = 1.0 / size                       # d q0_a / d p_a (diagonal)
    q0x, q0y, q0z = (px - cx) / size, (py - cy) / size, (pz - cz) / size
    qx, qy, qz = q0x, q0y, q0z
    dr = jnp.ones_like(px)
    zero = jnp.zeros_like(px)
    # J[a][b] = d q_a / d p_b, initialized to diag(1/size)
    jxx = s0 + zero
    jyy, jzz = jxx, jxx
    jxy = jxz = jyx = jyz = jzx = jzy = zero
    dx_ = dy_ = dz_ = zero                # d dr / d p
    for _ in range(iters):
        bx = jnp.where(jnp.abs(qx) <= 1.0, 1.0, -1.0)
        by = jnp.where(jnp.abs(qy) <= 1.0, 1.0, -1.0)
        bz = jnp.where(jnp.abs(qz) <= 1.0, 1.0, -1.0)
        qx = jnp.clip(qx, -1.0, 1.0) * 2.0 - qx
        qy = jnp.clip(qy, -1.0, 1.0) * 2.0 - qy
        qz = jnp.clip(qz, -1.0, 1.0) * 2.0 - qz
        jxx, jxy, jxz = bx * jxx, bx * jxy, bx * jxz
        jyx, jyy, jyz = by * jyx, by * jyy, by * jyz
        jzx, jzy, jzz = bz * jzx, bz * jzy, bz * jzz
        r2 = qx * qx + qy * qy + qz * qz
        f = jnp.where(r2 < 1.0, 1.0 / jnp.maximum(r2, 0.25), 1.0)
        # d f/d r2 = -1/r2^2 = -f^2 on the inversion branch, else 0
        fp = jnp.where(jnp.logical_and(r2 > 0.25, r2 < 1.0), -f * f, 0.0)
        r2x = 2.0 * (qx * jxx + qy * jyx + qz * jzx)
        r2y = 2.0 * (qx * jxy + qy * jyy + qz * jzy)
        r2z = 2.0 * (qx * jxz + qy * jyz + qz * jzz)
        fx, fy, fz = fp * r2x, fp * r2y, fp * r2z
        sf = mscale * f
        jxx = sf * jxx + mscale * qx * fx + s0
        jxy = sf * jxy + mscale * qx * fy
        jxz = sf * jxz + mscale * qx * fz
        jyx = sf * jyx + mscale * qy * fx
        jyy = sf * jyy + mscale * qy * fy + s0
        jyz = sf * jyz + mscale * qy * fz
        jzx = sf * jzx + mscale * qz * fx
        jzy = sf * jzy + mscale * qz * fy
        jzz = sf * jzz + mscale * qz * fz + s0
        qx, qy, qz = sf * qx + q0x, sf * qy + q0y, sf * qz + q0z
        asf = abs(mscale)
        dx_ = asf * (f * dx_ + dr * fx)
        dy_ = asf * (f * dy_ + dr * fy)
        dz_ = asf * (f * dz_ + dr * fz)
        dr = asf * f * dr + 1.0
    r = jnp.sqrt(qx * qx + qy * qy + qz * qz)
    sd = size * r / dr
    rinv = 1.0 / jnp.maximum(r, jnp.float32(1e-30))
    rx = (qx * jxx + qy * jyx + qz * jzx) * rinv
    ry = (qx * jxy + qy * jyy + qz * jzy) * rinv
    rz = (qx * jxz + qy * jyz + qz * jzz) * rinv
    inv_dr2 = 1.0 / (dr * dr)             # dr >= 1 by construction
    gx = size * (rx * dr - r * dx_) * inv_dr2
    gy = size * (ry * dr - r * dy_) * inv_dr2
    gz = size * (rz * dr - r * dz_) * inv_dr2
    return sd, gx, gy, gz


def _mandelbulb_sd(tbl, i, px, py, pz, power: float, iters: int):
    """Power-8 Mandelbulb distance estimate of leaf ``i`` — the trig-free
    triplex iteration of core.sdf.mandelbulb_sd (same guards, same masked
    escape; see scene.csg.Mandelbulb for the algebra), unrolled at trace
    time.  All ops are elementwise (mul/add/sqrt/log/min/max) — no
    transcendental a kernel lowering might lack."""
    del power
    cx, cy, cz = tbl[i, 0], tbl[i, 1], tbl[i, 2]
    size = tbl[i, 3]
    q0x, q0y, q0z = (px - cx) / size, (py - cy) / size, (pz - cz) / size
    wx, wy, wz = q0x, q0y, q0z
    m = wx * wx + wy * wy + wz * wz
    dz = jnp.ones_like(px)
    for _ in range(iters):
        esc = m > 256.0
        x = jnp.clip(wx, -16.0, 16.0)
        y = jnp.clip(wy, -16.0, 16.0)
        z = jnp.clip(wz, -16.0, 16.0)
        mq = jnp.minimum(m, 65536.0)
        dz_new = (8.0 * (mq * mq * mq) * jnp.sqrt(jnp.maximum(mq, 1e-12))
                  * dz + 1.0)   # see core.sdf.mandelbulb_sd
        x2, y2, z2 = x * x, y * y, z * z
        x4, y4, z4 = x2 * x2, y2 * y2, z2 * z2
        s2 = x2 + z2
        s = jnp.sqrt(jnp.maximum(s2, 1e-20))   # see core.sdf.mandelbulb_sd
        inv = 1.0 / jnp.maximum(s, 1e-10)
        ux, uz = x * inv, z * inv
        ux2, uz2 = ux * ux, uz * uz
        ux4, uz4 = ux2 * ux2, uz2 * uz2
        k1 = x4 + y4 + z4 - 6.0 * y2 * z2 - 6.0 * x2 * y2 + 2.0 * z2 * x2
        k4 = x2 - y2 + z2
        pa = ux * uz * (ux2 - uz2) * (ux4 - 6.0 * ux2 * uz2 + uz4)
        pb = (ux4 * ux4 - 28.0 * ux4 * ux2 * uz2 + 70.0 * ux4 * uz4
              - 28.0 * ux2 * uz2 * uz4 + uz4 * uz4)
        yk = y * k4 * k1 * s
        nx = 64.0 * yk * pa + q0x
        ny = -16.0 * y2 * s2 * k4 * k4 + k1 * k1 + q0y
        nz = -8.0 * yk * pb + q0z
        m_new = nx * nx + ny * ny + nz * nz
        wx = jnp.where(esc, wx, nx)
        wy = jnp.where(esc, wy, ny)
        wz = jnp.where(esc, wz, nz)
        dz = jnp.where(esc, dz, dz_new)
        m = jnp.where(esc, m, m_new)
    m = jnp.maximum(m, 1e-12)
    return size * 0.25 * jnp.log(m) * jnp.sqrt(m) / dz


class _Jet:
    """Forward-mode scalar: value + 3 directional tangents (d/dp).

    Operator-overloaded so the Mandelbulb gradient below IS the forward
    iteration run on dual numbers — the tangent recurrences cannot drift
    from the primal (the failure mode a hand-expanded Jacobian invites;
    the Mandelbox fold is simple enough that _mandelbox_sd_grad writes its
    Jacobian rows out by hand, the bulb's degree-8 polynomial is not).
    Everything stays trace-time Python over jnp vectors, so the kernel
    sees only elementwise vector ops."""

    __slots__ = ("v", "tx", "ty", "tz")

    def __init__(self, v, tx, ty, tz):
        self.v, self.tx, self.ty, self.tz = v, tx, ty, tz

    def __add__(self, o):
        if isinstance(o, _Jet):
            return _Jet(self.v + o.v, self.tx + o.tx, self.ty + o.ty,
                        self.tz + o.tz)
        return _Jet(self.v + o, self.tx, self.ty, self.tz)

    __radd__ = __add__

    def __neg__(self):
        return _Jet(-self.v, -self.tx, -self.ty, -self.tz)

    def __sub__(self, o):
        return self + (-o if isinstance(o, _Jet) else -o)

    def __rsub__(self, o):
        return (-self) + o

    def __mul__(self, o):
        if isinstance(o, _Jet):
            return _Jet(self.v * o.v,
                        self.tx * o.v + self.v * o.tx,
                        self.ty * o.v + self.v * o.ty,
                        self.tz * o.v + self.v * o.tz)
        return _Jet(self.v * o, self.tx * o, self.ty * o, self.tz * o)

    __rmul__ = __mul__


def _jet_sqrt_floor(a: _Jet, floor: float) -> _Jet:
    r = jnp.sqrt(jnp.maximum(a.v, floor))
    g = jnp.where(a.v > floor, 0.5 / r, 0.0)
    return _Jet(r, g * a.tx, g * a.ty, g * a.tz)


def _jet_log_floor(a: _Jet, floor: float) -> _Jet:
    v = jnp.maximum(a.v, floor)
    g = jnp.where(a.v > floor, 1.0 / v, 0.0)
    return _Jet(jnp.log(v), g * a.tx, g * a.ty, g * a.tz)


def _jet_min_c(a: _Jet, c: float) -> _Jet:
    keep = a.v < c
    z = jnp.where(keep, 1.0, 0.0)
    return _Jet(jnp.minimum(a.v, c), z * a.tx, z * a.ty, z * a.tz)


def _jet_clip(a: _Jet, lo: float, hi: float) -> _Jet:
    keep = jnp.logical_and(a.v > lo, a.v < hi)
    z = jnp.where(keep, 1.0, 0.0)
    return _Jet(jnp.clip(a.v, lo, hi), z * a.tx, z * a.ty, z * a.tz)


def _jet_inv_floor(a: _Jet, floor: float) -> _Jet:
    v = jnp.maximum(a.v, floor)
    inv = 1.0 / v
    g = jnp.where(a.v > floor, -inv * inv, 0.0)
    return _Jet(inv, g * a.tx, g * a.ty, g * a.tz)


def _jet_where(mask, a: _Jet, b: _Jet) -> _Jet:
    return _Jet(jnp.where(mask, a.v, b.v), jnp.where(mask, a.tx, b.tx),
                jnp.where(mask, a.ty, b.ty), jnp.where(mask, a.tz, b.tz))


def _mandelbulb_sd_grad(tbl, i, px, py, pz, power: float, iters: int):
    """(sd, d sd/dp) of Mandelbulb leaf ``i`` — the forward iteration of
    _mandelbulb_sd executed on _Jet dual numbers (value + 3 tangents
    seeded with dq0/dp = diag(1/size)).  Matches jax.grad of
    core.sdf.mandelbulb_sd a.e. (escape/clip boundaries measure zero)."""
    del power
    cx, cy, cz = tbl[i, 0], tbl[i, 1], tbl[i, 2]
    size = tbl[i, 3]
    inv_s = 1.0 / size
    zero = jnp.zeros_like(px)
    s0 = inv_s + zero
    q0x = _Jet((px - cx) * inv_s, s0, zero, zero)
    q0y = _Jet((py - cy) * inv_s, zero, s0, zero)
    q0z = _Jet((pz - cz) * inv_s, zero, zero, s0)
    wx, wy, wz = q0x, q0y, q0z
    m = wx * wx + wy * wy + wz * wz
    dz = _Jet(jnp.ones_like(px), zero, zero, zero)
    for _ in range(iters):
        esc = m.v > 256.0
        x = _jet_clip(wx, -16.0, 16.0)
        y = _jet_clip(wy, -16.0, 16.0)
        z = _jet_clip(wz, -16.0, 16.0)
        mq = _jet_min_c(m, 65536.0)
        dz_new = 8.0 * (mq * mq * mq) * _jet_sqrt_floor(mq, 1e-12) * dz + 1.0
        x2, y2, z2 = x * x, y * y, z * z
        x4, y4, z4 = x2 * x2, y2 * y2, z2 * z2
        s2 = x2 + z2
        s = _jet_sqrt_floor(s2, 1e-20)
        inv = _jet_inv_floor(s, 1e-10)
        ux, uz = x * inv, z * inv
        ux2, uz2 = ux * ux, uz * uz
        ux4, uz4 = ux2 * ux2, uz2 * uz2
        k1 = (x4 + y4 + z4 - 6.0 * (y2 * z2) - 6.0 * (x2 * y2)
              + 2.0 * (z2 * x2))
        k4 = x2 - y2 + z2
        pa = ux * uz * (ux2 - uz2) * (ux4 - 6.0 * (ux2 * uz2) + uz4)
        pb = (ux4 * ux4 - 28.0 * (ux4 * (ux2 * uz2)) + 70.0 * (ux4 * uz4)
              - 28.0 * ((ux2 * uz2) * uz4) + uz4 * uz4)
        yk = y * k4 * k1 * s
        nx = 64.0 * yk * pa + q0x
        ny = -16.0 * (y2 * s2) * (k4 * k4) + k1 * k1 + q0y
        nz = -8.0 * yk * pb + q0z
        m_new = nx * nx + ny * ny + nz * nz
        wx = _jet_where(esc, wx, nx)
        wy = _jet_where(esc, wy, ny)
        wz = _jet_where(esc, wz, nz)
        dz = _jet_where(esc, dz, dz_new)
        m = _jet_where(esc, m, m_new)
    lg = _jet_log_floor(m, 1e-12)
    rt = _jet_sqrt_floor(m, 1e-12)
    inv_dz = _jet_inv_floor(dz, 0.0)      # dz >= 1 by construction
    de = 0.25 * lg * rt * inv_dz
    return size * de.v, size * de.tx, size * de.ty, size * de.tz


def _julia_sd(tbl, i, px, py, pz, const, iters: int):
    """Quaternion z^2 + c Julia DE of leaf ``i`` — the masked-escape
    iteration of core.sdf.julia_sd (see scene.csg.Julia), unrolled at
    trace time.  ``const`` is the structural 4-tuple run-type param."""
    ca, cb, cc, cd = (float(v) for v in const)
    cx_, cy_, cz_ = tbl[i, 0], tbl[i, 1], tbl[i, 2]
    size = tbl[i, 3]
    a = (px - cx_) / size
    b = (py - cy_) / size
    c_ = (pz - cz_) / size
    d = jnp.zeros_like(px)
    m = a * a + b * b + c_ * c_ + d * d
    md = jnp.ones_like(px)
    for _ in range(iters):
        esc = m > 16.0
        mq = jnp.minimum(m, 4096.0)
        md_new = 2.0 * jnp.sqrt(jnp.maximum(mq, 1e-12)) * md
        ax = jnp.clip(a, -8.0, 8.0)
        bx = jnp.clip(b, -8.0, 8.0)
        cxx = jnp.clip(c_, -8.0, 8.0)
        dx = jnp.clip(d, -8.0, 8.0)
        na = ax * ax - bx * bx - cxx * cxx - dx * dx + ca
        nb = 2.0 * ax * bx + cb
        nc = 2.0 * ax * cxx + cc
        nd = 2.0 * ax * dx + cd
        m_new = na * na + nb * nb + nc * nc + nd * nd
        a = jnp.where(esc, a, na)
        b = jnp.where(esc, b, nb)
        c_ = jnp.where(esc, c_, nc)
        d = jnp.where(esc, d, nd)
        md = jnp.where(esc, md, md_new)
        m = jnp.where(esc, m, m_new)
    m = jnp.maximum(m, 1e-12)
    md = jnp.maximum(md, 1e-12)
    return size * 0.25 * jnp.sqrt(m) * jnp.log(m) / md


def _jet_max_c(a: _Jet, c: float) -> _Jet:
    keep = a.v > c
    z = jnp.where(keep, 1.0, 0.0)
    return _Jet(jnp.maximum(a.v, c), z * a.tx, z * a.ty, z * a.tz)


def _julia_sd_grad(tbl, i, px, py, pz, const, iters: int):
    """(sd, d sd/dp) of Julia leaf ``i`` — the forward iteration on _Jet
    dual numbers (same pattern as _mandelbulb_sd_grad)."""
    ca, cb, cc, cd = (float(v) for v in const)
    cx_, cy_, cz_ = tbl[i, 0], tbl[i, 1], tbl[i, 2]
    size = tbl[i, 3]
    inv_s = 1.0 / size
    zero = jnp.zeros_like(px)
    s0 = inv_s + zero
    a = _Jet((px - cx_) * inv_s, s0, zero, zero)
    b = _Jet((py - cy_) * inv_s, zero, s0, zero)
    c_ = _Jet((pz - cz_) * inv_s, zero, zero, s0)
    d = _Jet(zero, zero, zero, zero)
    m = a * a + b * b + c_ * c_ + d * d
    md = _Jet(jnp.ones_like(px), zero, zero, zero)
    for _ in range(iters):
        esc = m.v > 16.0
        mq = _jet_min_c(m, 4096.0)
        md_new = 2.0 * _jet_sqrt_floor(mq, 1e-12) * md
        ax = _jet_clip(a, -8.0, 8.0)
        bx = _jet_clip(b, -8.0, 8.0)
        cxx = _jet_clip(c_, -8.0, 8.0)
        dx = _jet_clip(d, -8.0, 8.0)
        na = ax * ax - bx * bx - cxx * cxx - dx * dx + ca
        nb = 2.0 * (ax * bx) + cb
        nc = 2.0 * (ax * cxx) + cc
        nd = 2.0 * (ax * dx) + cd
        m_new = na * na + nb * nb + nc * nc + nd * nd
        a = _jet_where(esc, a, na)
        b = _jet_where(esc, b, nb)
        c_ = _jet_where(esc, c_, nc)
        d = _jet_where(esc, d, nd)
        md = _jet_where(esc, md, md_new)
        m = _jet_where(esc, m, m_new)
    rt = _jet_sqrt_floor(m, 1e-12)
    lg = _jet_log_floor(m, 1e-12)
    inv_md = _jet_inv_floor(_jet_max_c(md, 1e-12), 0.0)
    de = 0.25 * rt * lg * inv_md
    return size * de.v, size * de.tx, size * de.ty, size * de.tz


_PROC_SD_KERNEL = {"mb": _mandelbox_sd, "bulb": _mandelbulb_sd,
                   "julia": _julia_sd}
_PROC_GRAD_KERNEL = {"mb": _mandelbox_sd_grad, "bulb": _mandelbulb_sd_grad,
                     "julia": _julia_sd_grad}


def _prim_sd(ptype, tbl, i, px, py, pz):
    """Distance of primitive ``i`` (scalars from the table) to rays
    (vectors).
    ``ptype``: int PrimType, or (kind, param, iters) for procedural runs
    (kind "mb" Mandelbox / "bulb" Mandelbulb)."""
    if isinstance(ptype, tuple):
        return _PROC_SD_KERNEL[ptype[0]](tbl, i, px, py, pz,
                                         ptype[1], ptype[2])
    cx, cy, cz = tbl[i, 0], tbl[i, 1], tbl[i, 2]
    if ptype == int(PrimType.SPHERE):
        dx, dy, dz = px - cx, py - cy, pz - cz
        return jnp.sqrt(dx * dx + dy * dy + dz * dz) - tbl[i, 3]
    hx, hy, hz = tbl[i, 3] * 0.5, tbl[i, 4] * 0.5, tbl[i, 5] * 0.5
    bx = jnp.abs(px - cx) - hx
    by = jnp.abs(py - cy) - hy
    bz = jnp.abs(pz - cz) - hz
    if ptype == int(PrimType.BOX):
        return jnp.maximum(jnp.maximum(bx, by), bz)
    return _med3(bx, by, bz)  # cross: median of the three excesses


# Groups at least this large get the per-tile base-bound cull.
_CULL_MIN_GROUP = 8

# Manual unroll factor for the primitive loops (the Triton lowering takes
# no partial ``fori_loop`` unroll, so we block by hand: fewer
# loop-carried branches, scalar loads issue ahead of the vector ops).
# Untuned on the GPU.
_UNROLL = 4

# March steps per early-exit check: the all-converged test is a
# block-wide reduction, so it runs every K steps instead of every step.
# Converged lanes are frozen by the mask either way, so up to K-1 extra
# masked iterations change nothing.  Untuned on the GPU.
_EXIT_CHECK_EVERY = 8


def _fold_span_dynamic(step, start, count, carry):
    """Fold ``count`` consecutive prims from a TRACED ``start`` row
    (static count): blocked fori + tracer-arithmetic remainder, mirroring
    the static run paths bit for bit (same op per leaf, same order).  Used
    by the recursive Menger subtree cull, whose level-2 cell starts are
    affine in a fori counter (_menger_subtree_fold)."""
    blocks, rem = divmod(count, _UNROLL)
    if blocks:
        def body(k, c):
            i = start + k * _UNROLL
            for j in range(_UNROLL):
                c = step(i + j, c)
            return c

        carry = jax.lax.fori_loop(0, blocks, body, carry)
    base = start + blocks * _UNROLL
    for j in range(rem):
        carry = step(base + j, carry)
    return carry


def _fold_runs(tbl, runs, px, py, pz, init):
    """min over runs of scale * prim_sd, starting from ``init``."""
    gmin = init
    for (ptype, start, count, scale) in runs:
        if not isinstance(start, (int, np.integer)):
            gmin = _fold_span_dynamic(
                lambda i, c, _p=ptype, _s=float(scale): jnp.minimum(
                    c, _s * _prim_sd(_p, tbl, i, px, py, pz)),
                start, count, gmin)
            continue
        if count <= _UNROLL:
            for i in range(start, start + count):
                sd = _prim_sd(ptype, tbl, i, px, py, pz)
                gmin = jnp.minimum(gmin, float(scale) * sd)
            continue
        blocks, rem = divmod(count, _UNROLL)

        def body(k, acc, _ptype=ptype, _scale=float(scale), _start=start):
            i = _start + k * _UNROLL
            for j in range(_UNROLL):
                sd = _prim_sd(_ptype, tbl, i + j, px, py, pz)
                acc = jnp.minimum(acc, _scale * sd)
            return acc

        gmin = jax.lax.fori_loop(0, blocks, body, gmin)
        for i in range(start + blocks * _UNROLL, start + count):
            sd = _prim_sd(ptype, tbl, i, px, py, pz)
            gmin = jnp.minimum(gmin, float(scale) * sd)
    return gmin


def _bvh_row_base(kp) -> int:
    """First bound row of the wide-UNION chunk cull (right after the flag
    row; one row per iter_bvh_chunks entry, same order)."""
    return _flag_row(kp) + 1


def _menger_off_row(kp) -> int:
    """First of the 20 Menger child-offset rows (after the bvh bound
    rows); present iff _needs_menger_offsets(kp) — the recursive subtree
    cull's level-2 fori fetches cell offsets by traced row index."""
    from ..scene.compile import iter_bvh_chunks
    return _bvh_row_base(kp) + len(iter_bvh_chunks(kp))


def iter_bvh_order_spans(kp):
    """Uniform chunk spans eligible for the ORDERED value-fold walk:
    ((group_index, run_index, uniform_len), ...) in the deterministic
    group/run order shared by _build_table (which appends uniform_len
    chunk-order rows per span after the Menger offset rows) and
    _bvh_group_fold (which reads them back by the same ordinal).  Spans
    shorter than 3 chunks gain nothing from ordering and get no rows."""
    out = []
    for gi, g in enumerate(getattr(kp, "groups", ())):
        for ri, chunks in (g.bvh or ()):
            uni = _uniform_prefix(chunks)
            if uni >= 3:
                out.append((gi, ri, uni))
    return tuple(out)


def _order_row_base(kp) -> int:
    """First chunk-order row (after the Menger offset rows)."""
    return _menger_off_row(kp) + (20 if _needs_menger_offsets(kp) else 0)


def _needs_menger_offsets(kp) -> bool:
    """Does any group take the level-2 recursive subtree cull (and so
    need the offset rows in the table)?"""
    return any(_use_subtree(g) and _subtree_recurses(g)
               for g in getattr(kp, "groups", ()))


def _bvh_group_offset(kp, g) -> int:
    """Ordinal of group ``g``'s first chunk in iter_bvh_chunks order."""
    off = 0
    for gg in kp.groups:
        if gg is g:
            return off
        for _ri, chunks in (gg.bvh or ()):
            off += len(chunks)
    raise ValueError("group not in plan")


# Module switch for A/B harnesses (fori vs unrolled chunk walk).
_BVH_FORI = True
# Diagnostic switch for cost-decomposition harnesses ONLY (results are
# WRONG outside "on"): "on" = normal proof-gated walk; "off" = fold all
# chunks with no tests (the unculled reference fold); "testsonly" =
# pay every test but never fold a chunk (isolates test cost).
_BVH_MODE = "on"


def _bvh_group_fold(kp, g, tbl, px, py, pz, state, fold_runs_fn, value_of,
                    ordered=False):
    """Chunk-culled plain-UNION group fold (GroupPlan.bvh) — generic over
    the fold carry: ``fold_runs_fn(runs, state)`` folds the given runs
    into the carry, ``value_of(state)`` reads the tile's running scene
    minimum for the skip proof.

    Exactness (the same proof-not-heuristic pattern as the DIFFERENCE
    base-bound cull): the chunk's bound row is the LIVE axis-aligned
    bounding box of its primitives' supports (_build_table), so per lane
    lb(p) = max_a(|p_a - c_a| - h_a) <= sd_i(p) for every member i — per
    axis |p_a - c_ia| - e_ia >= |p_a - c_a| - h_a by support containment,
    and both the sphere SDF (>= its Chebyshev excess) and the box SDF
    (max of excesses) dominate the axis maximum.  When every lane has
    lb >= running, no member can win any strict-< selection downstream:
    skipping the fold changes neither value nor winner index/gradient
    (a tie keeps the EARLIER leaf, which is already folded — which is why
    runs MUST fold in run order below, chunked or not: folding the
    un-chunked runs first would let a LATER leaf claim an exact-sd tie,
    flipping the reference-observable first-wins color winner AND
    invalidating this very premise).  This bounds the O(N) UNION fold
    the reference pays per evaluation (body.cpp:66-111)."""
    bvh = dict(g.bvh)
    row = _bvh_row_base(kp) + _bvh_group_offset(kp, g)
    for ri, run in enumerate(g.runs):
        if ri not in bvh:
            state = fold_runs_fn((run,), state)
            continue
        ptype = run[0]
        chunks = bvh[ri]

        def chunk_step(r, s, c, st, _ptype=ptype):
            if _BVH_MODE == "off":
                return fold_runs_fn(((_ptype, s, c, 1),), st)
            lb = jnp.maximum(jnp.maximum(
                jnp.abs(px - tbl[r, 0]) - tbl[r, 3],
                jnp.abs(py - tbl[r, 1]) - tbl[r, 4]),
                jnp.abs(pz - tbl[r, 2]) - tbl[r, 5])
            skip = _all_lanes(lb >= value_of(st))
            if _BVH_MODE == "testsonly":
                # keep lb + the reduce + the cond live without folding
                return jax.lax.cond(
                    skip, lambda st2: st2,
                    lambda st2: fold_runs_fn(
                        ((_ptype, s, 1, 1),), st2), st)
            return jax.lax.cond(
                skip, lambda st2: st2,
                lambda st2: fold_runs_fn(((_ptype, s, c, 1),), st2), st)

        # chunk starts/rows are affine in the chunk ordinal (the splitter
        # emits _BVH_CHUNK-strided spans; only the final chunk can be
        # short), so the walk is ONE fori whose body holds one traced
        # cond — the compile-scaling pattern (an unrolled walk traces
        # ~1,024 leaf steps + 32 conds per fold instance on scatter1k);
        # results are identical (same tests, same order — only trace
        # size changes).
        s0, c0 = chunks[0]
        uni = _uniform_prefix(chunks)
        obase = _span_order_base(kp, g, ri) if ordered else None
        if ordered and _BVH_SEED and uni >= 3:
            # SEED the running min with one representative member per
            # chunk (its first leaf) before any skip test: min is
            # idempotent, so re-folding members later changes nothing
            # bitwise, and the tests now compare against a near-tight
            # running instead of whatever the earlier groups left —
            # leaf-order walking left 62% of chunk-fold work live on
            # scatter1k because running was still the floor distance.
            # Value folds only (callers pass ordered=False for idx/grad
            # folds: a pre-folded representative would claim first-wins
            # ties from earlier leaves).
            state = fold_runs_fn(
                tuple((ptype, s0 + k * c0, 1, 1) for k in range(uni)),
                state)
        if _BVH_FORI and uni >= 2:
            row0 = row

            if obase is not None:
                # ORDERED walk (value folds only — min is order-free
                # bitwise; idx/grad folds keep leaf order for first-wins
                # ties): chunk ordinals come from the live
                # nearest-camera order rows (_build_table), so the
                # running min tightens immediately and the later — far —
                # chunks' proof-gated skips actually fire.
                def body(k, st, _row0=row0, _s0=s0, _c0=c0,
                         _ob=obase):
                    oid = tbl[_ob + k, 0].astype(jnp.int32)
                    return chunk_step(_row0 + oid, _s0 + oid * _c0, _c0,
                                      st)
            else:
                def body(k, st, _row0=row0, _s0=s0, _c0=c0):
                    return chunk_step(_row0 + k, _s0 + k * _c0, _c0, st)

            state = jax.lax.fori_loop(0, uni, body, state)
            row += uni
            rest = chunks[uni:]
        else:
            rest = chunks
        for (s, c) in rest:
            state = chunk_step(row, s, c, state)
            row += 1
    return state


def _uniform_prefix(chunks) -> int:
    """Length of a chunk list's leading affine span (s0 + k*c0, c0) —
    the ONE shared definition for the fold's fori walk, the order-row
    table layout (iter_bvh_order_spans) and preload_table's bound-row
    skip.  These three must agree or the order rows desync from the
    walk (load-bearing; pinned by test_bvh_cull's layout test)."""
    s0, c0 = chunks[0]
    uni = 0
    while uni < len(chunks) and chunks[uni] == (s0 + uni * c0, c0):
        uni += 1
    return uni


# Module switches (ordered vs leaf-order value walk; representative-seeded
# running min).  Seeding stays off: once the walk is nearest-first, the
# unconditional representative folds cost more than the extra skips they
# enable (previous hardware; unmeasured on the GPU).
_BVH_ORDERED = True
_BVH_SEED = False


def _span_order_base(kp, g, ri):
    """First order row of (group g, run ri)'s uniform chunk span, or
    None when the span has no order rows (see iter_bvh_order_spans)."""
    if not _BVH_ORDERED:
        return None
    spans = iter_bvh_order_spans(kp)
    gi = kp.groups.index(g)
    base = _order_row_base(kp)
    for (sgi, sri, uni) in spans:
        if (sgi, sri) == (gi, ri):
            return base
        base += uni
    return None


def _menger_carve_lattice(tbl, g, px, py, pz):
    """EXACT min over a Menger group's carve crosses via the per-level
    coordinate lattice (GroupPlan.lattice) — the branch-free replacement
    for folding 20^k crosses one by one.

    Within a level every cross shares per-axis centre coordinates and one
    size, so the per-axis excesses ``b* = |p* - c*| - s*/2`` take only a
    few distinct values, each computed once from a representative table
    row.  The cross SDF ``median(bx, by, bz)`` is monotone in each
    argument and ``jnp.minimum`` returns one of its inputs exactly, so
    ``min over a (y,z) column = median(min_x bx, by, bz)`` holds BITWISE:
    the collapsed median sees the winning cross's exact excess values.
    Demo-scene level 2: 27 axis values + 64 column medians instead of 400
    19-op cross evaluations (~7x fewer vector ops), no conds, no reduces.

    Only valid while the live rows actually share coordinates; callers
    gate on the _lattice_ok flag (tbl flag row) and fall back to the full
    fold otherwise."""
    best = None
    for level in g.lattice:
        if len(level) == 1:             # level-0: a single cross
            sd = _prim_sd(int(PrimType.CROSS), tbl, level[0],
                          px, py, pz)
        else:
            xs_reps, ys_reps, zs_reps, size_rep, columns, _members = level
            hx = tbl[size_rep, 3] * 0.5
            hy = tbl[size_rep, 4] * 0.5
            hz = tbl[size_rep, 5] * 0.5
            bx = [jnp.abs(px - tbl[r, 0]) - hx for r in xs_reps]
            by = [jnp.abs(py - tbl[r, 1]) - hy for r in ys_reps]
            bz = [jnp.abs(pz - tbl[r, 2]) - hz for r in zs_reps]
            sd = None
            # columns SHARE x-sets (level k has at most 2^k distinct
            # shapes: E={-1,1} or F={-1,0,1} per sub-level), so each
            # distinct set's min is computed ONCE — min over the same
            # multiset is bitwise order-free.  This is what makes the
            # 512-column iters=4 level 3 traceable: 512 x (med3 + min)
            # instead of 512 x (up-to-27-min chain + med3) — the global
            # three-level collapse replaces the per-subtree guarded fold
            # outright (r5; the factored-minima idea from
            # _subtree_collapse_eval applied at the global lattice).
            xset_min = {}
            for (iy, iz, ixs, _rows) in columns:
                # sorted key: same-set columns can list ixs in different
                # DFS orders; min over one multiset is bitwise
                # order-free (the b-values are |.|-h: never -0.0 or NaN)
                key = tuple(sorted(ixs))
                a = xset_min.get(key)
                if a is None:
                    a = bx[key[0]]
                    for ix in key[1:]:
                        a = jnp.minimum(a, bx[ix])
                    xset_min[key] = a
                med = _med3(a, by[iy], bz[iz])
                sd = med if sd is None else jnp.minimum(sd, med)
        best = sd if best is None else jnp.minimum(best, sd)
    return best


# Exact-table Menger carve folds at least this big take the per-subtree
# hierarchical cull (deep sponges whose lattice collapse is column-capped).
_SUBTREE_MIN_COUNT = 1024


def _menger_subtrees(g):
    """Static level-1 subtree layout of a Menger group's carve: 20 DFS
    subtrees, each contiguous (generators._generate_menger recursion) —
    (rows_per_subtree, ((offset, start), ...)).  None unless the group has
    menger provenance with iters >= 2 and the expected 1 + 1 + 20*T rows."""
    if g.fused is None or g.fused[0] != "menger" or g.fused[1] < 2:
        return None
    iters = g.fused[1]
    T = sum(20 ** k for k in range(iters - 1))   # crosses per subtree
    if g.count != 2 + 20 * T or any(s != 1 for s in g.scales[1:]):
        return None
    from ..scene.generators import _MENGER_OFFSETS
    return T, tuple((off, g.start + 2 + j * T)
                    for j, off in enumerate(_MENGER_OFFSETS))


# A level-1 subtree recurses (its 20 child cells get their own skip
# tests) only when each child holds at least this many crosses: a skip
# test's all-lanes reduce + branch costs about as much as one ~15-op
# cross evaluation, so guarding single crosses (sub_T == 1) is a wash
# while guarding 21-cross cells (iters=4's level-2) wins whenever even a
# tenth of them skip.
_SUBTREE_RECURSE_MIN = 21


def _subtree_recurses(g) -> bool:
    """Does this group's subtree cull take the level-2 fori pass (and so
    need the Menger offset rows in the table, _build_table)?  Recursion
    pays per CHILD cell, so the threshold applies to the child size
    (T-1)//20, not the subtree total: at (T-1)//20 == 1 the fori would
    guard single crosses — a wash the threshold exists for."""
    sub = _menger_subtrees(g)
    if sub is None:
        return False
    T = sub[0]
    return (T - 1) % 20 == 0 and (T - 1) // 20 >= _SUBTREE_RECURSE_MIN


def _menger_subtree_fold(kp, tbl, g, px, py, pz, carry, fold_fn, value_of):
    """EXACT carve fold for big Menger groups with a HIERARCHICAL
    per-tile, per-cell skip: every cross in the subtree of cell k (cube
    side sz/3 at c_k = c + o_k sz/3, where sz is the PARENT cell's side;
    descendant centres deviate < sz/6) has half-width <= sz/18, and the
    cross SDF med3(|p-c|-h) is monotone per axis — so

        LB_k = med3(|p - c_k| - (sz/6 + sz/18))   (per axis)

    lower-bounds every member.  When ALL lanes of the tile have
    LB_k >= the running carve min, folding cell k's subtree cannot change
    the strict-< fold result (value, winner, or gradient) — one skip
    test elides it.  The DFS leaf layout (reference emission order,
    body.cpp:149-156) is recursively [cell root cross, 20 child
    subtrees], so live level-1 cells descend: their 20 child cells get
    skip tests at the next scale (sz -> sz/3) via ONE ``lax.fori_loop``
    whose body holds a single traced ``lax.cond`` — NOT 400 unrolled
    conds, which took XLA minutes to compile.  The child-cell centre
    offsets ride in the table's Menger offset rows (_build_table) so the
    fori body can fetch them by traced index (the same dynamic scalar reads
    the run folds already use), and the child folds run from traced row
    starts (_fold_span_dynamic).  For iters=4 a tile near the surface
    touches a handful of level-2 cells and folds ~21 crosses per live
    one, instead of 421 per live level-1 subtree.  Tiles are compact
    pixel blocks (core.order), so the all-lanes test fires on real
    spatial structure.

    Generic over the carried state: ``fold_fn(runs, carry)`` is any of
    the _fold_runs* family closed over (tbl, p); ``value_of(carry)``
    extracts the running min the skip test compares against.

    PERTURBATION ENVELOPE: the skip bounds derive cell centres from the
    GROUP ROOT row and the generated offset lattice.  The margin proof
    holds for tables within per-axis drift < sz/18 of that lattice at
    the level-1 scale (sz = s) and < sz/18 at the level-2 scale
    (sz = s/3, i.e. < s/54 absolute) — generator-emitted tables are
    ulps-exact on it.  The iters=4 VALUE folds are runtime-gated on
    subtree_collapse_ok (which certifies drift < s/72) with a plain-fold
    fallback; idx/grad folds and iters>=5 currently assume the envelope
    (optimizing raw deep-sponge cross rows past it is out of scope —
    fused-generator plans are the supported way to optimize sponges)."""
    T, subs = _menger_subtrees(g)
    carry = fold_fn(((int(PrimType.CROSS), g.start + 1, 1, 1),), carry)
    cx, cy, cz = tbl[g.start, 0], tbl[g.start, 1], tbl[g.start, 2]
    s = tbl[g.start, 3]
    third = s * (1.0 / 3.0)
    margin = s * (2.0 / 9.0)           # cell half s/6 + max cross half s/18
    recurse = _subtree_recurses(g)
    for (off, start) in subs:
        ox = cx + float(off[0]) * third
        oy = cy + float(off[1]) * third
        oz = cz + float(off[2]) * third
        bx = jnp.abs(px - ox) - margin
        by = jnp.abs(py - oy) - margin
        bz = jnp.abs(pz - oz) - margin
        lb = _med3(bx, by, bz)

        def with_subtree(c, _start=start, _ox=ox, _oy=oy, _oz=oz):
            if not recurse:
                return fold_fn(((int(PrimType.CROSS), _start, T, 1),), c)
            return _menger_level2_walk(kp, tbl, px, py, pz, fold_fn,
                                       value_of, c, _ox, _oy, _oz,
                                       _start, T, third)

        skip = _all_lanes(lb >= value_of(carry))
        carry = jax.lax.cond(skip, lambda c: c, with_subtree, carry)
    return carry


def _menger_level2_walk(kp, tbl, px, py, pz, fold_fn, value_of, c,
                        ox, oy, oz, b0, T, third):
    """Level-2 cell walk of one LIVE level-1 subtree: the subtree root
    cross (row ``b0``), then its 20 child cells in DFS order, each
    behind the margin bound at the child scale (one fori, one traced
    cond).  Shared by _menger_subtree_fold's recursion and
    _menger_subtree_vbound_fold's live-subtree descent — their required
    bitwise parity lives in this ONE body (r5 review: the two
    hand-synced copies were a silent-desync hazard)."""
    sub2 = (T - 1) // 20
    ninth = third * (1.0 / 3.0)
    margin2 = third * (2.0 / 9.0)
    off_row = _menger_off_row(kp)
    c = fold_fn(((int(PrimType.CROSS), b0, 1, 1),), c)

    def body(k, cc):
        ox2 = ox + tbl[off_row + k, 0] * ninth
        oy2 = oy + tbl[off_row + k, 1] * ninth
        oz2 = oz + tbl[off_row + k, 2] * ninth
        lb2 = _med3(jnp.abs(px - ox2) - margin2,
                    jnp.abs(py - oy2) - margin2,
                    jnp.abs(pz - oz2) - margin2)
        start2 = b0 + 1 + k * sub2

        def live(c3):
            return fold_fn(((int(PrimType.CROSS), start2, sub2, 1),), c3)

        skip2 = _all_lanes(lb2 >= value_of(cc))
        return jax.lax.cond(skip2, lambda c3: c3, live, cc)

    return jax.lax.fori_loop(0, 20, body, c)


def _menger_carve_subtree_culled(kp, tbl, g, px, py, pz, init):
    """Value-only subtree-culled carve (see _menger_subtree_fold)."""
    return _menger_subtree_fold(
        kp, tbl, g, px, py, pz, init,
        lambda runs, c: _fold_runs(tbl, runs, px, py, pz, c),
        lambda c: c)


# ---------------------------------------------------------------------------
# Per-subtree two-level lattice collapse (value-only folds, iters=4 sponges).
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _menger_yz_columns():
    """(y, z) columns of the 20 Menger child offsets with their x-value
    sets: 8 columns — 4 with x in {-1, 0, 1} (|y| == |z| == 1, edge +
    corner cells) and 4 with x in {-1, 1} (one of y/z zero; x = 0 would be
    the excluded face centre).  Static combinatorics of the generator
    (body.cpp:119-144 offset order), shared by the collapse and its
    structure flag."""
    from ..scene.generators import _MENGER_OFFSETS
    cols = {}
    for (x, y, z) in _MENGER_OFFSETS:
        cols.setdefault((y, z), []).append(x)
    return tuple((yz, tuple(sorted(xs))) for yz, xs in cols.items())


@functools.lru_cache(maxsize=1)
def _menger_axis_reps():
    """Per axis: {offset value -> first child index j with that value} —
    the representative rows the collapsed fold reads coordinates from."""
    from ..scene.generators import _MENGER_OFFSETS
    reps = []
    for axis in range(3):
        m = {}
        for j, off in enumerate(_MENGER_OFFSETS):
            m.setdefault(off[axis], j)
        reps.append(m)
    return tuple(reps)


# Module switch for A/B harnesses (benchmarks/ab_subtree_collapse.py);
# flipping it changes TRACE behavior without changing plan cache keys, so
# harnesses must clear the kernel lru caches (ab_bvh._clear_kernel_caches).
_SUBTREE_COLLAPSE = True


def _subtree_collapses(g) -> bool:
    """Can this group's carve take the per-subtree two-level lattice
    collapse for VALUE-only folds?  Exactly iters=4 sponges: each level-1
    subtree then holds 1 + 20 + 400 crosses — a root plus two fully
    collapsible levels.  (idx/grad folds never collapse: color ties are
    reference-observable first-wins in leaf order, CLAUDE.md invariant.)"""
    if not _SUBTREE_COLLAPSE:
        return False
    sub = _menger_subtrees(g)
    return sub is not None and sub[0] == 421


def _subtree_collapse_eval(tbl, b0, px, py, pz, c):
    """EXACT min over one level-1 Menger subtree's 421 carve crosses in
    ~490 vector ops and zero reduces/branches — the two-level analogue of
    _menger_carve_lattice, localized to the subtree at traced root row
    ``b0`` (DFS layout: [root, 20 x (cell cross, 20 leaf crosses)]).

    Within the subtree every level shares per-axis centre coordinates and
    one size: level-2 centres are c1 + o2*(s/9) (3 distinct coords per
    axis), level-3 centres c1 + o2*(s/9) + o3*(s/27) — and (o2, o3)
    decomposes UNIQUELY from 3*o2 + o3, so 9 distinct coords per axis,
    each generated by the identical float expression (generators.py
    recursion), hence exactly equal across members.  The cross SDF
    med3(bx, by, bz) is monotone per argument and jnp.minimum returns one
    of its inputs exactly, so per (y, z) column

        min over column = med3(min over member x of bx, by, bz)

    holds BITWISE (the winning cross's exact excesses — the
    _menger_carve_lattice proof).  Level-3's x-minima factor: a column's
    x-set is {3a + b : a in X2, b in X3} with X2/X3 in {E = {-1,1},
    F = {-1,0,1}}, so 4 shared minima cover all 64 (o2-col x o3-col)
    pairs.  Coordinates and halves come from REPRESENTATIVE table rows
    (never recomputed — generation-order float identities only hold
    row-to-row), so results match the leaf fold bit for bit while the
    structure flag holds (subtree_collapse_ok)."""
    reps = _menger_axis_reps()
    cols = _menger_yz_columns()

    def r2(j2):
        return b0 + 1 + j2 * 21

    def r3(j2, j3):
        return b0 + 2 + j2 * 21 + j3

    c = jnp.minimum(c, _prim_sd(int(PrimType.CROSS), tbl, b0, px, py, pz))
    p = (px, py, pz)
    b2 = []              # b2[axis][v]: per-axis excess, v in (-1, 0, 1)
    b3 = []              # b3[axis][(u, v)]: u = level-2, v = level-3 offset
    for a in range(3):
        rep = reps[a]
        h2 = tbl[r2(0), 3 + a] * 0.5
        h3 = tbl[r3(0, 0), 3 + a] * 0.5
        b2.append({v: jnp.abs(p[a] - tbl[r2(rep[v]), a]) - h2
                   for v in (-1, 0, 1)})
        b3.append({(u, v): jnp.abs(p[a] - tbl[r3(rep[u], rep[v]), a]) - h3
                   for u in (-1, 0, 1) for v in (-1, 0, 1)})
    # level-2: min over 20 crosses = min over the 8 (y, z) columns
    bx2 = b2[0]
    mE2 = jnp.minimum(bx2[-1], bx2[1])
    mF2 = jnp.minimum(mE2, bx2[0])
    for (y, z), xs in cols:
        mx = mF2 if len(xs) == 3 else mE2
        c = jnp.minimum(c, _med3(mx, b2[1][y], b2[2][z]))
    # level-3: min over 400 crosses = 64 column pairs, factored x-minima
    bx3 = b3[0]
    mEE = jnp.minimum(jnp.minimum(bx3[(-1, -1)], bx3[(-1, 1)]),
                      jnp.minimum(bx3[(1, -1)], bx3[(1, 1)]))
    mEF = jnp.minimum(mEE, jnp.minimum(bx3[(-1, 0)], bx3[(1, 0)]))
    m0E = jnp.minimum(bx3[(0, -1)], bx3[(0, 1)])
    mFE = jnp.minimum(mEE, m0E)
    mFF = jnp.minimum(mEF, jnp.minimum(m0E, bx3[(0, 0)]))
    mx3 = {(2, 2): mEE, (2, 3): mEF, (3, 2): mFE, (3, 3): mFF}
    for (y2, z2), xs2 in cols:
        for (y3, z3), xs3 in cols:
            mx = mx3[(len(xs2), len(xs3))]
            c = jnp.minimum(c, _med3(mx, b3[1][(y2, y3)], b3[2][(z2, z3)]))
    return c


def _menger_subtree_collapsed(kp, tbl, g, px, py, pz, init):
    """Value-only iters=4 carve: every level-1 subtree folds through the
    two-level lattice collapse UNCONDITIONALLY — one fori, zero skip
    tests.  The guarded version (level-1 margin bound + cond per subtree)
    was slower on the previous hardware: the 20 all-lane margin reduces +
    conds cost more than the ~17 subtree collapses they skip (unmeasured
    on the GPU).  The collapse lesson, completed: collapse the
    math AND drop the last guard level.  Bitwise-identical either way
    (min is exact selection; the skip was exactness-preserving).

    Callers gate on the subtree_collapse_ok flag (flag row column 1) and
    fall back to the PLAIN leaf fold when the live rows no longer share
    the generated per-level coordinates (sharing is all this fold needs
    now; the flag's drift check additionally certifies the idx/grad
    walk's skip bounds — see _menger_subtree_vbound_fold)."""
    T, _subs = _menger_subtrees(g)
    carry = jnp.minimum(init, _prim_sd(int(PrimType.CROSS), tbl,
                                       g.start + 1, px, py, pz))

    def body(j, c):
        b0 = g.start + 2 + j * T
        return _subtree_collapse_eval(tbl, b0, px, py, pz, c)

    return jax.lax.fori_loop(0, 20, body, carry)


def _menger_subtree_vbound_fold(kp, tbl, g, px, py, pz, carry, fold_fn,
                                value_of):
    """fori-driven level-1 subtree walk for the idx/grad fold family with
    TWO exact skip levels (r5; ROADMAP's worked plan):

      1. the margin bound med3(|p - o_j| - s*2/9) of _menger_subtree_fold
         (cheap, ~10 ops);
      2. for margin-live subtrees, the subtree's COLLAPSED VALUE MIN m_j
         (_subtree_collapse_eval, ~490 straight-line ops) — an EXACT
         bound: every cross in subtree j has sd >= m_j with equality
         attained by the subtree winner, so "all lanes m_j >= running"
         proves the strict-< fold cannot change (value, winner, or
         gradient): a cross tying the running value loses first-wins by
         leaf order (body.cpp:12-14) because subtrees fold in DFS order
         after the running winner.

    Margin-live-but-not-winning subtrees (most near-surface ones — the
    reason menger4's backward ran at ~1/3 of its forward) skip their
    whole 421-cross idx/grad fold for ~490 ops.  A subtree that survives
    BOTH bounds (typically only the one holding the winner) descends via
    the level-2 margin walk of _menger_subtree_fold — folding ~21-cross
    live cells instead of 421 flat crosses.  One fori whose body
    holds the nested conds (the proven compile-scaling pattern; subtree
    starts are affine in the counter, child offsets ride the table's
    Menger offset rows).

    Callers gate on subtree_collapse_ok (flag row col 1): all bounds
    (level-1 margin, m_j, level-2 margin) and the collapse eval assume
    the generated lattice (group-root derived centres +
    representative-row reads); the flag's s/72 tolerance keeps every
    level's margin proof (level-2 slack is 5s/162)."""
    T, _subs = _menger_subtrees(g)
    carry = fold_fn(((int(PrimType.CROSS), g.start + 1, 1, 1),), carry)
    cx, cy, cz = tbl[g.start, 0], tbl[g.start, 1], tbl[g.start, 2]
    s = tbl[g.start, 3]
    third = s * (1.0 / 3.0)
    margin = s * (2.0 / 9.0)
    off_row = _menger_off_row(kp)
    inf = jnp.full(px.shape, jnp.inf, px.dtype)

    def body(j, c):
        ox = cx + tbl[off_row + j, 0] * third
        oy = cy + tbl[off_row + j, 1] * third
        oz = cz + tbl[off_row + j, 2] * third
        lb = _med3(jnp.abs(px - ox) - margin,
                   jnp.abs(py - oy) - margin,
                   jnp.abs(pz - oz) - margin)
        b0 = g.start + 2 + j * T

        def margin_live(c2):
            m_j = _subtree_collapse_eval(tbl, b0, px, py, pz, inf)

            def live(c3):
                return _menger_level2_walk(kp, tbl, px, py, pz, fold_fn,
                                           value_of, c3, ox, oy, oz, b0,
                                           T, third)

            skip_m = _all_lanes(m_j >= value_of(c2))
            return jax.lax.cond(skip_m, lambda c3: c3, live, c2)

        skip = _all_lanes(lb >= value_of(c))
        return jax.lax.cond(skip, lambda c2: c2, margin_live, c)

    return jax.lax.fori_loop(0, 20, body, carry)


# Module switch for A/B harnesses (benchmarks/ab_vbound.py); same
# clear-the-kernel-caches contract as _SUBTREE_COLLAPSE.
_SUBTREE_VBOUND = True


def _subtree_carve_fold(kp, tbl, g, px, py, pz, carry, fold_fn, value_of,
                        pos_runs):
    """Carve fold for a _use_subtree group, idx/grad fold family: when
    the group collapses (iters=4) the walk is runtime-gated on the
    structure flag — the collapsed-VALUE-bound fori walk while it holds,
    the PLAIN leaf fold otherwise (exact for any table; the margin walk
    shares the generated-lattice assumption and is no safer a fallback).
    Non-collapsing deep sponges (iters >= 5) keep the recursive
    margin-bound walk (envelope documented on _menger_subtree_fold)."""
    if _subtree_collapses(g) and _SUBTREE_VBOUND:
        return jax.lax.cond(
            tbl[_flag_row(kp), 1] > 0.5,
            lambda c: _menger_subtree_vbound_fold(kp, tbl, g, px, py, pz,
                                                  c, fold_fn, value_of),
            lambda c: fold_fn(pos_runs, c),
            carry)
    return _menger_subtree_fold(kp, tbl, g, px, py, pz, carry, fold_fn,
                                value_of)


def subtree_collapse_ok(kp, tables) -> jnp.ndarray:
    """Scalar f32 flag (flag-row column 1, _build_table): do the LIVE
    tables still satisfy (a) the per-subtree shared-coordinate structure
    the collapsed fold reads through representative rows
    (_subtree_collapse_eval) and (b) the generated-lattice positions the
    level-1 SKIP BOUND derives from the group root row (every member row
    within s/72 per axis — inside every level's margin slack)?  Same as
    lattice_ok: vectorized gathers over static index arrays, computed
    OUTSIDE the kernels once per dispatch; generator scenes pass,
    perturbed rows (optimizer steps on the exact table) drop back to the
    plain leaf fold — exact for ANY table."""
    if not isinstance(kp, KernelPlan):
        return jnp.float32(0.0)
    from ..scene.generators import _MENGER_OFFSETS
    pos = jnp.asarray(tables.prim_pos)
    aux = jnp.asarray(tables.prim_aux)
    reps = _menger_axis_reps()
    offs = np.asarray(_MENGER_OFFSETS)
    checks = []
    for g in kp.groups:
        if not (_use_subtree(g) and _subtree_collapses(g)):
            continue
        T = _menger_subtrees(g)[0]
        b0 = g.start + 2 + np.arange(20) * T            # [20] subtree roots
        r2 = b0[:, None] + 1 + np.arange(20) * 21       # [20, 20]
        r3 = r2[:, :, None] + 1 + np.arange(20)         # [20, 20, 20]
        for a in range(3):
            repj = np.array([reps[a][v] for v in offs[:, a]])
            rep2 = b0[:, None] + 1 + repj[None, :] * 21
            rep3 = (b0[:, None, None] + 1 + repj[None, :, None] * 21
                    + 1 + repj[None, None, :])
            checks.append(jnp.all(pos[r2, a] == pos[rep2, a]))
            checks.append(jnp.all(pos[r3, a] == pos[rep3, a]))
        checks.append(jnp.all(aux[r2] == aux[r2[:, :1]]))
        checks.append(jnp.all(aux[r3] == aux[r3[:, :1, :1]]))
        # Bound validity (r4 advisor): the skip tests derive cell centres
        # from the GROUP ROOT row.  Within-subtree sharing alone would
        # pass a uniformly translated subtree while silently invalidating
        # them.  Verify every member row sits within tol = s/72 (per
        # axis) of the generated lattice position, and sizes within tol:
        # level-1 margin s*2/9 has slack s/18 over the true member
        # extent s/6 (uses s/72 pos + s/144 half drift); the level-2
        # margin 2s/27 of the vbound walk has slack 5s/162 over its
        # extent 7s/162 (drift budget 3.4s/162 > 2.25 + 1.13 used).
        # Generator tables are ulps-exact on the lattice, so the
        # tightening costs nothing real.
        root = pos[g.start]
        s = aux[g.start, 0]
        third = s * (1.0 / 3.0)
        ninth = third * (1.0 / 3.0)
        tw7 = ninth * (1.0 / 3.0)
        offs_f = jnp.asarray(offs, pos.dtype)           # [20, 3]
        q1 = root[None] + offs_f * third                # cell centres (b0)
        q2 = q1[:, None] + offs_f[None] * ninth
        q3 = q2[:, :, None] + offs_f[None, None] * tw7
        tol = s * (1.0 / 72.0)
        checks.append(jnp.all(jnp.abs(pos[b0] - q1) <= tol))
        checks.append(jnp.all(jnp.abs(pos[r2] - q2) <= tol))
        checks.append(jnp.all(jnp.abs(pos[r3] - q3) <= tol))
        checks.append(jnp.all(jnp.abs(aux[b0] - ninth) <= tol))
        checks.append(jnp.all(jnp.abs(aux[r2] - tw7) <= tol))
        checks.append(jnp.all(jnp.abs(aux[r3] - tw7 * (1.0 / 3.0))
                              <= tol))
    if not checks:
        return jnp.float32(0.0)
    ok = checks[0]
    for c in checks[1:]:
        ok = jnp.logical_and(ok, c)
    return ok.astype(jnp.float32)


def _lattice_idx_ok(g) -> bool:
    """May the idx/grad fold family use the collapsed-lattice WINNER
    folds?  Only when every level's column count stays small: the winner
    collapse carries per-column row-select chains that cannot share
    factored x-minima, so iters=4's 512-column level would trace ~40k
    ops.  Big-lattice groups route their winner folds through the
    value-bound subtree walk instead (_subtree_carve_fold); their VALUE
    folds still take the global lattice collapse (x-set minima are
    shared there, ~3k traced ops for the whole 8,421-cross carve)."""
    return g.lattice is not None and all(
        len(level) == 1 or len(level[4]) <= 128 for level in g.lattice)


def _use_subtree(g) -> bool:
    """Should this group's carve take the per-subtree walk in the
    idx/grad fold family?  Deep sponges whose lattice is either absent
    or too wide for the winner collapse (_lattice_idx_ok) — small
    lattices stay the better exact fast path for winners too."""
    return ((g.lattice is None or not _lattice_idx_ok(g))
            and g.count >= _SUBTREE_MIN_COUNT
            and _menger_subtrees(g) is not None)


def lattice_ok(kp, tables) -> jnp.ndarray:
    """Scalar f32 flag (1.0/0.0): do the LIVE tables still satisfy every
    lattice group's shared-coordinate structure?  Computed with plain jnp
    OUTSIDE the kernels (vectorized gathers over static index arrays) and
    shipped to them in the table's flag row (_build_table); generator
    scenes pass bitwise, scenes whose cross rows were perturbed (e.g. by
    an optimizer step) drop back to the exact full fold."""
    if not isinstance(kp, KernelPlan):
        return jnp.float32(0.0)
    pos = jnp.asarray(tables.prim_pos)
    aux = jnp.asarray(tables.prim_aux)
    checks = []
    for g in kp.groups:
        if g.lattice is None:
            continue
        for level in g.lattice:
            if len(level) == 1:
                continue
            xs_reps, ys_reps, zs_reps, size_rep, _columns, members = level
            rows = np.array([m[0] for m in members])
            rx = np.array([xs_reps[m[1]] for m in members])
            ry = np.array([ys_reps[m[2]] for m in members])
            rz = np.array([zs_reps[m[3]] for m in members])
            checks.append(jnp.all(pos[rows, 0] == pos[rx, 0]))
            checks.append(jnp.all(pos[rows, 1] == pos[ry, 1]))
            checks.append(jnp.all(pos[rows, 2] == pos[rz, 2]))
            checks.append(jnp.all(aux[rows] == aux[size_rep]))
    if not checks:
        return jnp.float32(0.0)
    ok = checks[0]
    for c in checks[1:]:
        ok = jnp.logical_and(ok, c)
    return ok.astype(jnp.float32)


def _cross_sd_q(qx, qy, qz, half):
    bx = jnp.abs(qx) - half
    by = jnp.abs(qy) - half
    bz = jnp.abs(qz) - half
    return _med3(bx, by, bz)


def _menger_carve(tbl, box_idx: int, iters: int, px, py, pz, dtype):
    """Space-folding evaluation of the union of the sponge's 20^k crosses.

    Per level k the crosses sit on a ±pitch sublattice of the previous
    level's cells; folding the query into the nearest cell makes one cross
    evaluation stand for the whole level.  Properties (proved against the
    explicit table): identical zero set (cross arms along a cell column
    coincide between neighboring cells; phantom cells lie inside ancestor
    carvings), and conservative values (a min over a superset), so sphere
    tracing converges to the same surfaces.  O(iters) work vs O(20^k).
    Box centre/size read from the group's base primitive row —
    differentiable Menger parameters are (position, size)."""
    cx, cy, cz = tbl[box_idx, 0], tbl[box_idx, 1], tbl[box_idx, 2]
    s = tbl[box_idx, 3]
    qx, qy, qz = px - cx, py - cy, pz - cz
    pitch = s / 3.0
    csize = s / 3.0
    carve = jnp.full(px.shape, jnp.inf, dtype)
    for k in range(iters):
        carve = jnp.minimum(carve, _cross_sd_q(qx, qy, qz, csize * 0.5))
        if k + 1 < iters:
            def fold(q, _p=pitch):
                cell = _round_clip1(q / _p)
                return q - cell * _p
            qx, qy, qz = fold(qx), fold(qy), fold(qz)
            pitch = pitch / 3.0
            csize = csize / 3.0
    return carve


def _deathstar_carve(tbl, base_idx: int, px, py, pz):
    """Fused DeathStar carve: the subtracted sphere DERIVED from the base
    row — centre + 1.5 r in x, same radius (body.cpp:159-169).  Fused-mode
    semantics: the group is a function of the generator's own parameters
    (base position, radius); the carve's table row is never read, so
    gradients flow to the generator, not to two independent spheres."""
    r = tbl[base_idx, 3]
    dx = px - (tbl[base_idx, 0] + 1.5 * r)
    dy = py - tbl[base_idx, 1]
    dz = pz - tbl[base_idx, 2]
    return jnp.sqrt(dx * dx + dy * dy + dz * dz) - r


def _deathstar_carve_grad(tbl, base_idx: int, px, py, pz):
    """(carve, d carve/dp) twin of _deathstar_carve."""
    r = tbl[base_idx, 3]
    dx = px - (tbl[base_idx, 0] + 1.5 * r)
    dy = py - tbl[base_idx, 1]
    dz = pz - tbl[base_idx, 2]
    d = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    inv = 1.0 / jnp.maximum(d, jnp.float32(1e-30))
    return d - r, dx * inv, dy * inv, dz * inv


# Base-primitive type per fused-generator kind (the leaf at group.start).
_FUSED_BASE_TYPE = {"menger": int(PrimType.BOX),
                    "deathstar": int(PrimType.SPHERE)}


def _fused_carve(g, tbl, px, py, pz, dtype):
    """Carve evaluation of a fused generator group, dispatched on the
    provenance kind (GroupPlan.fused) — the group value is always
    max(base_sd, -carve) = -min(-base_sd, carve)."""
    if g.fused[0] == "menger":
        return _menger_carve(tbl, g.start, g.fused[1], px, py, pz, dtype)
    return _deathstar_carve(tbl, g.start, px, py, pz)


def _fused_carve_grad(g, tbl, px, py, pz, dtype):
    """(carve, d carve/dp) dispatch twin of _fused_carve."""
    if g.fused[0] == "menger":
        return _menger_carve_grad(tbl, g.start, g.fused[1], px, py, pz,
                                  dtype)
    return _deathstar_carve_grad(tbl, g.start, px, py, pz)


class _TableView:
    """Table wrapper with pre-read scalars for statically-indexed
    primitives.  Constructed BEFORE a march loop, so the (loop-invariant)
    scalar loads are traced outside the loop body and read once per tile
    instead of once per step; dynamically-indexed (fori) reads pass
    through to the underlying ref."""

    def __init__(self, tbl, cache):
        self._tbl = tbl
        self._cache = cache

    def __getitem__(self, key):
        i, j = key
        if isinstance(i, (int, np.integer)):   # fori indices are tracers
            v = self._cache.get((int(i), j))
            if v is not None:
                return v
        return self._tbl[key]


# Preload at most this many scalars (register pressure guard).  Untuned
# on the GPU.
_PRELOAD_LIMIT = 256

# Apply the per-block cull to fused generator groups: OFF — the folded
# carve is only ~30 vector ops, about what the cull's block-wide reduce +
# lax.cond costs (the cull stays essential for exact-table groups, where
# it skips 400+ primitive folds).  Untuned on the GPU.
_CULL_FUSED = False

# Apply the per-block cull to lattice-collapsed groups: the collapsed
# carve is ~7x cheaper than the full fold, which shrinks what the cull can
# save while its reduce + cond cost is unchanged (same trade as
# _CULL_FUSED).  Untuned on the GPU.
_CULL_LATTICE = False


def preload_table(kp, tbl, fused: bool):
    """Build a _TableView caching every scalar the fold will read through a
    STATIC index (unrolled runs, fori leftovers, fused generator bases)."""
    cache = {}

    def load(i, js):
        for j in js:
            if (i, j) not in cache:
                cache[(i, j)] = tbl[i, j]

    if isinstance(kp, ScenePlan):
        # Generic deep plan: preload every leaf (deep trees are small; the
        # _PRELOAD_LIMIT guard below still applies).
        for i, t in enumerate(kp.prim_type):
            load(i, range(4) if t in (int(PrimType.SPHERE),
                                      int(PrimType.MANDELBOX),
                                      int(PrimType.MANDELBULB),
                                      int(PrimType.JULIA))
                 else range(6))
        if len(cache) > _PRELOAD_LIMIT:
            return tbl
        return _TableView(tbl, cache)

    flag = _flag_row(kp)
    for g in kp.groups:
        use_fused = fused and g.fused is not None
        for (ptype, start, count, scale) in g.runs:
            if use_fused and scale == 1:
                continue               # replaced by the folded carve
            js = (range(4) if isinstance(ptype, tuple)    # mandelbox
                  or ptype == int(PrimType.SPHERE) else range(6))
            if count <= _UNROLL:
                idxs = range(start, start + count)
            else:
                blocks = count // _UNROLL
                idxs = range(start + blocks * _UNROLL, start + count)
            for i in idxs:
                load(i, js)
        if use_fused:
            load(g.start, range(4))    # folded carve reads pos + size.x
        if not use_fused and _use_subtree(g) and _subtree_collapses(g):
            load(flag, (1,))           # subtree-collapse structure flag
        if g.lattice is not None and not use_fused:
            load(flag, (0,))           # lattice-validity flag row
            for level in g.lattice:
                if len(level) == 1:
                    load(level[0], range(6))
                    continue
                xs_reps, ys_reps, zs_reps, size_rep = level[:4]
                load(size_rep, (3, 4, 5))
                for r in xs_reps:
                    load(r, (0,))
                for r in ys_reps:
                    load(r, (1,))
                for r in zs_reps:
                    load(r, (2,))
    # wide-UNION chunk-cull bound rows: preload ONLY the rows the fold
    # reads at STATIC indices — the uniform span's rows are read by
    # TRACED index inside the fori walk and bypass the _TableView cache
    # (r5 review: caching them was dead weight that also counted toward
    # _PRELOAD_LIMIT and could flip the whole preload off)
    brow = _bvh_row_base(kp)
    for g in kp.groups:
        for _ri, chunks in (g.bvh or ()):
            uni = _uniform_prefix(chunks) if _BVH_FORI else 0
            if uni < 2:
                uni = 0
            for k in range(uni, len(chunks)):
                load(brow + k, range(6))
            brow += len(chunks)
    if len(cache) > _PRELOAD_LIMIT:
        return tbl
    return _TableView(tbl, cache)


def _type_segments(prim_type, start: int, count: int, proc_map=None):
    """Split leaves [start, start+count) into maximal same-type segments.
    Procedural leaves (``proc_map``: leaf -> (kind, param, iters)) get the
    tagged run type — same convention as compile.run_type."""
    segs = []
    for off in range(count):
        t = prim_type[start + off]
        if proc_map and (start + off) in proc_map:
            t = proc_map[start + off]
        if segs and segs[-1][0] == t:
            segs[-1] = (t, segs[-1][1], segs[-1][2] + 1)
        else:
            segs.append((t, start + off, 1))
    return segs


def _scene_generic_tile(plan: ScenePlan, tbl, px, py, pz, dtype,
                        with_idx: bool, with_grad: bool):
    """Arbitrary-depth scene evaluation: the static post-order ListPlan
    sequence unrolled at trace time — each list's (value[, idx][, grad])
    lives in registers, entries fold left-to-right with strict first-wins
    comparisons (body.cpp:12-14 / core.sdf argmin-first semantics).  MAX
    folds run through min via max(x) = -min(-x).  No cull (deep scenes are
    small); no fused-generator provenance (generators are always depth-2).

    Returns (sd[, idx][, gx, gy, gz]) matching the two-level variants."""
    from ..core.sdf import _coalesced_entries, KIND_LIST as _KL

    inf = jnp.full(px.shape, jnp.inf, dtype)
    zero = jnp.zeros(px.shape, dtype)
    neg_one = jnp.full(px.shape, -1, jnp.int32)

    def empty():
        return (inf, neg_one, zero, zero, zero)

    def negate(e):
        v, i, gx, gy, gz = e
        return (-v, i, -gx, -gy, -gz)

    proc_map = {i: (k, pm, it) for (i, k, pm, it) in plan.proc}

    def fold_run(op, start, count, neg):
        # entry value = (neg ? -sd : sd); MIN folds directly, MAX via -min.
        s = -1 if neg else 1
        scale = s if op == MIN else -s
        runs = tuple((pt, st, ct, scale)
                     for (pt, st, ct) in _type_segments(plan.prim_type,
                                                        start, count,
                                                        proc_map))
        if with_grad and with_idx:
            m, i, gx, gy, gz = _fold_runs_idx_grad(
                tbl, runs, px, py, pz, (inf, neg_one, zero, zero, zero))
        elif with_idx:
            m, i = _fold_runs_idx(tbl, runs, px, py, pz, (inf, neg_one))
            gx = gy = gz = zero
        elif with_grad:
            m, gx, gy, gz = _fold_runs_grad(
                tbl, runs, px, py, pz, (inf, zero, zero, zero))
            i = neg_one
        else:
            m = _fold_runs(tbl, runs, px, py, pz, inf)
            i, gx, gy, gz = neg_one, zero, zero, zero
        if op == MIN:
            return (m, i, gx, gy, gz)
        return (-m, i, -gx, -gy, -gz)

    def combine(op, acc, e):
        av, ai, agx, agy, agz = acc
        v, i, gx, gy, gz = e
        better = v < av if op == MIN else v > av   # strict: first wins
        return (jnp.where(better, v, av),
                jnp.where(better, i, ai),
                jnp.where(better, gx, agx),
                jnp.where(better, gy, agy),
                jnp.where(better, gz, agz))

    results = []
    for lp in plan.lists:
        acc = None
        for (kind, idx, count, neg) in _coalesced_entries(lp):
            if kind == _KL:
                e = results[idx]
                if neg:
                    e = negate(e)
            else:
                e = fold_run(lp.op, idx, count, neg)
            acc = e if acc is None else combine(lp.op, acc, e)
        results.append(acc if acc is not None else empty())
    v, i, gx, gy, gz = results[-1]
    out = (v,)
    if with_idx:
        out += (i,)
    if with_grad:
        out += (gx, gy, gz)
    return out if len(out) > 1 else out[0]


def _scene_sd_tile(kp, tbl, px, py, pz, dtype, fused=False):
    """Scene SDF for a tile: static unroll over groups/runs, fori over
    primitives within a run, all reductions as running minima in registers.
    ``kp`` is a KernelPlan (two-level fast path) or a full ScenePlan
    (arbitrary-depth generic path — see kernel_key).

    Exact per-tile culling for large max-groups (DIFFERENCE lists like the
    421-cross Menger carve): the group value max(base, -cross_i, ...) is
    bounded below by the base primitives alone, so when that cheap bound
    already exceeds the running scene minimum on EVERY lane of the tile,
    folding the remaining primitives cannot change the result — skip them.
    Semantics-preserving (the skip condition is a proof, not a heuristic);
    effectiveness comes from ray tiles being spatially coherent."""
    if isinstance(kp, ScenePlan):
        return _scene_generic_tile(kp, tbl, px, py, pz, dtype,
                                   with_idx=False, with_grad=False)
    inf = jnp.full(px.shape, jnp.inf, dtype)
    rsign = 1.0 if kp.root_op == MIN else -1.0
    running = inf
    for g in kp.groups:
        neg_runs = [r for r in g.runs if r[3] == -1]
        pos_runs = [r for r in g.runs if r[3] == 1]
        use_fused = fused and g.fused is not None
        use_lattice = g.lattice is not None and not use_fused
        diff_group = g.gsign == -1 and rsign == 1.0 and bool(neg_runs)
        cullable = (diff_group
                    and (g.count >= _CULL_MIN_GROUP or use_fused)
                    and (_CULL_FUSED or not use_fused)
                    and (_CULL_LATTICE or not use_lattice))

        def lattice_carve(_g=g, _runs=tuple(pos_runs)):
            # collapsed-lattice carve when the live rows still share
            # coordinates (flag row), full fold otherwise — both exact
            return jax.lax.cond(
                tbl[_flag_row(kp), 0] > 0.5,
                lambda _: _menger_carve_lattice(tbl, _g, px, py, pz),
                lambda _: _fold_runs(tbl, _runs, px, py, pz, inf),
                0)

        if diff_group and (use_fused or use_lattice) and not cullable:
            gmin_base = _fold_runs(tbl, neg_runs, px, py, pz, inf)
            carve = (_fused_carve(g, tbl, px, py, pz, dtype)
                     if use_fused else lattice_carve())
            running = jnp.minimum(running,
                                  rsign * -jnp.minimum(gmin_base, carve))
        elif cullable:
            gmin_base = _fold_runs(tbl, neg_runs, px, py, pz, inf)
            lb = -gmin_base          # = max over base sd <= group value

            if use_fused:
                def with_rest(r, _base=gmin_base, _g=g):
                    carve = _fused_carve(_g, tbl, px, py, pz, dtype)
                    return jnp.minimum(r, -jnp.minimum(_base, carve))
            elif use_lattice:
                def with_rest(r, _base=gmin_base):
                    return jnp.minimum(
                        r, -jnp.minimum(_base, lattice_carve()))
            elif _use_subtree(g):
                # column-capped deep sponge: per-subtree hierarchical cull;
                # value-only folds additionally take the two-level lattice
                # collapse while the structure flag holds (flag row col 1).
                # The flag also certifies the level-1 SKIP BOUND (member
                # rows within s/72 of the generated lattice) — so the
                # flag-false fallback is the PLAIN leaf fold, which is
                # exact for any table, not the recursion, whose own skip
                # bounds share the generated-lattice assumption.
                def with_rest(r, _base=gmin_base, _g=g,
                              _runs=tuple(pos_runs)):
                    if _subtree_collapses(_g):
                        gmin = jax.lax.cond(
                            tbl[_flag_row(kp), 1] > 0.5,
                            lambda b, __g=_g: _menger_subtree_collapsed(
                                kp, tbl, __g, px, py, pz, b),
                            lambda b: _fold_runs(tbl, _runs, px, py, pz,
                                                 b),
                            _base)
                    else:
                        gmin = _menger_carve_subtree_culled(kp, tbl, _g, px,
                                                            py, pz, _base)
                    return jnp.minimum(r, -gmin)
            else:
                def with_rest(r, _base=gmin_base, _runs=tuple(pos_runs)):
                    gmin = _fold_runs(tbl, _runs, px, py, pz, _base)
                    return jnp.minimum(r, -gmin)

            skip = _all_lanes(lb >= running)
            running = jax.lax.cond(skip, lambda r: r, with_rest, running)
        elif g.bvh is not None:
            # wide-UNION chunk cull: gsign == +1 under a MIN root (the
            # partition exists only then), so the group folds straight
            # into the running scene min with per-chunk skips
            running = _bvh_group_fold(
                kp, g, tbl, px, py, pz, running,
                lambda runs, r: _fold_runs(tbl, runs, px, py, pz, r),
                lambda r: r, ordered=True)
        else:
            gmin = _fold_runs(tbl, g.runs, px, py, pz, inf)
            gval = float(g.gsign) * gmin
            running = jnp.minimum(running, rsign * gval)
    return rsign * running


def march_values(kp, tbl, ox, oy, oz, dx, dy, dz, iterations: int,
                 eps: float, fused: bool, tmax=None, soft_k=None,
                 init_done=None, with_steps: bool = False):
    """March one ray block of vectors -> (px, py, pz, sd, done-mask), then
    the penumbra factor when ``soft_k`` is set and the per-ray step count
    when ``with_steps``.

    ``tmax`` (shadow rays): the march also terminates once the accumulated
    distance passes the per-ray target — EXACT for the shadow boolean (see
    core.shading.shadowed): any endpoint at/beyond the light is 'lit' and
    the reference march only moves forward.  ``soft_k``: track min over
    steps of clamp(soft_k * sd / t, 0, 1) (same formula as
    core.shading._soft_step).  ``init_done``: boolean lanes whose result
    is not needed (e.g. shadow rays of provably-black pixels) start
    pre-converged: zero field evals, never a straggler; they return
    p = origin, sd = +inf, done = 1.

    Early exit is per block: the all-done test runs every
    K = _EXIT_CHECK_EVERY steps, the remainder runs after the loop so the
    TOTAL evaluation cap stays exactly ``iterations`` (reference parity for
    never-converging rays, scene.cpp:35), and done lanes are frozen by the
    mask, so extra masked steps change nothing.  The loop is a
    ``fori_loop`` over K-step blocks whose body skips once all lanes are
    done — not a ``while_loop``: the Triton compiler shipped with JAX 0.9
    crashes on a ``scf.while`` that carries a block-reduced flag.  The K
    steps are a loop too, so the scene fold is traced once per march
    (kernel compile time grows with program size)."""
    dtype = dx.dtype
    shape = dx.shape
    soft = soft_k is not None

    def step(st):
        px, py, pz, sd_prev, done, pen, steps = st
        sd = _scene_sd_tile(kp, tbl, px, py, pz, dtype, fused=fused)
        active = done < 0.5
        if with_steps:
            steps = steps + jnp.where(active, 1.0, 0.0)
        if soft:
            t_cur = (px - ox) * dx + (py - oy) * dy + (pz - oz) * dz
            ratio = jnp.clip(soft_k * sd / jnp.maximum(t_cur, eps),
                             0.0, 1.0)
            pen = jnp.where(active, jnp.minimum(pen, ratio), pen)
        length = jnp.where(active, jnp.minimum(sd, MAX_STEP), 0.0)
        px = px + length * dx
        py = py + length * dy
        pz = pz + length * dz
        sd_new = jnp.where(active, sd, sd_prev)
        done = jnp.where(sd_new < eps, 1.0, done)
        if tmax is not None:
            # t = (p - o) . d  (directions are unit-length)
            t = (px - ox) * dx + (py - oy) * dy + (pz - oz) * dz
            done = jnp.where(t >= tmax, 1.0, done)
        return (px, py, pz, sd_new, done, pen, steps)

    # f32 done mask: 0 = active
    done0 = (jnp.zeros(shape, dtype) if init_done is None
             else jnp.where(init_done, 1.0, 0.0).astype(dtype))
    st = (jnp.broadcast_to(ox, shape), jnp.broadcast_to(oy, shape),
          jnp.broadcast_to(oz, shape), jnp.full(shape, jnp.inf, dtype),
          done0, jnp.ones(shape, dtype) if soft else None,
          jnp.zeros(shape, dtype) if with_steps else None)

    K = min(_EXIT_CHECK_EVERY, max(iterations, 1))
    blocks, rem = divmod(iterations, K)

    def run_k(s):
        return jax.lax.fori_loop(0, K, lambda _, x: step(x), s)

    def block(_, s):
        return jax.lax.cond(jnp.min(s[4]) > 0.5, lambda x: x, run_k, s)

    if blocks:
        st = jax.lax.fori_loop(0, blocks, block, st)
    for _ in range(rem):
        st = step(st)
    return (st[:5] + ((st[5],) if soft else ())
            + ((st[6],) if with_steps else ()))


def _march_kernel(kp: KernelPlan, iterations: int, eps: float,
                  has_tmax: bool, fused: bool, with_steps: bool, *refs):
    """March one ray block (march_values) from ray-stream refs; optional
    per-ray ``tmax`` input and step-count output."""
    refs = list(refs)
    steps_ref = refs.pop() if with_steps else None
    if has_tmax:
        (tbl_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tmax_ref,
         px_ref, py_ref, pz_ref, sd_ref, done_ref) = refs
    else:
        (tbl_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
         px_ref, py_ref, pz_ref, sd_ref, done_ref) = refs
    # loop-invariant loads happen once, before the march loop
    out = march_values(kp, preload_table(kp, tbl_ref, fused),
                       ox_ref[...], oy_ref[...], oz_ref[...],
                       dx_ref[...], dy_ref[...], dz_ref[...], iterations,
                       eps, fused, tmax=tmax_ref[...] if has_tmax else None,
                       with_steps=with_steps)
    (px_ref[...], py_ref[...], pz_ref[...], sd_ref[...],
     done_ref[...]) = out[:5]
    if with_steps:
        steps_ref[...] = out[5]


def _flag_row(kp) -> int:
    """Row index of the table's flag row (first row past the leaves)."""
    if isinstance(kp, KernelPlan) and kp.groups:
        g = kp.groups[-1]
        return g.start + g.count
    return 1


def _build_table(tables: SceneTables, kp=None) -> jnp.ndarray:
    """[P+1(+B), 8] primitive table (one global-memory ref read by scalar
    loads in every kernel): centre xyz, aux xyz,
    padding; one trailing FLAG row — column 0 carries the lattice-validity
    bit (lattice_ok) so kernels can gate the collapsed Menger fold without
    any extra operand plumbing.

    When the plan carries wide-UNION chunk culls (GroupPlan.bvh), one
    bound row per chunk follows the flag row: [cx cy cz hx hy hz 0 0], the
    tight LIVE axis-aligned bounding box of the chunk's primitives
    (per-axis support: centre ± radius for spheres, ± half size for
    boxes).  Computed from the CURRENT table values every dispatch, so a
    fitted/perturbed scene keeps an exact bound; only the chunk partition
    is static."""
    P = tables.prim_pos.shape[0]
    pad = jnp.zeros((P, 2), tables.prim_pos.dtype)
    body = jnp.concatenate(
        [jnp.asarray(tables.prim_pos), jnp.asarray(tables.prim_aux), pad],
        axis=1)
    flag = lattice_ok(kp, tables) if kp is not None else jnp.float32(0.0)
    sflag = (subtree_collapse_ok(kp, tables) if kp is not None
             else jnp.float32(0.0))
    flag_row = (jnp.zeros((1, 8), body.dtype).at[0, 0].set(flag)
                .at[0, 1].set(sflag))
    parts = [body, flag_row]
    chunks = iter_bvh_chunks(kp) if kp is not None else ()
    centers = []
    if chunks:
        pos = jnp.asarray(tables.prim_pos)
        aux = jnp.asarray(tables.prim_aux)
        z2 = jnp.zeros((2,), body.dtype)
        rows = []
        for (ptype, s, c) in chunks:
            p = pos[s:s + c]
            if ptype == int(PrimType.SPHERE):
                e = jnp.broadcast_to(aux[s:s + c, 0:1], (c, 3))
            else:
                e = aux[s:s + c] * 0.5
            lo = jnp.min(p - e, axis=0)
            hi = jnp.max(p + e, axis=0)
            centers.append((lo + hi) * 0.5)
            rows.append(jnp.concatenate([(lo + hi) * 0.5, (hi - lo) * 0.5,
                                         z2]))
        parts.append(jnp.stack(rows))
    if kp is not None and _needs_menger_offsets(kp):
        # 20 static child-cell offset rows [ox oy oz 0...] for the
        # recursive subtree cull's level-2 fori (_menger_subtree_fold)
        from ..scene.generators import _MENGER_OFFSETS
        offs = np.zeros((20, 8), np.float32)
        offs[:, :3] = np.asarray(_MENGER_OFFSETS, np.float32)
        parts.append(jnp.asarray(offs))
    spans = iter_bvh_order_spans(kp) if kp is not None else ()
    if spans:
        # LIVE nearest-camera chunk order, one ordinal per row (col 0):
        # VALUE folds walk chunks nearest-first so the running tile min
        # tightens immediately and the EXISTING proof-gated skips fire
        # for the far chunks (min-folds are order-free bitwise; idx/grad
        # folds keep leaf order for first-wins ties).  Recomputed from
        # the live tables every dispatch, like the bound rows.
        cam = jnp.asarray(tables.cam_position)
        cc = jnp.stack(centers)                         # [nchunks, 3]
        d = jnp.sum((cc - cam[None, :]) ** 2, axis=1)
        # chunk ordinals are global; spans index into their own range
        base = 0
        offs_of = {}
        for gi, g in enumerate(kp.groups):
            for ri, ch in (g.bvh or ()):
                offs_of[(gi, ri)] = base
                base += len(ch)
        for (gi, ri, uni) in spans:
            o = offs_of[(gi, ri)]
            order = jnp.argsort(d[o:o + uni]).astype(body.dtype)
            rows = jnp.zeros((uni, 8), body.dtype).at[:, 0].set(order)
            parts.append(rows)
    return jnp.concatenate(parts, axis=0)


@functools.lru_cache(maxsize=64)
def _compiled_call(kp: KernelPlan, iterations: int, eps: float,
                   ray_block: int, num_blocks: int, has_tmax: bool,
                   fused: bool, with_steps: bool, interpret: bool):
    f32 = jax.ShapeDtypeStruct((num_blocks * ray_block,), jnp.float32)
    n_ray_inputs = 7 if has_tmax else 6
    n_outputs = 6 if with_steps else 5
    kernel = functools.partial(_march_kernel, kp, iterations, eps, has_tmax,
                               fused, with_steps)
    return _kernel_call(kernel, num_blocks, ray_block,
                        ["any"] + ["ray"] * n_ray_inputs, (f32,) * n_outputs,
                        interpret)


def _tiling(R: int, ray_block: int):
    """(num_blocks, prep, unprep) for a flat batch of ``R`` rays cut into
    1-D blocks of ``ray_block`` lanes."""
    _check_block(ray_block)
    num_blocks = max(1, -(-R // ray_block))
    padded = num_blocks * ray_block

    def prep(v):
        # edge-pad: padding lanes replay the last real ray, so they converge
        # with it and never hold a block's early exit hostage
        return jnp.pad(v, ((0, padded - R),), mode="edge")

    def unprep(v):
        return v[:R]

    return num_blocks, prep, unprep


def pallas_march(kp: KernelPlan, iterations: int, eps: float,
                 ray_block: int, origin: jnp.ndarray, ray: jnp.ndarray,
                 tables: SceneTables, *, tmax=None, fused: bool = False,
                 with_steps: bool = False, interpret=None):
    """March a flat batch of rays. origin/ray: [R, 3] -> MarchResult.
    ``tmax`` [R] (optional): stop rays once they pass this distance.
    ``with_steps``: also return per-ray iteration counts [R]."""
    R = origin.shape[0]
    num_blocks, prep, unprep = _tiling(R, ray_block)

    comps = [prep(origin[:, a]) for a in range(3)]
    comps += [prep(ray[:, a]) for a in range(3)]
    if tmax is not None:
        comps.append(prep(tmax))
    tbl = _build_table(tables, kp)

    call = _compiled_call(kp, iterations, eps, ray_block, num_blocks,
                          tmax is not None, fused, with_steps,
                          resolve_interpret(interpret))
    outs = call(tbl, *comps)
    if with_steps:
        px, py, pz, sd, done, steps = outs
    else:
        px, py, pz, sd, done = outs

    p = jnp.stack([unprep(px), unprep(py), unprep(pz)], axis=-1)
    sd = unprep(sd)
    res = MarchResult(position=p, sd=sd,
                      converged=jnp.logical_and(unprep(done) > 0.5,
                                                sd < eps))
    if with_steps:
        return res, unprep(steps).astype(jnp.int32)
    return res


def _fold_runs_idx(tbl, runs, px, py, pz, carry):
    """(min, argmin-leaf) fold over runs of scale * prim_sd; strict < keeps
    the earliest index (reference first-wins ties, body.cpp:12-14)."""
    for (ptype, start, count, scale) in runs:
        def step(i, c, _ptype=ptype, _scale=float(scale)):
            acc, aidx = c
            sd = _scale * _prim_sd(_ptype, tbl, i, px, py, pz)
            better = sd < acc
            return (jnp.where(better, sd, acc),
                    jnp.where(better,
                              jnp.full(px.shape, 1, jnp.int32) * i,
                              aidx))
        if not isinstance(start, (int, np.integer)):
            carry = _fold_span_dynamic(step, start, count, carry)
            continue
        if count <= _UNROLL:
            for i in range(start, start + count):
                carry = step(i, carry)
            continue
        blocks = count // _UNROLL

        def body(k, c, _start=start):
            i = _start + k * _UNROLL
            for j in range(_UNROLL):
                c = step(i + j, c)
            return c

        carry = jax.lax.fori_loop(0, blocks, body, carry)
        for i in range(start + blocks * _UNROLL, start + count):
            carry = step(i, carry)
    return carry


def _prim_sd_grad(ptype, tbl, i, px, py, pz):
    """(sd, dsd/dp) of primitive ``i`` — hand-derived a.e. gradients:
    sphere: (p-c)/|p-c|; box: sign on the argmax axis (Chebyshev); cross:
    sign on the MEDIAN axis (_med3 selects it); procedural fractals
    (tuple-tagged run type): forward-mode Jacobian sweeps
    (_mandelbox_sd_grad / _mandelbulb_sd_grad)."""
    if isinstance(ptype, tuple):
        return _PROC_GRAD_KERNEL[ptype[0]](tbl, i, px, py, pz,
                                           ptype[1], ptype[2])
    cx, cy, cz = tbl[i, 0], tbl[i, 1], tbl[i, 2]
    dx, dy, dz = px - cx, py - cy, pz - cz
    if ptype == int(PrimType.SPHERE):
        r = jnp.sqrt(dx * dx + dy * dy + dz * dz)
        inv = 1.0 / jnp.maximum(r, jnp.float32(1e-30))
        return r - tbl[i, 3], dx * inv, dy * inv, dz * inv
    hx, hy, hz = tbl[i, 3] * 0.5, tbl[i, 4] * 0.5, tbl[i, 5] * 0.5
    bx = jnp.abs(dx) - hx
    by = jnp.abs(dy) - hy
    bz = jnp.abs(dz) - hz
    sx, sy, sz = jnp.sign(dx), jnp.sign(dy), jnp.sign(dz)
    mx = jnp.maximum(jnp.maximum(bx, by), bz)
    if ptype == int(PrimType.BOX):
        # one-hot on the (first) argmax axis, ties to x then y
        on_x = bx >= jnp.maximum(by, bz)
        on_y = jnp.logical_and(jnp.logical_not(on_x), by >= bz)
        gx = jnp.where(on_x, sx, 0.0)
        gy = jnp.where(on_y, sy, 0.0)
        gz = jnp.where(jnp.logical_or(on_x, on_y), 0.0, sz)
        return mx, gx, gy, gz
    sd = _med3(bx, by, bz)
    # median axis: not the argmax, not the argmin
    max_x = bx >= jnp.maximum(by, bz)
    max_y = jnp.logical_and(jnp.logical_not(max_x), by >= bz)
    min_x = bx <= jnp.minimum(by, bz)
    min_y = jnp.logical_and(jnp.logical_not(min_x), by <= bz)
    med_x = jnp.logical_not(jnp.logical_or(max_x, min_x))
    med_y = jnp.logical_not(jnp.logical_or(
        jnp.logical_or(max_y, min_y), med_x))
    med_z = jnp.logical_not(jnp.logical_or(med_x, med_y))
    gx = jnp.where(med_x, sx, 0.0)
    gy = jnp.where(med_y, sy, 0.0)
    gz = jnp.where(med_z, sz, 0.0)
    return sd, gx, gy, gz


def _fold_runs_grad(tbl, runs, px, py, pz, carry):
    """(min, winner-gradient) fold over runs of scale * prim_sd."""
    for (ptype, start, count, scale) in runs:
        def step(i, c, _ptype=ptype, _scale=float(scale)):
            acc, gx, gy, gz = c
            sd, ggx, ggy, ggz = _prim_sd_grad(_ptype, tbl, i, px, py, pz)
            sd = _scale * sd
            better = sd < acc
            return (jnp.where(better, sd, acc),
                    jnp.where(better, _scale * ggx, gx),
                    jnp.where(better, _scale * ggy, gy),
                    jnp.where(better, _scale * ggz, gz))
        if not isinstance(start, (int, np.integer)):
            carry = _fold_span_dynamic(step, start, count, carry)
            continue
        if count <= _UNROLL:
            for i in range(start, start + count):
                carry = step(i, carry)
            continue
        blocks = count // _UNROLL

        def body(k, c, _start=start):
            i = _start + k * _UNROLL
            for j in range(_UNROLL):
                c = step(i + j, c)
            return c

        carry = jax.lax.fori_loop(0, blocks, body, carry)
        for i in range(start + blocks * _UNROLL, start + count):
            carry = step(i, carry)
    return carry


def _menger_carve_grad(tbl, box_idx: int, iters: int, px, py, pz, dtype):
    """(carve, grad) for the space-folded Menger union: the folds are
    translations a.e., so the winning cross's gradient passes through."""
    cx, cy, cz = tbl[box_idx, 0], tbl[box_idx, 1], tbl[box_idx, 2]
    s = tbl[box_idx, 3]
    qx, qy, qz = px - cx, py - cy, pz - cz
    pitch = s / 3.0
    csize = s / 3.0
    carve = jnp.full(px.shape, jnp.inf, dtype)
    gx = jnp.zeros(px.shape, dtype)
    gy = jnp.zeros(px.shape, dtype)
    gz = jnp.zeros(px.shape, dtype)
    for k in range(iters):
        half = csize * 0.5
        bx = jnp.abs(qx) - half
        by = jnp.abs(qy) - half
        bz = jnp.abs(qz) - half
        sd = _med3(bx, by, bz)
        max_x = bx >= jnp.maximum(by, bz)
        max_y = jnp.logical_and(jnp.logical_not(max_x), by >= bz)
        min_x = bx <= jnp.minimum(by, bz)
        min_y = jnp.logical_and(jnp.logical_not(min_x), by <= bz)
        med_x = jnp.logical_not(jnp.logical_or(max_x, min_x))
        med_y = jnp.logical_not(jnp.logical_or(
            jnp.logical_or(max_y, min_y), med_x))
        med_z = jnp.logical_not(jnp.logical_or(med_x, med_y))
        better = sd < carve
        carve = jnp.where(better, sd, carve)
        gx = jnp.where(better, jnp.where(med_x, jnp.sign(qx), 0.0), gx)
        gy = jnp.where(better, jnp.where(med_y, jnp.sign(qy), 0.0), gy)
        gz = jnp.where(better, jnp.where(med_z, jnp.sign(qz), 0.0), gz)
        if k + 1 < iters:
            def fold(q, _p=pitch):
                cell = _round_clip1(q / _p)
                return q - cell * _p
            qx, qy, qz = fold(qx), fold(qy), fold(qz)
            pitch = pitch / 3.0
            csize = csize / 3.0
    return carve, gx, gy, gz


def _med3_grad_axes(a, b, c):
    """One-hot median-axis masks for ``_med3(a, b, c)`` — (med_a, med_b,
    med_c): the median is not the argmax and not the argmin, ties broken
    toward earlier arguments (same chain as _prim_sd_grad's cross case)."""
    max_a = a >= jnp.maximum(b, c)
    max_b = jnp.logical_and(jnp.logical_not(max_a), b >= c)
    min_a = a <= jnp.minimum(b, c)
    min_b = jnp.logical_and(jnp.logical_not(min_a), b <= c)
    med_a = jnp.logical_not(jnp.logical_or(max_a, min_a))
    med_b = jnp.logical_not(jnp.logical_or(
        jnp.logical_or(max_b, min_b), med_a))
    med_c = jnp.logical_not(jnp.logical_or(med_a, med_b))
    return med_a, med_b, med_c


def _menger_carve_lattice_grad(tbl, g, px, py, pz):
    """(carve, winner dsd/dp) for the collapsed-lattice Menger carve —
    the gradient twin of _menger_carve_lattice.  Values follow the exact
    same min/med3 op order (bitwise-identical carve); gradients ride the
    fold as one-hot axis signs selected by the same comparisons: each
    per-axis excess ``b = |p - c| - h`` contributes ``sign(p - c)`` on its
    own axis, column mins and the cross-median pick a winner, levels fold
    by running min.  ~3x the value collapse's ops — still ~6x cheaper
    than the 20^k-cross full gradient fold it replaces."""
    best = bgx = bgy = bgz = None
    for level in g.lattice:
        if len(level) == 1:             # level-0: a single cross
            sd, gx, gy, gz = _prim_sd_grad(int(PrimType.CROSS), tbl,
                                           level[0], px, py, pz)
        else:
            xs_reps, ys_reps, zs_reps, size_rep, columns, _members = level
            hx = tbl[size_rep, 3] * 0.5
            hy = tbl[size_rep, 4] * 0.5
            hz = tbl[size_rep, 5] * 0.5
            dxs = [px - tbl[r, 0] for r in xs_reps]
            dys = [py - tbl[r, 1] for r in ys_reps]
            dzs = [pz - tbl[r, 2] for r in zs_reps]
            bx = [jnp.abs(d) - hx for d in dxs]
            by = [jnp.abs(d) - hy for d in dys]
            bz = [jnp.abs(d) - hz for d in dzs]
            sx = [jnp.sign(d) for d in dxs]
            sy = [jnp.sign(d) for d in dys]
            sz = [jnp.sign(d) for d in dzs]
            sd = gx = gy = gz = None
            for (iy, iz, ixs, _rows) in columns:
                a, ga = bx[ixs[0]], sx[ixs[0]]
                for ix in ixs[1:]:
                    take = bx[ix] < a
                    ga = jnp.where(take, sx[ix], ga)
                    a = jnp.minimum(a, bx[ix])
                med = _med3(a, by[iy], bz[iz])
                med_a, med_b, med_c = _med3_grad_axes(a, by[iy], bz[iz])
                mgx = jnp.where(med_a, ga, 0.0)
                mgy = jnp.where(med_b, sy[iy], 0.0)
                mgz = jnp.where(med_c, sz[iz], 0.0)
                if sd is None:
                    sd, gx, gy, gz = med, mgx, mgy, mgz
                else:
                    take = med < sd
                    gx = jnp.where(take, mgx, gx)
                    gy = jnp.where(take, mgy, gy)
                    gz = jnp.where(take, mgz, gz)
                    sd = jnp.minimum(sd, med)
        if best is None:
            best, bgx, bgy, bgz = sd, gx, gy, gz
        else:
            take = sd < best
            bgx = jnp.where(take, gx, bgx)
            bgy = jnp.where(take, gy, bgy)
            bgz = jnp.where(take, gz, bgz)
            best = jnp.minimum(best, sd)
    return best, bgx, bgy, bgz


def _menger_carve_lattice_idx_grad(tbl, g, px, py, pz):
    """(carve, winner row, winner dsd/dp) for the collapsed-lattice Menger
    carve — _menger_carve_lattice_grad with the winning cross's TABLE ROW
    carried through the fold (columns store member rows parallel to their
    ix lists).  Values stay bitwise-identical to the full fold; the row
    lets the single-launch backward's theta algebra run on lattice groups
    instead of falling back to the 421-cross plain fold.

    Tie note: within a column, the x-min fold keeps first-wins ties in
    LEAF order (member order is DFS); ACROSS columns/levels the fold
    visits sorted-column order, so on coincident-arm tie REGIONS the
    reported winner may be a different member of the same tie class than
    the plain fold's.  Tied leaves have identical fields and identical
    per-parameter formulas, so every cotangent sum per tie class — and
    the resulting optimizer step — is unchanged (ops/scene_vjp module
    note); tests compare winners off the tie set only."""
    best = bgx = bgy = bgz = bidx = None
    for level in g.lattice:
        if len(level) == 1:             # level-0: a single cross
            sd, gx, gy, gz = _prim_sd_grad(int(PrimType.CROSS), tbl,
                                           level[0], px, py, pz)
            idx = jnp.full(px.shape, level[0], jnp.int32)
        else:
            xs_reps, ys_reps, zs_reps, size_rep, columns, _members = level
            hx = tbl[size_rep, 3] * 0.5
            hy = tbl[size_rep, 4] * 0.5
            hz = tbl[size_rep, 5] * 0.5
            dxs = [px - tbl[r, 0] for r in xs_reps]
            dys = [py - tbl[r, 1] for r in ys_reps]
            dzs = [pz - tbl[r, 2] for r in zs_reps]
            bx = [jnp.abs(d) - hx for d in dxs]
            by = [jnp.abs(d) - hy for d in dys]
            bz = [jnp.abs(d) - hz for d in dzs]
            sx = [jnp.sign(d) for d in dxs]
            sy = [jnp.sign(d) for d in dys]
            sz = [jnp.sign(d) for d in dzs]
            sd = gx = gy = gz = idx = None
            for (iy, iz, ixs, rows) in columns:
                a, ga = bx[ixs[0]], sx[ixs[0]]
                ra = jnp.full(px.shape, rows[0], jnp.int32)
                for ix, row in zip(ixs[1:], rows[1:]):
                    take = bx[ix] < a
                    ga = jnp.where(take, sx[ix], ga)
                    ra = jnp.where(take,
                                   jnp.full(px.shape, row, jnp.int32), ra)
                    a = jnp.minimum(a, bx[ix])
                med = _med3(a, by[iy], bz[iz])
                med_a, med_b, med_c = _med3_grad_axes(a, by[iy], bz[iz])
                mgx = jnp.where(med_a, ga, 0.0)
                mgy = jnp.where(med_b, sy[iy], 0.0)
                mgz = jnp.where(med_c, sz[iz], 0.0)
                if sd is None:
                    sd, gx, gy, gz, idx = med, mgx, mgy, mgz, ra
                else:
                    take = med < sd
                    gx = jnp.where(take, mgx, gx)
                    gy = jnp.where(take, mgy, gy)
                    gz = jnp.where(take, mgz, gz)
                    idx = jnp.where(take, ra, idx)
                    sd = jnp.minimum(sd, med)
        if best is None:
            best, bgx, bgy, bgz, bidx = sd, gx, gy, gz, idx
        else:
            take = sd < best
            bgx = jnp.where(take, gx, bgx)
            bgy = jnp.where(take, gy, bgy)
            bgz = jnp.where(take, gz, bgz)
            bidx = jnp.where(take, idx, bidx)
            best = jnp.minimum(best, sd)
    return best, bidx, bgx, bgy, bgz


def _scene_sd_grad_tile(kp: KernelPlan, tbl, px, py, pz, dtype,
                        fused=False):
    """(scene sd, analytic dsd/dp): the winner's gradient through every
    fold.  One evaluation instead of six FD evaluations — the 'analytic'
    normal mode of the fused render kernel (the jnp analogue is
    core.shading.normal_analytic).

    Rides the same cost structure as the value fold (_scene_sd_tile):
    lattice groups take the collapsed-lattice gradient when the flag row
    proves the live tables still share coordinates (full gradient fold
    otherwise), and large exact DIFFERENCE groups are skipped under the
    identical per-tile base-bound proof — a culled group loses the
    strict-< root fold, so neither the value nor the winner's gradient
    can change."""
    if isinstance(kp, ScenePlan):
        return _scene_generic_tile(kp, tbl, px, py, pz, dtype,
                                   with_idx=False, with_grad=True)
    inf = jnp.full(px.shape, jnp.inf, dtype)
    zero = jnp.zeros(px.shape, dtype)
    rsign = 1.0 if kp.root_op == MIN else -1.0
    running, rgx, rgy, rgz = inf, zero, zero, zero

    def root_update(state, gval, ggx, ggy, ggz):
        running, rgx, rgy, rgz = state
        v = rsign * gval
        better = v < running
        return (jnp.where(better, v, running),
                jnp.where(better, ggx, rgx),
                jnp.where(better, ggy, rgy),
                jnp.where(better, ggz, rgz))

    init4 = (inf, zero, zero, zero)
    state = (running, rgx, rgy, rgz)
    for g in kp.groups:
        neg_runs = [r for r in g.runs if r[3] == -1]
        pos_runs = [r for r in g.runs if r[3] == 1]
        use_fused = fused and g.fused is not None
        use_lattice = _lattice_idx_ok(g) and not use_fused
        diff_group = g.gsign == -1 and rsign == 1.0 and bool(neg_runs)
        cullable = (diff_group and g.count >= _CULL_MIN_GROUP
                    and not use_fused
                    and (_CULL_LATTICE or not use_lattice))
        if use_fused:
            box_sd, bgx, bgy, bgz = _prim_sd_grad(
                _FUSED_BASE_TYPE[g.fused[0]], tbl, g.start, px, py, pz)
            carve, cgx, cgy, cgz = _fused_carve_grad(g, tbl, px, py, pz,
                                                     dtype)
            better = box_sd >= -carve    # gval = max(base, -carve)
            gval = jnp.maximum(box_sd, -carve)
            ggx = jnp.where(better, bgx, -cgx)
            ggy = jnp.where(better, bgy, -cgy)
            ggz = jnp.where(better, bgz, -cgz)
            state = root_update(state, gval, ggx, ggy, ggz)
        elif diff_group and use_lattice:
            bmin, bgx, bgy, bgz = _fold_runs_grad(
                tbl, neg_runs, px, py, pz, init4)

            def lattice_grad(_, _g=g, _runs=tuple(pos_runs)):
                return jax.lax.cond(
                    tbl[_flag_row(kp), 0] > 0.5,
                    lambda __: _menger_carve_lattice_grad(tbl, _g,
                                                          px, py, pz),
                    lambda __: _fold_runs_grad(tbl, _runs, px, py, pz,
                                               init4),
                    0)

            if cullable:
                lb = -bmin           # = max over base sd <= group value

                def with_rest(s, _b=(bmin, bgx, bgy, bgz),
                              _lat=lattice_grad):
                    carve, cgx, cgy, cgz = _lat(0)
                    take_base = _b[0] <= carve   # gval = -min(base, carve)
                    gval = -jnp.minimum(_b[0], carve)
                    return root_update(
                        s, gval,
                        -jnp.where(take_base, _b[1], cgx),
                        -jnp.where(take_base, _b[2], cgy),
                        -jnp.where(take_base, _b[3], cgz))

                skip = _all_lanes(lb >= state[0])
                state = jax.lax.cond(skip, lambda s: s, with_rest, state)
            else:
                carve, cgx, cgy, cgz = lattice_grad(0)
                take_base = bmin <= carve
                gval = -jnp.minimum(bmin, carve)
                state = root_update(
                    state, gval,
                    -jnp.where(take_base, bgx, cgx),
                    -jnp.where(take_base, bgy, cgy),
                    -jnp.where(take_base, bgz, cgz))
        elif cullable:
            gmin_base = _fold_runs(tbl, neg_runs, px, py, pz, inf)
            lb = -gmin_base

            if _use_subtree(g):
                def with_group(s, _g=g, _neg=tuple(neg_runs),
                               _pos=tuple(pos_runs)):
                    c = _fold_runs_grad(tbl, _neg, px, py, pz, init4)
                    c = _subtree_carve_fold(
                        kp, tbl, _g, px, py, pz, c,
                        lambda runs, cc: _fold_runs_grad(tbl, runs, px,
                                                         py, pz, cc),
                        lambda cc: cc[0], _pos)
                    gmin, ggx, ggy, ggz = c
                    return root_update(s, -gmin, -ggx, -ggy, -ggz)
            else:
                def with_group(s, _runs=tuple(g.runs)):
                    gmin, ggx, ggy, ggz = _fold_runs_grad(
                        tbl, _runs, px, py, pz, init4)
                    return root_update(s, -gmin, -ggx, -ggy, -ggz)

            skip = _all_lanes(lb >= state[0])
            state = jax.lax.cond(skip, lambda s: s, with_group, state)
        elif g.bvh is not None:
            # wide-UNION chunk cull (gsign +1, MIN root): direct fold into
            # the root carry preserves the strict-< winner selections
            state = _bvh_group_fold(
                kp, g, tbl, px, py, pz, state,
                lambda runs, s: _fold_runs_grad(tbl, runs, px, py, pz, s),
                lambda s: s[0])
        else:
            gmin, ggx, ggy, ggz = _fold_runs_grad(
                tbl, g.runs, px, py, pz, init4)
            gs = float(g.gsign)
            state = root_update(state, gs * gmin, gs * ggx, gs * ggy,
                                gs * ggz)
    running, rgx, rgy, rgz = state
    # sd = rsign * min_i(rsign * gval_i): the rsign factors cancel in the
    # chain rule, so the winner's stored gval-gradient is returned as-is.
    return rsign * running, rgx, rgy, rgz


def _fold_runs_idx_grad(tbl, runs, px, py, pz, carry):
    """(min, argmin-leaf, winner dsd/dp) fold over runs of scale * prim_sd.
    Strict < keeps the earliest index (first-wins ties, body.cpp:12-14);
    winner selection is identical to _fold_runs_idx / _fold_runs_grad."""
    for (ptype, start, count, scale) in runs:
        def step(i, c, _ptype=ptype, _scale=float(scale)):
            acc, aidx, gx, gy, gz = c
            sd, ggx, ggy, ggz = _prim_sd_grad(_ptype, tbl, i, px, py, pz)
            sd = _scale * sd
            better = sd < acc
            return (jnp.where(better, sd, acc),
                    jnp.where(better,
                              jnp.full(px.shape, 1, jnp.int32) * i, aidx),
                    jnp.where(better, _scale * ggx, gx),
                    jnp.where(better, _scale * ggy, gy),
                    jnp.where(better, _scale * ggz, gz))
        if not isinstance(start, (int, np.integer)):
            carry = _fold_span_dynamic(step, start, count, carry)
            continue
        if count <= _UNROLL:
            for i in range(start, start + count):
                carry = step(i, carry)
            continue
        blocks = count // _UNROLL

        def body(k, c, _start=start):
            i = _start + k * _UNROLL
            for j in range(_UNROLL):
                c = step(i + j, c)
            return c

        carry = jax.lax.fori_loop(0, blocks, body, carry)
        for i in range(start + blocks * _UNROLL, start + count):
            carry = step(i, carry)
    return carry


def _scene_sd_idx_grad_tile(kp: KernelPlan, tbl, px, py, pz, dtype,
                            fused=False):
    """Scene SDF + winning leaf index + the winner's dsd/dp in ONE fold
    pass, with the same exact per-tile base-bound cull as _scene_sd_tile.

    This is the backward-pass workhorse (ops.scene_vjp): given (idx, grad)
    per ray, cotangents to every primitive parameter are a per-lane
    formula + segment-sum OUTSIDE the kernel — the [rays, prims] leaf
    matrix is never materialized anywhere in the backward.

    With ``fused`` on, generator groups evaluate base + derived carve
    (same values as _scene_sd_tile fused mode); a carve win reports the
    EXTENDED winner id ``_flag_row(kp) + ordinal`` (ordinal = position of
    the group among fused groups, plan order) so the host backward can
    apply the carve's own theta algebra (translation + homogeneity;
    scene_vjp._fused_statics maps extended ids back to base rows)."""
    if isinstance(kp, ScenePlan):
        return _scene_generic_tile(kp, tbl, px, py, pz, dtype,
                                   with_idx=True, with_grad=True)
    inf = jnp.full(px.shape, jnp.inf, dtype)
    zero = jnp.zeros(px.shape, dtype)
    rsign = 1.0 if kp.root_op == MIN else -1.0
    ext_base = _flag_row(kp)
    fused_ordinal = 0
    state = (inf, jnp.full(px.shape, -1, jnp.int32), zero, zero, zero)

    def root_update(state, gsign, carry):
        running, ridx, rgx, rgy, rgz = state
        gmin, gidx, ggx, ggy, ggz = carry
        gs = float(gsign)
        v = rsign * gs * gmin
        better = v < running
        # rsign cancels in the chain rule (sd = rsign * min of rsign*gval),
        # so the winner's gval-gradient is stored with gsign only.
        return (jnp.where(better, v, running),
                jnp.where(better, gidx, ridx),
                jnp.where(better, gs * ggx, rgx),
                jnp.where(better, gs * ggy, rgy),
                jnp.where(better, gs * ggz, rgz))

    init = (inf, jnp.full(px.shape, -1, jnp.int32), zero, zero, zero)
    for g in kp.groups:
        neg_runs = [r for r in g.runs if r[3] == -1]
        pos_runs = [r for r in g.runs if r[3] == 1]
        use_fused = fused and g.fused is not None
        cullable = (g.gsign == -1 and rsign == 1.0 and neg_runs
                    and g.count >= _CULL_MIN_GROUP and not use_fused)
        if use_fused:
            ext_id = ext_base + fused_ordinal
            fused_ordinal += 1
            bt = _FUSED_BASE_TYPE[g.fused[0]]
            base_sd, bgx, bgy, bgz = _prim_sd_grad(bt, tbl, g.start,
                                                   px, py, pz)
            carve, cgx, cgy, cgz = _fused_carve_grad(g, tbl, px, py, pz,
                                                     dtype)
            # group val = max(base, -carve); base (the earlier leaf) wins
            # ties, matching the strict-< exact fold
            take_base = base_sd >= -carve
            gval = jnp.maximum(base_sd, -carve)
            carry = (gval,
                     jnp.where(take_base,
                               jnp.full(px.shape, g.start, jnp.int32),
                               jnp.full(px.shape, ext_id, jnp.int32)),
                     jnp.where(take_base, bgx, -cgx),
                     jnp.where(take_base, bgy, -cgy),
                     jnp.where(take_base, bgz, -cgz))
            state = root_update(state, 1, carry)
        elif cullable:
            gmin_base = _fold_runs(tbl, neg_runs, px, py, pz, inf)
            lb = -gmin_base

            if _use_subtree(g):
                def with_group(s, _g=g, _neg=tuple(neg_runs),
                               _pos=tuple(pos_runs)):
                    carry = _fold_runs_idx_grad(tbl, _neg, px, py, pz,
                                                init)
                    carry = _subtree_carve_fold(
                        kp, tbl, _g, px, py, pz, carry,
                        lambda runs, c: _fold_runs_idx_grad(
                            tbl, runs, px, py, pz, c),
                        lambda c: c[0], _pos)
                    return root_update(s, -1, carry)
            elif _lattice_idx_ok(g):
                # collapsed-lattice carve with winner rows — the backward
                # stencil's dominant fold drops from 20^k cross
                # evaluations to the column collapse (~3.5x fewer ops);
                # flag-row-gated exactly like the value fold.  Big
                # lattices (iters>=4) take the _use_subtree branch above
                # instead (see _lattice_idx_ok)
                def with_group(s, _g=g, _neg=tuple(neg_runs),
                               _pos=tuple(pos_runs)):
                    bmin, bidx, bgx, bgy, bgz = _fold_runs_idx_grad(
                        tbl, _neg, px, py, pz, init)
                    carve = jax.lax.cond(
                        tbl[_flag_row(kp), 0] > 0.5,
                        lambda _: _menger_carve_lattice_idx_grad(
                            tbl, _g, px, py, pz),
                        lambda _: _fold_runs_idx_grad(tbl, _pos, px, py,
                                                      pz, init),
                        0)
                    cm, cidx, cgx, cgy, cgz = carve
                    tb = bmin <= cm      # base leaf is earlier: wins ties
                    carry = (jnp.minimum(bmin, cm),
                             jnp.where(tb, bidx, cidx),
                             jnp.where(tb, bgx, cgx),
                             jnp.where(tb, bgy, cgy),
                             jnp.where(tb, bgz, cgz))
                    return root_update(s, -1, carry)
            else:
                def with_group(s, _runs=g.runs):
                    carry = _fold_runs_idx_grad(tbl, _runs, px, py, pz,
                                                init)
                    return root_update(s, -1, carry)

            skip = _all_lanes(lb >= state[0])
            state = jax.lax.cond(skip, lambda s: s, with_group, state)
        elif g.bvh is not None:
            # wide-UNION chunk cull (gsign +1, MIN root): direct fold into
            # the root carry preserves the strict-< winner selections
            state = _bvh_group_fold(
                kp, g, tbl, px, py, pz, state,
                lambda runs, s: _fold_runs_idx_grad(tbl, runs, px, py,
                                                    pz, s),
                lambda s: s[0])
        else:
            carry = _fold_runs_idx_grad(tbl, g.runs, px, py, pz, init)
            state = root_update(state, g.gsign, carry)
    running, ridx, rgx, rgy, rgz = state
    return rsign * running, ridx, rgx, rgy, rgz


def _scene_sd_idx_tile(kp: KernelPlan, tbl, px, py, pz, dtype, fused=False):
    """Scene SDF + winning leaf index, with the same exact per-tile
    base-bound cull as _scene_sd_tile (a culled group provably loses the
    strict-< root fold, so neither value nor winner can change).  Fused
    generator groups report their base primitive as the winner (every leaf
    of a generator shares one color, body.cpp:149-169)."""
    if isinstance(kp, ScenePlan):
        sd, idx = _scene_generic_tile(kp, tbl, px, py, pz, dtype,
                                      with_idx=True, with_grad=False)
        return sd, idx
    inf = jnp.full(px.shape, jnp.inf, dtype)
    rsign = 1.0 if kp.root_op == MIN else -1.0
    running = inf
    ridx = jnp.full(px.shape, -1, jnp.int32)

    def root_update(running, ridx, gval, gidx):
        v = rsign * gval
        better = v < running
        return (jnp.where(better, v, running),
                jnp.where(better, gidx, ridx))

    for g in kp.groups:
        neg_runs = [r for r in g.runs if r[3] == -1]
        pos_runs = [r for r in g.runs if r[3] == 1]
        use_fused = fused and g.fused is not None
        cullable = (g.gsign == -1 and rsign == 1.0 and neg_runs
                    and (g.count >= _CULL_MIN_GROUP or use_fused)
                    and (_CULL_FUSED or not use_fused))
        if use_fused and not cullable:
            gmin_base = _fold_runs(tbl, neg_runs, px, py, pz, inf)
            carve = _fused_carve(g, tbl, px, py, pz, dtype)
            running, ridx = root_update(
                running, ridx, -jnp.minimum(gmin_base, carve),
                jnp.full(px.shape, g.start, jnp.int32))
        elif cullable:
            gmin_base = _fold_runs(tbl, neg_runs, px, py, pz, inf)
            lb = -gmin_base

            if use_fused:
                def with_group(carry, _base=gmin_base, _g=g):
                    r, ri = carry
                    carve = _fused_carve(_g, tbl, px, py, pz, dtype)
                    gval = -jnp.minimum(_base, carve)
                    gidx = jnp.full(px.shape, _g.start, jnp.int32)
                    return root_update(r, ri, gval, gidx)
            elif _use_subtree(g):
                def with_group(carry, _g=g, _neg=tuple(neg_runs),
                               _pos=tuple(pos_runs)):
                    r, ri = carry
                    c = _fold_runs_idx(
                        tbl, _neg, px, py, pz,
                        (inf, jnp.full(px.shape, -1, jnp.int32)))
                    c = _subtree_carve_fold(
                        kp, tbl, _g, px, py, pz, c,
                        lambda runs, cc: _fold_runs_idx(tbl, runs, px, py,
                                                        pz, cc),
                        lambda cc: cc[0], _pos)
                    return root_update(r, ri, float(-1) * c[0], c[1])
            else:
                def with_group(carry, _runs=g.runs):
                    r, ri = carry
                    gmin, gidx = _fold_runs_idx(
                        tbl, _runs, px, py, pz,
                        (inf, jnp.full(px.shape, -1, jnp.int32)))
                    return root_update(r, ri, float(-1) * gmin, gidx)

            skip = _all_lanes(lb >= running)
            running, ridx = jax.lax.cond(skip, lambda c: c, with_group,
                                         (running, ridx))
        elif g.bvh is not None:
            # wide-UNION chunk cull: fold straight into the root carry —
            # strict-< per prim keeps first-wins ties, and a skipped
            # chunk provably cannot win (see _bvh_group_fold)
            running, ridx = _bvh_group_fold(
                kp, g, tbl, px, py, pz, (running, ridx),
                lambda runs, c: _fold_runs_idx(tbl, runs, px, py, pz, c),
                lambda c: c[0])
        else:
            gmin, gidx = _fold_runs_idx(
                tbl, g.runs, px, py, pz,
                (inf, jnp.full(px.shape, -1, jnp.int32)))
            running, ridx = root_update(running, ridx,
                                        float(g.gsign) * gmin, gidx)
    return rsign * running, ridx


def _surface_kernel(kp: KernelPlan, fd_h: float, with_color: bool,
                    with_normal: bool, fused: bool, analytic: bool,
                    tbl_ref, px_ref, py_ref, pz_ref, *out_refs):
    """Point-evaluation kernel: scene SD (+ color index, + gradient).

    Gradient modes: central differences with 6 extra evals (mirroring
    scene::grad, scene.cpp:70-89 — the parity default) or the hand-derived
    analytic winner gradient (one eval)."""
    dtype = px_ref.dtype
    px, py, pz = px_ref[...], py_ref[...], pz_ref[...]
    outs = list(out_refs)
    sd_ref = outs.pop(0)
    if with_color and with_normal and analytic:
        # Combined backward-pass mode: sd + winner index + winner gradient
        # in ONE fold pass (ops.scene_vjp builds all parameter cotangents
        # from these outside the kernel).  With ``fused`` the winner id
        # may be an EXTENDED carve id — see _scene_sd_idx_grad_tile.
        sd, idx, gx, gy, gz = _scene_sd_idx_grad_tile(kp, tbl_ref,
                                                      px, py, pz, dtype,
                                                      fused=fused)
        sd_ref[...] = sd
        outs.pop(0)[...] = idx
        outs.pop(0)[...] = gx
        outs.pop(0)[...] = gy
        outs.pop(0)[...] = gz
        return
    if with_color:
        sd, idx = _scene_sd_idx_tile(kp, tbl_ref, px, py, pz, dtype,
                                     fused=fused)
        outs.pop(0)[...] = idx
    else:
        sd = _scene_sd_tile(kp, tbl_ref, px, py, pz, dtype, fused=fused)
    sd_ref[...] = sd
    if with_normal and analytic:
        _, gx, gy, gz = _scene_sd_grad_tile(kp, tbl_ref, px, py, pz, dtype,
                                            fused=fused)
        outs.pop(0)[...] = gx
        outs.pop(0)[...] = gy
        outs.pop(0)[...] = gz
    elif with_normal:
        h = jnp.array(fd_h, dtype)
        ev = lambda a, b, c: _scene_sd_tile(kp, tbl_ref, a, b, c, dtype,
                                            fused=fused)
        gx = ev(px + h, py, pz) - ev(px - h, py, pz)
        gy = ev(px, py + h, pz) - ev(px, py - h, pz)
        gz = ev(px, py, pz + h) - ev(px, py, pz - h)
        inv = 1.0 / (2.0 * fd_h)
        outs.pop(0)[...] = gx * inv
        outs.pop(0)[...] = gy * inv
        outs.pop(0)[...] = gz * inv


@functools.lru_cache(maxsize=64)
def _compiled_surface_call(kp: KernelPlan, fd_h: float, with_color: bool,
                           with_normal: bool, fused: bool, analytic: bool,
                           ray_block: int, num_blocks: int,
                           interpret: bool):
    f32 = jax.ShapeDtypeStruct((num_blocks * ray_block,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((num_blocks * ray_block,), jnp.int32)
    out_shape = [f32]
    if with_color:
        out_shape.append(i32)
    if with_normal:
        out_shape += [f32, f32, f32]
    kernel = functools.partial(_surface_kernel, kp, fd_h, with_color,
                               with_normal, fused, analytic)
    return _kernel_call(kernel, num_blocks, ray_block,
                        ["any", "ray", "ray", "ray"], out_shape, interpret)


def pallas_surface_eval(kp: KernelPlan, fd_h: float, ray_block: int,
                        p: jnp.ndarray, tables: SceneTables, *,
                        with_color: bool, with_normal: bool,
                        fused: bool = False, analytic: bool = False,
                        interpret=None):
    """Evaluate the scene at points p [R, 3].

    Returns (sd [R], color_idx [R] or None, grad [R, 3] or None)."""
    R = p.shape[0]
    num_blocks, prep, unprep = _tiling(R, ray_block)
    comps = [prep(p[:, a]) for a in range(3)]
    tbl = _build_table(tables, kp)
    call = _compiled_surface_call(kp, fd_h, with_color, with_normal, fused,
                                  analytic, ray_block, num_blocks,
                                  resolve_interpret(interpret))
    outs = list(call(tbl, *comps))
    sd = unprep(outs.pop(0))
    cidx = unprep(outs.pop(0)) if with_color else None
    grad = None
    if with_normal:
        grad = jnp.stack([unprep(outs.pop(0)) for _ in range(3)], axis=-1)
    return sd, cidx, grad


def make_pallas_march(plan: ScenePlan, cfg: RenderConfig,
                      *, interpret=None) -> Callable:
    """forward_impl for ops.march_op: (origin, ray, tables) -> MarchResult.

    Depth<=2 scenes (every reference scene) compile the two-level normal
    form with culling; deeper trees compile the generic post-order
    evaluator (kernel_key) — all grammar-expressible scenes run here."""
    kp = kernel_key(plan)

    def forward_impl(origin, ray, tables):
        shape = origin.shape
        res = pallas_march(kp, cfg.iterations,
                           cfg.surface_precision, cfg.ray_block,
                           origin.reshape(-1, 3), ray.reshape(-1, 3),
                           tables, fused=cfg.fused_generators,
                           interpret=interpret)
        return MarchResult(position=res.position.reshape(shape),
                           sd=res.sd.reshape(shape[:-1]),
                           converged=res.converged.reshape(shape[:-1]))

    return forward_impl
