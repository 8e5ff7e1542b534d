"""Vectorized scene SDF evaluation (pure jax.numpy).

This is the oracle implementation of the scene distance field — the analogue
of the reference's C++ CPU path (scene.cpp:65 + body.cpp:66-111), but
re-designed struct-of-arrays: one batched evaluation of every leaf primitive
followed by a static sequence of min/max folds from the compiled
:class:`~raymarching_tpu.scene.compile.ScenePlan`.  No polymorphic dispatch,
no tree walking, no data-dependent control flow — everything vectorizes over
an arbitrary leading ray batch under XLA.

Two entry points:
  * :func:`scene_sd` — distance only (the march hot path).
  * :func:`scene_surface` — distance + color, reproducing the reference's
    left-to-right first-wins tie-break via first-occurrence argmin.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..scene.compile import (KIND_LEAF, KIND_LIST, MIN, ScenePlan,
                             SceneTables)
from ..scene.csg import PrimType

_INF = jnp.float32(jnp.inf)


def _med3(a, b, c):
    """Median of three via a min/max sorting network — see leaf_sd; the
    SAME expression runs in the Pallas kernels (pallas_march._med3) so the
    oracle and the kernels stay bit-identical."""
    return jnp.maximum(jnp.minimum(a, b),
                       jnp.minimum(jnp.maximum(a, b), c))


def mandelbox_sd(p: jnp.ndarray, c: jnp.ndarray, size: jnp.ndarray,
                 scale: float, iterations: int) -> jnp.ndarray:
    """Mandelbox distance estimate, vectorized: p [..., 3] -> [...].

    The classic box-fold / sphere-fold iteration (see scene.csg.Mandelbox
    for the formula and semantics).  ``scale``/``iterations`` are Python
    statics (the loop unrolls at trace time — no data-dependent control
    flow); ``c``/``size`` are traced table entries, so gradients flow to
    them on every autodiff path.  The sphere fold's three branches compile
    to two exactly-rounded selects: f = r2<1 ? 1/max(r2, 1/4) : 1."""
    q0 = (p - c) / size
    q = q0
    dr = jnp.ones(p.shape[:-1], p.dtype)
    for _ in range(iterations):
        q = jnp.clip(q, -1.0, 1.0) * 2.0 - q
        r2 = jnp.sum(q * q, axis=-1)
        f = jnp.where(r2 < 1.0, 1.0 / jnp.maximum(r2, 0.25), 1.0)
        q = (scale * f)[..., None] * q + q0
        dr = abs(scale) * f * dr + 1.0
    # max() floor: the iterated q can land exactly on 0 (the origin is a
    # fixed point of the fold), where sqrt's autodiff is inf — the floor
    # zeroes that cotangent (max's subgradient picks the constant branch)
    # while leaving every representable f32 value >= 1e-24 bit-identical
    # to the kernel's unguarded sqrt (ops.pallas_march._mandelbox_sd,
    # whose hand-derived Jacobian carries the same guard via rinv).
    return size * jnp.sqrt(jnp.maximum(jnp.sum(q * q, axis=-1),
                                       1e-24)) / dr


def mandelbulb_sd(p: jnp.ndarray, c: jnp.ndarray, size: jnp.ndarray,
                  power: float, iterations: int) -> jnp.ndarray:
    """Power-8 Mandelbulb distance estimate, vectorized: p [..., 3] -> [...].

    Trig-free triplex w <- w^8 + q0 with masked escape — value-identical
    to the scalar early-break oracle (scene.csg.Mandelbulb.sdf, which
    documents the algebra and the (x,z)-radius factoring).  The fixed
    trip count unrolls at trace time; escaped lanes freeze via where.

    Autodiff-safety guards (all value-neutral for live lanes, and all
    zeroing the dead branch's cotangent via min/max/clip subgradients):
      * w clipped to [-16, 16] before each step (live lanes have m <= 256
        so |w| <= 16 exactly) — keeps frozen-lane polynomials finite;
      * m floored at 1e-12 in the final log/sqrt (m = 0 only at the exact
        center);
      * the (x,z)-plane radius s floored at 1e-10 in the unit-vector
        division (pa/pb are bounded ratios; s * pa -> 0 as s -> 0; the
        relatively large floor keeps the FORWARD-MODE 1/s^2 tangent terms
        within f32 range in the kernel jet sweep, and is value-exact
        everywhere except within 1e-10 of the local y-axis).
    """
    del power                    # fixed at 8 — the polynomial collapse
    q0 = (p - c) / size
    w = q0
    m = jnp.sum(w * w, axis=-1)
    dz = jnp.ones(p.shape[:-1], p.dtype)
    for _ in range(iterations):
        esc = m > 256.0
        wc = jnp.clip(w, -16.0, 16.0)
        x, y, z = wc[..., 0], wc[..., 1], wc[..., 2]
        mq = jnp.minimum(m, 65536.0)
        # mq floored inside THIS sqrt too: at the exact center m = 0 and
        # sqrt's inf VJP meets the zero m^3 co-factor (inf*0 = NaN); for
        # m >= 1e-12 the floor is value-exact, below it m^3 underflows
        # to 0 in f32 so dz_new = 1 either way.
        dz_new = (8.0 * (mq * mq * mq) * jnp.sqrt(jnp.maximum(mq, 1e-12))
                  * dz + 1.0)
        x2, y2, z2 = x * x, y * y, z * z
        x4, y4, z4 = x2 * x2, y2 * y2, z2 * z2
        s2 = x2 + z2
        # s2 floored INSIDE the sqrt: sqrt'(0) = inf and the on-axis
        # cotangent into s is generally nonzero (yk = y*k4*k1*s), so an
        # unguarded sqrt NaNs autodiff for points exactly on the local
        # y-axis; 1e-20 keeps s consistent with the 1e-10 inv floor.
        s = jnp.sqrt(jnp.maximum(s2, 1e-20))
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
        w_new = jnp.stack([
            64.0 * yk * pa + q0[..., 0],
            -16.0 * y2 * s2 * k4 * k4 + k1 * k1 + q0[..., 1],
            -8.0 * yk * pb + q0[..., 2],
        ], axis=-1)
        m_new = jnp.sum(w_new * w_new, axis=-1)
        w = jnp.where(esc[..., None], w, w_new)
        dz = jnp.where(esc, dz, dz_new)
        m = jnp.where(esc, m, m_new)
    m = jnp.maximum(m, 1e-12)
    return size * 0.25 * jnp.log(m) * jnp.sqrt(m) / dz


def julia_sd(p: jnp.ndarray, c: jnp.ndarray, size: jnp.ndarray,
             const, iterations: int) -> jnp.ndarray:
    """Quaternion z^2 + c Julia distance estimate: p [..., 3] -> [...].

    ``const`` is the structural 4-tuple Julia constant (see
    scene.csg.Julia for the algebra and the DE).  Masked escape (bailout
    16), same guard pattern as mandelbulb_sd: live lanes satisfy m <= 16
    so the [-8, 8] clip is value-exact, the min(m, 4096) keeps frozen-lane
    md factors finite, and the sqrt/log floors zero dead-branch
    cotangents at the center fixed point."""
    ca, cb, cc, cd = (float(v) for v in const)
    q0 = (p - c) / size
    a, b, c_, d = (q0[..., 0], q0[..., 1], q0[..., 2],
                   jnp.zeros(p.shape[:-1], p.dtype))
    m = a * a + b * b + c_ * c_ + d * d
    md = jnp.ones(p.shape[:-1], p.dtype)
    for _ in range(iterations):
        esc = m > 16.0
        mq = jnp.minimum(m, 4096.0)
        md_new = 2.0 * jnp.sqrt(jnp.maximum(mq, 1e-12)) * md
        ax = jnp.clip(a, -8.0, 8.0)
        bx = jnp.clip(b, -8.0, 8.0)
        cx = jnp.clip(c_, -8.0, 8.0)
        dx = jnp.clip(d, -8.0, 8.0)
        na = ax * ax - bx * bx - cx * cx - dx * dx + ca
        nb = 2.0 * ax * bx + cb
        nc = 2.0 * ax * cx + cc
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


_PROC_SD = {"mb": mandelbox_sd, "bulb": mandelbulb_sd, "julia": julia_sd}


def leaf_sd(plan: ScenePlan, tables: SceneTables, p: jnp.ndarray) -> jnp.ndarray:
    """Signed distances of every leaf primitive.

    p: [..., 3] query points -> [..., P].

    Formulas (body.cpp:32-57):
      sphere: |c - p| - r
      box:    max_axis(|p - c| - s/2)
      cross:  median_axis(b), b = |p - c| - s/2 — computed as the min/max
              sorting network median3(b) rather than the reference's
              ``sum(b) - min(b) - max(b)``: mathematically identical, but
              built only from exactly-rounded min/max ops so it is cheaper
              AND exactly monotone per argument in f32, which the
              collapsed-lattice Menger fold's bitwise-equality proof needs
              (ops.pallas_march._menger_carve_lattice).  Deviation from
              the C++ sum form is ulp-scale rounding only.
    """
    d = p[..., None, :] - tables.prim_pos          # [..., P, 3]
    b = jnp.abs(d) - tables.prim_aux * 0.5         # [..., P, 3]
    box = jnp.max(b, axis=-1)
    cross = _med3(b[..., 0], b[..., 1], b[..., 2])
    # max() floor (value-neutral for every f32 >= 1e-24, see mandelbox_sd):
    # at p exactly on a prim position sqrt's VJP is inf, and the type-mask
    # select turns 0 * inf into NaN for every OTHER prim's gradient — the
    # dense formula runs for all columns, so one coincident point poisons
    # the whole cotangent.  Reachable in practice: the Mandelbox fold's
    # fixed point IS its position, and axis-aligned rays land there.
    sphere = (jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=-1), 1e-24))
              - tables.prim_aux[..., 0])

    t = np.asarray(plan.prim_type, np.int32)       # static per-scene
    sd = jnp.where(t == int(PrimType.SPHERE), sphere,
                   jnp.where(t == int(PrimType.BOX), box, cross))
    # Procedural fractal leaves (extension): few per scene, each its own
    # static column write — the dense per-type formulas above don't apply.
    for (i, kind, param, iters) in plan.proc:
        sd = sd.at[..., i].set(_PROC_SD[kind](
            p, tables.prim_pos[i], tables.prim_aux[i, 0], param, iters))
    return sd


_RUN = 2  # coalesced contiguous leaf run


@functools.lru_cache(maxsize=None)
def _coalesced_entries(lp):
    """Merge consecutive same-negation leaf entries into (RUN, start, count,
    neg) items — a 422-child Menger list becomes two sliced reductions
    instead of 422 stacked scalars.  Tie-break order is preserved: within-run
    argmin picks the first occurrence and items fold left-to-right."""
    items = []
    for kind, idx, neg in lp.entries:
        if (kind == KIND_LEAF and items and items[-1][0] == _RUN
                and items[-1][3] == neg
                and items[-1][1] + items[-1][2] == idx):
            items[-1] = (_RUN, items[-1][1], items[-1][2] + 1, neg)
        elif kind == KIND_LEAF:
            items.append((_RUN, idx, 1, neg))
        else:
            items.append((KIND_LIST, idx, 0, neg))
    return tuple(items)


def _fold_values(plan: ScenePlan, leaf: jnp.ndarray, with_color: bool):
    """Run the static post-order fold.  leaf: [..., P].

    Returns (sd, color_idx) where color_idx is int32 leaf index (-1 = none,
    i.e. the empty-list black color, body.cpp:67-70) — or (sd, None) when
    with_color is False.
    """
    batch = leaf.shape[:-1]
    results = []
    for lp in plan.lists:
        if not lp.entries:
            sd = jnp.full(batch, _INF, leaf.dtype)
            ci = jnp.full(batch, -1, jnp.int32) if with_color else None
            results.append((sd, ci))
            continue
        vals = []
        idxs = []
        for item in _coalesced_entries(lp):
            kind, idx, count, neg = item
            if kind == _RUN:
                seg = leaf[..., idx:idx + count]
                if neg:
                    seg = -seg
                if count == 1:
                    v = seg[..., 0]
                    ci = (jnp.full(batch, idx, jnp.int32)
                          if with_color else None)
                elif with_color:
                    # First-occurrence argmin/argmax == the reference's left
                    # fold with first-operand-wins ties (body.cpp:12-14).
                    k = (jnp.argmin(seg, -1) if lp.op == MIN
                         else jnp.argmax(seg, -1))
                    v = jnp.take_along_axis(seg, k[..., None], -1)[..., 0]
                    ci = (k + idx).astype(jnp.int32)
                else:
                    v = (jnp.min(seg, -1) if lp.op == MIN
                         else jnp.max(seg, -1))
                    ci = None
            else:
                v, ci = results[idx]
                if neg:
                    v = -v
            vals.append(v)
            if with_color:
                idxs.append(ci)
        if len(vals) == 1:
            results.append((vals[0], idxs[0] if with_color else None))
            continue
        stack = jnp.stack(vals, axis=-1)           # [..., I]
        if with_color:
            k = jnp.argmin(stack, -1) if lp.op == MIN else jnp.argmax(stack, -1)
            sd = jnp.take_along_axis(stack, k[..., None], -1)[..., 0]
            istack = jnp.stack(idxs, axis=-1)
            ci = jnp.take_along_axis(istack, k[..., None], -1)[..., 0]
        else:
            sd = jnp.min(stack, -1) if lp.op == MIN else jnp.max(stack, -1)
            ci = None
        results.append((sd, ci))
    return results[-1]


def scene_sd(plan: ScenePlan, tables: SceneTables, p: jnp.ndarray) -> jnp.ndarray:
    """Scene signed distance at p [..., 3] -> [...]."""
    leaf = leaf_sd(plan, tables, p)
    sd, _ = _fold_values(plan, leaf, with_color=False)
    return sd


def scene_surface(plan: ScenePlan, tables: SceneTables, p: jnp.ndarray):
    """Scene signed distance and surface color at p: ([...], [..., 3])."""
    leaf = leaf_sd(plan, tables, p)
    sd, ci = _fold_values(plan, leaf, with_color=True)
    return sd, take_rows(jnp.asarray(tables.prim_color), ci)


# Rays per block of segment_sum_rows' first level.  XLA:GPU's scatter-add
# accumulates a row's updates one after another in f32, so a row that most
# rays hit (a Bounds wall) drifts with the ray count: 1.9e-3 relative at 1M
# rays on an H100 (PERF.md).  Summing per block first bounds each chain.
_SUM_BLOCK = 256
# Cap on the [blocks, P, C] partial sums (elements); past it blocks grow.
_SUM_PARTIALS = 1 << 24


def segment_sum_rows(idx: jnp.ndarray, vals: jnp.ndarray,
                     P: int) -> jnp.ndarray:
    """Sum of ``vals`` [R, C] rows per ``idx`` [R] in [0, P) -> [P, C];
    other ids drop.  Two levels: a scatter-add per block of rays, then a
    reduction over the blocks."""
    R, C = vals.shape
    nb = max(1, min(-(-R // _SUM_BLOCK), _SUM_PARTIALS // max(P * C, 1)))
    block = -(-R // nb)
    pad = nb * block - R
    idx = jnp.where((idx >= 0) & (idx < P), idx, P)
    if pad:
        idx = jnp.concatenate([idx, jnp.full((pad,), P, idx.dtype)])
        vals = jnp.concatenate([vals, jnp.zeros((pad, C), vals.dtype)])
    part = jnp.zeros((nb, P, C), vals.dtype).at[
        jnp.arange(nb)[:, None], idx.reshape(nb, block)].add(
            vals.reshape(nb, block, C), mode="drop")
    return jnp.sum(part, axis=0)


@jax.custom_vjp
def take_rows(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Rows ``table[idx]`` [..., C] (idx < 0 -> zeros); the cotangent of
    ``table`` is summed by segment_sum_rows, not one scatter-add."""
    safe = jnp.clip(idx, 0, table.shape[0] - 1)
    return jnp.where((idx >= 0)[..., None], table[safe], 0.0)


def _take_rows_fwd(table, idx):
    return take_rows(table, idx), (idx, table.shape[0])


def _take_rows_bwd(res, g):
    idx, P = res
    return (segment_sum_rows(idx.reshape(-1), g.reshape(-1, g.shape[-1]), P),
            None)


take_rows.defvjp(_take_rows_fwd, _take_rows_bwd)


def _run_sd(tables: SceneTables, ptype, start: int, count: int,
            p: jnp.ndarray) -> jnp.ndarray:
    """Distances for one same-type leaf run: p [..., 3] -> [..., count].

    ``ptype`` is an int PrimType, or the tagged tuple (kind, param, iters)
    for Mandelbox runs (see compile._kernel_normal_form.run_type)."""
    pos = jnp.asarray(tables.prim_pos)[start:start + count]
    aux = jnp.asarray(tables.prim_aux)[start:start + count]
    if isinstance(ptype, tuple):
        fn = _PROC_SD[ptype[0]]
        return jnp.stack(
            [fn(p, pos[k], aux[k, 0], ptype[1], ptype[2])
             for k in range(count)], axis=-1)
    d = p[..., None, :] - pos
    if ptype == int(PrimType.SPHERE):
        # same 1e-24 floor as leaf_sd: value-neutral, NaN-free VJP at d=0
        return (jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=-1), 1e-24))
                - aux[..., 0])
    b = jnp.abs(d) - aux * 0.5
    if ptype == int(PrimType.BOX):
        return jnp.max(b, axis=-1)
    return _med3(b[..., 0], b[..., 1], b[..., 2])


def _menger_carve_jnp(tables: SceneTables, box_idx: int, iters: int,
                      p: jnp.ndarray) -> jnp.ndarray:
    """jnp mirror of ops.pallas_march._menger_carve (space-folded union of
    the sponge's crosses; same math, for the IFT/normal backward)."""
    c = jnp.asarray(tables.prim_pos)[box_idx]
    s = jnp.asarray(tables.prim_aux)[box_idx, 0]
    q = p - c
    pitch = s / 3.0
    csize = s / 3.0
    carve = jnp.full(p.shape[:-1], _INF, p.dtype)
    for k in range(iters):
        b = jnp.abs(q) - csize * 0.5
        cross = _med3(b[..., 0], b[..., 1], b[..., 2])
        carve = jnp.minimum(carve, cross)
        if k + 1 < iters:
            cell = jnp.clip(jnp.round(q / pitch), -1.0, 1.0)
            q = q - cell * pitch
            pitch = pitch / 3.0
            csize = csize / 3.0
    return carve


def _deathstar_carve_jnp(tables: SceneTables, base_idx: int,
                         p: jnp.ndarray) -> jnp.ndarray:
    """jnp mirror of ops.pallas_march._deathstar_carve: the subtracted
    sphere derived from the base row (centre + 1.5 r in x, same radius,
    body.cpp:159-169) — fused-mode gradients flow to the generator's own
    (position, radius), not to an independent second sphere."""
    c = jnp.asarray(tables.prim_pos)[base_idx]
    r = jnp.asarray(tables.prim_aux)[base_idx, 0]
    d = p - (c + jnp.stack([1.5 * r, jnp.zeros_like(r),
                            jnp.zeros_like(r)]))
    return jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=-1), 1e-24)) - r


def scene_sd_fused(plan: ScenePlan, tables: SceneTables,
                   p: jnp.ndarray) -> jnp.ndarray:
    """Scene SDF with fused generator groups (RenderConfig.fused_generators
    semantics): Menger groups evaluate by space folding — O(iters) instead
    of O(20^k) — so reverse-mode through this function (the IFT backward's
    f_theta route) never touches the 20^k cross table; DeathStar groups
    derive their carve sphere from the base row.  Non-generator groups
    match the exact table evaluation."""
    kp = plan.kernel
    assert kp is not None, "fused evaluation requires kernel normal form"
    rsign = 1.0 if kp.root_op == MIN else -1.0
    running = jnp.full(p.shape[:-1], _INF, p.dtype)
    for g in kp.groups:
        if g.fused is not None and g.fused[0] == "deathstar":
            base = _run_sd(tables, int(PrimType.SPHERE), g.start, 1,
                           p)[..., 0]
            carve = _deathstar_carve_jnp(tables, g.start, p)
            gval = jnp.maximum(base, -carve)
        elif g.fused is not None and g.fused[0] == "menger":
            box_sd = _run_sd(tables, int(PrimType.BOX), g.start, 1, p)[..., 0]
            carve = _menger_carve_jnp(tables, g.start, g.fused[1], p)
            gval = jnp.maximum(box_sd, -carve)
        else:
            gmin = jnp.full(p.shape[:-1], _INF, p.dtype)
            for (ptype, start, count, scale) in g.runs:
                sd = _run_sd(tables, ptype, start, count, p)
                gmin = jnp.minimum(gmin, jnp.min(float(scale) * sd, axis=-1))
            gval = float(g.gsign) * gmin
        running = jnp.minimum(running, rsign * gval)
    return rsign * running


def scene_sd_kernel_form(plan: ScenePlan, tables: SceneTables,
                         p: jnp.ndarray) -> jnp.ndarray:
    """Distance via the two-level kernel normal form (jnp mirror of the
    Pallas kernel's reduction order; used to validate the lowering)."""
    kp = plan.kernel
    assert kp is not None, "scene is not in two-level normal form"
    leaf = leaf_sd(plan, tables, p)                # [..., P]
    batch = leaf.shape[:-1]
    rsign = 1.0 if kp.root_op == MIN else -1.0
    running = jnp.full(batch, _INF, leaf.dtype)
    for g in kp.groups:
        scales = np.asarray(g.scales, np.float32)
        seg = leaf[..., g.start:g.start + g.count] * scales
        gval = float(g.gsign) * jnp.min(seg, axis=-1)
        running = jnp.minimum(running, rsign * gval)
    return rsign * running
