"""Single fused Pallas render kernel: the whole per-ray pipeline in one
kernel launch.

Where ops.pallas_march splits the pipeline into four kernels (march, shadow
x lights, surface, normal) glued by XLA, this kernel runs the ENTIRE
reference per-pixel program (scene.cpp:26-32 + render.cpp:104-115) for a
ray block without leaving registers (one ray per GPU thread):

    march -> color index at the pre-step point -> FD normal ->
    per-light shadow march with exact at-light termination -> Lambert
    accumulate with the [saturation, 1] clamp.

Outputs per ray: hit point + sd + converged (the IFT backward residuals),
color index, and the scalar light term.  The backward pass reuses the same
modular jnp formulations as the multi-kernel path (see api.fused_render_op).

The reference's GLSL kernel (shader.comp:328-370) is the same fusion shape —
one invocation does march+grad+shadow+shade — but as a divergent
interpreter; here every stage is a static unroll over the compiled plan.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from ..config import RenderConfig
from ..core.march import MAX_STEP
from ..core.sdf import take_rows
from ..scene.compile import KernelPlan, ScenePlan, SceneTables
from .pallas_march import (_build_table, _kernel_call, _scene_sd_idx_tile,
                           _scene_sd_tile, _tiling, kernel_key, march_values,
                           preload_table, resolve_interpret)


def _split_shade_refs(out_refs, num_lights: int, colored: bool,
                      soft: bool, ao: bool, winner: bool = False):
    """Split the variable tail of a shade output list:
    (cidx, light[3 if colored], smask[, sfac x num_lights][, ao]
    [, sd/widx/gx/gy/gz winner residuals])."""
    outs = list(out_refs)
    cidx_ref = outs.pop(0)
    light_refs = tuple(outs.pop(0) for _ in range(3 if colored else 1))
    smask_ref = outs.pop(0)
    sfac_refs = tuple(outs.pop(0) for _ in range(num_lights)) if soft else ()
    ao_ref = outs.pop(0) if ao else None
    winner_refs = tuple(outs.pop(0) for _ in range(5)) if winner else None
    assert not outs
    return cidx_ref, light_refs, smask_ref, sfac_refs, ao_ref, winner_refs


def _num_shade_refs(num_lights: int, colored: bool, soft: bool,
                    ao: bool, winner: bool = False) -> int:
    """Flat ref count of one _split_shade_refs set."""
    return (1 + (3 if colored else 1) + 1 + (num_lights if soft else 0)
            + (1 if ao else 0) + (5 if winner else 0))


def _raygen_dirs(raygen, cam_ref, base_ref, ray_block, dtype):
    """In-kernel primary-ray directions for the serving fast path
    (RenderConfig.serve_raygen): invert the block-major ray layout from
    the lane's absolute ray index to (pixel, SSAA sample) indices and
    evaluate the camera model in registers — the same math as
    core.camera.generate_rays (corner-biased (i+1, j+1)/k sample offsets
    render.cpp:104-105, screen-rect lerp, normalize, rotate; z = -1 so
    the norm's z^2 term is exactly 1).  Kills the jnp raygen pass, the
    to_blocked reorder, and the [R, 3] dirs stream from serving frames.
    ``cam_ref`` rows come from _serve_cam_rows; the chunk's first ray
    index arrives as an int32 scalar in ``base_ref``."""
    W, H, k, bh, bw = raygen
    S = k * k
    ri = (base_ref[0] + pl.program_id(0) * ray_block
          + jax.lax.broadcasted_iota(jnp.int32, (ray_block,), 0))
    s = ri % S
    t1 = ri // S
    if bh:
        GW = W // bw
        ix = t1 % bw
        t2 = t1 // bw
        iy = t2 % bh
        t3 = t2 // bh
        pxi = (t3 % GW) * bw + ix
        pyi = (t3 // GW) * bh + iy
    else:
        pxi = t1 % W
        pyi = t1 // W
    i = (s // k).astype(dtype)
    j = (s % k).astype(dtype)
    w = cam_ref[0, 3]
    h = cam_ref[0, 4]
    u = (pxi.astype(dtype) + (i + 1.0) * (1.0 / k)) * (1.0 / W)
    v = (pyi.astype(dtype) + (j + 1.0) * (1.0 / k)) * (1.0 / H)
    x = w * (u - 0.5)
    y = h * (0.5 - v)
    n = jnp.sqrt(x * x + y * y + 1.0)
    xc, yc, zc = x / n, y / n, -1.0 / n
    # world = cam @ R.T: out_a = sum_b d_b * R[a, b]
    dx = xc * cam_ref[1, 0] + yc * cam_ref[1, 1] + zc * cam_ref[1, 2]
    dy = xc * cam_ref[1, 3] + yc * cam_ref[1, 4] + zc * cam_ref[1, 5]
    dz = xc * cam_ref[1, 6] + yc * cam_ref[1, 7] + zc * cam_ref[2, 0]
    return dx, dy, dz


def _render_kernel(kp: KernelPlan, iterations: int, eps: float,
                   offset_eps: float, saturation: float, fd_h: float,
                   num_lights: int, shadows: bool, fused: bool,
                   analytic: bool, colored: bool, soft_k: float,
                   ao_strength: float, ao_samples: int, ao_delta: float,
                   bounces: int, per_ray_org: bool, black_ids,
                   save_winner: bool, sat_skip: bool, raygen,
                   tbl_ref, lights_ref, *in_refs):
    gate_ref = None
    if black_ids:
        gate_ref, in_refs = in_refs[0], in_refs[1:]
    if raygen is not None:
        assert not per_ray_org, "serve raygen is pinhole-only"
        org_ref, cam_ref, base_ref = in_refs[:3]
        dx_ref = dy_ref = dz_ref = None
        out_refs = in_refs[3:]
    elif per_ray_org:
        # arbitrary ray bundles (api.render_rays / batched animation
        # frames): each lane carries its own origin stream
        ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref = in_refs[:6]
        out_refs = in_refs[6:]
    else:
        org_ref, dx_ref, dy_ref, dz_ref = in_refs[:4]
        out_refs = in_refs[4:]
    (px_ref, py_ref, pz_ref, sd_ref, done_ref) = out_refs[:5]
    soft = shadows and soft_k > 0.0
    ao = ao_strength > 0.0
    assert not (save_winner and bounces), \
        "winner residuals are reflection-free (the replay backward owns " \
        "bounce chains)"
    # one full shade-ref set for the primary hit + one per mirror bounce
    n_per = _num_shade_refs(num_lights, colored, soft, ao, save_winner)
    rest = list(out_refs[5:])
    shade_sets = []
    for _ in range(1 + bounces):
        shade_sets.append(_split_shade_refs(rest[:n_per], num_lights,
                                            colored, soft, ao, save_winner))
        rest = rest[n_per:]
    # per-bounce hit geometry (px, py, pz, sd, done) — the backward
    # replay's IFT anchors (_reflect_bwd)
    bgeom_sets = []
    for _ in range(bounces):
        bgeom_sets.append(tuple(rest[:5]))
        rest = rest[5:]
    assert not rest
    dtype = jnp.float32 if raygen is not None else dx_ref.dtype
    # hoist loop-invariant scalar loads out of every march/eval below
    tbl_ref = preload_table(kp, tbl_ref, fused)
    if raygen is not None:
        dx, dy, dz = _raygen_dirs(raygen, cam_ref, base_ref,
                                  out_refs[0].shape[0], dtype)
    else:
        dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    if per_ray_org:
        ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    else:
        ox = jnp.full(dx.shape, org_ref[0], dtype)
        oy = jnp.full(dx.shape, org_ref[1], dtype)
        oz = jnp.full(dx.shape, org_ref[2], dtype)

    # 1. primary march
    px, py, pz, sd, done = march_values(kp, tbl_ref, ox, oy, oz,
                                        dx, dy, dz, iterations, eps, fused)
    px_ref[...], py_ref[...], pz_ref[...] = px, py, pz
    sd_ref[...], done_ref[...] = sd, done

    nrm = _shade_body(kp, iterations, eps, offset_eps, saturation, fd_h,
                      num_lights, shadows, fused, analytic, colored, soft_k,
                      ao_strength, ao_samples, ao_delta,
                      tbl_ref, lights_ref, px, py, pz, sd, dx, dy, dz,
                      *shade_sets[0], black_ids=black_ids,
                      gate_ref=gate_ref, sat_skip=sat_skip)

    # 2. mirror bounces (RenderConfig.reflect_*): reflect off the shaded
    # hit, push the origin off the surface exactly like a shadow ray, and
    # re-run the identical march + shade — everything stays in registers;
    # per-bounce shade outputs are blended OUTSIDE the kernel (the
    # kernel table carries no primitive colors).  d and n are unit, so the
    # mirrored direction needs no renormalization.
    for b in range(1, 1 + bounces):
        nx, ny, nz = nrm
        ddot = dx * nx + dy * ny + dz * nz
        dx = dx - 2.0 * ddot * nx
        dy = dy - 2.0 * ddot * ny
        dz = dz - 2.0 * ddot * nz
        off = eps + offset_eps
        ox, oy, oz = px + nx * off, py + ny * off, pz + nz * off
        px, py, pz, sd, bdone = march_values(kp, tbl_ref, ox, oy, oz,
                                              dx, dy, dz, iterations, eps,
                                              fused)
        gb = bgeom_sets[b - 1]
        gb[0][...], gb[1][...], gb[2][...] = px, py, pz
        gb[3][...], gb[4][...] = sd, bdone
        nrm = _shade_body(kp, iterations, eps, offset_eps, saturation,
                          fd_h, num_lights, shadows, fused, analytic,
                          colored, soft_k, ao_strength, ao_samples,
                          ao_delta, tbl_ref, lights_ref, px, py, pz, sd,
                          dx, dy, dz, *shade_sets[b], sat_skip=sat_skip)


def _big_program(kp) -> bool:
    """Is this scene's traced fold big enough that COMPILE time, not ILP,
    is the binding constraint?  Big programs trace repeated scene folds
    (FD stencil points, per-light shadow marches) once and drive them
    with ``lax.fori_loop`` — kernel compile time grows superlinearly
    with program size.  Small scenes stay unrolled for ILP across the
    independent evals.  The thresholds are untuned on the GPU."""
    groups = getattr(kp, "groups", None)
    if groups is None:
        return len(getattr(kp, "prim_type", ())) > 64
    if any(g.lattice is not None for g in groups):
        return True
    return sum(g.count for g in groups) > 64


def _shade_body(kp: KernelPlan, iterations: int, eps: float,
                offset_eps: float, saturation: float, fd_h: float,
                num_lights: int, shadows: bool, fused: bool,
                analytic: bool, colored: bool, soft_k: float,
                ao_strength: float, ao_samples: int, ao_delta: float,
                tbl_ref, lights_ref, px, py, pz, sd, dx, dy, dz,
                cidx_ref, light_refs, smask_ref, sfac_refs=(), ao_ref=None,
                winner_refs=None, black_ids=(), gate_ref=None,
                sat_skip=True):
    """Steps 2-4 of the per-ray pipeline given marched hit points: color
    index at the pre-step point, normal, shadow marches, Lambert clamp.
    Shared by the single mega kernel and the two-phase shade kernel.

    Extensions (both opt-in, stop-gradient factors — see core.shading):
    ``soft_k > 0`` tracks the penumbra factor inside each shadow march and
    scales the Lambert term by it (per-light factors go out via
    ``sfac_refs`` for the backward replay); ``ao_strength > 0`` computes
    the SDF ambient-occlusion factor and scales the final clamped light
    (factor out via ``ao_ref``).

    ``black_ids``/``gate_ref`` (RenderConfig.shade_skip_black): lanes whose
    color winner is a compile-time-black primitive (or a miss) start their
    shadow marches pre-converged — their pixel is color * light == 0
    whatever light is, so the marches' only effect was wall-clock.  The
    gate scalar is the runtime proof that those table rows are still
    black (computed outside the kernel); 0 disables the skip bitwise."""
    dtype = dx.dtype
    # 2. color index at the pre-step point (scene.cpp:34-42 semantics)
    step = jnp.minimum(sd, MAX_STEP)
    _, cidx = _scene_sd_idx_tile(kp, tbl_ref, px - step * dx, py - step * dy,
                                 pz - step * dz, dtype, fused=fused)
    cidx_ref[...] = cidx

    skip = None
    if black_ids and gate_ref is not None and shadows:
        isb = cidx < 0                      # miss lanes shade to black too
        for k in black_ids:
            isb = jnp.logical_or(isb, cidx == k)
        skip = jnp.logical_and(isb, gate_ref[0] > 0.5)

    # 3. normal at the hit point: FD (reference parity, scene.cpp:70-89)
    # or the hand-derived analytic winner gradient (one eval vs six)
    if analytic and winner_refs is not None:
        # Save-the-winner mode (custom-vjp forward, bounces == 0): the
        # combined (sd, winner id, gradient) fold replaces the plain
        # gradient fold — BIT-IDENTICAL g (same strict-< selections, same
        # arithmetic; tests/test_mega.py pins it) — and its outputs become
        # backward residuals, so the single-launch winner backwards
        # (_fused_analytic_bwd / _exact_analytic_bwd) skip their own
        # winner kernel launch entirely.
        from .pallas_march import _scene_sd_idx_grad_tile
        sdh, widx, gx, gy, gz = _scene_sd_idx_grad_tile(
            kp, tbl_ref, px, py, pz, dtype, fused=fused)
        winner_refs[0][...] = sdh
        winner_refs[1][...] = widx
        winner_refs[2][...] = gx
        winner_refs[3][...] = gy
        winner_refs[4][...] = gz
    elif analytic:
        from .pallas_march import _scene_sd_grad_tile
        _, gx, gy, gz = _scene_sd_grad_tile(kp, tbl_ref, px, py, pz, dtype,
                                            fused=fused)
    else:
        assert winner_refs is None, "winner residuals need analytic normals"
        h = jnp.array(fd_h, dtype)
        ev = lambda a, b, c: _scene_sd_tile(kp, tbl_ref, a, b, c, dtype,
                                            fused=fused)
        if _big_program(kp):
            # Big scene programs (lattice collapse, wide tables): trace
            # the scene fold ONCE and fori over the 6 stencil points —
            # the unrolled stencil was ~60% of the traced kernel.
            # SAME ESTIMATOR, same adds in the same order (per axis the
            # accumulator sees 0 + e_plus, then + (-e_minus)); compiled
            # output may still differ from the unrolled form by an ulp
            # where the compiler contracts loop bodies differently —
            # within the cross-backend tolerance contract the suite pins.
            zero = jnp.zeros(px.shape, dtype)

            def stencil(k, acc):
                gx, gy, gz = acc
                # shift/mask, not // and %: the Triton lowering mistypes
                # the scalar remainder inside a loop body
                axis = jnp.right_shift(k, 1)
                sgn = 1.0 - 2.0 * jnp.bitwise_and(k, 1).astype(dtype)
                ox = jnp.where(axis == 0, sgn * h, 0.0)
                oy = jnp.where(axis == 1, sgn * h, 0.0)
                oz = jnp.where(axis == 2, sgn * h, 0.0)
                se = sgn * ev(px + ox, py + oy, pz + oz)
                return (jnp.where(axis == 0, gx + se, gx),
                        jnp.where(axis == 1, gy + se, gy),
                        jnp.where(axis == 2, gz + se, gz))

            gx, gy, gz = jax.lax.fori_loop(0, 6, stencil,
                                           (zero, zero, zero))
        else:
            gx = ev(px + h, py, pz) - ev(px - h, py, pz)
            gy = ev(px, py + h, pz) - ev(px, py - h, pz)
            gz = ev(px, py, pz + h) - ev(px, py, pz - h)
    gn = jnp.sqrt(gx * gx + gy * gy + gz * gz)
    inv = 1.0 / jnp.maximum(gn, jnp.finfo(jnp.float32).tiny)
    nx, ny, nz = gx * inv, gy * inv, gz * inv

    # (white lights only: LightColor scenes scale each term by an
    # arbitrary per-channel factor the bound would have to carry)
    if shadows and sat_skip and num_lights > 0 and not colored:
        # SATURATION-FLOOR shadow skip (r5, EXACT fwd+bwd): when even
        # the all-lit Lambert accumulation cannot reach the clamp floor
        # (sum_l max(n.l_dir, 0) < saturation, STRICT, computed with the
        # shade loop's own per-term arithmetic so float-add monotonicity
        # makes it a true bound on every shadow outcome's total), the
        # [saturation, 1] clamp pins the pixel either way, zeroes every
        # upstream cotangent in the backward, and the jnp replay clamps
        # to the identical floor: a skipped lane's saved smask bit reads
        # SHADOWED (endpoint = origin fails the passed test), so the
        # replay total is 0, and clip(0) == clip(anything <= bound) ==
        # saturation.  NOTE the shadowed-not-lit convention for skipped
        # lanes: any new smask consumer must not trust skipped bits
        # (render_aovs disables the skips for its shadow plane).
        # Unlike the
        # black skip this holds UNDER DIFFERENTIATION, so it stays on in
        # the custom-vjp forward.  menger4's two shadow marches were 71%
        # of its forward kernel and the carved sponge is full of lanes
        # no light can lift above the floor.
        def upper_term(li, u):
            lx = jnp.asarray(lights_ref[li, 0], dtype)
            ly = jnp.asarray(lights_ref[li, 1], dtype)
            lz = jnp.asarray(lights_ref[li, 2], dtype)
            rx, ry, rz = lx - px, ly - py, lz - pz
            rd = jnp.sqrt(rx * rx + ry * ry + rz * rz)
            rinv = 1.0 / jnp.maximum(rd, jnp.finfo(jnp.float32).tiny)
            lamb = (nx * (rx * rinv) + ny * (ry * rinv)
                    + nz * (rz * rinv))
            return u + jnp.maximum(lamb, 0.0)

        if _big_program(kp):
            upper = jax.lax.fori_loop(0, num_lights, upper_term,
                                      jnp.zeros(dx.shape, dtype))
        else:
            upper = jnp.zeros(dx.shape, dtype)
            for li in range(num_lights):
                upper = upper_term(li, upper)
        dark = upper < saturation
        skip = dark if skip is None else jnp.logical_or(skip, dark)

    # 4. multi-light Lambert with boolean shadows (scene.cpp:45-62).
    # Per-light shadow booleans also go out as a bitmask so the backward
    # replay can reconstruct the clamp/masking exactly.  ``colored``
    # (LightColor scene extension) accumulates per channel — bit-identical
    # to the scalar path when every light is white, hence compiled only
    # when the scene actually uses it.
    total = [jnp.zeros(dx.shape, dtype) for _ in range(3 if colored else 1)]
    smask = jnp.zeros(dx.shape, jnp.int32)

    def light_term(li, smask, total):
        """One light's Lambert + shadow contribution — ``li`` may be a
        Python int (unrolled loop) or a fori tracer (big programs trace
        the shadow march once; lights_ref reads are dynamic either way).
        Returns the updated (smask, total) carry."""
        lx = jnp.asarray(lights_ref[li, 0], dtype)
        ly = jnp.asarray(lights_ref[li, 1], dtype)
        lz = jnp.asarray(lights_ref[li, 2], dtype)
        rx, ry, rz = lx - px, ly - py, lz - pz
        rd = jnp.sqrt(rx * rx + ry * ry + rz * rz)
        rinv = 1.0 / jnp.maximum(rd, jnp.finfo(jnp.float32).tiny)
        rx, ry, rz = rx * rinv, ry * rinv, rz * rinv
        lambert = nx * rx + ny * ry + nz * rz
        if shadows:
            soft = soft_k > 0.0
            off = eps + offset_eps
            sx, sy, sz = px + nx * off, py + ny * off, pz + nz * off
            t2x, t2y, t2z = lx - sx, ly - sy, lz - sz
            tmax = jnp.sqrt(t2x * t2x + t2y * t2y + t2z * t2z)
            res = march_values(
                kp, tbl_ref, sx, sy, sz, rx, ry, rz, iterations, eps,
                fused, tmax=tmax, soft_k=soft_k if soft else None,
                init_done=skip)
            qx, qy, qz = res[0], res[1], res[2]
            passed = ((lx - qx) * rx + (ly - qy) * ry
                      + (lz - qz) * rz) <= 0
            bit = (jnp.left_shift(jnp.int32(1), li)
                   if not isinstance(li, int) else jnp.int32(1 << li))
            smask = jnp.where(passed, smask, jnp.bitwise_or(smask, bit))
            if soft:
                fac = jnp.where(passed, res[5], 0.0)
                sfac_refs[li][...] = fac
                lambert = lambert * fac
            else:
                lambert = jnp.where(passed, lambert, 0.0)
        if colored:
            total = [t + lambert * jnp.asarray(lights_ref[li, 4 + c],
                                               dtype)
                     for c, t in enumerate(total)]
        else:
            total = [total[0] + lambert]
        return smask, total

    if _big_program(kp) and soft_k <= 0.0:
        # big programs: ONE traced shadow march, fori over lights — the
        # per-light march was a full scene-fold instance each in the
        # kernel program.  (Soft shadows keep the unrolled loop: the
        # per-light penumbra factors write to statically-indexed refs.)
        def light_body(li, carry):
            smask, tot = carry
            smask, tot_list = light_term(li, smask, list(tot))
            return smask, tuple(tot_list)

        smask, tot = jax.lax.fori_loop(0, num_lights, light_body,
                                       (smask, tuple(total)))
        total = list(tot)
    else:
        for li in range(num_lights):
            smask, total = light_term(li, smask, total)
    ao = None
    if ao_strength > 0.0:
        occ = jnp.zeros(dx.shape, dtype)
        for i in range(1, ao_samples + 1):
            d = i * ao_delta
            sdo = _scene_sd_tile(kp, tbl_ref, px + d * nx, py + d * ny,
                                 pz + d * nz, dtype, fused=fused)
            occ = occ + (2.0 ** -i) * (d - sdo)
        ao = jnp.clip(1.0 - ao_strength * occ, 0.0, 1.0)
        ao_ref[...] = ao
    for ref, tot in zip(light_refs, total):
        clipped = jnp.clip(tot, saturation, 1.0)
        ref[...] = clipped * ao if ao is not None else clipped
    smask_ref[...] = smask
    # unit surface normal, for the caller's reflection bounce (if any)
    return nx, ny, nz


def _shade_kernel(kp: KernelPlan, iterations: int, eps: float,
                  offset_eps: float, saturation: float, fd_h: float,
                  num_lights: int, shadows: bool, fused: bool,
                  analytic: bool, colored: bool, soft_k: float,
                  ao_strength: float, ao_samples: int, ao_delta: float,
                  black_ids, save_winner: bool, sat_skip: bool,
                  tbl_ref, lights_ref, *refs):
    """Shade-only kernel for the two-phase path: hit points come from the
    (compacted) march kernels instead of an in-kernel march."""
    gate_ref = None
    if black_ids:
        gate_ref, refs = refs[0], refs[1:]
    (px_ref, py_ref, pz_ref, sd_ref, dx_ref, dy_ref, dz_ref) = refs[:7]
    out_refs = refs[7:]
    shade_refs = _split_shade_refs(out_refs, num_lights, colored,
                                   shadows and soft_k > 0.0,
                                   ao_strength > 0.0, save_winner)
    tbl = preload_table(kp, tbl_ref, fused)
    _shade_body(kp, iterations, eps, offset_eps, saturation, fd_h,
                num_lights, shadows, fused, analytic, colored, soft_k,
                ao_strength, ao_samples, ao_delta,
                tbl, lights_ref, px_ref[...], py_ref[...], pz_ref[...],
                sd_ref[...], dx_ref[...], dy_ref[...], dz_ref[...],
                *shade_refs, black_ids=black_ids, gate_ref=gate_ref,
                sat_skip=sat_skip)


def _shade_out_shapes(f32, i32, num_lights: int, colored: bool,
                      soft: bool, ao: bool, winner: bool = False):
    """ShapeDtypeStructs matching _split_shade_refs's layout."""
    light_outs = (f32, f32, f32) if colored else (f32,)
    sfac_outs = (f32,) * num_lights if soft else ()
    ao_outs = (f32,) if ao else ()
    winner_outs = (f32, i32, f32, f32, f32) if winner else ()
    return (i32,) + light_outs + (i32,) + sfac_outs + ao_outs + winner_outs


@functools.lru_cache(maxsize=64)
def _compiled_shade_call(kp: KernelPlan, iterations: int, eps: float,
                         offset_eps: float, saturation: float, fd_h: float,
                         num_lights: int, shadows: bool, fused: bool,
                         analytic: bool, colored: bool, soft_k: float,
                         ao_strength: float, ao_samples: int,
                         ao_delta: float, black_ids, save_winner: bool,
                         sat_skip: bool, ray_block: int, num_blocks: int,
                         interpret: bool):
    f32 = jax.ShapeDtypeStruct((num_blocks * ray_block,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((num_blocks * ray_block,), jnp.int32)
    out_shape = _shade_out_shapes(f32, i32, num_lights, colored,
                                  shadows and soft_k > 0.0,
                                  ao_strength > 0.0, save_winner)
    kernel = functools.partial(_shade_kernel, kp, iterations, eps,
                               offset_eps, saturation, fd_h, num_lights,
                               shadows, fused, analytic, colored, soft_k,
                               ao_strength, ao_samples, ao_delta, black_ids,
                               save_winner, sat_skip)
    gate = ["any"] if black_ids else []
    return _kernel_call(kernel, num_blocks, ray_block,
                        ["any", "any"] + gate + ["ray"] * 7, out_shape,
                        interpret)


@functools.lru_cache(maxsize=64)
def _compiled_render_call(kp: KernelPlan, iterations: int, eps: float,
                          offset_eps: float, saturation: float, fd_h: float,
                          num_lights: int, shadows: bool, fused: bool,
                          analytic: bool, colored: bool, soft_k: float,
                          ao_strength: float, ao_samples: int,
                          ao_delta: float, bounces: int,
                          per_ray_org: bool, black_ids, save_winner: bool,
                          sat_skip: bool, ray_block: int, num_blocks: int,
                          interpret: bool, raygen=None):
    f32 = jax.ShapeDtypeStruct((num_blocks * ray_block,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((num_blocks * ray_block,), jnp.int32)
    kernel = functools.partial(_render_kernel, kp, iterations, eps,
                               offset_eps, saturation, fd_h, num_lights,
                               shadows, fused, analytic, colored, soft_k,
                               ao_strength, ao_samples, ao_delta, bounces,
                               per_ray_org, black_ids, save_winner,
                               sat_skip, raygen)
    out_shape = (f32, f32, f32, f32, f32) + (1 + bounces) * _shade_out_shapes(
        f32, i32, num_lights, colored, shadows and soft_k > 0.0,
        ao_strength > 0.0, save_winner) + bounces * (f32, f32, f32, f32, f32)
    gate = ["any"] if black_ids else []
    org = ["ray"] * 3 if per_ray_org else ["any"]
    dirs = ["any", "any"] if raygen is not None else ["ray"] * 3
    return _kernel_call(kernel, num_blocks, ray_block,
                        ["any", "any"] + gate + org + dirs, out_shape,
                        interpret)


def _unpack_shade_outs(outs, unprep, num_lights: int, colored: bool,
                       soft: bool, ao: bool, winner: bool = False):
    """Invert _shade_out_shapes -> (cidx, light, smask, sfac, aofac, wres);
    sfac [R, L] / aofac [R] or None when the mode is off; wres is the
    saved winner residual (sd [R], widx [R], g [R, 3]) or None."""
    outs = list(outs)
    cidx = unprep(outs.pop(0))
    if colored:
        light = jnp.stack([unprep(outs.pop(0)) for _ in range(3)], axis=-1)
    else:
        light = unprep(outs.pop(0))
    smask = unprep(outs.pop(0))
    sfac = None
    if soft:
        sfac = jnp.stack([unprep(outs.pop(0)) for _ in range(num_lights)],
                         axis=-1)
    aofac = unprep(outs.pop(0)) if ao else None
    wres = None
    if winner:
        sdh = unprep(outs.pop(0))
        widx = unprep(outs.pop(0))
        g = jnp.stack([unprep(outs.pop(0)) for _ in range(3)], axis=-1)
        wres = (sdh, widx, g)
    assert not outs
    return cidx, light, smask, sfac, aofac, wres


def black_skip_ids(plan: ScenePlan, cfg: RenderConfig):
    """Static black-primitive leaf ids when the shadow skip is engaged
    (RenderConfig.shade_skip_black), else ().  Requires shadows (there is
    nothing to skip otherwise) and the two-level kernel plan (the generic
    ScenePlan carries no black_prims provenance)."""
    ids = tuple(getattr(kernel_key(plan), "black_prims", ()))
    if ids and cfg.shade_skip_black and cfg.shadows:
        return ids
    return ()


def _serve_cam_rows(tables: SceneTables, cfg: RenderConfig) -> jnp.ndarray:
    """[3, 8] camera rows for the in-kernel raygen (_raygen_dirs):
    row 0 = [pos xyz, focal w, focal h, 0, 0, 0];
    rows 1-2 = the camera rotation, row-major (R22 wraps to row 2)."""
    from ..core import camera as cam

    w = cam.camera_focal(jnp.asarray(tables.cam_fov, jnp.float32))
    h = w / cfg.aspect_ratio
    Rm = cam.camera_rotation(jnp.asarray(tables.cam_direction),
                             jnp.asarray(tables.cam_up)).reshape(9)
    row0 = jnp.concatenate([
        jnp.asarray(tables.cam_position, jnp.float32).reshape(3),
        jnp.stack([w, h]), jnp.zeros((3,), jnp.float32)])
    row12 = jnp.concatenate([Rm, jnp.zeros((7,), jnp.float32)])
    return jnp.concatenate([row0, row12]).reshape(3, 8)


def serve_render_chunk(plan: ScenePlan, cfg: RenderConfig, tables,
                       raygen, ray_base, n_rays: int,
                       interpret=None) -> jnp.ndarray:
    """Forward-only serving render of ``n_rays`` consecutive rays in the
    kernel's own layout, directions generated IN-kernel
    (RenderConfig.serve_raygen): colors [n_rays, 3].  PRIMAL ONLY — no
    custom VJP; training paths keep the standard raygen so camera
    cotangents flow through saved activations (the r3 analysis: in-kernel
    raygen nets ~zero fwd+bwd because the backward must replay it)."""
    outs = pallas_render_rays(plan, cfg, tables.cam_position, None,
                              tables, interpret=interpret,
                              raygen=raygen, ray_base=ray_base,
                              n_rays=n_rays)
    cidx, light = outs[3], outs[4]
    return _blend_bounces(plan, cfg, tables, cidx, light,
                          outs[8] if len(outs) > 8 else ())


def pallas_render_rays(plan: ScenePlan, cfg: RenderConfig,
                       origin: jnp.ndarray, dirs: jnp.ndarray,
                       tables: SceneTables, *, interpret=None,
                       save_winner: bool = False,
                       raygen=None, ray_base=None, n_rays=None):
    """Fully fused forward: dirs [R, 3], origin [3] or [R, 3] ->
    (p_hit [R,3], sd [R], converged [R], cidx [R], light [R], smask [R],
    sfac [R, L] | None, aofac [R] | None).  A [R, 3] origin makes every
    lane carry its own origin (arbitrary ray bundles / batched frames);
    a [3] origin stays a scalar broadcast (three fewer ray streams).

    ``light`` already includes the soft-shadow / AO factors when those
    modes are on; ``sfac``/``aofac`` ride along only so the backward
    replay can reapply the exact (stop-gradient) factors the kernel used.

    With cfg.reflect_strength > 0 a NINTH element is appended: a tuple of
    per-bounce (cidx_b, light_b, smask_b, sfac_b, aofac_b, p_b, sd_b,
    conv_b) outputs from the in-kernel mirror bounces — blend the first
    two with _blend_bounces; the geometry tail anchors the differentiable
    backward replay (_reflect_bwd).

    ``save_winner`` (custom-vjp forward only; requires analytic normals,
    no bounces): the shade body's normal fold also reports the winner id,
    and a NINTH element (sd_hit [R], widx [R], g [R, 3]) is appended — the
    exact values the single-launch winner backwards would otherwise
    recompute with their own kernel launch (bit-identical: same fold at
    the same points)."""
    kp = kernel_key(plan)
    colored = plan.colored_lights
    soft = cfg.shadows and cfg.soft_shadow_k > 0.0
    ao = cfg.ao_strength > 0.0
    bounces = cfg.reflect_bounces if cfg.reflect_strength > 0.0 else 0
    assert not (save_winner and bounces), \
        "winner residuals are reflection-free"
    assert not save_winner or cfg.normal_mode == "analytic", \
        "winner residuals ride the analytic normal fold"
    L = int(plan.num_lights)
    if raygen is not None:
        # serve fast path (RenderConfig.serve_raygen): directions are
        # computed IN the kernel from the ray index (_raygen_dirs); the
        # cam + ray-base operands replace the three dirs streams.
        assert dirs is None and n_rays is not None
        assert jnp.ndim(origin) == 1, "serve raygen is pinhole-only"
        R = int(n_rays)
        num_blocks, prep, unprep = _tiling(R, cfg.ray_block)
        comps = [_serve_cam_rows(tables, cfg),
                 jnp.asarray(ray_base, jnp.int32).reshape(1)]
    else:
        R = dirs.shape[0]
        num_blocks, prep, unprep = _tiling(R, cfg.ray_block)
        comps = [prep(dirs[:, a]) for a in range(3)]
    tbl = _build_table(tables, kp)
    # [L, 8] light rows: position xyz, pad, color rgb, pad.
    nL = tables.light_pos.shape[0]
    lights = jnp.concatenate(
        [jnp.asarray(tables.light_pos), jnp.zeros((nL, 1), jnp.float32),
         jnp.asarray(tables.light_color), jnp.zeros((nL, 1), jnp.float32)],
        axis=1)
    per_ray_org = jnp.ndim(origin) == 2
    if per_ray_org:
        org_args = [prep(jnp.asarray(origin, jnp.float32)[:, a])
                    for a in range(3)]
    else:
        org_args = [jnp.asarray(origin, jnp.float32).reshape(3)]

    # Black-lane shadow skip (RenderConfig.shade_skip_black): static ids
    # from compile-time colors + a runtime gate scalar proving the live
    # table rows are STILL black (fitting a color flips the gate to 0 and
    # the kernel behaves bitwise as if the feature were off).
    black_ids = black_skip_ids(plan, cfg) if bounces == 0 else ()
    gate_args = []
    if black_ids:
        rows = jnp.asarray(tables.prim_color)[jnp.asarray(black_ids)]
        gate_args = [jnp.where(jnp.all(rows == 0.0), 1.0, 0.0)
                     .astype(jnp.float32).reshape(1)]

    if 0 < cfg.two_phase_k1 < cfg.iterations and bounces == 0 \
            and raygen is None:
        p, sd, conv = _two_phase_march(plan, cfg,
                                       jnp.asarray(origin, jnp.float32),
                                       dirs, tables, interpret)
        shade = _compiled_shade_call(
            kp, cfg.iterations, cfg.surface_precision,
            cfg.offset_precision, cfg.saturation, cfg.fd_h,
            L, cfg.shadows, cfg.fused_generators,
            cfg.normal_mode == "analytic", colored, cfg.soft_shadow_k,
            cfg.ao_strength, cfg.ao_samples, cfg.ao_delta, black_ids,
            save_winner, cfg.shadow_sat_skip,
            cfg.ray_block, num_blocks, resolve_interpret(interpret))
        pc = [prep(p[:, a]) for a in range(3)]
        outs = shade(tbl, lights, *gate_args, *pc, prep(sd), *comps)
        cidx, light, smask, sfac, aofac, wres = _unpack_shade_outs(
            outs, unprep, L, colored, soft, ao, save_winner)
        base = (p, sd, conv, cidx, light, smask, sfac, aofac)
        return base + (wres,) if save_winner else base

    call = _compiled_render_call(
        kp, cfg.iterations, cfg.surface_precision, cfg.offset_precision,
        cfg.saturation, cfg.fd_h, L, cfg.shadows,
        cfg.fused_generators, cfg.normal_mode == "analytic", colored,
        cfg.soft_shadow_k, cfg.ao_strength, cfg.ao_samples, cfg.ao_delta,
        bounces, per_ray_org, black_ids, save_winner, cfg.shadow_sat_skip,
        cfg.ray_block, num_blocks, resolve_interpret(interpret), raygen)
    outs = call(tbl, lights, *gate_args, *org_args, *comps)
    px, py, pz, sd, done = outs[:5]
    n_per = _num_shade_refs(L, colored, soft, ao, save_winner)
    rest = outs[5:]
    cidx, light, smask, sfac, aofac, wres = _unpack_shade_outs(
        rest[:n_per], unprep, L, colored, soft, ao, save_winner)
    geom = rest[(1 + bounces) * n_per:]
    bounce_shades = []
    for b in range(bounces):
        shade_b = _unpack_shade_outs(rest[(1 + b) * n_per:(2 + b) * n_per],
                                     unprep, L, colored, soft, ao)[:5]
        g = geom[b * 5:(b + 1) * 5]
        p_b = jnp.stack([unprep(g[0]), unprep(g[1]), unprep(g[2])], axis=-1)
        sd_b = unprep(g[3])
        conv_b = jnp.logical_and(unprep(g[4]) > 0.5,
                                 sd_b < cfg.surface_precision)
        bounce_shades.append(shade_b + (p_b, sd_b, conv_b))
    bounce_shades = tuple(bounce_shades)

    p = jnp.stack([unprep(px), unprep(py), unprep(pz)], axis=-1)
    sd = unprep(sd)
    base = (p, sd,
            jnp.logical_and(unprep(done) > 0.5, sd < cfg.surface_precision),
            cidx, light, smask, sfac, aofac)
    if save_winner:
        return base + (wres,)
    return base + (bounce_shades,) if bounces else base


# Phase-2 capacity as a fraction of the chunk: covers any scene whose
# unconverged tail at K1 steps is below 1/8 of rays (demo profile: ~1% at
# K1=48); overflow falls back to the plain full-budget march, so the cap
# affects performance only, never results.
_PHASE2_CAP_FRAC = 8


def _two_phase_march(plan: ScenePlan, cfg: RenderConfig, origin, dirs,
                     tables, interpret: bool):
    """March all rays K1 steps, compact the unconverged tail into dense
    tiles, finish only those — exact (see RenderConfig.two_phase_k1)."""
    from .pallas_march import pallas_march

    kp = kernel_key(plan)
    R = dirs.shape[0]
    k1 = cfg.two_phase_k1
    o = jnp.broadcast_to(origin, dirs.shape)
    res1 = pallas_march(kp, k1, cfg.surface_precision, cfg.ray_block,
                        o, dirs, tables, fused=cfg.fused_generators,
                        interpret=interpret)
    # NOTE primary marches have no tmax, so done == converged here and an
    # unconverged ray is exactly "still marching".
    unconv = jnp.logical_not(res1.converged)
    cap = max(R // _PHASE2_CAP_FRAC, min(R, cfg.ray_block))
    # Stable sort: unconverged lanes first, original order within groups.
    order = jnp.argsort(res1.converged, stable=True)
    sel = order[:cap]
    sel_active = unconv[sel]

    res2 = pallas_march(kp, cfg.iterations - k1, cfg.surface_precision,
                        cfg.ray_block, res1.position[sel], dirs[sel],
                        tables, fused=cfg.fused_generators,
                        interpret=interpret)
    # merge: phase-2 results only for lanes that were actually unconverged
    # (converged lanes in the capacity block keep their phase-1 state).
    p = res1.position.at[sel].set(
        jnp.where(sel_active[:, None], res2.position, res1.position[sel]))
    sd = res1.sd.at[sel].set(
        jnp.where(sel_active, res2.sd, res1.sd[sel]))
    conv = res1.converged.at[sel].set(
        jnp.where(sel_active, res2.converged, res1.converged[sel]))

    def fallback(_):
        # > cap rays unconverged at K1: re-march everything from the origin
        # with the full budget (the plain exact path).
        res = pallas_march(kp, cfg.iterations, cfg.surface_precision,
                           cfg.ray_block, o, dirs, tables,
                           fused=cfg.fused_generators, interpret=interpret)
        return res.position, res.sd, res.converged

    overflow = jnp.sum(unconv.astype(jnp.int32)) > cap
    return jax.lax.cond(overflow, fallback,
                        lambda args: args, (p, sd, conv))


# ---------------------------------------------------------------------------
# Differentiable wrapper: fused Pallas forward + modular jnp backward.
# ---------------------------------------------------------------------------

from .march_op import ift_ray_weights


def _sd_fn(plan, cfg):
    if cfg.fused_generators:
        from ..core.sdf import scene_sd_fused
        return lambda tb, q: scene_sd_fused(plan, tb, q)
    from ..core.sdf import scene_sd
    return lambda tb, q: scene_sd(plan, tb, q)


def _lambert_replay(plan, cfg, tables, p, n, smask, sfac, aofac):
    """The shared differentiable tail of BOTH backward shading replays:
    per-light Lambert from a (replayed) normal, with the kernel's SAVED
    discrete/stop-gradient factors reapplied — hard-shadow booleans from
    the smask bitfield, or the soft-shadow sfac [R, L] and AO aofac [R]
    constants — then the [saturation, 1] clamp.  One definition keeps
    _replay_shade and _exact_fd_bwd's closure from drifting apart (any
    shading-semantics change lands in exactly one place)."""
    colored = plan.colored_lights
    from ..core import shading as sh
    total = jnp.zeros(p.shape if colored else p.shape[:-1], p.dtype)
    for li in range(int(plan.num_lights)):
        lp = jnp.asarray(tables.light_pos)[li]
        lambert = jnp.sum(n * sh.normalize(lp - p), axis=-1)
        if sfac is not None:
            lambert = lambert * sfac[..., li]
        else:
            shadowed = (smask >> li) & 1
            lambert = jnp.where(shadowed == 1, 0.0, lambert)
        if colored:
            total = total + lambert[..., None] * \
                jnp.asarray(tables.light_color)[li]
        else:
            total = total + lambert
    light = jnp.clip(total, cfg.saturation, 1.0)
    if aofac is not None:
        light = light * (aofac[..., None] if colored else aofac)
    return light if colored else light[..., None]


def _replay_shade(plan, cfg, interpret, tables, p, cidx, smask,
                  sfac=None, aofac=None):
    """Differentiable jnp replay of shading from saved kernel outputs.

    Uses the SAVED discrete decisions (color winner, shadow booleans) so the
    backward transposes exactly the branch the kernel took; continuous parts
    (normal, Lambert, clamp) are recomputed differentiably.  ``sfac``
    [R, L] / ``aofac`` [R] are the kernel's saved soft-shadow / AO factors
    — reapplied as constants (they are stop-gradient by definition, see
    core.shading)."""
    from ..core import shading as sh

    sdf = _sd_fn(plan, cfg)
    sd_one = lambda q: sdf(tables, q)

    p_color_color = take_rows(jnp.asarray(tables.prim_color), cidx)

    # Differentiate the SAME normal estimator the forward kernel evaluated
    # (the analytic winner gradient == reverse-mode through the sd field
    # a.e., so jax.vjp of sd reproduces it; FD replays the 6-eval stencil).
    # The exact-table FD configuration never reaches this replay —
    # _fused_bwd dispatches it to _exact_fd_bwd (single-launch stencil
    # winner kernel) before ever building the shade closure.
    assert cfg.fused_generators or cfg.normal_mode == "analytic", (
        "exact-table FD backward must go through _exact_fd_bwd")
    if cfg.normal_mode == "analytic":
        g = sh.normal_analytic(sd_one, p)
    else:
        g = sh.normal_fd(sd_one, p, cfg.fd_h)
    n = sh.normalize(g)

    light = _lambert_replay(plan, cfg, tables, p, n, smask, sfac, aofac)
    return light * p_color_color


def _blend_bounces(plan, cfg, tables, cidx, light, bounce_shades):
    """Final ray color from the primary shade + per-bounce shade outputs
    (tinted-mirror blend, core.render._shade_rays semantics):

        c_k = color_k * ((1-s) * light_k + s * c_{k+1}),   c_last plain.

    With no bounces this reduces to the plain ``light * color``."""
    s = cfg.reflect_strength
    from .scene_vjp import _fused_candidates, _gather_rows
    rows = (_fused_candidates(plan, False)
            if cfg.fused_generators and plan.kernel is not None else None)

    def col(ci):
        # winner colors by one-hot matmul contraction (misses -> zeros), not
        # a per-ray row gather — the gather costs more than the blend it
        # feeds, and its VJP is a scatter (scene_vjp._gather_rows note)
        return _gather_rows(ci.reshape(-1), jnp.asarray(tables.prim_color),
                            rows).reshape(ci.shape + (3,))

    def lit(li):
        return li if plan.colored_lights else li[..., None]

    if not bounce_shades:
        return lit(light) * col(cidx)
    last = bounce_shades[-1]
    c = lit(last[1]) * col(last[0])
    for shade_b in reversed(bounce_shades[:-1]):
        c = col(shade_b[0]) * ((1.0 - s) * lit(shade_b[1]) + s * c)
    return col(cidx) * ((1.0 - s) * lit(light) + s * c)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def fused_render_op(plan: ScenePlan, cfg: RenderConfig, interpret: bool,
                    tables, origin, dirs):
    """Colors [R, 3] for rays (origin [3], dirs [R, 3]) — one kernel."""
    outs = pallas_render_rays(plan, cfg, origin, dirs, tables,
                              interpret=interpret)
    cidx, light = outs[3], outs[4]
    return _blend_bounces(plan, cfg, tables, cidx, light,
                          outs[8] if len(outs) > 8 else ())


def _save_winner_engaged(plan, cfg) -> bool:
    """Whether the custom-vjp forward saves (sd, widx, g) winner residuals
    from the shade fold — exactly the configurations whose backward is a
    single-launch winner backward (_fused_analytic_bwd /
    _exact_analytic_bwd), so the saved values replace that launch."""
    bounces = cfg.reflect_bounces if cfg.reflect_strength > 0.0 else 0
    return (bounces == 0 and cfg.normal_mode == "analytic"
            and not plan.proc
            and (not cfg.fused_generators or plan.kernel is not None))


def _fused_fwd(plan, cfg, interpret, tables, origin, dirs):
    # Under differentiation the black-lane shadow skip must be OFF: a
    # black winner's pixel is color * light == 0, which kills every
    # cotangent THROUGH light — but d pixel / d color = light itself, and
    # a skipped lane never computed its true shadow state, so the replay
    # could not reconstruct that gradient (a black-initialized primitive
    # would be stuck black under fitting).  custom_vjp gives the exact
    # hook: this fwd rule only ever runs when a vjp is being traced, so
    # forward-only rendering (the primal fused_render_op) keeps the skip.
    cfg = cfg.replace(shade_skip_black=False)
    save_winner = _save_winner_engaged(plan, cfg)
    outs = pallas_render_rays(plan, cfg, origin, dirs, tables,
                              interpret=interpret, save_winner=save_winner)
    p, sd, conv, cidx, light, smask, sfac, aofac = outs[:8]
    wres = outs[8] if save_winner else None
    bounce_res = outs[8] if (len(outs) > 8 and not save_winner) else ()
    out = _blend_bounces(plan, cfg, tables, cidx, light, bounce_res)
    t = jnp.sum((p - origin) * dirs, axis=-1) / jnp.sum(dirs * dirs, axis=-1)
    return out, (tables, origin, dirs, p, sd, conv, cidx, smask, t,
                 sfac, aofac, bounce_res, wres)


def _exact_fd_bwd(plan, cfg, residuals, g_out, interpret):
    """Backward for the default exact-table FD-normal path with ONE kernel
    launch total: a batched winner evaluation over all 7 stencil points
    (hit + 6 FD offsets) supplies

      * the FD normal primal (from the stencil sd values — bitwise the
        same min-fold the forward kernel evaluated),
      * every d scene/d p needed by the FD chain and the IFT route,
      * the winner rows for ONE concatenated parameter scatter.

    Mathematically identical to the modular route (_replay_shade +
    fd_normal_bwd + ift_pieces); the restructure exists because backward
    cost was kernel-dispatch latency, not fold FLOPs (see
    scene_vjp.stencil_eval).  tests/test_scene_vjp.py pins end-to-end
    grads against the jnp oracle."""
    from ..core import shading as sh
    from .scene_vjp import (_segment_add, fd_stencil_cotangents,
                            stencil_eval, theta_cotangents)

    (tables, origin, dirs, p, sd, conv, cidx, smask, t,
     sfac, aofac, _bounce_res, _wres) = residuals
    sd7, widx7, g7, q7 = stencil_eval(plan, cfg, p, tables, interpret,
                                      center=True)
    inv = 1.0 / (2.0 * cfg.fd_h)
    gfd = jnp.stack([(sd7[1 + a] - sd7[4 + a]) * inv for a in range(3)],
                    axis=-1)

    # 1. shading replay from the FD-gradient primal (normalize + Lambert +
    # clamp are plain jnp — jax.vjp transposes them; the sd-field parts
    # are chained by hand below).  The color gather stays OUTSIDE the vjp
    # so its transpose routes through the one-hot segment-add instead of an
    # XLA scatter (scene_vjp._segment_add rationale).
    colored = plan.colored_lights
    # winner colors by one-hot matmul contraction, not a per-ray row gather
    # (see _exact_analytic_bwd)
    from .scene_vjp import _gather_rows
    color_p = _gather_rows(cidx.reshape(-1),
                           jnp.asarray(tables.prim_color)).reshape(
                               cidx.shape + (3,))

    def shade(tables_, p_, gfd_, color_):
        n = sh.normalize(gfd_)
        light = _lambert_replay(plan, cfg, tables_, p_, n, smask, sfac,
                                aofac)
        return light * color_

    _, vjp_shade = jax.vjp(shade, tables, p, gfd, color_p)
    tables_bar, p_bar, gfd_bar, color_bar = vjp_shade(g_out)
    # negative cidx (miss) rows drop out of the one-hot contraction
    pc_bar = _segment_add(cidx.reshape(-1), color_bar.reshape(-1, 3),
                          int(tables.prim_color.shape[0]))
    tables_bar = tables_bar._replace(
        prim_color=tables_bar.prim_color + pc_bar)

    # 2. FD chain: d f(p ± h e_a) cotangents -> p and the winner rows.
    u_fd = fd_stencil_cotangents(cfg, gfd_bar)              # [6, R]
    p_bar = p_bar + jnp.sum(u_fd[..., None] * g7[1:], axis=0)

    # 3. IFT route at the hit point (winner row 0 of the same launch).
    g0 = g7[0]
    denom = jnp.sum(g0 * dirs, axis=-1)
    t_bar = jnp.where(conv, jnp.sum(p_bar * dirs, axis=-1), 0.0)
    w = ift_ray_weights(t_bar, denom, cfg.ift_damping)
    gp_w = w[..., None] * g0

    # 4. one concatenated scatter for all 7 rows' parameter cotangents
    u_all = jnp.concatenate([w[None], u_fd])                # [7, R]
    tables_bar2 = theta_cotangents(plan, tables, widx7, g7, u_all,
                                   sd=sd7, p=q7)

    # a [3] origin broadcast over rays sums its cotangent; a [R, 3]
    # per-ray origin keeps it per ray (api.render_rays bundles)
    o_bar = (p_bar + gp_w if jnp.ndim(origin) == 2 else
             jnp.sum(p_bar + gp_w, axis=tuple(range(p.ndim - 1))))
    d_bar = t[..., None] * (p_bar + gp_w)
    tables_bar = jax.tree_util.tree_map(jnp.add, tables_bar, tables_bar2)
    return tables_bar, o_bar, d_bar


def _exact_analytic_bwd(plan, cfg, residuals, g_out, interpret):
    """Backward for the exact-table ANALYTIC-normal path with ONE kernel
    launch total (vs _exact_fd_bwd's 7-point stencil): the combined winner
    evaluation at the hit supplies the analytic-normal primal g0, the IFT
    gradient, and the winner rows; the normal's own VJP is the closed-form
    winner-Hessian chain (scene_vjp.winner_hessian_chain — sphere
    curvature, flat box/cross).  Dense prim types only; plans with
    procedural leaves fall back to the jnp replay (dispatched in
    _fused_bwd)."""
    from ..core import shading as sh
    from .scene_vjp import (_gather_rows, _segment_add, theta_cotangents,
                            winner_eval, winner_hessian_chain)

    (tables, origin, dirs, p, sd, conv, cidx, smask, t,
     sfac, aofac, _bounce_res, wres) = residuals
    # Winner residuals saved by the custom-vjp forward (the shade fold's
    # own (sd, widx, g) at the hit — bit-identical to a fresh winner
    # launch) make this a ZERO-launch backward; absent, launch one.
    if wres is not None:
        sd0, widx0, g0 = wres
    else:
        sd0, widx0, g0 = winner_eval(plan, cfg, p, tables, interpret)

    # 1. shading replay from the analytic-gradient primal (see
    # _exact_fd_bwd step 1 — identical structure, g0 in place of gfd).
    # Winner colors by one-hot contraction, NOT jnp row gather (a
    # per-ray gather can cost more than the reduction it feeds; misses
    # return zeros).
    color_p = _gather_rows(cidx.reshape(-1),
                           jnp.asarray(tables.prim_color)).reshape(
                               cidx.shape + (3,))

    def shade(tables_, p_, g_, color_):
        n = sh.normalize(g_)
        light = _lambert_replay(plan, cfg, tables_, p_, n, smask, sfac,
                                aofac)
        return light * color_

    _, vjp_shade = jax.vjp(shade, tables, p, g0, color_p)
    tables_bar, p_bar, g_bar, color_bar = vjp_shade(g_out)
    pc_bar = _segment_add(cidx.reshape(-1), color_bar.reshape(-1, 3),
                          int(tables.prim_color.shape[0]))
    tables_bar = tables_bar._replace(
        prim_color=tables_bar.prim_color + pc_bar)

    # 2. analytic-normal chain: closed-form winner Hessian.
    hess_p_bar, rows, hidx = winner_hessian_chain(plan, tables, widx0, g0,
                                                  g_bar, sd0)
    p_bar = p_bar + hess_p_bar

    # 3. IFT route at the hit point (same winner launch).
    denom = jnp.sum(g0 * dirs, axis=-1)
    t_bar = jnp.where(conv, jnp.sum(p_bar * dirs, axis=-1), 0.0)
    w = ift_ray_weights(t_bar, denom, cfg.ift_damping)
    gp_w = w[..., None] * g0

    # 4. parameter scatters: IFT winner rows + the Hessian's center rows.
    tables_bar2 = theta_cotangents(plan, tables, widx0, g0, w,
                                   sd=sd0, p=p)
    pos_hess = _segment_add(hidx, rows, int(tables.prim_pos.shape[0]))
    tables_bar2 = tables_bar2._replace(
        prim_pos=tables_bar2.prim_pos + pos_hess)

    o_bar = (p_bar + gp_w if jnp.ndim(origin) == 2 else
             jnp.sum(p_bar + gp_w, axis=tuple(range(p.ndim - 1))))
    d_bar = t[..., None] * (p_bar + gp_w)
    tables_bar = jax.tree_util.tree_map(jnp.add, tables_bar, tables_bar2)
    return tables_bar, o_bar, d_bar


def _fused_analytic_bwd(plan, cfg, residuals, g_out, interpret):
    """Backward for the FUSED-generator analytic-normal path (the bench
    headline regime) with ONE kernel launch total, replacing the jnp
    replay that re-evaluated the folded field several times per ray
    (normal_analytic is reverse-over-reverse of scene_sd_fused).  Identical structure to
    _exact_analytic_bwd, with the fused twins: the combined winner kernel
    runs on the FOLDED field and may report extended carve-winner ids;
    theta algebra and the normal's Hessian chain dispatch on the winner
    kind (scene_vjp._fused_statics).  Dense prim types only (plans with
    procedural leaves keep the replay, dispatched in _fused_bwd)."""
    from ..core import shading as sh
    from .scene_vjp import (_fused_candidates, _gather_rows,
                            _segment_add_rows, fused_theta_cotangents,
                            fused_winner_eval,
                            fused_winner_hessian_chain)

    (tables, origin, dirs, p, sd, conv, cidx, smask, t,
     sfac, aofac, _bounce_res, wres) = residuals
    # Winner residuals saved by the custom-vjp forward (see
    # _exact_analytic_bwd) make this a ZERO-launch backward.
    if wres is not None:
        sd0, widx0, g0 = wres
    else:
        sd0, widx0, g0 = fused_winner_eval(plan, cfg, p, tables, interpret)

    # winner colors by one-hot matmul contraction over the ~10 fused color
    # candidates (see _exact_analytic_bwd — never a per-ray row gather)
    color_p = _gather_rows(cidx.reshape(-1),
                           jnp.asarray(tables.prim_color),
                           _fused_candidates(plan, False)).reshape(
                               cidx.shape + (3,))

    def shade(tables_, p_, g_, color_):
        n = sh.normalize(g_)
        light = _lambert_replay(plan, cfg, tables_, p_, n, smask, sfac,
                                aofac)
        return light * color_

    _, vjp_shade = jax.vjp(shade, tables, p, g0, color_p)
    tables_bar, p_bar, g_bar, color_bar = vjp_shade(g_out)
    # fused color winners are always group-base or dense rows
    # (_scene_sd_idx_tile) — the one-hot spans those candidates only
    pc_bar = _segment_add_rows(cidx.reshape(-1), color_bar.reshape(-1, 3),
                               int(tables.prim_color.shape[0]),
                               _fused_candidates(plan, False))
    tables_bar = tables_bar._replace(
        prim_color=tables_bar.prim_color + pc_bar)

    # analytic-normal chain: closed-form winner Hessian on the folded
    # field (curved = spheres + the DeathStar's derived carve sphere).
    hess_p_bar, hess_pos, hess_aux = fused_winner_hessian_chain(
        plan, tables, widx0, g0, g_bar, sd0)
    p_bar = p_bar + hess_p_bar

    # IFT route at the hit point (same winner launch).
    denom = jnp.sum(g0 * dirs, axis=-1)
    t_bar = jnp.where(conv, jnp.sum(p_bar * dirs, axis=-1), 0.0)
    w = ift_ray_weights(t_bar, denom, cfg.ift_damping)
    gp_w = w[..., None] * g0

    tables_bar2 = fused_theta_cotangents(plan, tables, widx0, g0, w,
                                         sd=sd0, p=p)
    tables_bar2 = tables_bar2._replace(
        prim_pos=tables_bar2.prim_pos + hess_pos,
        prim_aux=tables_bar2.prim_aux + hess_aux)

    o_bar = (p_bar + gp_w if jnp.ndim(origin) == 2 else
             jnp.sum(p_bar + gp_w, axis=tuple(range(p.ndim - 1))))
    d_bar = t[..., None] * (p_bar + gp_w)
    tables_bar = jax.tree_util.tree_map(jnp.add, tables_bar, tables_bar2)
    return tables_bar, o_bar, d_bar


def _anchored_hit(plan, cfg, p_saved, conv_saved):
    """Differentiable surrogate for "march from (o, d) to the surface",
    anchored at a kernel-saved hit point: the primal just returns
    ``p_saved`` (bitwise the mega kernel's own march result), while the
    VJP applies the implicit-function cotangent rule at that point —
    t* satisfies f(o + t* d) = eps, so dt*/d(theta, o, d) flows through
    grad f at the hit (ops.march_op semantics, damped per
    cfg.ift_damping).  Unconverged lanes contribute no t-cotangent; their
    p_bar still flows to the origin (p = o + sum(steps) d exactly as in
    _fused_bwd's primary route)."""
    sdf = _sd_fn(plan, cfg)

    @jax.custom_vjp
    def hit(tables, o, d):
        return p_saved

    def fwd(tables, o, d):
        return p_saved, (tables, o, d)

    def bwd(res, p_bar):
        tables, o, d = res
        _, vjp_f = jax.vjp(lambda tb, q: sdf(tb, q), tables, p_saved)
        ones = jnp.ones(p_saved.shape[:-1], p_saved.dtype)
        _, grad_p = vjp_f(ones)
        denom = jnp.sum(grad_p * d, axis=-1)
        t_bar = jnp.where(conv_saved, jnp.sum(p_bar * d, axis=-1), 0.0)
        w = ift_ray_weights(t_bar, denom, cfg.ift_damping)
        tb_bar, gp_w = vjp_f(w)
        t = (jnp.sum((p_saved - o) * d, axis=-1)
             / jnp.sum(d * d, axis=-1))
        adj = p_bar + gp_w
        return tb_bar, adj, t[..., None] * adj

    hit.defvjp(fwd, bwd)
    return hit


def _reflect_bwd(plan, cfg, interpret, residuals, g_out):
    """Backward for reflect configs on the mega kernel: one differentiable
    jnp replay of the WHOLE bounce chain (core.render._shade_rays
    semantics), with every march replaced by an ``_anchored_hit`` at the
    kernel-saved per-bounce hit point.  ``jax.vjp`` of the chain then
    transposes everything the recursion couples — including the
    second-order terms through the reflected direction d' = d - 2(d.n)n,
    where n itself is a field gradient (FD stencil or analytic, matching
    cfg.normal_mode) — so scene parameters receive cotangents from every
    bounce, not just the primary shade.

    The field evals ride the jnp scene field (scene_sd / scene_sd_fused),
    i.e. the same route the multi-kernel 'pallas' backend differentiates
    bounces through; the winner-kernel fast path (ops.scene_vjp) stays
    reserved for the reflection-free default."""
    from ..core import shading as sh

    (tables, origin, dirs, p, sd, conv, cidx, smask, t,
     sfac, aofac, bounce_res, _wres) = residuals
    anchors = [(p, conv, cidx, smask, sfac, aofac)]
    for br in bounce_res:
        cidx_b, _light_b, smask_b, sfac_b, aofac_b, p_b, _sd_b, conv_b = br
        anchors.append((p_b, conv_b, cidx_b, smask_b, sfac_b, aofac_b))
    hits = [_anchored_hit(plan, cfg, a[0], a[1]) for a in anchors]
    sdf = _sd_fn(plan, cfg)
    s = cfg.reflect_strength
    off = cfg.surface_precision + cfg.offset_precision

    def chain(tables_, origin_, dirs_):
        o = jnp.broadcast_to(origin_, dirs_.shape)
        d = dirs_
        cols, lits = [], []
        for b, (_, _, cidx_b, smask_b, sfac_b, aofac_b) in \
                enumerate(anchors):
            ph = hits[b](tables_, o, d)
            sd_one = lambda q: sdf(tables_, q)
            if cfg.normal_mode == "analytic":
                g = sh.normal_analytic(sd_one, ph)
            else:
                g = sh.normal_fd(sd_one, ph, cfg.fd_h)
            n = sh.normalize(g)
            lits.append(_lambert_replay(plan, cfg, tables_, ph, n, smask_b,
                                        sfac_b, aofac_b))
            cols.append(take_rows(jnp.asarray(tables_.prim_color), cidx_b))
            if b + 1 < len(anchors):
                ddot = jnp.sum(d * n, axis=-1, keepdims=True)
                d = d - 2.0 * ddot * n
                o = ph + off * n
        c = lits[-1] * cols[-1]
        for b in reversed(range(len(anchors) - 1)):
            c = cols[b] * ((1.0 - s) * lits[b] + s * c)
        return c

    _, vjp = jax.vjp(chain, tables, origin, dirs)
    return vjp(g_out)


def _fused_bwd(plan, cfg, interpret, residuals, g_out):
    if cfg.reflect_strength > 0.0:
        return _reflect_bwd(plan, cfg, interpret, residuals, g_out)

    # (No black-lane handling here: _fused_fwd disables the shadow skip
    # under differentiation, so every residual row is real and gradients
    # — including d loss / d prim_color of black primitives — are exact.)
    if not cfg.fused_generators and cfg.normal_mode == "fd":
        return _exact_fd_bwd(plan, cfg, residuals, g_out, interpret)
    if not cfg.fused_generators and not plan.proc:
        # analytic normals on dense exact tables: single-launch backward
        # with the closed-form winner-Hessian normal chain.
        return _exact_analytic_bwd(plan, cfg, residuals, g_out, interpret)
    if (cfg.fused_generators and cfg.normal_mode == "analytic"
            and not plan.proc and plan.kernel is not None):
        # the headline regime: single-launch winner backward on the
        # FOLDED field (extended carve-winner ids).
        return _fused_analytic_bwd(plan, cfg, residuals, g_out, interpret)

    (tables, origin, dirs, p, sd, conv, cidx, smask, t,
     sfac, aofac, _bounce_res, _wres) = residuals

    # 1. Transpose the shading replay w.r.t. (tables, p).  The ray
    # direction enters shading only through the saved discrete color
    # winner, so it carries no shading cotangent.
    def shade(tables_, p_):
        return _replay_shade(plan, cfg, interpret, tables_, p_, cidx, smask,
                             sfac, aofac)

    _, vjp_shade = jax.vjp(shade, tables, p)
    tables_bar, p_bar = vjp_shade(g_out)

    # 2. Implicit-function route for the hit point (see ops.march_op).
    if not cfg.fused_generators:
        # Exact tables: winner-kernel route (ops.scene_vjp) — one combined
        # fold pass + a segment-sum; no [rays, prims] matrix.
        from .scene_vjp import ift_pieces
        tables_bar2, gp_w = ift_pieces(plan, cfg, interpret, p, dirs, conv,
                                       p_bar, tables)
    else:
        sdf = _sd_fn(plan, cfg)
        _, vjp_f = jax.vjp(lambda tb, q: sdf(tb, q), tables, p)
        ones = jnp.ones(p.shape[:-1], p.dtype)
        _, grad_p = vjp_f(ones)
        denom = jnp.sum(grad_p * dirs, axis=-1)
        t_bar = jnp.where(conv, jnp.sum(p_bar * dirs, axis=-1), 0.0)
        w = ift_ray_weights(t_bar, denom, cfg.ift_damping)
        tables_bar2, gp_w = vjp_f(w)

    # a [3] origin broadcast over rays sums its cotangent; a [R, 3]
    # per-ray origin keeps it per ray (api.render_rays bundles)
    o_bar = (p_bar + gp_w if jnp.ndim(origin) == 2 else
             jnp.sum(p_bar + gp_w, axis=tuple(range(p.ndim - 1))))
    d_bar = t[..., None] * (p_bar + gp_w)
    tables_bar = jax.tree_util.tree_map(jnp.add, tables_bar, tables_bar2)
    return tables_bar, o_bar, d_bar


fused_render_op.defvjp(_fused_fwd, _fused_bwd)
