"""High-level rendering API with backend dispatch.

Backends (RenderConfig.backend or the ``backend=`` argument):
  * ``"ref"``    — pure-jnp oracle: scan/while march, autodiff by unrolling.
    The allclose ground truth (the analogue of the reference CPU path).
  * ``"jnp"``    — fast path on XLA: while-loop forward march wrapped in the
    implicit-function custom VJP (ops.march_op).
  * ``"pallas"`` — fused Pallas kernels for the march, shadow rays
    (with exact early termination at the light), surface color lookup, and
    finite-difference normals; IFT backward, with normals backpropagated by
    rematerializing the jnp FD formula.
  * ``"mega"``   — the whole per-ray pipeline (march + color + FD normal +
    shadows + Lambert) in ONE pallas_call per ray chunk
    (ops.pallas_render); same IFT backward replayed from saved kernel
    outputs.  Fastest.  Depth<=2 scenes compile the two-level normal form
    with culling; deeper trees compile the generic post-order evaluator
    (ops.pallas_march.kernel_key) — every grammar-expressible scene runs
    on the kernel path.
  * ``"auto"``   — mega on a GPU, jnp on the CPU; any other platform
    raises.

Every kernel entry point takes ``interpret=None``: the kernels run in the
Pallas interpreter exactly when the default JAX backend is the CPU
(ops.pallas_march.resolve_interpret), never on a GPU.
"""

from __future__ import annotations

from functools import partial

import math
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from .config import RenderConfig
from .core import shading
from .core.render import render_image
from .core.sdf import scene_sd, take_rows
from .ops.march_op import make_march_fn
from .scene.compile import ScenePlan, SceneTables
from .scene.parser import Scene


def resolve_backend(backend: str) -> str:
    """``"auto"`` -> the mega kernel path on a GPU, ``jnp`` on the CPU;
    any other platform raises.  Explicit backends pass through."""
    if backend != "auto":
        return backend
    platform = jax.default_backend()
    if platform == "gpu":
        return "mega"
    if platform == "cpu":
        return "jnp"
    raise RuntimeError(f"backend='auto' has no path for platform "
                       f"{platform!r} (gpu or cpu)")


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def _normal_op(plan: ScenePlan, cfg: RenderConfig, interpret, p, tables):
    """Scene gradient (FD stencil or analytic winner gradient, per
    cfg.normal_mode): Pallas forward, jnp-rematerialized backward."""
    from .ops.pallas_march import kernel_key, pallas_surface_eval

    _, _, g = pallas_surface_eval(
        kernel_key(plan), cfg.fd_h, cfg.ray_block,
        p.reshape(-1, 3), tables,
        with_color=False, with_normal=True, fused=cfg.fused_generators,
        analytic=cfg.normal_mode == "analytic", interpret=interpret)
    return g.reshape(p.shape)


def _normal_fwd(plan, cfg, interpret, p, tables):
    return _normal_op(plan, cfg, interpret, p, tables), (p, tables)


def _normal_bwd(plan, cfg, interpret, residuals, g_bar):
    p, tables = residuals
    if not cfg.fused_generators and cfg.normal_mode != "analytic":
        # Exact-table FD path: six winner-kernel passes + segment-sums
        # (ops.scene_vjp) — no [rays, prims] matrix in the backward.
        from .ops.scene_vjp import fd_normal_bwd
        return fd_normal_bwd(plan, cfg, interpret, p, tables, g_bar)
    if not cfg.fused_generators and not plan.proc:
        # Exact-table analytic path (dense prim types): the winner
        # gradient's derivative is local and closed-form (sphere Hessian,
        # flat box/cross) — one winner pass + one segment-add; procedural
        # leaves have no closed-form Hessian and take the replay below.
        from .ops.scene_vjp import analytic_normal_bwd
        return analytic_normal_bwd(plan, cfg, interpret, p, tables, g_bar)
    if (cfg.fused_generators and cfg.normal_mode == "analytic"
            and not plan.proc and plan.kernel is not None):
        # Fused-field analytic: same closed-form chain on the folded
        # field (extended carve-winner ids — scene_vjp._fused_statics).
        from .ops.scene_vjp import fused_analytic_normal_bwd
        return fused_analytic_normal_bwd(plan, cfg, interpret, p, tables,
                                         g_bar)
    # Differentiate the SAME field the forward kernel evaluated: folded
    # generators when fused mode is on (also ~60x cheaper to transpose),
    # and the SAME estimator (the analytic winner gradient is reverse-mode
    # through the sd field a.e., so jax.grad of sd reproduces it).
    from .core.sdf import scene_sd_fused

    def estimator(p_, tables_):
        if cfg.fused_generators:
            sd_fn = lambda q: scene_sd_fused(plan, tables_, q)
        else:
            sd_fn = lambda q: scene_sd(plan, tables_, q)
        if cfg.normal_mode == "analytic":
            return shading.normal_analytic(sd_fn, p_)
        return shading.normal_fd(sd_fn, p_, cfg.fd_h)

    _, vjp = jax.vjp(estimator, p, tables)
    return vjp(g_bar)


_normal_op.defvjp(_normal_fwd, _normal_bwd)


def make_render_hooks(plan: ScenePlan, tables: SceneTables,
                      cfg: RenderConfig, backend: str, *,
                      interpret: Optional[bool] = None) -> dict:
    """Build the fused-implementation hooks for core.render.render_image."""
    backend = resolve_backend(backend)
    if backend == "ref":
        return {}

    sd_fn = lambda tb, p: scene_sd(plan, tb, p)
    if backend == "jnp":
        return {"march_fn": make_march_fn(
            sd_fn, cfg.iterations, cfg.surface_precision, tables,
            damping=cfg.ift_damping)}
    if backend != "pallas":
        raise ValueError(f"unknown backend {backend!r}")

    from .ops.pallas_march import (kernel_key, make_pallas_march,
                                   pallas_march, pallas_surface_eval)

    if cfg.fused_generators:
        # IFT backward must differentiate the same (folded) field the
        # kernel marched — and its f_theta transpose then costs O(active
        # prims), not O(20^k).
        from .core.sdf import scene_sd_fused
        sd_fn = lambda tb, p: scene_sd_fused(plan, tb, p)

    forward_impl = make_pallas_march(plan, cfg, interpret=interpret)
    if cfg.fused_generators:
        bwd_impl = None        # folded-field jnp backward is already cheap
    else:
        from .ops.scene_vjp import make_march_bwd
        bwd_impl = make_march_bwd(plan, cfg, interpret)
    march_fn = make_march_fn(sd_fn, cfg.iterations, cfg.surface_precision,
                             tables, forward_impl=forward_impl,
                             bwd_impl=bwd_impl, damping=cfg.ift_damping)

    # Kernels invoked outside a custom_vjp must see stop-gradient inputs —
    # pallas_call has no JVP rule, and these uses are piecewise-constant /
    # boolean anyway (shadow test, color argmin).
    sg_tables = jax.tree_util.tree_map(lax.stop_gradient, tables)

    def shadow_fn(o, d, tmax):
        o, d, tmax = map(lax.stop_gradient, (o, d, tmax))
        shape = o.shape
        res = pallas_march(kernel_key(plan), cfg.iterations,
                           cfg.surface_precision,
                           cfg.ray_block, o.reshape(-1, 3),
                           d.reshape(-1, 3), sg_tables,
                           tmax=tmax.reshape(-1),
                           fused=cfg.fused_generators, interpret=interpret)
        from .core.march import MarchResult
        return MarchResult(position=res.position.reshape(shape),
                           sd=res.sd.reshape(shape[:-1]),
                           converged=res.converged.reshape(shape[:-1]))

    def surface_fn(p):
        flat = lax.stop_gradient(p.reshape(-1, 3))
        sd, cidx, _ = pallas_surface_eval(
            kernel_key(plan), cfg.fd_h, cfg.ray_block, flat, sg_tables,
            with_color=True, with_normal=False,
            fused=cfg.fused_generators, interpret=interpret)
        color = take_rows(jnp.asarray(tables.prim_color), cidx)
        return (sd.reshape(p.shape[:-1]),
                color.reshape(p.shape[:-1] + (3,)))

    def normal_fn(p):
        return _normal_op(plan, cfg, interpret, p, tables)

    # Both normal modes route through the Pallas surface kernel (FD stencil
    # or in-kernel analytic winner gradient) — never the jnp scene_sd,
    # whose [rays, prims] leaf matrix the kernel path exists to avoid.
    return {"march_fn": march_fn, "shadow_fn": shadow_fn,
            "surface_fn": surface_fn, "normal_fn": normal_fn}


# XLA compile time grows steeply with the lax.map chunk count, so the
# caller's ray_chunk is treated as a MINIMUM granule and coarsened until
# the map length fits (chunking exists to bound the backward's per-chunk
# working set); alignment to the kernel's ray block keeps chunks
# block-exact.
_MAX_CHUNKS = 64


def _effective_chunk(cfg: RenderConfig, R: int) -> int:
    chunk = cfg.ray_chunk
    if not chunk or R <= chunk:
        return chunk
    if math.ceil(R / chunk) <= _MAX_CHUNKS:
        return chunk
    align = cfg.ray_block
    return math.ceil(math.ceil(R / _MAX_CHUNKS) / align) * align


def _render_mega(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
                 interpret, ray_perm=None) -> jnp.ndarray:
    """Single-kernel render: the whole per-ray pipeline in one pallas_call
    (ops.pallas_render), SSAA averaging outside.

    Rays are processed in ray_chunk blocks via lax.map (no remat — the
    custom VJP already saves exactly its residuals): the backward for a
    mapped chunk does many small color scatter-adds instead of one giant
    one, and the chunk bounds the backward's working set."""
    from .core import camera as cam
    from .core.order import (block_dims, from_blocked, resolve_ray_order,
                             to_blocked)
    from .ops.pallas_render import fused_render_op

    S = cfg.samples_per_pixel
    R = cfg.height * cfg.width * S
    if (cfg.serve_raygen and ray_perm is None and R < 2 ** 31):
        # Serving fast path: directions generated IN the kernel
        # (ops.pallas_render._raygen_dirs; RenderConfig.serve_raygen).
        # Primal-only — differentiating through it fails loudly (no VJP).
        return _render_mega_serve(plan, tables, cfg, interpret, R, S)
    origin, dirs = cam.generate_rays(tables, cfg)
    flat = dirs.reshape(R, 3)

    # Block ray order (bit-exact, see core.order): kernel blocks cover
    # compact pixel blocks instead of image-row runs, so a block's slowest
    # lane is a near neighbour, not a fractal pixel far away.
    bdims = (block_dims(cfg.height, cfg.width, S, cfg.ray_block)
             if resolve_ray_order(cfg, "mega") else None)
    if bdims is not None:
        flat = to_blocked(flat, cfg.height, cfg.width, S, *bdims)

    # Cost-ordered block scheduling (opt-in via ray_perm, see
    # plan_cost_order): permute 128-ray rows so each kernel block holds
    # similar-cost rows.  Bit-exact (outputs inverse-permuted below) and
    # scatter-free in the backward (core.order.row_permuters).
    apply_perm = invert_perm = None
    if ray_perm is not None:
        from .core.order import PERM_ROW, row_permuters
        if len(ray_perm) * PERM_ROW != R:
            raise ValueError(f"ray_perm has {len(ray_perm)} rows; frame "
                             f"needs {R // PERM_ROW}")
        apply_perm, invert_perm = row_permuters(ray_perm)
        flat = apply_perm(flat)

    chunk = _effective_chunk(cfg, R)
    if chunk and R > chunk:
        pad = (-R) % chunk
        padded = jnp.concatenate(
            [flat, jnp.broadcast_to(flat[-1:], (pad, 3))]) if pad else flat
        blocks = padded.reshape(-1, chunk, 3)
        colors = jax.lax.map(
            lambda d: fused_render_op(plan, cfg, interpret, tables,
                                      origin, d), blocks)
        colors = colors.reshape(-1, 3)[:R]
    else:
        colors = fused_render_op(plan, cfg, interpret, tables, origin, flat)
    if invert_perm is not None:
        colors = invert_perm(colors)
    if bdims is not None:
        colors = from_blocked(colors, cfg.height, cfg.width, S, *bdims)
    return jnp.mean(colors.reshape(cfg.height, cfg.width, S, 3), axis=2)


def _render_mega_serve(plan: ScenePlan, tables: SceneTables,
                       cfg: RenderConfig, interpret,
                       R: int, S: int) -> jnp.ndarray:
    """Serving fast path (RenderConfig.serve_raygen): the mega kernel
    generates its own ray directions from the ray index, so the frame
    skips the jnp raygen pass, the to_blocked reorder, and the [R, 3]
    HBM dirs stream entirely — each chunk is just a kernel launch keyed
    by its base ray index.  Output rays come back in the kernel's own
    (block-major) layout and are un-blocked here; images match the
    standard path to raygen ulps (bench.py gates them)."""
    from .core.order import block_dims, from_blocked, resolve_ray_order
    from .ops.pallas_render import serve_render_chunk

    bdims = (block_dims(cfg.height, cfg.width, S, cfg.ray_block)
             if resolve_ray_order(cfg, "mega") else None)
    bh, bw = bdims if bdims is not None else (0, 0)
    raygen = (cfg.width, cfg.height, cfg.ssaa, bh, bw)
    chunk = _effective_chunk(cfg, R)
    if chunk and R > chunk:
        pad = (-R) % chunk
        bases = jnp.arange((R + pad) // chunk, dtype=jnp.int32) * chunk
        colors = jax.lax.map(
            lambda b: serve_render_chunk(plan, cfg, tables, raygen, b,
                                         chunk, interpret), bases)
        colors = colors.reshape(-1, 3)[:R]
    else:
        colors = serve_render_chunk(plan, cfg, tables, raygen,
                                    jnp.int32(0), R, interpret)
    if bdims is not None:
        colors = from_blocked(colors, cfg.height, cfg.width, S, *bdims)
    return jnp.mean(colors.reshape(cfg.height, cfg.width, S, 3), axis=2)


def plan_cost_order(plan: ScenePlan, tables: SceneTables,
                    cfg: RenderConfig, *, forward_only: bool = False,
                    interpret: Optional[bool] = None):
    """Predict per-row frame cost and return the 128-ray row permutation
    for cost-ordered block scheduling (``render_tables(..., ray_perm=)``).

    The cost model is the WHOLE per-ray pipeline, not just the primary
    march: primary steps + every light's shadow-march steps (from the hit
    point, lifted off the surface exactly like the shade body).  Ordering
    by primary steps alone makes blocks homogeneous in march cost but
    HETEROGENEOUS in shadow cost (rays with equal primary cost come from
    all over the image), so the shadow straggler eats the win.
    ``forward_only`` additionally models the black-lane shadow skip (those
    lanes' shadow marches are free in serving renders, and the skip is
    disabled under differentiation — match the regime you schedule for).

    The prepass costs a few forward marches — amortize it across a
    training run or a static-camera serving loop (the reference's fit
    loop holds the camera fixed for the whole optimization).  Stale costs
    (scene params drifting during a fit) degrade only SPEED, never
    results: the image is bit-exact under ANY permutation.  Returns a
    host numpy int32 array; pass it to render_tables unchanged (it is
    folded into the jit as a constant).

    Not the default: the frame's three march phases (primary, shadow x2)
    have nearly independent divergence patterns, so no single ordering
    reduces TOTAL issued work, and permuting block order costs memory
    locality by itself.  Kept for single-phase workloads (shadowless
    serving, standalone marches, extreme-divergence fractals) where the
    composition gain can dominate.  Unmeasured on the GPU.
    """
    import numpy as np

    from .core import camera as cam
    from .core.order import (block_dims, resolve_ray_order, row_cost_perm,
                             to_blocked)
    from .ops.pallas_march import kernel_key, pallas_march, pallas_surface_eval
    from .ops.pallas_render import black_skip_ids

    kp = kernel_key(plan)
    origin, dirs = cam.generate_rays(tables, cfg)
    S = cfg.samples_per_pixel
    R = cfg.height * cfg.width * S
    flat = dirs.reshape(R, 3)
    bdims = (block_dims(cfg.height, cfg.width, S, cfg.ray_block)
             if resolve_ray_order(cfg, "mega") else None)
    if bdims is not None:
        flat = to_blocked(flat, cfg.height, cfg.width, S, *bdims)
    black = black_skip_ids(plan, cfg) if forward_only else ()
    tiny = float(np.finfo(np.float32).tiny)

    @jax.jit
    def _cost(o, d, tb):
        res, steps = pallas_march(
            kp, cfg.iterations, cfg.surface_precision, cfg.ray_block,
            o, d, tb, fused=cfg.fused_generators, with_steps=True,
            interpret=interpret)
        cost = steps.astype(jnp.float32)
        if not cfg.shadows:
            return cost
        p = res.position
        _, cidx, g = pallas_surface_eval(
            kp, cfg.fd_h, cfg.ray_block, p, tb,
            with_color=bool(black), with_normal=True,
            fused=cfg.fused_generators, analytic=True, interpret=interpret)
        n = g / jnp.maximum(jnp.linalg.norm(g, axis=-1, keepdims=True),
                            tiny)
        s = p + n * (cfg.surface_precision + cfg.offset_precision)
        shadow = jnp.zeros_like(cost)
        for li in range(plan.num_lights):
            r = tb.light_pos[li][None, :] - s
            tmax = jnp.linalg.norm(r, axis=-1)
            rd = r / jnp.maximum(tmax, tiny)[:, None]
            _, ssteps = pallas_march(
                kp, cfg.iterations, cfg.surface_precision,
                cfg.ray_block, s, rd, tb, tmax=tmax,
                fused=cfg.fused_generators, with_steps=True,
                interpret=interpret)
            shadow = shadow + ssteps.astype(jnp.float32)
        if black:
            skip = cidx < 0
            for k in black:
                skip = jnp.logical_or(skip, cidx == k)
            shadow = jnp.where(skip, 0.0, shadow)
        return cost + shadow

    o = jnp.broadcast_to(jnp.asarray(origin, jnp.float32), flat.shape)
    return row_cost_perm(np.asarray(_cost(o, flat, tables)))


def render_tables(plan: ScenePlan, tables: SceneTables,
                  cfg: Optional[RenderConfig] = None, *,
                  backend: Optional[str] = None,
                  differentiable: bool = False,
                  interpret: Optional[bool] = None,
                  ray_perm=None) -> jnp.ndarray:
    """Render compiled tables -> [H, W, 3].  Differentiable w.r.t. every
    array in ``tables`` on all backends (IFT backward on the fast paths,
    unrolled autodiff on ``ref`` with differentiable=True).

    ``ray_perm``: optional host int array of 128-ray row indices
    (from ``plan_cost_order``) enabling cost-ordered block scheduling on
    the mega backend — bit-exact, speed-only (see core.order)."""
    cfg = cfg or RenderConfig()
    backend = resolve_backend(backend or cfg.backend)
    if backend == "pallas" and (cfg.soft_shadow_k > 0.0
                                or cfg.ao_strength > 0.0):
        # The multi-kernel pallas path has no soft-shadow/AO hook — its
        # shading would silently fall back to soft_shadow_factor over the
        # jnp scene_sd, re-marching every shadow ray through the
        # [rays, prims] leaf matrix (the working set the kernel path
        # exists to avoid).  The mega kernel tracks the penumbra factor
        # in-kernel; route there (it is the auto choice on a GPU anyway).
        backend = "mega"
    if ray_perm is not None and (backend != "mega" or cfg.aperture > 0.0):
        raise ValueError("ray_perm (cost-ordered scheduling) rides the "
                         "mega pinhole path only")
    if cfg.aperture > 0.0:
        return _render_dof(plan, tables, cfg, backend, differentiable,
                           interpret)
    if backend == "mega":
        return _render_mega(plan, tables, cfg, interpret, ray_perm=ray_perm)
    hooks = make_render_hooks(plan, tables, cfg, backend,
                              interpret=interpret)
    return render_image(plan, tables, cfg,
                        differentiable=differentiable and backend == "ref",
                        **hooks)


def _render_dof(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
                backend: str, differentiable: bool,
                interpret) -> jnp.ndarray:
    """Thin-lens depth of field (cfg.aperture > 0): the frame becomes one
    per-ray-origin bundle — every SSAA sample carries its lens-disk origin
    and focal-point direction (core.camera.generate_rays_dof) — and the
    ordinary SSAA mean integrates over the lens.  Mega rides render_rays
    (per-ray-origin streams, cfg.ray_chunk honored); ref/jnp/pallas
    ride the hook layer, whose marches already accept [R, 3] origins
    (the reflection recursion relies on it)."""
    from .core import camera as cam
    from .core.order import (block_dims, from_blocked, resolve_ray_order,
                             to_blocked)
    from .core.render import _shade_rays

    o, d = cam.generate_rays_dof(tables, cfg)
    S = cfg.samples_per_pixel
    R = cfg.height * cfg.width * S
    o, d = o.reshape(R, 3), d.reshape(R, 3)
    bdims = (block_dims(cfg.height, cfg.width, S, cfg.ray_block)
             if resolve_ray_order(cfg, backend) else None)
    if bdims is not None:
        o = to_blocked(o, cfg.height, cfg.width, S, *bdims)
        d = to_blocked(d, cfg.height, cfg.width, S, *bdims)
    if backend == "mega":
        colors = render_rays(plan, tables, o, d, cfg, interpret=interpret)
    else:
        hooks = make_render_hooks(plan, tables, cfg, backend,
                                  interpret=interpret)
        diff = differentiable and backend == "ref"

        def shade(oo, dd):
            return _shade_rays(plan, tables, cfg, oo, dd,
                               differentiable=diff, **hooks)

        chunk = _effective_chunk(cfg, R)
        if chunk and R > chunk:
            pad = (-R) % chunk

            def padto(x):
                return (jnp.concatenate(
                    [x, jnp.broadcast_to(x[-1:], (pad, 3))]) if pad else x)

            policy = jax.checkpoint_policies.save_only_these_names("march")
            colors = lax.map(
                jax.checkpoint(lambda od: shade(od[0], od[1]),
                               policy=policy),
                (padto(o).reshape(-1, chunk, 3),
                 padto(d).reshape(-1, chunk, 3)))
            colors = colors.reshape(-1, 3)[:R]
        else:
            colors = shade(o, d)
    if bdims is not None:
        colors = from_blocked(colors, cfg.height, cfg.width, S, *bdims)
    return jnp.mean(colors.reshape(cfg.height, cfg.width, S, 3), axis=2)


def render_tiled(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
                 *, row_block: int = 128, backend: Optional[str] = None,
                 interpret: Optional[bool] = None, row_start: int = 0,
                 num_rows: Optional[int] = None):
    """Stream a frame through the device in row blocks -> host [H, W, 3].

    For frames whose full ray set exceeds device HBM (a 16k x 16k SSAA 3x3
    frame is 2.3G rays — ~28 GB of direction vectors alone): only ONE
    block's rays and outputs ever live on device; rows assemble into host
    RAM as they finish.  The block row start is a traced scalar, so every
    full block shares one compiled executable (plus at most one more for
    the remainder block).  Complements parallel.sharded (which shards rows
    ACROSS devices); this streams rows THROUGH one device.
    ``row_start``/``num_rows`` restrict the streamed span to a slice of
    the frame — ``render_tiled_multihost`` gives every host its own
    contiguous band this way.
    """
    import numpy as np

    backend = resolve_backend(backend or cfg.backend)
    if backend == "pallas" and (cfg.soft_shadow_k > 0.0
                                or cfg.ao_strength > 0.0):
        backend = "mega"        # see render_tables: no pallas soft/AO hook
    from .core import camera as cam
    from .core.render import _shade_rays
    S = cfg.samples_per_pixel
    span = cfg.height if num_rows is None else num_rows
    if not (0 <= row_start and row_start + span <= cfg.height):
        raise ValueError(
            f"row band [{row_start}, {row_start + span}) outside frame "
            f"height {cfg.height}")

    from .core.order import (block_dims, from_blocked, resolve_ray_order,
                             to_blocked)

    @partial(jax.jit, static_argnames=("n",))
    def block(tables, r0, n):
        if cfg.aperture > 0.0:
            # Thin-lens band: per-sample lens origins + refocused dirs
            # (generate_rays_dof row_range) — keeps --row-block consistent
            # with the whole-frame DoF path instead of silently pinhole.
            origin, dirs = cam.generate_rays_dof(tables, cfg,
                                                 row_range=(r0, n))
            origin = origin.reshape(-1, 3)
        else:
            origin, dirs = cam.generate_rays(tables, cfg, row_range=(r0, n))
        flat = dirs.reshape(-1, 3)
        bdims = (block_dims(n, cfg.width, S, cfg.ray_block)
                 if resolve_ray_order(cfg, backend) else None)
        if bdims is not None:
            flat = to_blocked(flat, n, cfg.width, S, *bdims)
            if jnp.ndim(origin) == 2:
                origin = to_blocked(origin, n, cfg.width, S, *bdims)
        if backend == "mega":
            from .ops.pallas_render import fused_render_op
            colors = fused_render_op(plan, cfg, interpret, tables, origin,
                                     flat)
        else:
            hooks = make_render_hooks(plan, tables, cfg, backend,
                                      interpret=interpret)
            colors = _shade_rays(plan, tables, cfg, origin, flat,
                                 differentiable=False, **hooks)
        if bdims is not None:
            colors = from_blocked(colors, n, cfg.width, S, *bdims)
        return jnp.mean(colors.reshape(n, cfg.width, S, 3), axis=2)

    r = row_start
    end = row_start + (cfg.height if num_rows is None else num_rows)
    out = np.empty((end - row_start, cfg.width, 3), np.float32)
    while r < end:
        n = min(row_block, end - r)
        out[r - row_start:r - row_start + n] = np.asarray(
            block(tables, jnp.int32(r), n))
        r += n
    return out


def render_tiled_multihost(plan: ScenePlan, tables: SceneTables,
                           cfg: RenderConfig, *, row_block: int = 128,
                           backend: Optional[str] = None,
                           interpret: Optional[bool] = None):
    """Host-sharded tiled rendering: every process streams its OWN
    contiguous row slice through its local device via ``render_tiled``,
    then ONE save-time DCN allgather assembles the full frame on every
    host -> [H, W, 3] numpy.

    This composes the two big-frame strategies: ``parallel.sharded``
    shards rows across the chips of one jit, ``render_tiled`` streams
    rows through bounded HBM — here each host gets height/P rows and
    streams them in ``row_block`` chunks, so a frame larger than the
    whole slice's combined HBM still renders.  Cross-host traffic is the
    single gather (the analogue of the reference's glGetTexImage
    readback, render.cpp:474); the hot loop never leaves the host.
    Single-process: identical to ``render_tiled``."""
    import numpy as np

    P = jax.process_count()
    if P == 1:
        return render_tiled(plan, tables, cfg, row_block=row_block,
                            backend=backend, interpret=interpret)
    p = jax.process_index()
    base, rem = divmod(cfg.height, P)
    n = base + (1 if p < rem else 0)
    r0 = p * base + min(p, rem)
    mine = render_tiled(plan, tables, cfg, row_block=row_block,
                        backend=backend, interpret=interpret,
                        row_start=r0, num_rows=n)
    # process_allgather needs uniform shapes: pad the short slices by one
    # row, stack host-major, trim after the gather.
    pad = base + (1 if rem else 0)
    if n < pad:
        mine = np.concatenate(
            [mine, np.zeros((pad - n, cfg.width, 3), np.float32)], axis=0)
    from jax.experimental import multihost_utils

    stacked = np.asarray(multihost_utils.process_allgather(mine))
    pieces = [stacked[q, :base + (1 if q < rem else 0)] for q in range(P)]
    return np.concatenate(pieces, axis=0)


def render_rays(plan: ScenePlan, tables: SceneTables,
                origins: jnp.ndarray, dirs: jnp.ndarray,
                cfg: Optional[RenderConfig] = None, *,
                interpret: Optional[bool] = None) -> jnp.ndarray:
    """Render an ARBITRARY ray bundle -> [R, 3] linear colors.

    ``origins`` [R, 3] (per-ray) or [3] (shared); ``dirs`` [R, 3] unit.
    No reference equivalent (its rays only come from the camera grid,
    render.cpp:92-101) — this is the entry point for custom samplings:
    posed-photo fitting, light probes, batched animation frames
    (render_frames).  Runs the mega kernel (per-ray origins ride three
    ray streams instead of a scalar broadcast) and is differentiable
    w.r.t. tables, origins and dirs through the same custom-VJP op as
    render_tables' mega path.  ``cfg.ray_chunk`` bounds the working set."""
    cfg = cfg or RenderConfig()
    from .ops.pallas_render import fused_render_op

    dirs = jnp.asarray(dirs, jnp.float32)
    origins = jnp.asarray(origins, jnp.float32)
    R = dirs.shape[0]
    chunk = _effective_chunk(cfg, R)
    if not (chunk and R > chunk):
        return fused_render_op(plan, cfg, interpret, tables, origins, dirs)
    per_ray = origins.ndim == 2
    pad = (-R) % chunk
    dpad = jnp.concatenate([dirs, jnp.broadcast_to(dirs[-1:], (pad, 3))]) \
        if pad else dirs
    dblk = dpad.reshape(-1, chunk, 3)
    if per_ray:
        opad = jnp.concatenate(
            [origins, jnp.broadcast_to(origins[-1:], (pad, 3))]) \
            if pad else origins
        oblk = opad.reshape(-1, chunk, 3)
        colors = jax.lax.map(
            lambda od: fused_render_op(plan, cfg, interpret, tables,
                                       od[0], od[1]), (oblk, dblk))
    else:
        colors = jax.lax.map(
            lambda d: fused_render_op(plan, cfg, interpret, tables,
                                      origins, d), dblk)
    return colors.reshape(-1, 3)[:R]


def render_frames(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
                  positions: jnp.ndarray, directions: jnp.ndarray, *,
                  interpret: Optional[bool] = None) -> jnp.ndarray:
    """Batched multi-frame render: F camera poses -> [F, H, W, 3].

    All F frames' rays go through ONE chunked device stream (render_rays
    with per-ray origins), so dispatch / tail latency amortizes across the
    whole animation instead of per frame — the batch-serving path behind
    serve.py's /animate.  ``positions``/``directions`` are [F, 3]; other
    camera intrinsics (up, fov) come from ``tables``."""
    from .core import camera as cam

    positions = jnp.asarray(positions, jnp.float32)
    directions = jnp.asarray(directions, jnp.float32)
    F = int(positions.shape[0])
    S = cfg.samples_per_pixel
    R = cfg.height * cfg.width * S
    all_o, all_d = [], []
    for i in range(F):
        t = tables._replace(cam_position=positions[i],
                            cam_direction=directions[i])
        o, d = cam.generate_rays(t, cfg)
        all_o.append(jnp.broadcast_to(o, (R, 3)))
        all_d.append(d.reshape(R, 3))
    colors = render_rays(plan, tables, jnp.concatenate(all_o),
                         jnp.concatenate(all_d), cfg, interpret=interpret)
    return jnp.mean(colors.reshape(F, cfg.height, cfg.width, S, 3), axis=3)


def turntable_frames(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
                     frames: int, *, orbit: Optional[float] = None,
                     center=None, backend: str = "auto",
                     interpret: Optional[bool] = None, batch: int = 8):
    """Yield ``frames`` [H, W, 3] float frames orbiting the scene — the
    shared turntable path behind serve.py's /animate and the CLI's
    ``--animate`` (no reference equivalent; its main() renders one frame,
    main.cpp:17-88).

    The camera circles in the xz plane about ``center`` (default: mean
    primitive position) at its starting radius and height, always looking
    at the centre.  ``orbit`` is the swept angle in RADIANS (default one
    full turn).  Full loops exclude the endpoint (frame 0 == frame N
    would duplicate); PARTIAL sweeps include it — the last frame sits at
    exactly ``orbit``, not orbit*(N-1)/N.

    On the mega backend, poses render ``batch`` at a time through ONE
    chunked device stream (render_frames) so dispatch/tail latency
    amortizes across the animation; other backends re-run a single jitted
    executable per frame (only the camera pytree changes, so every frame
    after the first reuses the compiled executable)."""
    import math

    import numpy as np

    resolved = resolve_backend(backend)
    if orbit is None:
        orbit = 2.0 * math.pi
    if center is not None:
        center = np.asarray(center, np.float32)
    else:
        center = (np.asarray(tables.prim_pos, np.float32).mean(0)
                  if tables.prim_pos.shape[0] else np.zeros(3, np.float32))
    p0 = np.asarray(tables.cam_position, np.float32) - center
    radius = float(np.hypot(p0[0], p0[2]))
    phi0 = math.atan2(float(p0[2]), float(p0[0]))
    two_pi = 2.0 * math.pi
    denom = (max(frames, 1) if abs(orbit) >= two_pi - 1e-9
             else max(frames - 1, 1))

    def pose(i):
        phi = phi0 + orbit * i / denom
        pos = center + np.array([radius * math.cos(phi), float(p0[1]),
                                 radius * math.sin(phi)], np.float32)
        look = center - pos
        nrm = float(np.linalg.norm(look))
        return pos, ((look / nrm) if nrm > 1e-6
                     else np.asarray(tables.cam_direction))

    if resolved == "mega":
        for b0 in range(0, frames, batch):
            n = min(batch, frames - b0)
            ps, ds = zip(*(pose(b0 + i) for i in range(n)))
            imgs = np.asarray(render_frames(
                plan, tables, cfg, np.stack(ps).astype(np.float32),
                np.stack(ds).astype(np.float32), interpret=interpret))
            for img in imgs:
                yield img
    else:
        render = jax.jit(lambda t: render_tables(
            plan, t, cfg, backend=resolved, interpret=interpret))
        for i in range(frames):
            pos, d = pose(i)
            t = tables._replace(cam_position=jnp.asarray(pos),
                                cam_direction=jnp.asarray(d))
            yield np.asarray(render(t))


def render_aovs(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
                *, interpret: Optional[bool] = None) -> dict:
    """Render AOVs (arbitrary output variables) in one pass — the
    compositing/debugging outputs a production renderer exposes beyond the
    beauty image (no reference equivalent; its pipeline writes color only,
    render.cpp:122-139):

      color  [H, W, 3]  the beauty image (identical to render_tables)
      depth  [H, W]     mean ray-space hit distance t over converged SSAA
                        samples; +inf where no sample converged
      normal [H, W, 3]  SSAA-mean surface normal, renormalized; zero on miss
      objid  [H, W]     int32 winner primitive index of the pixel's FIRST
                        SSAA sample (-1 = miss) — ids do not average
      hit    [H, W]     converged-sample coverage fraction in [0, 1]
      shadow [H, W, L]  per-light shadowed-sample fraction in [0, 1]
                        (from the kernel's shadow bitmask; hard-shadow
                        boundaries are LIGHT discontinuities the other
                        planes cannot see — utils.gatecheck uses this)

    One mega-kernel launch supplies everything but the normal (one more
    surface-kernel launch).  Not differentiable (outputs, not a loss
    path)."""
    from .core import camera as cam
    from .ops.pallas_render import _blend_bounces, pallas_render_rays

    origin, dirs = cam.generate_rays(tables, cfg)
    S = cfg.samples_per_pixel
    H, W = cfg.height, cfg.width
    flat = lax.stop_gradient(dirs.reshape(-1, 3))
    sg_tables = jax.tree_util.tree_map(lax.stop_gradient, tables)

    # Both shadow-march skips OFF: a skipped lane's smask bit reads
    # SHADOWED (its march endpoint is the origin, so the passed test
    # fails) — harmless for the beauty image (the skips are bit-exact by
    # contract, so the color plane still matches render_tables bitwise)
    # but it would poison the shadow AOV plane with false full-shadow
    # bands along terminators, and gatecheck classifies against it
    # (r5 review finding, verified).
    aov_cfg = cfg.replace(shadow_sat_skip=False, shade_skip_black=False)
    outs = pallas_render_rays(plan, aov_cfg, origin, flat, sg_tables,
                              interpret=interpret)
    p, sd, conv, cidx, light, smask = outs[:6]
    # geometry planes stay primary-hit; the color plane blends any mirror
    # bounces so it keeps matching the beauty render exactly
    colors = _blend_bounces(plan, cfg, sg_tables, cidx, light,
                            outs[8] if len(outs) > 8 else ())

    g = _normal_op(plan, cfg, interpret, p, sg_tables)
    sq = jnp.sum(g * g, axis=-1, keepdims=True)
    n = g / jnp.sqrt(jnp.maximum(sq, jnp.finfo(g.dtype).tiny))
    n = jnp.where(conv[..., None], n, 0.0)

    t = jnp.sum((p - origin) * flat, axis=-1) / jnp.sum(flat * flat, axis=-1)

    convS = conv.reshape(H, W, S)
    hit = jnp.mean(convS.astype(jnp.float32), axis=2)
    tS = jnp.where(convS, t.reshape(H, W, S), 0.0)
    depth = jnp.where(hit > 0.0,
                      jnp.sum(tS, axis=2) / jnp.maximum(
                          jnp.sum(convS, axis=2), 1),
                      jnp.inf)
    nS = jnp.where(convS[..., None], n.reshape(H, W, S, 3), 0.0)
    nm = jnp.sum(nS, axis=2)
    nsq = jnp.sum(nm * nm, axis=-1, keepdims=True)
    normal = jnp.where(hit[..., None] > 0.0,
                       nm / jnp.sqrt(jnp.maximum(
                           nsq, jnp.finfo(nm.dtype).tiny)), 0.0)
    objid = cidx.reshape(H, W, S)[..., 0].astype(jnp.int32)

    L = int(jnp.shape(tables.light_pos)[0])
    bits = ((smask.astype(jnp.int32)[..., None]
             >> jnp.arange(max(L, 1), dtype=jnp.int32)) & 1)
    # converged samples only: a miss sample's shadow march runs from its
    # step-cap drift point and its bits are noise (r5 review) — like the
    # depth plane, average over converged samples, zero where none
    bitsS = jnp.where(convS[..., None],
                      bits.reshape(H, W, S, max(L, 1)).astype(jnp.float32),
                      0.0)
    shadow = jnp.sum(bitsS, axis=2) / jnp.maximum(
        jnp.sum(convS, axis=2), 1)[..., None]

    return {
        "color": jnp.mean(colors.reshape(H, W, S, 3), axis=2),
        "depth": depth,
        "normal": normal,
        "objid": objid,
        "hit": hit,
        "shadow": shadow,
    }


@partial(jax.jit, static_argnames=("plan", "cfg", "backend",
                                   "differentiable"))
def render_tables_jit(plan: ScenePlan, tables: SceneTables,
                      cfg: RenderConfig, backend: str = "auto",
                      differentiable: bool = False) -> jnp.ndarray:
    return render_tables(plan, tables, cfg, backend=backend,
                         differentiable=differentiable)


def render(scene: Scene, cfg: Optional[RenderConfig] = None, *,
           backend: Optional[str] = None, jit: bool = True) -> jnp.ndarray:
    """Render a parsed Scene -> [H, W, 3] image array."""
    from .scene.compile import compile_scene

    cfg = cfg or RenderConfig()
    plan, tables = compile_scene(scene)
    if jit:
        return render_tables_jit(plan, tables, cfg,
                                 resolve_backend(backend or cfg.backend))
    return render_tables(plan, tables, cfg, backend=backend)
