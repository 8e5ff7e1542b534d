"""Differentiable march operator: fast forward + implicit-function backward.

The march is a <=1000-step fixed-point iteration (scene.cpp:34-42).  Naive
reverse-mode (unrolling the scan) costs O(iterations) compute and residual
memory in the backward sweep.  This op instead treats the converged hit
point as a root of  f(o + t d, theta) = c  (c = the sub-epsilon residual at
the stopping point, held constant so forward values stay bit-identical to
the reference march) and differentiates via the implicit function theorem —
reparameterized differentiable sphere tracing:

    denom = grad_p f . d                  (at the hit point)
    dt/dtheta = -f_theta / denom
    dt/do     = -grad_p f / denom
    dt/dd     = -t grad_p f / denom
    p* = o + t d   chains the explicit o, d terms with the t routes.

Cost: ONE extra SDF evaluation + one SDF VJP per ray — instead of re-walking
up to 1000 steps.  Non-converged rays (no surface hit: the reference has no
miss flag, SURVEY §2) get zero implicit gradients (t treated as constant).

Notes on dropped cotangents:
  * ``sd`` output: downstream it only shifts the color-lookup point
    p_color = p_hit - sd*d; the color gather is piecewise-constant in
    position, so its a.e. gradient is zero — ``sd_bar`` is discarded.
  * ``converged``: boolean, non-differentiable.

The forward driver is pluggable: pure-jnp while_loop (CPU / oracle) or the
fused Pallas kernel (ops.pallas_march).  The backward only needs hit
points, so both forwards share this backward; gradcheck against the
unrolled-scan autodiff oracle validates the IFT route (tests/test_grad.py).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..core.march import MarchResult, march_while

# |grad f . d| can vanish at grazing incidence; clamp away from zero,
# preserving sign, to keep 1/denom finite (standard in differentiable
# sphere-tracing formulations).
_DENOM_EPS = 1e-6


def ift_ray_weights(t_bar, denom, damping: float):
    """The IFT per-ray scalar cotangent w = -t_bar / (grad f . d), stabilized.

    damping == 0 (default): sign-preserving _DENOM_EPS clamp — the exact
    IFT derivative everywhere it is well-conditioned, up to 1/eps at
    grazing incidence.

    damping > 0: Tikhonov-damped inverse -t_bar * denom/(denom^2 + damping^2).
    At |denom| >> damping this is 1/denom to O((damping/denom)^2); as
    |denom| -> 0 the weight rolls off to ZERO instead of exploding to
    1/eps.  Rationale: a grazing ray's hit point is genuinely
    ill-conditioned in the scene parameters, but a PIXEL loss only varies
    over the pixel footprint — the exact 1/denom linearization holds for a
    vanishing parameter radius, so near-silhouette rays contribute
    enormous terms (up to t_bar/eps = 1e6 t_bar) that do not reflect the
    loss landscape.  The damped weight is a per-ray trust region; set
    cfg.ift_damping ~ a few 1e-3 when FITTING (examples/fit_fractal.py).
    Exactness note: damping bounds only the IFT route; on rough surfaces
    the normal-chain gradient (d shade / d normal / d p) is the dominant
    high-frequency term and is correctly LEFT exact — the jagged landscape
    it reflects is real, and smooth-geometry objectives (see the fitting
    example) are the remedy, not a biased derivative."""
    if damping > 0.0:
        return -t_bar * denom / (denom * denom + damping * damping)
    d = jnp.where(jnp.abs(denom) < _DENOM_EPS,
                  jnp.where(denom < 0, -_DENOM_EPS, _DENOM_EPS), denom)
    return -t_bar / d


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3, 4, 5))
def march_op(scene_sd_fn: Callable, iterations: int, eps: float,
             forward_impl: Optional[Callable],
             bwd_impl: Optional[Callable], damping: float,
             origin: jnp.ndarray, ray: jnp.ndarray, tables) -> MarchResult:
    """March origin + t*ray to the surface of ``scene_sd_fn(tables, .)``.

    scene_sd_fn: (tables, p[..., 3]) -> sd[...].  Every traced scene
    parameter must come in through ``tables`` (a pytree) so the custom VJP
    can route cotangents to it.  ``forward_impl``, when given, replaces the
    jnp while-loop forward (e.g. with the fused Pallas kernel); it maps
    (origin, ray, tables) -> MarchResult with identical semantics.
    ``bwd_impl`` (residuals, cotangents) -> (o_bar, d_bar, tables_bar)
    replaces the jnp IFT backward below (e.g. with the winner-kernel route,
    ops.scene_vjp.make_march_bwd, which never materializes [rays, prims]).
    """
    if forward_impl is not None:
        return forward_impl(origin, ray, tables)
    return march_while(lambda p: scene_sd_fn(tables, p), origin, ray,
                       iterations, eps)


def _march_fwd(scene_sd_fn, iterations, eps, forward_impl, bwd_impl,
               damping, origin, ray, tables):
    res = march_op(scene_sd_fn, iterations, eps, forward_impl, bwd_impl,
                   damping, origin, ray, tables)
    t = jnp.sum((res.position - origin) * ray, axis=-1) / \
        jnp.sum(ray * ray, axis=-1)
    return res, (res.position, res.converged, t, ray, tables)


def _march_bwd(scene_sd_fn, iterations, eps, forward_impl, bwd_impl,
               damping, residuals, cotangents):
    if bwd_impl is not None:
        return bwd_impl(residuals, cotangents)
    p_hit, converged, t, ray, tables = residuals
    p_bar = cotangents.position                     # [..., 3]

    _, vjp = jax.vjp(lambda tb, p: scene_sd_fn(tb, p), tables, p_hit)

    # grad_p f via pullback of a ones cotangent (tables route discarded).
    ones = jnp.ones(p_hit.shape[:-1], p_hit.dtype)
    _, grad_p = vjp(ones)
    denom = jnp.sum(grad_p * ray, axis=-1)

    # Scalar cotangent on f per ray; zero where the march never converged.
    t_bar = jnp.where(converged, jnp.sum(p_bar * ray, axis=-1), 0.0)
    w = ift_ray_weights(t_bar, denom, damping)
    tables_bar, gp_w = vjp(w)                       # f_theta route; w*grad_p f

    o_bar = p_bar + gp_w                            # I + d (x) dt/do
    d_bar = t[..., None] * (p_bar + gp_w)           # t I + d (x) dt/dd
    return o_bar, d_bar, tables_bar


march_op.defvjp(_march_fwd, _march_bwd)


def make_march_fn(scene_sd_fn: Callable, iterations: int, eps: float,
                  tables, forward_impl: Optional[Callable] = None,
                  bwd_impl: Optional[Callable] = None,
                  damping: float = 0.0):
    """Adapt to the (origin, dirs) -> MarchResult interface of
    core.render's ``march_fn`` hook."""
    def fn(origin, dirs):
        return march_op(scene_sd_fn, iterations, eps, forward_impl,
                        bwd_impl, damping, origin, dirs, tables)
    return fn
