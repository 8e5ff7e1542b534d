"""Sphere-tracing march: masked fixed-point iteration.

Reference semantics (scene.cpp:34-42): up to ``iterations`` steps of

    surface = SDF(p); p += surface.SD * ray; if surface.SD < eps: break

i.e. the position update happens BEFORE the convergence check, so the hit
point includes one final sub-epsilon step, and the returned (SD, color) were
evaluated at the position one step back.  There is no miss flag; scenes rely
on an inverted Bounds box so every ray terminates (SURVEY §2 fine print).

Vector re-design: per-ray ``break`` becomes a convergence mask —
converged rays freeze while the rest keep stepping, which preserves the
reference's per-ray trajectory bit-for-bit while every lane stays in
lockstep.  Two drivers:

  * ``lax.while_loop`` with a whole-batch "all converged" early exit —
    fastest forward path (not differentiable);
  * ``lax.scan`` over a fixed iteration count with optional rematerialized
    chunks — reverse-mode differentiable; this is the CPU-autodiff oracle
    the north star's gradient allclose contract is defined against.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class MarchResult(NamedTuple):
    position: jnp.ndarray  # [..., 3] endpoint (includes the final step)
    sd: jnp.ndarray        # [...] last-evaluated SD (at position - sd*ray)
    converged: jnp.ndarray  # [...] bool


# Step-length clamp: in any bounded scene (every reference scene wraps the
# world in ``Bounds``) the SDF never approaches this, so trajectories are
# bit-identical; for unbounded/empty scenes it stops +-inf steps from
# producing inf * 0 = NaN positions (the reference NaNs here too — we choose
# graceful degradation instead).
MAX_STEP = 1e5


def _march_step(scene_sd: Callable, p, sd_last, done, t, ray, eps, tmax):
    sd = scene_sd(p)
    step = jnp.minimum(sd, MAX_STEP)
    active = jnp.logical_not(done)
    step = jnp.where(active, step, 0.0)
    p_new = p + step[..., None] * ray
    t_new = t + step
    sd_new = jnp.where(active, sd, sd_last)
    done_new = jnp.logical_or(done, sd_new < eps)
    if tmax is not None:
        # Early termination once the ray has passed its target distance
        # (shadow rays: the light).  EXACT for the shadow boolean
        # dot(light - endpoint, ray) > 0 — any endpoint at t >= tmax is at
        # or beyond the light, and the reference march could only ever
        # continue FORWARD from there (scene.cpp:45-50).
        done_new = jnp.logical_or(done_new, t_new >= tmax)
    return p_new, sd_new, done_new, t_new


def march_while(scene_sd: Callable, origin: jnp.ndarray, ray: jnp.ndarray,
                iterations: int, eps: float, tmax=None) -> MarchResult:
    """Early-exit march (forward only). origin/ray: [..., 3]."""
    batch = origin.shape[:-1]
    init = (jnp.zeros((), jnp.int32),
            origin,
            jnp.full(batch, jnp.inf, origin.dtype),
            jnp.zeros(batch, bool),
            jnp.zeros(batch, origin.dtype))

    def cond(state):
        it, _, _, done, _ = state
        return jnp.logical_and(it < iterations, jnp.logical_not(jnp.all(done)))

    def body(state):
        it, p, sd_last, done, t = state
        p, sd_last, done, t = _march_step(scene_sd, p, sd_last, done, t,
                                          ray, eps, tmax)
        return it + 1, p, sd_last, done, t

    _, p, sd, done, _ = lax.while_loop(cond, body, init)
    converged = jnp.logical_and(done, sd < eps)
    return MarchResult(position=p, sd=sd, converged=converged)


def march_scan(scene_sd: Callable, origin: jnp.ndarray, ray: jnp.ndarray,
               iterations: int, eps: float,
               remat_chunk: int = 50, tmax=None) -> MarchResult:
    """Fixed-iteration march (reverse-mode differentiable).

    ``remat_chunk`` > 0 splits the scan into rematerialized chunks so the
    backward pass stores O(iterations / chunk) residual sets instead of one
    per step (jax.checkpoint — the memory/FLOPs trade, SURVEY §5).
    """
    batch = origin.shape[:-1]
    carry0 = (origin, jnp.full(batch, jnp.inf, origin.dtype),
              jnp.zeros(batch, bool),
              jnp.zeros(batch, origin.dtype))

    def step(carry, _):
        p, sd_last, done, t = carry
        return _march_step(scene_sd, p, sd_last, done, t, ray, eps, tmax), None

    if remat_chunk and remat_chunk < iterations:
        chunks, rem = divmod(iterations, remat_chunk)

        def chunk_step(carry, _):
            carry, _ = lax.scan(step, carry, None, length=remat_chunk)
            return carry, None

        carry, _ = lax.scan(jax.checkpoint(chunk_step), carry0, None,
                            length=chunks)
        if rem:
            carry, _ = lax.scan(step, carry, None, length=rem)
    else:
        carry, _ = lax.scan(step, carry0, None, length=iterations)

    p, sd, done, _ = carry
    converged = jnp.logical_and(done, sd < eps)
    return MarchResult(position=p, sd=sd, converged=converged)


def march_profile(scene_sd: Callable, origin: jnp.ndarray, ray: jnp.ndarray,
                  iterations: int, eps: float):
    """March with per-ray step counting -> (MarchResult, steps [..] int32).

    Observability path (SURVEY §5 metrics row: march-iteration histograms);
    the hot kernels don't pay for the counter."""
    batch = origin.shape[:-1]
    init = (jnp.zeros((), jnp.int32), origin,
            jnp.full(batch, jnp.inf, origin.dtype),
            jnp.zeros(batch, bool),
            jnp.zeros(batch, origin.dtype),
            jnp.zeros(batch, jnp.int32))

    def cond(state):
        it, _, _, done, _, _ = state
        return jnp.logical_and(it < iterations, jnp.logical_not(jnp.all(done)))

    def body(state):
        it, p, sd_last, done, t, steps = state
        steps = steps + jnp.logical_not(done).astype(jnp.int32)
        p, sd_last, done, t = _march_step(scene_sd, p, sd_last, done, t,
                                          ray, eps, None)
        return it + 1, p, sd_last, done, t, steps

    _, p, sd, done, _, steps = lax.while_loop(cond, body, init)
    converged = jnp.logical_and(done, sd < eps)
    return MarchResult(position=p, sd=sd, converged=converged), steps


def march(scene_sd: Callable, origin: jnp.ndarray, ray: jnp.ndarray,
          iterations: int, eps: float, *, differentiable: bool = False,
          early_exit: bool = True, remat_chunk: int = 50,
          tmax=None) -> MarchResult:
    if differentiable:
        return march_scan(scene_sd, origin, ray, iterations, eps,
                          remat_chunk=remat_chunk, tmax=tmax)
    if early_exit:
        return march_while(scene_sd, origin, ray, iterations, eps, tmax=tmax)
    return march_scan(scene_sd, origin, ray, iterations, eps, remat_chunk=0,
                      tmax=tmax)
