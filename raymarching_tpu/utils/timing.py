"""Phase timers and throughput reporting.

The reference's entire observability story is chrono spans printed per
backend (main.cpp:36-77).  This keeps that ergonomic (wall-clock per phase)
and adds Mrays/s, plus optional jax.profiler trace capture.  JAX returns
before the device finishes, so a phase that reports a rate must end in
``Phase.sync`` (``jax.block_until_ready``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np


class Phase:
    """Wall-clock span: ``with Phase("render", rays=n) as ph: ...
    ph.sync(x)``.

    A throughput rate is printed only for a phase that called ``sync`` —
    without it the span measured the enqueue, not the device work."""

    def __init__(self, name: str, rays: Optional[int] = None,
                 verbose: bool = True):
        self.name = name
        self.rays = rays
        self.verbose = verbose
        self.seconds = None
        self.synced = False

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def sync(self, value):
        """Block until every array leaf of ``value`` is computed on the
        device, and return ``value``."""
        import jax

        jax.block_until_ready(value)
        self.synced = True
        return value

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self.verbose and exc[0] is None:
            msg = f"[{self.name}] {self.seconds:.3f} s"
            if self.rays and self.synced:
                msg += f"  ({self.rays / self.seconds / 1e6:.3f} Mrays/s)"
            print(msg)
        return False


def device_record() -> dict:
    """The default JAX device as JAX reports it, plus the card's name and
    power limit from nvidia-smi on a GPU — printed beside every rate."""
    import subprocess

    import jax

    d = jax.devices()[0]
    rec = {"platform": d.platform, "kind": d.device_kind,
           "count": len(jax.devices())}
    if d.platform == "gpu":
        rec["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    return rec


@contextlib.contextmanager
def profiler_trace(logdir: Optional[str]):
    """Capture a jax.profiler trace when a logdir is given."""
    if not logdir:
        yield
        return
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def march_iteration_stats(converged: np.ndarray,
                          steps: Optional[np.ndarray] = None) -> dict:
    """Convergence summary for observability (SURVEY §5 metrics row)."""
    converged = np.asarray(converged)
    out = {
        "rays": int(converged.size),
        "converged": int(converged.sum()),
        "miss_fraction": float(1.0 - converged.mean()) if converged.size
        else 0.0,
    }
    if steps is not None:
        steps = np.asarray(steps)
        out["steps"] = {
            "mean": float(steps.mean()),
            "p50": int(np.percentile(steps, 50)),
            "p90": int(np.percentile(steps, 90)),
            "p99": int(np.percentile(steps, 99)),
            "max": int(steps.max()),
        }
    return out


def profile_march(plan, tables, cfg, backend: str = "jnp") -> dict:
    """Render-shaped march profile: convergence + step histogram for the
    primary rays of ``cfg``'s camera.

    ``backend``: "jnp" (anywhere) or "pallas" (the kernel's own counters,
    incl. the per-block early-exit and culling behaviour)."""
    import jax
    import jax.numpy as jnp

    from ..core import camera as cam

    origin, dirs = cam.generate_rays(tables, cfg)
    dirs = jnp.reshape(dirs, (-1, 3))
    o = np.broadcast_to(np.asarray(origin), dirs.shape)

    if backend == "pallas":
        from ..ops.pallas_march import pallas_march

        res, steps = jax.jit(lambda oo, dd, tb: pallas_march(
            plan.kernel, cfg.iterations, cfg.surface_precision,
            cfg.ray_block, oo, dd, tb,
            fused=cfg.fused_generators, with_steps=True))(o, dirs, tables)
    else:
        from ..core.march import march_profile
        from ..core.sdf import scene_sd

        res, steps = jax.jit(lambda oo, dd: march_profile(
            lambda p: scene_sd(plan, tables, p), oo, dd,
            cfg.iterations, cfg.surface_precision))(o, dirs)
    return march_iteration_stats(np.asarray(res.converged),
                                 np.asarray(steps))
