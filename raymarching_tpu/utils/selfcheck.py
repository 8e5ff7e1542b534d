"""Failure detection: deterministic per-tile re-run (SURVEY §5 row).

The reference's failure story is "errors print and execution continues"
(render.cpp:417-425).  On an accelerator fleet the failure mode that bites
is *silent* data corruption — a flaky chip, a bad HBM row, a miscompiled
kernel — which no exception ever reports.  The standard defence (used by
large-scale training fleets) is redundant recomputation: the renderer is a
pure function of (plan, tables, cfg), so rendering the same rays twice on
the same device MUST produce bitwise-identical images; any difference is a
hardware/runtime fault, and because images tile, the differing tiles
localize it.

Two checks, both returning machine-readable reports (and both emitted to
the structured log when one is configured):

  * ``rerun_check``   — render N times, compare bitwise, report per-tile
                        mismatches.  Catches nondeterministic corruption.
  * ``oracle_check``  — compare the fast backend against the jnp oracle at
                        a reduced resolution with a loose tolerance.
                        Catches *deterministic* corruption (a consistently
                        wrong kernel or a stuck functional unit).

``assert_healthy`` composes them into one go/no-go gate for long
unattended runs (optimize.fit callbacks, serving startup).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..config import RenderConfig
from ..scene.compile import ScenePlan, SceneTables
from .structlog import emit


def _tile_mismatches(a: np.ndarray, b: np.ndarray,
                     tile: Tuple[int, int]) -> list:
    """[(row0, col0, count), ...] for tiles where a != b (bitwise)."""
    th, tw = tile
    h, w = a.shape[:2]
    out = []
    neq = np.any(a != b, axis=-1)
    for r0 in range(0, h, th):
        for c0 in range(0, w, tw):
            n = int(neq[r0:r0 + th, c0:c0 + tw].sum())
            if n:
                out.append((r0, c0, n))
    return out


def rerun_check(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
                *, backend: str = "auto", repeats: int = 2,
                tile: Tuple[int, int] = (64, 64),
                interpret: bool = False) -> dict:
    """Render ``repeats`` times; any bitwise difference is a fault.

    The render is a deterministic pure function, so this is a zero-false-
    positive detector: a report with ``ok=False`` means the hardware or
    runtime produced different bits for identical work.  Mismatching tiles
    are listed so a fault can be localized (and, on a sharded mesh, mapped
    back to the owning device via the row partitioning).
    """
    from ..api import render_tables

    imgs = [np.asarray(render_tables(plan, tables, cfg, backend=backend,
                                     interpret=interpret))
            for _ in range(repeats)]
    bad = []
    worst = 0.0
    for i, img in enumerate(imgs[1:], start=1):
        tiles = _tile_mismatches(imgs[0], img, tile)
        if tiles:
            bad.append({"repeat": i, "tiles": tiles[:16],
                        "tiles_total": len(tiles)})
            worst = max(worst, float(np.abs(imgs[0] - img).max()))
    report = {
        "check": "rerun", "ok": not bad, "repeats": repeats,
        "backend": backend, "rays": cfg.rays_per_image,
        "max_abs_diff": worst, "mismatches": bad,
    }
    emit("selfcheck", **{k: v for k, v in report.items() if k != "mismatches"},
         mismatch_repeats=len(bad))
    return report


def oracle_check(plan: ScenePlan, tables: SceneTables, cfg: RenderConfig,
                 *, backend: str = "auto", tol: float = 5e-3,
                 max_bad_frac: float = 0.005,
                 interpret: bool = False) -> dict:
    """Fast backend vs the jnp oracle at reduced resolution.

    Loose by construction (FD normals near edges differ at ~1e-3 between
    op orderings); the gate is the *fraction* of pixels beyond ``tol``,
    mirroring bench.py's fused-mode gate.  A failure means the device is
    computing a consistently wrong function — the re-run check cannot see
    that, the oracle can.
    """
    from ..api import render_tables

    small = cfg.replace(width=max(cfg.width // 8, 32),
                        height=max(cfg.height // 8, 32),
                        ray_chunk=0)
    fast = np.asarray(render_tables(plan, tables, small, backend=backend,
                                    interpret=interpret))
    ref = np.asarray(render_tables(plan, tables, small, backend="jnp"))
    diff = np.abs(fast - ref).max(axis=-1)
    bad_frac = float((diff > tol).mean())
    report = {
        "check": "oracle", "ok": bad_frac <= max_bad_frac,
        "backend": backend, "tol": tol, "bad_pixel_frac": bad_frac,
        "max_abs_diff": float(diff.max()),
        "resolution": [small.width, small.height],
    }
    emit("selfcheck", **report)
    return report


def assert_healthy(plan: ScenePlan, tables: SceneTables,
                   cfg: Optional[RenderConfig] = None, *,
                   backend: str = "auto", repeats: int = 2,
                   interpret: bool = False) -> dict:
    """Run both checks; raise RuntimeError with the report on failure."""
    cfg = cfg or RenderConfig(width=256, height=192, ssaa=1, iterations=500)
    r1 = rerun_check(plan, tables, cfg, backend=backend, repeats=repeats,
                     interpret=interpret)
    r2 = oracle_check(plan, tables, cfg, backend=backend,
                      interpret=interpret)
    report = {"ok": r1["ok"] and r2["ok"], "rerun": r1, "oracle": r2}
    if not report["ok"]:
        raise RuntimeError(f"selfcheck failed: {report}")
    return report
