"""Differentiable FRACTAL fitting: recover a quaternion Julia set's
position, size, and color from pixels alone.

A demo the reference renderer could not express, let alone differentiate:
the target image is a procedural Julia-set fractal; the initial guess is
shifted, shrunk, and re-tinted; plain Adam on the photometric MSE recovers
the parameters.  Gradients flow through the sphere-trace fixed point (IFT
backward) and through the unrolled quaternion iteration into the leaf's
table entries — the size cotangent rides the DE's homogeneity
(ops.scene_vjp.theta_cotangents).

Two knobs matter for fitting fractals and are demonstrated here:

  * ``ift_damping``: rolls off the IFT 1/(grad f . d) weight on grazing
    rays (abundant on curved fractal surfaces) instead of clamping it at
    1e6 — see ops.march_op.ift_ray_weights.
  * Geometry smoothness: the Julia set at moderate iteration counts has
    SMOOTH swirled surfaces, so photometric gradients are informative.  A
    deep Mandelbulb's surface is rough at pixel scale — its pointwise
    gradient is exact but the loss landscape is jagged, and plain local
    descent stalls (that regime needs stochastic smoothing or silhouette
    terms; a documented limitation, not a gradient bug:
    tests/test_julia.py pins gradient correctness at fixed points).

Expected outcome (~2 min on CPU): loss drops ~100x, color converges to
~1e-3, size and position close most of the gap — the remainder is the
genuine depth-vs-scale ambiguity of a single view of an unfamiliar shape.

    python examples/fit_fractal.py [--steps 150] [--out /tmp/fit_fractal]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--out", default="/tmp/fit_fractal")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args()
    from raymarching_tpu.utils.cache import setup_compile_cache
    setup_compile_cache()

    from raymarching_tpu import RenderConfig
    from raymarching_tpu.api import render_tables, resolve_backend
    from raymarching_tpu.io.image import save_image
    from raymarching_tpu.optimize import fit
    from raymarching_tpu.scene.compile import compile_tree
    from raymarching_tpu.scene.csg import Julia, ListNode, Mode, bounds
    from raymarching_tpu.scene.objects import Camera, Light

    backend = resolve_backend(args.backend or "auto")
    tree = ListNode(Mode.UNION, [
        bounds(60.0),
        Julia((0.0, 0.0, -5.0), 1.3, c=(-0.2, 0.6, 0.2, 0.2), iterations=6,
              color=(0.9, 0.55, 0.25)),
    ])
    plan, tables_true = compile_tree(
        tree, [Light((5.0, 6.0, 0.5))],
        Camera(position=(2.4, 1.9, -1.4), direction=(-2.4, -2.0, -3.6),
               fov=50.0))
    # Shadows off (a boolean is a step function — zero gradient a.e., pure
    # noise for fitting) + analytic normals + damped IFT weights.
    cfg = RenderConfig(width=96, height=72, ssaa=1, iterations=300,
                       shadows=False, normal_mode="analytic",
                       ift_damping=3e-3)

    target = render_tables(plan, tables_true, cfg, backend=backend)

    # Perturb the fractal: shift, shrink, re-tint.
    pos = np.array(tables_true.prim_pos)
    aux = np.array(tables_true.prim_aux)
    col = np.array(tables_true.prim_color)
    pos[1] += np.array([0.2, -0.15, 0.18])
    aux[1, 0] *= 0.8
    col[1] = np.clip(col[1] + np.array([-0.3, 0.2, 0.3]), 0, 1)
    tables0 = tables_true._replace(prim_pos=pos, prim_aux=aux,
                                   prim_color=col)

    os.makedirs(args.out, exist_ok=True)
    save_image(os.path.join(args.out, "target.png"), np.asarray(target))
    save_image(os.path.join(args.out, "initial.png"),
               np.asarray(render_tables(plan, tables0, cfg,
                                        backend=backend)))

    def cb(step, loss, _):
        if step % 25 == 0:
            print(f"step {step:4d}  loss {loss:.6f}")

    res = fit(plan, tables0, target, cfg, steps=args.steps, lr=1e-2,
              backend=backend,
              trainable=("prim_pos", "prim_aux", "prim_color"),
              callback=cb)

    fitted = render_tables(plan, res.tables, cfg, backend=backend)
    save_image(os.path.join(args.out, "fitted.png"), np.asarray(fitted))
    true_pos = np.asarray(tables_true.prim_pos[1])
    fit_pos = np.asarray(res.tables.prim_pos[1])
    ce = np.abs(np.asarray(res.tables.prim_color[1])
                - np.asarray(tables_true.prim_color[1])).max()
    print(f"loss {res.losses[0]:.6f} -> {res.losses[-1]:.6f} "
          f"({res.losses[0] / max(res.losses[-1], 1e-12):.1f}x reduction)")
    print(f"julia position error: {np.abs(fit_pos - true_pos).max():.4f} "
          f"(was {np.abs(np.asarray(tables0.prim_pos[1]) - true_pos).max():.4f})")
    print(f"julia size: {float(res.tables.prim_aux[1, 0]):.4f} "
          f"(true {float(tables_true.prim_aux[1, 0]):.4f}, "
          f"start {float(tables0.prim_aux[1, 0]):.4f}); "
          f"color err {ce:.4f}")
    print(f"images in {args.out}/: target.png initial.png fitted.png")


if __name__ == "__main__":
    main()
