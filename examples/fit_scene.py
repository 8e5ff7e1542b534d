"""Differentiable rendering demo: recover perturbed scene parameters.

The capability the reference renderer could never have: render a target
image, perturb the scene (sphere positions, radii, colors, a light), and
gradient-descend the parameters back by comparing rendered pixels — the
gradients flow through the iterative sphere-trace via the implicit-function
backward.

    python examples/fit_scene.py [--steps 150] [--out /tmp/fit]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--out", default="/tmp/fit")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args()
    from raymarching_tpu.utils.cache import setup_compile_cache
    setup_compile_cache()

    from raymarching_tpu import RenderConfig, compile_scene, load_scene
    from raymarching_tpu.api import render_tables, resolve_backend
    from raymarching_tpu.io.image import save_image
    from raymarching_tpu.optimize import fit

    backend = resolve_backend(args.backend or "auto")
    here = os.path.dirname(os.path.abspath(__file__))
    scene = load_scene(os.path.join(here, "..", "scenes", "config3.txt"))
    plan, tables_true = compile_scene(scene)
    cfg = RenderConfig(width=128, height=96, ssaa=1, iterations=300,
                       shadows=True, normal_mode="analytic")

    target = render_tables(plan, tables_true, cfg, backend=backend)

    # Perturb: shift + shrink the DeathStar, move a light, tint the sphere.
    rng = np.random.default_rng(0)
    pos = np.array(tables_true.prim_pos)
    aux = np.array(tables_true.prim_aux)
    col = np.array(tables_true.prim_color)
    lp = np.array(tables_true.light_pos)
    pos[2:4] += rng.normal(0, 0.4, (2, 3))
    aux[2:4, 0] *= 0.8
    col[4] = np.clip(col[4] + 0.3, 0, 1)
    lp[0] += np.array([2.0, -1.0, 1.0])
    tables0 = tables_true._replace(prim_pos=pos, prim_aux=aux,
                                   prim_color=col, light_pos=lp)

    os.makedirs(args.out, exist_ok=True)
    save_image(os.path.join(args.out, "target.png"), np.asarray(target))
    save_image(os.path.join(args.out, "initial.png"),
               np.asarray(render_tables(plan, tables0, cfg,
                                        backend=backend)))

    def cb(step, loss, _):
        if step % 25 == 0:
            print(f"step {step:4d}  loss {loss:.6f}")

    res = fit(plan, tables0, target, cfg, steps=args.steps, lr=2e-2,
              backend=backend,
              trainable=("prim_pos", "prim_aux", "prim_color", "light_pos"),
              checkpoint_path=os.path.join(args.out, "ckpt.npz"),
              callback=cb)

    fitted = render_tables(plan, res.tables, cfg, backend=backend)
    save_image(os.path.join(args.out, "fitted.png"), np.asarray(fitted))
    print(f"loss {res.losses[0]:.6f} -> {res.losses[-1]:.6f} "
          f"({res.losses[0] / max(res.losses[-1], 1e-12):.1f}x reduction)")
    print(f"images in {args.out}/: target.png initial.png fitted.png")


if __name__ == "__main__":
    main()
