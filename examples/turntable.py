"""Turntable animation: render N frames orbiting the demo scene.

Production-shaped throughput demo — the jit cache makes every frame after
the first hot (only the camera pytree changes, never the traced program).

    python examples/turntable.py [--frames 24] [--out /tmp/turntable]
"""

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--out", default="/tmp/turntable")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=384)
    ap.add_argument("--backend", default="auto")
    args = ap.parse_args()
    from raymarching_tpu.utils.cache import setup_compile_cache
    setup_compile_cache()

    import jax

    from raymarching_tpu import RenderConfig, compile_scene, load_scene
    from raymarching_tpu.api import render_tables, resolve_backend
    from raymarching_tpu.io.image import save_image

    here = os.path.dirname(os.path.abspath(__file__))
    scene = load_scene(os.path.join(here, "..", "scenes", "demo.txt"))
    plan, tables = compile_scene(scene)
    cfg = RenderConfig(width=args.width, height=args.height, ssaa=2,
                       iterations=1000, normal_mode="fd",
                       fused_generators=True)
    backend = resolve_backend(args.backend)
    render = jax.jit(lambda t: render_tables(plan, t, cfg, backend=backend))

    # Orbit the original camera position around the scene centre.
    centre = np.array([5.0, 5.0, -35.0], np.float32)
    p0 = np.asarray(tables.cam_position) - centre
    radius = float(np.linalg.norm(p0[[0, 2]]))
    phi0 = math.atan2(float(p0[2]), float(p0[0]))

    os.makedirs(args.out, exist_ok=True)
    times = []
    for i in range(args.frames):
        phi = phi0 + 2.0 * math.pi * i / args.frames
        pos = centre + np.array([radius * math.cos(phi), float(p0[1]),
                                 radius * math.sin(phi)], np.float32)
        look = centre - pos
        t = tables._replace(cam_position=pos,
                            cam_direction=look / np.linalg.norm(look))
        t0 = time.perf_counter()
        img = np.asarray(render(t))
        times.append(time.perf_counter() - t0)
        save_image(os.path.join(args.out, f"frame_{i:03d}.png"), img)

    steady = times[1:] or times
    print(f"{args.frames} frames -> {args.out}; first (compile) "
          f"{times[0]:.2f}s, steady {np.mean(steady):.3f}s/frame "
          f"({1.0 / np.mean(steady):.1f} fps at "
          f"{args.width}x{args.height} SSAA2)")


if __name__ == "__main__":
    main()
