"""Command-line driver.

Replacement for the reference's fixed main() pipeline
(main.cpp:17-88): load scene -> render through the selected backend(s) with
per-phase wall-clock prints -> save image.  Unlike the reference (no argv at
all), everything is a flag; defaults reproduce the reference configuration
(1024x768, SSAA 3x3, 1000 iterations).

    python -m raymarching_tpu --scene scenes/demo.txt --out out.png
    python -m raymarching_tpu --scene scenes/demo.txt --backend ref,pallas \
        --width 512 --height 384 --ssaa 2 --compare
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .api import render_tables_jit, resolve_backend
from .config import RenderConfig
from .io.image import save_image
from .scene.compile import compile_scene
from .scene.parser import load_scene
from .utils.timing import Phase


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raymarching_tpu",
        description="differentiable sphere-tracing renderer")
    p.add_argument("--scene", required=True, help="scene text file "
                   "(reference objects.txt grammar)")
    p.add_argument("--out", default=None,
                   help="output image (.png/.ppm/.jpg/.pfm; default out.png;"
                   " with --mesh and no --out the render is skipped)")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--ssaa", type=int, default=3, help="SSAA kernel size")
    p.add_argument("--iterations", type=int, default=1000)
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--backend", default="auto",
                   help="comma list of ref|jnp|pallas|auto")
    p.add_argument("--normal-mode", choices=("fd", "analytic"), default="fd",
                   help="fd = reference central differences; analytic = "
                   "exact SDF gradient (faster)")
    p.add_argument("--no-shadows", action="store_true")
    p.add_argument("--soft-shadow-k", type=float, default=0.0,
                   help="penumbra sharpness for soft shadows (extension; "
                   "0 = reference-parity hard boolean)")
    p.add_argument("--reflect", type=float, default=0.0, metavar="S",
                   help="mirror reflection strength in [0, 1), 0 = off "
                        "(tinted-mirror extension)")
    p.add_argument("--bounces", type=int, default=1,
                   help="mirror bounce count (with --reflect)")
    p.add_argument("--ao", type=float, default=0.0, metavar="STRENGTH",
                   help="SDF ambient-occlusion strength (extension; 0 = off)")
    p.add_argument("--aperture", type=float, default=0.0, metavar="RADIUS",
                   help="thin-lens aperture radius in world units "
                        "(extension; 0 = pinhole; blur quality scales "
                        "with --ssaa)")
    p.add_argument("--focus", type=float, default=6.0, metavar="DIST",
                   help="focus-plane distance along the view axis "
                        "(with --aperture)")
    p.add_argument("--ray-chunk", type=int, default=0,
                   help="rays per chunk (bounds memory on the jnp path)")
    p.add_argument("--row-block", type=int, default=0, metavar="N",
                   help="stream the frame through the device N rows at a "
                   "time (api.render_tiled) — renders frames whose full "
                   "ray set exceeds HBM; single-frame mode only")
    p.add_argument("--animate", type=int, default=0, metavar="N",
                   help="render an N-frame turntable orbit instead of one "
                   "image; --out .gif writes an animated GIF, otherwise "
                   "numbered frames <out>_000.png ... (serve /animate twin)")
    p.add_argument("--orbit", type=float, default=360.0, metavar="DEG",
                   help="turntable sweep in degrees (with --animate)")
    p.add_argument("--delay-cs", type=int, default=4,
                   help="GIF frame delay in centiseconds (with --animate)")
    p.add_argument("--mesh", default=None, metavar="PATH",
                   help="also extract the scene's zero isosurface as a "
                   "triangle mesh (.obj/.ply; marching tetrahedra over a "
                   "device-sampled SDF grid)")
    p.add_argument("--mesh-res", type=int, default=128,
                   help="mesh grid samples per axis (with --mesh)")
    p.add_argument("--mesh-bounds", type=float, nargs=6, default=None,
                   metavar=("X0", "Y0", "Z0", "X1", "Y1", "Z1"),
                   help="mesh grid world bounds (default: the scene's "
                   "solid-geometry bounding box)")
    p.add_argument("--compare", action="store_true",
                   help="report max abs difference between backends")
    p.add_argument("--profile", default=None, metavar="LOGDIR",
                   help="capture a jax.profiler trace")
    p.add_argument("--stats", action="store_true",
                   help="print march convergence / iteration statistics")
    p.add_argument("--log-json", default=None, metavar="PATH",
                   help="append structured JSON-lines events (per-host "
                   "provenance) to PATH; '-' for stderr")
    p.add_argument("--selfcheck", action="store_true",
                   help="deterministic re-run + oracle check before "
                   "rendering; nonzero exit on failure")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .utils.cache import setup_compile_cache
    setup_compile_cache()

    import os
    render_wanted = args.out is not None or args.mesh is None
    out = args.out if args.out is not None else "out.png"
    ext = os.path.splitext(out)[1].lower()
    if args.animate > 0 and ext == ".gif":
        pass
    elif render_wanted and ext not in (".png", ".ppm", ".jpg", ".jpeg",
                                       ".pfm", ""):
        print(f"error: unsupported output format {ext!r} "
              "(png, ppm, jpg, pfm are supported)", file=sys.stderr)
        return 2
    if args.mesh is not None and not args.mesh.lower().endswith(
            (".obj", ".ply")):
        print(f"error: unsupported mesh format {args.mesh!r} "
              "(obj, ply are supported)", file=sys.stderr)
        return 2
    if not os.path.exists(args.scene):
        print(f"error: scene file not found: {args.scene}", file=sys.stderr)
        return 2

    if args.log_json:
        from .utils.structlog import configure
        log = configure(path=None if args.log_json == "-" else args.log_json)
        log.log("start", scene=args.scene,
                resolution=[args.width, args.height], ssaa=args.ssaa)

    from .utils.structlog import emit

    with Phase("scene load"):
        scene = load_scene(args.scene)
        plan, tables = compile_scene(scene)
    print(f"scene: {plan.num_primitives} primitives, "
          f"{plan.num_lights} lights, "
          f"kernel-form={'yes' if plan.kernel else 'no'}")
    emit("scene", primitives=int(plan.num_primitives),
         lights=int(plan.num_lights), kernel_form=plan.kernel is not None)

    cfg = RenderConfig(
        width=args.width, height=args.height, ssaa=args.ssaa,
        iterations=args.iterations, gamma=args.gamma,
        shadows=not args.no_shadows, normal_mode=args.normal_mode,
        ray_chunk=args.ray_chunk, soft_shadow_k=args.soft_shadow_k,
        ao_strength=args.ao, reflect_strength=args.reflect,
        reflect_bounces=args.bounces, aperture=args.aperture,
        focus_dist=args.focus)

    backends = [resolve_backend(b.strip())
                for b in args.backend.split(",") if b.strip()]
    rays = cfg.rays_per_image
    images = {}

    # Host -> device upload of the scene tables, timed separately like the
    # reference's render::push SSBO upload (main.cpp:59-63): demonstrates
    # that scene upload is negligible next to rendering.
    import jax
    with Phase("push (tables to device)"):
        tables = jax.device_put(tables)
        jax.block_until_ready(tables)

    if args.selfcheck:
        from .utils.selfcheck import assert_healthy
        try:
            report = assert_healthy(plan, tables, backend=backends[-1])
        except RuntimeError as e:
            print(f"selfcheck FAILED: {e}", file=sys.stderr)
            return 3
        print(f"selfcheck ok (rerun x{report['rerun']['repeats']} bitwise, "
              f"oracle bad-frac {report['oracle']['bad_pixel_frac']:.4f})")

    if args.mesh is not None:
        from .io.mesh import extract_mesh, save_mesh
        bounds = None
        if args.mesh_bounds is not None:
            b = args.mesh_bounds
            bounds = (b[:3], b[3:])
        with Phase("mesh extract"):
            verts, faces = extract_mesh(
                plan, tables, resolution=max(2, args.mesh_res),
                bounds=bounds, backend=backends[-1])
        with Phase("mesh save"):
            save_mesh(args.mesh, verts, faces)
        print(f"wrote {args.mesh} ({len(verts)} vertices, "
              f"{len(faces)} triangles)")
        emit("mesh", out=args.mesh, vertices=int(len(verts)),
             triangles=int(len(faces)))
        if not render_wanted:
            emit("done", out=args.mesh)
            return 0

    if args.animate > 0:
        import math

        from .api import turntable_frames
        from .utils.timing import profiler_trace
        if args.compare or len(backends) > 1 or args.row_block > 0:
            print("error: --animate renders one backend; --compare / "
                  "multi-backend lists / --row-block apply to "
                  "single-frame mode only", file=sys.stderr)
            return 2
        backend = backends[-1]
        if args.stats:
            import json as _json

            from .utils.timing import profile_march
            stats_cfg = cfg.replace(width=min(cfg.width, 256),
                                    height=min(cfg.height, 192), ssaa=1)
            print("march stats (primary rays, reduced res):",
                  _json.dumps(profile_march(plan, tables, stats_cfg)))
        rays_total = args.animate * rays
        with profiler_trace(args.profile):
            with Phase(f"{backend} animate x{args.animate}",
                       rays=rays_total) as ph:
                frames = [np.asarray(f) for f in turntable_frames(
                    plan, tables, cfg, args.animate,
                    orbit=math.radians(args.orbit), backend=backend)]
                ph.sync(frames[-1])
        emit("animate", backend=backend, frames=args.animate,
             seconds=round(ph.seconds, 6),
             mrays_per_s=round(rays_total / ph.seconds / 1e6, 4))
        with Phase("save"):
            if ext == ".gif":
                from .io.gif import encode_gif
                from .io.image import to_uint8
                data = encode_gif(
                    (to_uint8(f, cfg.gamma) for f in frames),
                    delay_cs=max(1, min(args.delay_cs, 1000)))
                with open(out, "wb") as fh:
                    fh.write(data)
                print(f"wrote {out} ({args.animate} frames)")
            else:
                stem, fext = os.path.splitext(out)
                for i, f in enumerate(frames):
                    save_image(f"{stem}_{i:03d}{fext or '.png'}", f,
                               gamma=cfg.gamma)
                print(f"wrote {stem}_000{fext or '.png'} .. "
                      f"{stem}_{len(frames) - 1:03d}{fext or '.png'}")
        emit("done", out=out)
        return 0

    from .utils.timing import profiler_trace
    with profiler_trace(args.profile):
        for backend in backends:
            if args.row_block > 0:
                # One streamed pass only: --row-block targets frames whose
                # wall-clock is already very long, so the usual warm re-run
                # would double it.  The single timing therefore includes
                # the (one-block) compile.
                from .api import render_tiled
                with Phase(f"{backend} compile+render (tiled)",
                           rays=rays) as ph:
                    img = ph.sync(render_tiled(plan, tables, cfg,
                                               row_block=args.row_block,
                                               backend=backend))
            else:
                with Phase(f"{backend} compile+render", rays=rays) as ph:
                    img = ph.sync(render_tables_jit(plan, tables, cfg,
                                                    backend))
                with Phase(f"{backend} render", rays=rays) as ph:
                    img = ph.sync(render_tables_jit(plan, tables, cfg,
                                                    backend))
            images[backend] = img
            emit("render", backend=backend, seconds=round(ph.seconds, 6),
                 mrays_per_s=round(rays / ph.seconds / 1e6, 4))

    if args.compare and len(images) > 1:
        names = list(images)
        ref = images[names[0]]
        for other in names[1:]:
            diff = float(np.abs(images[other] - ref).max())
            print(f"max |{other} - {names[0]}| = {diff:.2e}")

    if args.stats:
        import json as _json

        from .utils.timing import profile_march
        stats_cfg = cfg.replace(width=min(cfg.width, 256),
                                height=min(cfg.height, 192), ssaa=1)
        print("march stats (primary rays, reduced res):",
              _json.dumps(profile_march(plan, tables, stats_cfg)))

    final = images[backends[-1]]
    with Phase("save"):
        save_image(out, final, gamma=cfg.gamma)
    print(f"wrote {out}")
    emit("done", out=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
