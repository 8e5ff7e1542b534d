"""BASELINE config ladder: render every rung, gate on allclose, report.

The five rungs from BASELINE.json plus the beyond-reference rung 6:
  1. single Sphere + one light, no shadows, no SSAA, 256^2
  2. Box + Cross, multiple lights + hard shadows, 512^2
  3. DeathStar + SSAA 2x2
  4. MengerSponge iters=2 with shadows + SSAA (camera-pose grads checked)
  5. full demo scene: MengerSponge iters=3, SSAA 3x3, 1024^2
  6. MengerSponge iters=4 — 8,422 primitives, beyond anything the
     reference ever rendered (its own demo caps at iters=3,
     objects.txt:22; body.cpp:149-156 recursion).  Exact tables: the
     static lattice collapse is column-capped (scene/compile.py
     _LATTICE_MAX_COLS) so the field folds via ``lax.fori_loop`` runs and
     the 8.4k-prim program compiles in seconds, not minutes.
  7. scatter1k — 1,000 scattered spheres (scenes/make_scatter.py), the
     worst shape for the reference's O(N)-per-evaluation UNION fold
     (body.cpp:66-111).  Exercises the wide-UNION chunk cull
     (scene/compile.py GroupPlan.bvh): chunks whose live bounding box
     provably cannot win are skipped per tile, exactly.

Timing: each rep is one frame (a scalar reduction of the image) ended by
``jax.block_until_ready``; the median of the reps is reported beside the
device and the card's name and power limit.  The allclose gate fetches
one full frame, untimed.

Each rung renders on the fast backend and is allclose-gated against the
jnp oracle.  Run on a GPU host:

    python benchmarks/ladder.py [--quick] [--json PATH]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="smaller resolutions (CI-sized)")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed frames per rung")
    ap.add_argument("--json", default="", help="write records here")
    args = ap.parse_args()
    from raymarching_tpu.utils.cache import setup_compile_cache
    setup_compile_cache()

    from raymarching_tpu import RenderConfig, compile_scene, load_scene
    from raymarching_tpu.api import render_tables, resolve_backend

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "..", "scenes")
    q = 4 if args.quick else 1
    # (name, scene file, cfg overrides, gate overrides) — gate overrides
    # shrink the oracle render where the jnp path's [chunk, prims] distance
    # matrix would not fit (rung 6's 8.4k prims).
    rungs = [
        ("config1", "config1.txt",
         dict(width=256 // q, height=256 // q, ssaa=1, shadows=False), {}),
        ("config2", "config2.txt",
         dict(width=512 // q, height=512 // q, ssaa=1, shadows=True), {}),
        ("config3", "config3.txt",
         dict(width=512 // q, height=512 // q, ssaa=2, shadows=True), {}),
        ("config4", "config4.txt",
         dict(width=512 // q, height=512 // q, ssaa=2, shadows=True), {}),
        ("config5", "demo.txt",
         dict(width=1024 // q, height=1024 // q, ssaa=3, shadows=True),
         # gate at 512^2 ssaa2: the reduced gate pins the same
         # kernels/semantics at the same scene for a fraction of the
         # 9.4M-ray oracle render
         dict(width=512, height=512, ssaa=2)),
        ("menger4", "menger4.txt",
         dict(width=512 // q, height=512 // q, ssaa=2, shadows=True),
         dict(width=96, height=96, ssaa=1, ray_chunk=4096)),
        # rung 7 (beyond-reference): 1,000 scattered spheres — the shape
        # the reference's O(N) UNION fold handles worst (body.cpp:66-111
        # pays all 1,000 SDFs per march step per ray).  Exercises the
        # wide-UNION chunk cull (scene/compile.py GroupPlan.bvh).
        ("scatter1k", "scatter1k.txt",
         dict(width=512 // q, height=512 // q, ssaa=2, shadows=True),
         dict(width=128, height=128, ssaa=1, ray_chunk=16384)),
    ]
    from raymarching_tpu.utils.timing import device_record
    device = device_record()
    backend = resolve_backend(args.backend)
    print(f"backend: {backend}  device: {device}")
    records = []

    for name, scene_file, over, gate_over in rungs:
        scene = load_scene(os.path.join(here, scene_file))
        plan, tables = compile_scene(scene)
        cfg = RenderConfig(iterations=1000, normal_mode="fd",
                           ray_chunk=65536, **over)
        f = jax.jit(lambda t, c=cfg: jnp.mean(
            render_tables(plan, t, c, backend=backend)))
        t0 = time.perf_counter()
        jax.block_until_ready(f(tables))     # compile + warm
        compile_s = time.perf_counter() - t0
        rates = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(f(tables))
            rates.append(cfg.rays_per_image
                         / (time.perf_counter() - t0) / 1e6)
        mrays = float(np.median(rates))

        # allclose gate against the jnp path: an independent implementation
        # of the same exact-table semantics (XLA while-march + scene_sd —
        # none of the Pallas kernel code); jnp==ref equivalence is covered
        # by the CI suite, so transitively this anchors the published
        # number to the oracle.  Isolated pixels on shadow/occlusion edges
        # can flip from last-ulp f32 differences between compiled backends,
        # so the gate is "99.5% of pixels within 5e-3" (the test-suite
        # contract), with the median reported for the bulk.
        gate_cfg = cfg.replace(**gate_over) if gate_over else cfg
        a = np.asarray(render_tables(plan, tables, gate_cfg,
                                     backend=backend))
        gate_backend = "jnp" if backend != "jnp" else "ref"
        b = np.asarray(render_tables(plan, tables, gate_cfg,
                                     backend=gate_backend))
        diff = np.abs(a - b).max(axis=-1)
        frac = float((diff < 5e-3).mean())
        gate = "OK" if frac > 0.995 else f"FAIL ({frac:.4f} within tol)"

        print(f"{name:9s} {cfg.width}x{cfg.height} ssaa{cfg.ssaa} "
              f"{plan.num_primitives:4d} prims: compile {compile_s:6.1f}s "
              f"{mrays:8.2f} Mrays/s  allclose[{gate}] "
              f"median={np.median(diff):.2e} max={diff.max():.2e}",
              flush=True)
        records.append({
            "rung": name, "width": cfg.width, "height": cfg.height,
            "ssaa": cfg.ssaa, "prims": plan.num_primitives,
            "compile_s": round(compile_s, 1), "mrays": round(mrays, 3),
            "gate_ok": frac > 0.995, "gate_frac": round(frac, 5),
            "reps": args.reps,
        })

    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"backend": backend, "device": device,
                       "rungs": records}, fh, indent=1)


if __name__ == "__main__":
    main()
