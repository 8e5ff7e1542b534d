"""Scaling-efficiency harness: rays/s vs mesh size.

On a multi-GPU host this measures the ray-sharded training step (the
``auto`` backend: the mega kernel path on a GPU) at every mesh width;
``--fake`` runs it against an 8-virtual-device CPU mesh (same code path,
demonstrates the harness).  Each rep ends in ``jax.block_until_ready``.

    python benchmarks/scaling.py [--devices 1 2 4] [--fake] [--json PATH]

The JSON record is machine-readable for the BASELINE gate; when measured
on virtual CPU devices it carries ``"fake_mesh": true`` — those numbers
validate the code path only (virtual devices share the host's cores).
The multi-GPU procedure is docs/SCALING_RUNBOOK.md.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="*", default=None)
    ap.add_argument("--fake", action="store_true",
                    help="force an 8-virtual-device CPU mesh")
    ap.add_argument("--json", default=None, help="write the record here")
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    if args.fake:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8")
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raymarching_tpu import RenderConfig, compile_scene, load_scene
    from raymarching_tpu.parallel.sharded import make_mesh, train_step
    from raymarching_tpu.parallel import distributed

    distributed.initialize()

    fake = jax.devices()[0].platform == "cpu"
    if fake:
        print("NOTE: virtual CPU devices share the same host cores — "
              "efficiency numbers here only validate the code path, not "
              "scaling (docs/SCALING_RUNBOOK.md).")
    n_avail = len(jax.devices())
    sizes = args.devices or [n for n in (1, 2, 4, 8, 16, 32) if n <= n_avail]
    scene = load_scene(os.path.join(os.path.dirname(__file__), "..",
                                    "scenes", "config3.txt"))
    plan, tables = compile_scene(scene)

    from raymarching_tpu.api import resolve_backend
    from raymarching_tpu.utils.timing import device_record
    backend = resolve_backend("auto")
    record = {
        "metric": "ray_sharded_train_step_scaling",
        "fake_mesh": bool(fake),
        "backend": backend,
        "device": device_record(),
        "processes": int(jax.process_count()),
        "scene": "config3.txt",
        "image": [args.width, args.height],
        "widths": [],
    }
    base_rate = None
    for n in sizes:
        cfg = RenderConfig(width=args.width,
                           height=(args.height // n) * n or n,
                           ssaa=1, iterations=300, normal_mode="analytic")
        mesh = make_mesh(n)
        target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
        step = jax.jit(lambda t: train_step(plan, t, target, cfg, mesh,
                                            lr=0.0, backend=backend))
        jax.block_until_ready(step(tables))  # compile + warm
        ts, cs = [], []
        for _ in range(max(args.reps, 1)):
            c0 = time.process_time()
            t0 = time.perf_counter()
            jax.block_until_ready(step(tables))
            ts.append(time.perf_counter() - t0)
            cs.append(time.process_time() - c0)
        dt = float(np.median(ts))
        cpu_s = float(np.median(cs))
        rate = cfg.rays_per_image / dt / 1e6
        if base_rate is None:
            base_rate = rate / n
        eff = rate / (base_rate * n) * 100.0
        record["widths"].append({
            "devices": int(n), "seconds": dt,
            "mrays_per_s": round(rate, 4),
            "efficiency_pct": round(eff, 1),
            "cpu_seconds": round(cpu_s, 3),
            "host_cores_utilized": round(cpu_s / dt, 2),
        })
        print(f"devices={n:3d}: {dt:7.3f}s  {rate:8.3f} Mrays/s "
              f"efficiency={eff:6.1f}%  util={cpu_s / dt:4.2f} cores  "
              f"[{record['device'].get('card', record['device']['kind'])}]")

    two = next((w for w in record["widths"] if w["devices"] == 2), None)
    if two is not None:
        record["efficiency_at_2_pct"] = two["efficiency_pct"]
        record["baseline_target_pct"] = 85.0
        record["meets_target"] = (bool(two["efficiency_pct"] >= 85.0)
                                  if not fake else None)
    if fake:
        # The fake-mesh curve "degrades" past the host's physical core
        # count — diagnose it IN the artifact.  Total CPU
        # seconds are ~constant across widths (the work is fixed); wall
        # time only tracks how completely the host cores get saturated
        # (n=1 leaves the XLA CPU intra-op pool under-subscribed; wider
        # meshes close the gap until util == physical cores, after which
        # extra virtual devices add only scheduler noise).  So fake-mesh
        # "efficiency" measures HOST-CORE SATURATION, not device scaling —
        # a multi-GPU host runs each width on its own cards
        # (docs/SCALING_RUNBOOK.md).
        host_cores = os.cpu_count()    # LOGICAL CPUs (SMT counts double)
        cpu_tot = [w["cpu_seconds"] for w in record["widths"]]
        record["diagnosis"] = {
            "host_logical_cpus": host_cores,
            "cpu_seconds_spread_pct": round(
                100.0 * (max(cpu_tot) - min(cpu_tot)) / min(cpu_tot), 1),
            "summary": (
                "harness artifact: all virtual devices share "
                f"{host_cores} logical host CPUs; total CPU-seconds are flat "
                "across widths while wall time tracks core saturation "
                "(see host_cores_utilized) — widths past the core count "
                "cannot improve and jitter +/- a few % explains the "
                "8-device knee.  Not a statement about device scaling."),
        }
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
