"""Benchmark: Mrays/s forward+backward on one GPU, MengerSponge scene.

Workload (BASELINE.json north star): the demo scene (MengerSponge iters=3 +
DeathStar + 2 spheres + floor + bounds, 2 lights — 428 primitives) at
512x512, SSAA 2x2, 1000 march iterations, hard shadows: one forward render
fused with a full backward sweep (gradients to every scene parameter).

Prints the card's name and power limit, then ONE JSON line: {"metric",
"value", "unit", "vs_baseline", "device", ...}.  Exits non-zero when the
default JAX device is not a GPU.  The fwd+bwd regimes measured and
reported every run:

  * ``exact_mrays``  — exact reference-table semantics (the apples-to-apples
    number against the reference's own math), FD normals — bit-parity with
    the reference's own estimator (scene.cpp:70-89);
  * ``exact_analytic_mrays`` — exact tables + analytic winner-gradient
    normals (same field, a.e.-equal estimator);
  * ``fused_mrays``  — the opt-in space-folded Menger mode (same zero set,
    conservative distances) with in-kernel analytic normals; eligible for
    the headline only if its image passes the allclose gate against the
    exact path AT THE HEADLINE FOOTPRINT (utils.gatecheck.fused_gate).

Forward-only serving regimes (the reference's own protocol — its 0.038
Mrays/s GTX 1060 baseline never computes a gradient, main.cpp:69-77):

  * ``forward_exact_mrays`` — exact semantics, FD normals, black-lane
    shadow skip engaged (bit-identical image; forward-only by design);
  * ``forward_mrays`` — the fused+analytic serving fast path (gated by the
    same headline-footprint gate).

Each rep is one frame ended by ``jax.block_until_ready``; the median and
spread of the reps are reported.  The headline ``value`` is the fused
fwd+bwd number when the gate passes, else the exact number.
``vs_baseline`` is informational: the reference's GL compute shader
renders 1024x768 SSAA 3x3 in 185.161 s on a GTX 1060 (reference
README.md:95) = 0.0382 Mrays/s, forward only.

``python bench.py --sweep`` instead times the exact regime (fwd+bwd and
forward-only) at each ``RenderConfig.ray_block`` in SWEEP_BLOCKS (warps
per program follow the block: one ray per thread, at most 8 warps) and
prints one JSON line per block, then one with all of them.
"""

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

BASELINE_MRAYS = 7.0778880e6 / 185.161 / 1e6  # 0.03822 Mrays/s (GTX 1060)
SWEEP_BLOCKS = (64, 128, 256, 512)


def _stats(rates):
    rates = np.asarray(rates)
    return {
        "median": float(np.median(rates)),
        "min": float(rates.min()),
        "max": float(rates.max()),
        "spread_pct": float(100.0 * (rates.max() - rates.min())
                            / np.median(rates)),
        "reps": int(len(rates)),
    }


def _measure(plan, tables, cfg, backend, reps=7, forward_only=False):
    """Per-frame throughput stats: ``reps`` frames, each timed alone and
    ended by ``jax.block_until_ready``, after one compile+warm call.

    ``forward_only`` measures the primal render (the serving protocol —
    no gradient is traced, so the black-lane shadow skip stays engaged).
    """
    from raymarching_tpu.api import render_tables

    def loss_fn(t):
        return jnp.mean(render_tables(plan, t, cfg, backend=backend))

    if forward_only:
        step = jax.jit(lambda t: (loss_fn(t),))
    else:
        step = jax.jit(jax.value_and_grad(loss_fn))

    # compile + warm + sanity (fetch everything once)
    out = step(tables)
    loss = float(out[0])
    assert loss > 0, "degenerate render"
    if not forward_only:
        g = np.asarray(out[1].prim_pos)
        assert np.all(np.isfinite(g)), "non-finite gradients"

    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(step(tables))
        rates.append(cfg.rays_per_image / (time.perf_counter() - t0) / 1e6)
    return _stats(rates)


def _serve_gate(plan, tables, cfg, backend):
    """Allclose gate for the in-kernel raygen serving path
    (RenderConfig.serve_raygen) at the headline footprint: the kernel's
    own direction math vs the standard jnp raygen differ only by ulps
    (same formulas, different fusion), so the images must agree
    essentially everywhere.  Returns (ok, stats)."""
    from raymarching_tpu.api import render_tables

    if backend not in ("pallas", "mega"):
        return False, {}
    std = jax.jit(lambda t: render_tables(plan, t, cfg, backend=backend))
    scfg = cfg.replace(serve_raygen=True)
    srv = jax.jit(lambda t: render_tables(plan, t, scfg, backend=backend))
    a = np.asarray(std(tables))
    b = np.asarray(srv(tables))
    diff = np.abs(a - b).max(axis=-1)
    thresh = 5e-3
    frac = float((diff < thresh).mean())
    stats = {
        "serve_gate_frac_within": round(frac, 6),
        "serve_gate_max_diff": round(float(diff.max()), 6),
    }
    return frac > 0.995, stats


def _device() -> dict:
    """The default device record (utils.timing.device_record); exits
    non-zero when it is not a GPU."""
    from raymarching_tpu.utils.timing import device_record

    dev = device_record()
    if dev["platform"] != "gpu":
        sys.exit(f"bench.py measures a GPU; the default JAX device is "
                 f"{dev['platform']}")
    return dev


def _sweep(plan, tables, cfg, backend, dev):
    """Exact-regime Mrays/s at each ray block (see the module docstring)."""
    from raymarching_tpu.ops.pallas_march import _num_warps

    rows = []
    for block in SWEEP_BLOCKS:
        c = cfg.replace(ray_block=block)
        row = {"ray_block": block, "num_warps": _num_warps(block),
               "fwd_bwd": _measure(plan, tables, c, backend, reps=5),
               "forward": _measure(plan, tables, c, backend, reps=5,
                                   forward_only=True)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    print(json.dumps({"metric": "ray_block_sweep_mrays_per_s",
                      "backend": backend, "device": dev, "rows": [
                          {"ray_block": r["ray_block"],
                           "num_warps": r["num_warps"],
                           "fwd_bwd_mrays": r["fwd_bwd"]["median"],
                           "forward_mrays": r["forward"]["median"]}
                          for r in rows]}))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="time each ray block size instead")
    args = ap.parse_args(argv)
    from raymarching_tpu.utils.cache import setup_compile_cache
    setup_compile_cache()
    dev = _device()
    print(f"card: {dev['card']}", flush=True)

    from raymarching_tpu import RenderConfig, compile_scene, load_scene
    from raymarching_tpu.api import resolve_backend
    from raymarching_tpu.utils.gatecheck import fused_gate

    width = height = 512
    ssaa = 2
    cfg = RenderConfig(width=width, height=height, ssaa=ssaa,
                       iterations=1000, shadows=True,
                       normal_mode="fd", ray_chunk=65536)
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    scene = load_scene(os.path.join(here, "scenes", "demo.txt"))
    plan, tables = compile_scene(scene)
    backend = resolve_backend("auto")
    if args.sweep:
        return _sweep(plan, tables, cfg, backend, dev)

    has_fused = backend in ("pallas", "mega") and any(
        g.fused for g in (plan.kernel.groups if plan.kernel else ()))

    # Gate first (compiles + validates the two forward paths the serving
    # regimes reuse), at the exact footprint the bench measures.
    fused_ok, gate_stats = (False, {})
    if has_fused:
        fused_ok, gate_stats = fused_gate(plan, tables, cfg, backend)

    # Forward-only serving regimes (the reference's own protocol): exact
    # semantics, and the gated fused fast path.  The black-lane shadow
    # skip stays engaged here — it is forward-only by design (the
    # custom-vjp fwd rule disables it whenever a gradient is traced) —
    # and so is the in-kernel raygen (RenderConfig.serve_raygen), gated
    # PER REGIME against the standard-raygen render of the SAME regime
    # (the fused+analytic+serve combination gets its own on-hardware
    # gate, not a transfer of the exact regime's).
    fcfg = cfg.replace(fused_generators=True, normal_mode="analytic")
    serve_ok, serve_stats = _serve_gate(plan, tables, cfg, backend)
    fwd_exact = _measure(plan, tables,
                         cfg.replace(serve_raygen=serve_ok),
                         backend, forward_only=True)
    fwd_fused = None
    if has_fused:
        serve_fused_ok, s2 = _serve_gate(plan, tables, fcfg, backend)
        serve_stats = dict(serve_stats)
        serve_stats.update({"serve_fused_" + k.removeprefix("serve_"): v
                            for k, v in s2.items()})
        serve_ok = serve_ok and serve_fused_ok
        fwd_fused = _measure(
            plan, tables, fcfg.replace(serve_raygen=serve_fused_ok),
            backend, forward_only=True)

    exact = _measure(plan, tables, cfg, backend)

    # Informational third regime: exact tables + analytic winner-gradient
    # normals.
    exact_analytic = _measure(plan, tables,
                              cfg.replace(normal_mode="analytic"), backend)

    # Fused-generator fast mode with ANALYTIC normals (the single-launch
    # winner-Hessian backward).  Eligible for the headline only when the
    # headline-footprint gate above passed.
    fused = _measure(plan, tables,
                     cfg.replace(fused_generators=True,
                                 normal_mode="analytic"),
                     backend) if has_fused else None

    # Headline: the faster of the two regimes (fused only when its image
    # passed the gate) — the exact regimes ride along in the JSON either way.
    use_fused = (fused_ok and fused
                 and fused["median"] > exact["median"])
    headline = fused["median"] if use_fused else exact["median"]
    tag = f"{backend}_fused" if use_fused else backend

    def rounded(d):
        return {k: (round(v, 4) if isinstance(v, float) else
                    ({kk: round(vv, 4) for kk, vv in v.items()}
                     if isinstance(v, dict) else v))
                for k, v in d.items()}

    fwd_serving = (fwd_fused if (fused_ok and fwd_fused
                                 and fwd_fused["median"]
                                 > fwd_exact["median"])
                   else fwd_exact)
    record = {
        "metric": f"mrays_per_s_fwd_bwd_menger512_ssaa2_{tag}",
        "value": round(headline, 4),
        "unit": "Mrays/s/chip",
        "vs_baseline": round(headline / BASELINE_MRAYS, 2),
        "device": dev,
        "timing_protocol": "per frame, ended by jax.block_until_ready",
        "exact_mrays": round(exact["median"], 4),
        "exact_vs_baseline": round(exact["median"] / BASELINE_MRAYS, 2),
        "exact_stats": rounded(exact),
        "exact_analytic_mrays": round(exact_analytic["median"], 4),
        "exact_analytic_stats": rounded(exact_analytic),
        "forward_mrays": round(fwd_serving["median"], 4),
        "forward_vs_baseline": round(fwd_serving["median"] / BASELINE_MRAYS,
                                     2),
        "forward_regime": ("fused_analytic" if fwd_serving is fwd_fused
                           else "exact_fd"),
        "forward_stats": rounded(fwd_serving),
        "forward_exact_mrays": round(fwd_exact["median"], 4),
        "forward_exact_stats": rounded(fwd_exact),
        "serve_raygen": serve_ok,
    }
    record.update(serve_stats)
    if fused is not None:
        record["fused_mrays"] = round(fused["median"], 4)
        record["fused_gate_ok"] = fused_ok
        record["fused_normal_mode"] = "analytic"
        record["fused_stats"] = rounded(fused)
        record.update(gate_stats)
        if fwd_fused is not None:
            record["forward_fused_mrays"] = round(fwd_fused["median"], 4)

    # The full record goes to stderr; the FINAL stdout line is a compact
    # record that keeps the device beside every rate.
    print(json.dumps(record), file=sys.stderr)
    compact = {k: record[k] for k in (
        "metric", "value", "unit", "vs_baseline", "device", "exact_mrays",
        "exact_analytic_mrays", "forward_mrays", "forward_vs_baseline",
        "forward_exact_mrays") if k in record}
    for k in ("fused_mrays", "fused_gate_ok", "gate_frac_within",
              "gate_max_diff", "gate_pixels_over",
              "gate_offenders_on_silhouette", "gate_offenders_interior",
              "serve_raygen"):
        if k in record:
            compact[k] = record[k]
    compact["spread_pct"] = (record.get("fused_stats") or
                             record["exact_stats"])["spread_pct"]
    print(json.dumps(compact))
    return 0


if __name__ == "__main__":
    sys.exit(main())
