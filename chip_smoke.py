"""Smoke run of the renderer's main path on one NVIDIA GPU.

    python chip_smoke.py                 # one card: phases 1-5
    python chip_smoke.py --devices 4     # four cards: the sharded phase only

Phases (any failure raises, so the exit code is non-zero and no result
line is printed):

1. device   - the default JAX device must be a GPU; prints the card's name
              and power limit (nvidia-smi).
2. kernels  - every kernel variant compiled at the bench width (demo scene,
              512x512 SSAA 2x2, 1000 iterations) and compared once with the
              ``ref`` jnp oracle; compile seconds and memory analysis.
3. main     - ``api.render_tables`` under ``jax.value_and_grad`` on the
              kernel path, its gradients against ``backend="jnp"``, frame
              times of the kernel path and of ``jnp``, 3 ``optimize.fit``
              Adam steps, and ``serve.py``'s handler answering 3 /render
              requests and one /aovs request.
4. scenes   - every ``scenes/*.txt`` forward on the kernel path at 128x128
              against ``ref``, plus one finite forward+backward.
5. gpu-tests - the tests marked ``gpu``, run by pytest inside this
              process (one JAX process per card).
6. multi    - only with ``--devices 4``: the ray-sharded ``train_step``
              gradients and a ``render_rays_sharded`` bundle gradient over
              a 4-card mesh against the same computation on one card.

Every comparison runs under ``jax.default_matmul_precision("highest")``.
The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
SCENES = HERE / "scenes"

# Exact regimes vs the oracle: mean |diff| and the share of values within
# 1e-3.  Triton contracts mul+add into FMA, so rays near the convergence
# threshold may flip; bitwise parity is not expected.
MEAN_TOL = 1e-4
ELEM_TOL = 1e-3
FRAC_MIN = 0.999
GRAD_RTOL = 1e-3            # relative L2, kernel path vs jnp (same IFT)
SHARD_LOSS_RTOL = 1e-6      # four cards vs one: psum order differs
SHARD_GRAD_RTOL = 1e-5
SHARD_GEOM_GRAD_RTOL = 2e-4  # prim_pos/prim_aux: sums with heavy cancellation
SCENE_RES = 128             # phase 4 frame size (SSAA 1)
SERVE_RES = 512             # /render frame size (SSAA 2)

RECORD: dict = {}


def log(*args):
    print(*args, flush=True)


def _require_repo():
    if not (HERE / "raymarching_tpu" / "__init__.py").is_file():
        sys.exit("chip_smoke.py must run from a checkout of the repository")
    sys.path.insert(0, str(HERE))


# --------------------------------------------------------------- helpers

def _np(x):
    import numpy as np
    return np.asarray(x, np.float64)


def compare(name, got, want, *, vec=False, tol=ELEM_TOL, mean_tol=MEAN_TOL,
            frac_min=FRAC_MIN, mask=None):
    """Elementwise agreement of ``got`` and ``want``: mean |diff| <=
    mean_tol and at least frac_min of the values within tol.  ``vec``
    reduces the last axis (xyz or rgb) by max first."""
    import numpy as np
    d = np.abs(_np(got) - _np(want))
    if vec:
        d = d.max(axis=-1)
    if mask is not None:
        d = d[np.asarray(mask)]
    d = np.where(np.isnan(d), np.inf, d).reshape(-1)
    fin = np.isfinite(d)
    mean = float(d[fin].mean()) if fin.all() and d.size else float("inf")
    frac = float((d <= tol).mean()) if d.size else 1.0
    rec = {"n": int(d.size), "mean_abs": mean, "frac_within": frac,
           "tol": tol, "max_abs": float(d.max()) if d.size else 0.0}
    RECORD.setdefault("compare", {})[name] = rec
    log(f"compare {name}: n={d.size} mean|d|={mean:.3e} "
        f"within{tol:g}={frac:.6f} max={rec['max_abs']:.3e}")
    if not (mean <= mean_tol and frac >= frac_min):
        raise AssertionError(f"{name}: mean|d| {mean:.3e} (limit "
                             f"{mean_tol:g}), within {tol:g} {frac:.6f} "
                             f"(limit {frac_min})")


def agree_flags(name, got, want, frac_min=FRAC_MIN):
    import numpy as np
    same = float((np.asarray(got) == np.asarray(want)).mean())
    RECORD.setdefault("compare", {})[name] = {"frac_equal": same}
    log(f"compare {name}: frac_equal={same:.6f}")
    if same < frac_min:
        raise AssertionError(f"{name}: {same:.6f} equal (limit {frac_min})")


def rel_l2(a, b):
    import numpy as np
    a, b = _np(a).reshape(-1), _np(b).reshape(-1)
    den = float(np.linalg.norm(b))
    return float(np.linalg.norm(a - b)) / (den if den > 0 else 1.0)


def tie_summed(plan, field, g):
    """Per-row gradient ``g`` of a primitive-table field with the rows of
    every generator group (Menger sponge, DeathStar) summed into one.
    Generator rows tie exactly (a Menger column's crosses share two
    coordinates), and the kernels credit a tie to the first row while
    jnp's min VJP splits it, so only the tie-class sum is comparable."""
    import numpy as np
    g = _np(g)
    if field not in ("prim_pos", "prim_aux", "prim_color"):
        return g
    cls = np.arange(g.shape[0])
    for grp in getattr(plan.kernel, "groups", ()):
        if grp.fused is not None:
            cls[grp.start:grp.start + grp.count] = grp.start
    out = np.zeros_like(g)
    np.add.at(out, cls, g)
    return out


def compile_timed(name, fn, *args):
    """AOT-compile ``fn`` for ``args``; print compile seconds and the
    executable's memory analysis; return the compiled callable."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    secs = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    ma = {k: int(getattr(mem, k)) for k in fields
          if mem is not None and hasattr(mem, k)}
    RECORD.setdefault("compile", {})[name] = {"seconds": secs, **ma}
    log(f"compile {name}: {secs:.2f} s  memory {ma}")
    return compiled


class Compiles:
    """AOT compiles submitted up front and run on a thread pool (XLA and
    the Triton compiler release the GIL), so a phase's compiles overlap.
    Compile seconds printed under the pool are wall times while up to
    ``WORKERS`` compiles run at once."""

    WORKERS = 8

    def __init__(self):
        from concurrent.futures import ThreadPoolExecutor
        self.pool = ThreadPoolExecutor(self.WORKERS)
        self.jobs = {}

    def submit(self, name, fn, *args):
        import jax
        abstract = jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(
                a.shape, a.dtype, weak_type=getattr(a, "weak_type", False)),
            args)
        self.jobs[name] = self.pool.submit(self._compile, name, fn,
                                           abstract)

    @staticmethod
    def _compile(name, fn, args):
        import jax
        with jax.default_matmul_precision("highest"):
            return compile_timed(name, fn, *args)

    def __getitem__(self, name):
        return self.jobs[name].result()

    def close(self):
        self.pool.shutdown(wait=True)


def timed(fn, *args, reps=5):
    """Median wall seconds of ``fn(*args)`` ended by block_until_ready
    (one warm call first)."""
    import jax
    import numpy as np
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


def load(name):
    from raymarching_tpu import compile_scene, load_scene
    return compile_scene(load_scene(str(SCENES / name)))


def bench_cfg(**kw):
    from raymarching_tpu import RenderConfig
    base = dict(width=512, height=512, ssaa=2, iterations=1000,
                shadows=True, normal_mode="fd", ray_chunk=65536)
    base.update(kw)
    return RenderConfig(**base)


# ---------------------------------------------------------------- phases

def phase_device():
    import jax

    from raymarching_tpu.utils.cache import setup_compile_cache
    from raymarching_tpu.utils.timing import device_record

    log(f"compile cache: {setup_compile_cache()}")
    dev = device_record()
    log(f"jax {jax.__version__} devices: {dev['count']} x {dev['platform']} "
        f"{dev['kind']}")
    if dev["platform"] != "gpu":
        raise SystemExit(f"no GPU: the default JAX device is "
                         f"{dev['platform']}")
    log(f"card: {dev['card']}")
    RECORD["device"] = dev
    return dev


def phase_kernels():
    """Each kernel at the bench width against the oracle."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raymarching_tpu.api import render_rays, render_tables
    from raymarching_tpu.core import camera as cam
    from raymarching_tpu.core import shading
    from raymarching_tpu.core.march import march_profile, march_while
    from raymarching_tpu.core.sdf import scene_sd, scene_surface
    from raymarching_tpu.ops.pallas_march import (kernel_key, pallas_march,
                                                  pallas_surface_eval)
    from raymarching_tpu.utils.gatecheck import fused_gate

    plan, tables = load("demo.txt")
    cfg = bench_cfg()
    kp = kernel_key(plan)
    B = cfg.ray_block
    origin, dirs = cam.generate_rays(tables, cfg)
    d = dirs.reshape(-1, 3)
    R = d.shape[0]
    o = jnp.broadcast_to(origin, d.shape)
    sd_fn = lambda p: scene_sd(plan, tables, p)
    chunk = min(R, cfg.ray_chunk)
    it, eps = cfg.iterations, cfg.surface_precision
    vec = jax.ShapeDtypeStruct((R, 3), jnp.float32)
    scal = jax.ShapeDtypeStruct((R,), jnp.float32)

    def chunked(f):
        """lax.map ``f`` over ray chunks (bounds the oracle's
        [rays, prims] working set)."""
        def run(*xs):
            blocks = [x.reshape((-1, chunk) + x.shape[1:]) for x in xs]
            out = jax.lax.map(lambda a: f(*a), tuple(blocks))
            return jax.tree_util.tree_map(
                lambda y: y.reshape((R,) + y.shape[2:]), out)
        return run

    modes = {"sd": dict(with_color=False, with_normal=False),
             "color": dict(with_color=True, with_normal=False),
             "fd": dict(with_color=False, with_normal=True),
             "winner": dict(with_color=True, with_normal=True,
                            analytic=True)}
    images = {
        "ref": (cfg, "ref"),
        "ref.analytic": (cfg.replace(normal_mode="analytic"), "ref"),
        "mega.exact_fd": (cfg, "mega"),
        "mega.exact_analytic": (cfg.replace(normal_mode="analytic"), "mega"),
        "mega.two_phase": (cfg.replace(two_phase_k1=48), "mega"),
        "mega.serve_raygen": (cfg.replace(serve_raygen=True), "mega"),
        "pallas.exact_fd": (cfg, "pallas"),
    }
    C = Compiles()
    C.submit("march", lambda o, d: pallas_march(
        kp, it, eps, B, o, d, tables), vec, vec)
    C.submit("ref.march", chunked(lambda a, b: march_while(
        sd_fn, a, b, it, eps)), vec, vec)
    C.submit("march.tmax", lambda s, rd, tm: pallas_march(
        kp, it, eps, B, s, rd, tables, tmax=tm), vec, vec, scal)
    C.submit("ref.march.tmax", chunked(lambda a, b, c: march_while(
        sd_fn, a, b, it, eps, tmax=c)), vec, vec, scal)
    C.submit("march.steps", lambda o, d: pallas_march(
        kp, it, eps, B, o, d, tables, with_steps=True)[1], vec, vec)
    C.submit("ref.march.steps", chunked(lambda a, b: march_profile(
        sd_fn, a, b, it, eps)[1]), vec, vec)
    for mode, kw in modes.items():
        C.submit(f"surface.{mode}", lambda p, kw=kw: pallas_surface_eval(
            kp, cfg.fd_h, B, p, tables, **kw), vec)
    C.submit("ref.surface", chunked(
        lambda q: scene_surface(plan, tables, q)), vec)
    C.submit("ref.normal_fd", chunked(
        lambda q: shading.normal_fd(sd_fn, q, cfg.fd_h)), vec)
    C.submit("ref.normal_analytic", chunked(
        lambda q: jax.vmap(jax.grad(lambda x: sd_fn(x[None])[0]))(q)), vec)
    for name, (c, b) in images.items():
        C.submit(f"render.{name}", lambda t, c=c, b=b: render_tables(
            plan, t, c, backend=b), tables)
    C.submit("render_rays.per_ray_origin", lambda o, d: render_rays(
        plan, tables, o, d, cfg), vec, vec)

    # -- march kernel: primary rays, shadow rays with tmax, step counters
    res = C["march"](o, d)
    ref = C["ref.march"](o, d)
    agree_flags("march.converged", res.converged, ref.converged)
    both = np.asarray(res.converged) & np.asarray(ref.converged)
    compare("march.position", res.position, ref.position, vec=True,
            mask=both)

    p_hit = jnp.where(res.converged[:, None], res.position, o + 5.0 * d)
    g = shading.normal_fd(sd_fn, p_hit, cfg.fd_h)
    n = g / jnp.maximum(jnp.linalg.norm(g, axis=-1, keepdims=True), 1e-30)
    s = p_hit + n * (cfg.surface_precision + cfg.offset_precision)
    r = tables.light_pos[0][None, :] - s
    tmax = jnp.linalg.norm(r, axis=-1)
    rd = r / tmax[:, None]
    lit = lambda q: (jnp.sum((tables.light_pos[0][None, :] - q) * rd,
                             axis=-1) <= 0)
    agree_flags("march.tmax.lit", lit(C["march.tmax"](s, rd, tmax).position),
                lit(C["ref.march.tmax"](s, rd, tmax).position))
    agree_flags("march.steps", C["march.steps"](o, d),
                C["ref.march.steps"](o, d))

    # -- surface kernel, four modes, at the hit points
    p = jnp.where(ref.converged[:, None], ref.position, p_hit)
    ref_sd, ref_color = C["ref.surface"](p)
    ref_grad = {"fd": C["ref.normal_fd"](p),
                "winner": C["ref.normal_analytic"](p)}

    def color_of(cidx):
        safe = jnp.clip(cidx, 0, tables.prim_color.shape[0] - 1)
        return jnp.where((cidx >= 0)[:, None], tables.prim_color[safe], 0.0)

    for mode in modes:
        sd, cidx, grad = C[f"surface.{mode}"](p)
        compare(f"surface.{mode}.sd", sd, ref_sd)
        if cidx is not None:
            agree_flags(f"surface.{mode}.color",
                        np.all(np.asarray(color_of(cidx))
                               == np.asarray(ref_color), axis=-1), True)
        if mode in ref_grad:
            compare(f"surface.{mode}.grad", grad, ref_grad[mode], vec=True)

    # -- whole-frame kernel paths against the ref image
    imgs = {name: C[f"render.{name}"](tables) for name in images}
    for name, (c, b) in images.items():
        if b == "ref":
            continue
        want = imgs["ref.analytic" if c.normal_mode == "analytic" else "ref"]
        if name == "mega.serve_raygen":
            # in-kernel raygen against the standard path of the same regime
            want = imgs["mega.exact_fd"]
        compare(f"image.{name}", imgs[name], want, vec=True)
    # per-ray origins through render_rays (the multiview/bundle entry)
    cols = C["render_rays.per_ray_origin"](o, d)
    img_rays = jnp.mean(cols.reshape(cfg.height, cfg.width, -1, 3), axis=2)
    compare("image.render_rays", img_rays, imgs["ref"], vec=True)

    # each kernel's device time beside the plain version XLA compiles
    # (the same computation through the jnp oracle), both ended by
    # block_until_ready
    pairs = {
        "march": (("march", (o, d)), ("ref.march", (o, d))),
        "march.tmax": (("march.tmax", (s, rd, tmax)),
                       ("ref.march.tmax", (s, rd, tmax))),
        "surface.sd": (("surface.sd", (p,)), ("ref.surface", (p,))),
        "surface.fd": (("surface.fd", (p,)), ("ref.normal_fd", (p,))),
        "surface.winner": (("surface.winner", (p,)),
                           ("ref.normal_analytic", (p,))),
        "mega.forward": (("render.mega.exact_fd", (tables,)),
                         ("render.ref", (tables,))),
        "two_phase.forward": (("render.mega.two_phase", (tables,)),
                              ("render.mega.exact_fd", (tables,))),
    }
    for name, ((kn, ka), (pn, pa)) in pairs.items():
        tk, _ = timed(C[kn], *ka, reps=3)
        tp, _ = timed(C[pn], *pa, reps=3)
        RECORD.setdefault("kernel_times", {})[name] = {
            "kernel_s": tk, "plain": pn, "plain_s": tp}
        log(f"time {name}: kernel {tk * 1e3:.3f} ms, plain ({pn}) "
            f"{tp * 1e3:.3f} ms")
    C.close()

    # fused regime: bench.py's gate against the exact kernel image
    ok, stats = fused_gate(plan, tables, cfg, "mega")
    RECORD.setdefault("compare", {})["image.mega.fused_analytic"] = stats
    log(f"compare image.mega.fused_analytic (gate): {stats}")
    if not ok:
        raise AssertionError(f"fused gate failed: {stats}")


def phase_main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raymarching_tpu.api import render_tables, resolve_backend

    backend = resolve_backend("auto")
    log(f"auto backend: {backend}")
    if backend != "mega":
        raise AssertionError(f"auto resolved to {backend!r} on a GPU")
    plan, tables = load("demo.txt")
    cfg = bench_cfg()
    R = cfg.rays_per_image

    def loss(t, b):
        return jnp.mean(render_tables(plan, t, cfg, backend=b))

    # Kernel-path gradients against the unrolled ``ref`` autodiff at
    # 128x128 SSAA1, with tests/test_grad.py's tolerance.
    small = bench_cfg(width=128, height=128, ssaa=1, ray_chunk=0)
    w = jnp.asarray(np.random.default_rng(7).uniform(
        0.5, 1.0, (small.height, small.width, 3)), jnp.float32)

    C = Compiles()
    for b in ("mega", "jnp"):
        C.submit(f"main.{b}.fwd_bwd", lambda t, b=b: jax.value_and_grad(
            lambda u: loss(u, b))(t), tables)
        C.submit(f"main.{b}.forward", lambda t, b=b: loss(t, b), tables)
    for b in ("mega", "ref"):
        C.submit(f"main.{b}.grad_128", lambda t, b=b: jax.grad(
            lambda u: jnp.sum(render_tables(plan, u, small, backend=b,
                                            differentiable=True) * w)
            / w.size)(t), tables)
    C.close()

    times = {}
    grads = {}
    for b in ("mega", "jnp"):
        fb, fw = C[f"main.{b}.fwd_bwd"], C[f"main.{b}.forward"]
        val, g = fb(tables)
        leaves = jax.tree_util.tree_leaves(g)
        if not (np.isfinite(float(val))
                and all(np.all(np.isfinite(np.asarray(x))) for x in leaves)):
            raise AssertionError(f"{b}: non-finite loss or gradient")
        grads[b] = g
        t_fb, _ = timed(fb, tables, reps=5 if b == "mega" else 3)
        t_fw, _ = timed(fw, tables, reps=5 if b == "mega" else 3)
        times[b] = {"fwd_bwd_s": t_fb, "forward_s": t_fw,
                    "fwd_bwd_mrays": R / t_fb / 1e6,
                    "forward_mrays": R / t_fw / 1e6}
        log(f"time {b}: fwd+bwd {t_fb * 1e3:.2f} ms "
            f"({R / t_fb / 1e6:.3f} Mrays/s)  forward {t_fw * 1e3:.2f} ms "
            f"({R / t_fw / 1e6:.3f} Mrays/s)")
    RECORD["times_512_ssaa2"] = times

    bad = []
    for field in grads["mega"]._fields:
        a = getattr(grads["mega"], field)
        b = getattr(grads["jnp"], field)
        raw = rel_l2(a, b)
        e = rel_l2(tie_summed(plan, field, a), tie_summed(plan, field, b))
        RECORD.setdefault("grad_vs_jnp", {})[field] = {"rel_l2": e,
                                                       "rel_l2_rows": raw}
        worst = ""
        if e > GRAD_RTOL:
            bad.append(f"{field} vs jnp {e:.3e}")
            da = np.abs(tie_summed(plan, field, a) - tie_summed(plan, field, b))
            row = np.unravel_index(int(da.argmax()), da.shape)
            worst = (f"; worst entry {row} kernel "
                     f"{float(np.asarray(a)[row]):.6e} jnp "
                     f"{float(np.asarray(b)[row]):.6e}")
        log(f"grad {field}: rel L2 vs jnp {e:.3e} (tie classes summed; "
            f"per row {raw:.3e}){worst}")

    g_ref = C["main.ref.grad_128"](tables)
    g_k = C["main.mega.grad_128"](tables)
    for field in ("prim_pos", "prim_aux", "prim_color", "light_pos"):
        x = tie_summed(plan, field, getattr(g_k, field))
        y = tie_summed(plan, field, getattr(g_ref, field))
        scale = max(float(np.abs(y).max()), 1e-8)
        excess = np.abs(x - y) - (0.02 * scale + 0.08 * np.abs(y))
        frac = float((excess <= 0).mean())
        RECORD.setdefault("grad_vs_ref_autodiff", {})[field] = {
            "frac_within": frac, "rel_l2": rel_l2(x, y)}
        log(f"grad {field}: vs ref autodiff 128^2, within _close tol "
            f"{frac:.6f}, rel L2 {rel_l2(x, y):.3e}")
        if frac < 1.0:
            bad.append(f"{field} vs ref autodiff")

    _fit_steps(plan, tables, cfg)
    _serve_requests()
    if bad:
        raise AssertionError(f"gradients: {bad}")


def _fit_steps(plan, tables, cfg):
    """3 Adam steps of optimize.fit toward a target rendered from a
    perturbed scene; the loss must be finite and fall."""
    import jax.numpy as jnp
    import numpy as np

    from raymarching_tpu.api import render_tables
    from raymarching_tpu.optimize import fit

    target_tables = tables._replace(
        prim_color=jnp.clip(tables.prim_color * 0.8 + 0.1, 0.0, 1.0),
        light_pos=tables.light_pos + 0.5)
    target = render_tables(plan, target_tables, cfg, backend="mega")
    t0 = time.perf_counter()
    res = fit(plan, tables, target, cfg, steps=3, lr=2e-2,
              trainable=("prim_color", "light_pos"))
    losses = [float(x) for x in res.losses]
    RECORD["fit_losses"] = losses
    log(f"fit: losses {losses} ({time.perf_counter() - t0:.1f} s incl. "
        "compile)")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"fit loss did not fall: {losses}")


def _serve_requests():
    """serve.py's handler in a thread on an ephemeral port: 3 /render at
    SERVE_RES^2 SSAA 2 and one /aovs at half that size."""
    import io
    import threading
    import urllib.request
    import zipfile
    from http.server import ThreadingHTTPServer

    import numpy as np

    from raymarching_tpu.serve import _make_handler

    server = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler("auto"))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    port = server.server_address[1]
    scene = (SCENES / "demo.txt").read_bytes()
    lat = []
    try:
        def post(path, query):
            url = f"http://127.0.0.1:{port}{path}?{query}"
            req = urllib.request.Request(url, data=scene, method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=900) as r:
                body = r.read()
                code = r.status
            return code, body, time.perf_counter() - t0

        for _ in range(3):
            code, body, dt = post(
                "/render", f"width={SERVE_RES}&height={SERVE_RES}&ssaa=2"
                "&format=png")
            if code != 200 or not body.startswith(b"\x89PNG"):
                raise AssertionError(f"/render answered {code}")
            lat.append(dt)
        aov = SERVE_RES // 2
        code, body, dt = post("/aovs", f"width={aov}&height={aov}&ssaa=1")
        if code != 200:
            raise AssertionError(f"/aovs answered {code}")
        z = zipfile.ZipFile(io.BytesIO(body))
        depth = np.load(io.BytesIO(z.read("depth.npy")))
        if depth.shape != (aov, aov) or not np.isfinite(depth).any():
            raise AssertionError("/aovs depth plane malformed")
        lat.append(dt)
    finally:
        server.shutdown()
        server.server_close()
        th.join(timeout=10)
    RECORD["serve_seconds"] = lat
    log(f"serve: /render x3 {[round(x, 3) for x in lat[:3]]} s "
        f"(first includes compile), /aovs {lat[3]:.3f} s")


def phase_scenes():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raymarching_tpu import RenderConfig
    from raymarching_tpu.api import render_tables

    scenes = {}
    C = Compiles()
    for path in sorted(SCENES.glob("*.txt")):
        plan, tables = load(path.name)
        cfg = RenderConfig(width=SCENE_RES, height=SCENE_RES, ssaa=1,
                           iterations=1000, ray_chunk=0)
        if path.stem == "mirror":
            cfg = cfg.replace(reflect_strength=0.4, soft_shadow_k=8.0,
                              ao_strength=0.5)
        scenes[path.stem] = (plan, tables)
        C.submit(f"scene.{path.stem}.forward", lambda t, c=cfg, p=plan:
                 render_tables(p, t, c, backend="mega"), tables)
        C.submit(f"scene.{path.stem}.ref", lambda t, c=cfg, p=plan:
                 render_tables(p, t, c, backend="ref"), tables)
        C.submit(f"scene.{path.stem}.fwd_bwd", lambda t, c=cfg, p=plan:
                 jax.value_and_grad(lambda u: jnp.mean(render_tables(
                     p, u, c, backend="mega")))(t), tables)
    failed = []
    for name, (plan, tables) in scenes.items():
        img = C[f"scene.{name}.forward"](tables)
        try:
            compare(f"scene.{name}", img, C[f"scene.{name}.ref"](tables),
                    vec=True)
        except AssertionError as e:         # every scene is reported
            failed.append(str(e))
        val, g = C[f"scene.{name}.fwd_bwd"](tables)
        ok = np.isfinite(float(val)) and all(
            np.all(np.isfinite(np.asarray(x)))
            for x in jax.tree_util.tree_leaves(g))
        log(f"scene {name}: fwd+bwd finite={ok}")
        if not ok:
            failed.append(f"{name}: non-finite fwd+bwd")
    C.close()
    if failed:
        raise AssertionError(f"scenes failed: {failed}")


def phase_gpu_tests():
    """pytest -m gpu in this process (RAYMARCHING_TESTS_ON_DEVICE keeps
    tests/conftest.py from forcing the CPU)."""
    import pytest
    os.environ["RAYMARCHING_TESTS_ON_DEVICE"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", str(HERE / "tests")])
    log(f"gpu tests: pytest exit {int(rc)}")
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (pytest exit {rc})")


def phase_multi(n: int):
    """Ray-sharded training step and bundle gradients on an ``n``-card
    mesh against the same computation on one card.

    The loss must agree within SHARD_LOSS_RTOL and every gradient field
    within SHARD_GRAD_RTOL, except the primitive-geometry fields, held to
    SHARD_GEOM_GRAD_RTOL: they are sums with heavy cancellation (grazing
    rays' IFT weights are large and of both signs), so any change of
    summation order moves them by ~1e-4 -- regrouping the same sum on ONE
    card (``ray_chunk`` = 1/4 of the rays) does as much (PERF.md)."""
    import jax
    import jax.numpy as jnp

    from raymarching_tpu.api import render_tables
    from raymarching_tpu.core.camera import generate_rays
    from raymarching_tpu.parallel.sharded import (make_mesh, mse_loss,
                                                  render_rays_sharded)

    if len(jax.devices()) < n:
        raise SystemExit(f"--devices {n}: only {len(jax.devices())} found")
    plan, tables = load("demo.txt")
    cfg = bench_cfg(ray_chunk=0)
    target = jnp.full((cfg.height, cfg.width, 3), 0.25, jnp.float32)
    o, d = generate_rays(tables, cfg)
    d = d.reshape(-1, 3)[::7]
    o = jnp.broadcast_to(o, d.shape)

    losses = {
        "train_step": lambda m: lambda t: mse_loss(plan, t, target, cfg, m,
                                                   backend="mega"),
        "bundle": lambda m: lambda t: jnp.mean(render_rays_sharded(
            plan, t, o, d, cfg, m)),
    }
    C = Compiles()
    for name, on_mesh in losses.items():
        for k in (1, n):
            C.submit(f"multi.{name}.{k}", jax.value_and_grad(
                on_mesh(make_mesh(k))), tables)
    for name in losses:
        t0 = time.perf_counter()
        l1, g1 = C[f"multi.{name}.1"](tables)
        t1 = time.perf_counter()
        ln, gn = C[f"multi.{name}.{n}"](tables)
        t2 = time.perf_counter()
        el = abs(float(ln) - float(l1)) / max(abs(float(l1)), 1e-30)
        log(f"multi {name}: loss 1 card {float(l1):.8f} / {n} cards "
            f"{float(ln):.8f} rel {el:.3e} (first calls {t1 - t0:.2f} s, "
            f"{t2 - t1:.2f} s)")
        RECORD.setdefault("multi", {})[name] = {"loss_rel": el}
        bad = [f"loss {el:.3e}"] if el > SHARD_LOSS_RTOL else []
        for field in g1._fields:
            ts = lambda g: tie_summed(plan, field, getattr(g, field))
            e = rel_l2(ts(gn), ts(g1))
            limit = (SHARD_GEOM_GRAD_RTOL if field in ("prim_pos", "prim_aux")
                     else SHARD_GRAD_RTOL)
            RECORD["multi"][name][field] = {"rel_l2": e, "limit": limit}
            log(f"multi {name} grad {field}: rel L2 {e:.3e} "
                f"(limit {limit:g})")
            if e > limit:
                bad.append(f"{field} {e:.3e}")
        if bad:
            raise AssertionError(f"{name}: {n} cards vs one differ: {bad}")
    C.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4 = run only the four-card sharded phase")
    ap.add_argument("--json", default=None,
                    help="write the full record to this path")
    args = ap.parse_args(argv)
    _require_repo()

    import jax

    t0 = time.perf_counter()
    dev = phase_device()
    with jax.default_matmul_precision("highest"):
        if args.devices > 1:
            phase_multi(args.devices)
        else:
            phases = {"kernels": phase_kernels, "main": phase_main,
                      "scenes": phase_scenes, "gpu-tests": phase_gpu_tests}
            for name, phase in phases.items():
                t1 = time.perf_counter()
                log(f"== phase {name}")
                phase()
                log(f"== phase {name} done in {time.perf_counter() - t1:.1f} s")
    RECORD["seconds"] = time.perf_counter() - t0
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(RECORD, indent=1))
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
