"""Multi-view inverse rendering through ONE batched ray stream.

The production fitting workflow ``api.render_rays`` exists for: F posed
captures of a scene, jointly fit the scene parameters against ALL views at
once.  Every view's rays (each with its own origin) ride a single chunked
mega-kernel stream, so the joint loss costs one device round-trip per
optimizer step instead of F — and its gradient flows through the per-ray
IFT backward with per-ray origin cotangents.

With ``--fit-poses`` the problem inverts: the scene is KNOWN and the
camera positions are the unknowns (camera localization / the pose half of
bundle adjustment).  Rays are generated differentiably from the pose
parameters, so the loss gradient flows through the look-at construction
and into ``render_rays``'s origin/direction cotangents.

    python examples/fit_multiview.py [--views 4] [--steps 120] [--cpu]
    python examples/fit_multiview.py --fit-poses [--cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def camera_rays(tables, cfg, position, look_at):
    """Rays for one posed view -> (origins [R,3], dirs [R,3])."""
    from raymarching_tpu.core import camera as cam

    pos = np.asarray(position, np.float32)
    look = np.asarray(look_at, np.float32) - pos
    look = look / np.linalg.norm(look)
    t = tables._replace(cam_position=jnp.asarray(pos),
                        cam_direction=jnp.asarray(look))
    o, d = cam.generate_rays(t, cfg)
    flat = d.reshape(-1, 3)
    return jnp.broadcast_to(o, flat.shape), flat


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU platform (must happen before any "
                         "jax device use; JAX_PLATFORMS in the env can be "
                         "overridden by site config)")
    ap.add_argument("--fit-poses", action="store_true",
                    help="hold the scene fixed and recover perturbed "
                         "camera positions instead (pose gradients flow "
                         "through the differentiable look-at + the "
                         "origin/direction cotangents of render_rays)")
    args = ap.parse_args()
    from raymarching_tpu.utils.cache import setup_compile_cache
    setup_compile_cache()

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import optax

    from raymarching_tpu import RenderConfig, compile_scene, parse_scene
    from raymarching_tpu.api import render_rays

    scene = parse_scene("""
Bounds 60
Light 6 10 4
Color 0.9 0.2 0.1
Sphere 0 0 -6 1.6
Color 0.2 0.8 0.3
Sphere 2.2 -0.4 -7 1.0
Color 0.9 0.9 0.9
Box 0 -2.2 -6 8 0.4 8
""")
    plan, tables_true = compile_scene(scene)
    cfg = RenderConfig(width=64, height=48, ssaa=1, iterations=250,
                       normal_mode="analytic", ray_chunk=65536)

    # F posed views on an arc around the scene, all looking at its center
    center = np.array([0.5, -0.5, -6.0], np.float32)
    phis = np.linspace(-0.7, 0.7, args.views)
    bundles = [camera_rays(tables_true, cfg,
                           center + 9.0 * np.array(
                               [np.sin(p), 0.25, np.cos(p)], np.float32),
                           center)
               for p in phis]
    origins = jnp.concatenate([b[0] for b in bundles])
    dirs = jnp.concatenate([b[1] for b in bundles])

    targets = render_rays(plan, tables_true, origins, dirs, cfg)

    if args.fit_poses:
        return fit_poses(args, plan, tables_true, cfg, targets,
                         jnp.asarray(center),
                         jnp.asarray(np.stack(
                             [center + 9.0 * np.array(
                                 [np.sin(p), 0.25, np.cos(p)], np.float32)
                              for p in phis])))

    # perturb the red sphere's position and radius, then fit them back
    pp = np.array(tables_true.prim_pos)
    aux = np.array(tables_true.prim_aux)
    pp[1] += np.array([0.7, -0.4, 0.5], np.float32)
    aux[1, 0] *= 0.7
    tables = tables_true._replace(prim_pos=jnp.asarray(pp),
                                  prim_aux=jnp.asarray(aux))

    @jax.jit
    def loss_fn(t):
        pred = render_rays(plan, t, origins, dirs, cfg)
        return jnp.mean((pred - targets) ** 2)

    opt = optax.adam(args.lr)
    opt_state = opt.init(tables)

    @jax.jit
    def step(t, s):
        loss, g = jax.value_and_grad(loss_fn)(t)
        updates, s = opt.update(g, s)
        return optax.apply_updates(t, updates), s, loss

    err0 = float(np.linalg.norm(np.asarray(tables.prim_pos[1])
                                - np.asarray(tables_true.prim_pos[1])))
    for i in range(args.steps):
        tables, opt_state, loss = step(tables, opt_state)
        if i % 20 == 0 or i == args.steps - 1:
            err = float(np.linalg.norm(
                np.asarray(tables.prim_pos[1])
                - np.asarray(tables_true.prim_pos[1])))
            print(f"step {i:4d}  joint-loss {float(loss):.3e}  "
                  f"pos-err {err:.4f}", flush=True)
    err = float(np.linalg.norm(np.asarray(tables.prim_pos[1])
                               - np.asarray(tables_true.prim_pos[1])))
    print(f"position error {err0:.3f} -> {err:.3f}; "
          f"radius {float(aux[1, 0]):.3f} -> "
          f"{float(tables.prim_aux[1, 0]):.3f} "
          f"(true {float(tables_true.prim_aux[1, 0]):.3f})")
    assert err < 0.5 * err0, "multi-view fit failed to converge"
    print("ok")
    return 0


def fit_poses(args, plan, tables, cfg, targets, center, poses_true):
    """Camera localization: recover perturbed camera POSITIONS from the
    rendered views, scene fixed.  The ray bundle is rebuilt from the pose
    parameters inside the loss, so jax.grad chains through the look-at
    normalization and camera grid into render_rays's origin/direction
    cotangents (the per-ray o_bar/d_bar of the mega kernel's IFT
    backward)."""
    import jax.numpy as jnp
    import optax

    from raymarching_tpu.api import render_rays
    from raymarching_tpu.core import camera as cam

    R = cfg.height * cfg.width * cfg.samples_per_pixel

    def bundle(poses):
        os, ds = [], []
        for i in range(poses.shape[0]):          # static F, unrolled
            look = center - poses[i]
            look = look / jnp.linalg.norm(look)
            t = tables._replace(cam_position=poses[i], cam_direction=look)
            o, d = cam.generate_rays(t, cfg)
            os.append(jnp.broadcast_to(o, (R, 3)))
            ds.append(d.reshape(R, 3))
        return jnp.concatenate(os), jnp.concatenate(ds)

    @jax.jit
    def loss_fn(poses):
        o, d = bundle(poses)
        pred = render_rays(plan, tables, o, d, cfg)
        return jnp.mean((pred - targets) ** 2)

    rng = np.random.default_rng(7)
    poses = poses_true + jnp.asarray(
        rng.normal(scale=0.35, size=poses_true.shape).astype(np.float32))
    opt = optax.adam(args.lr)
    state = opt.init(poses)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(loss_fn)(p)
        up, s = opt.update(g, s)
        return optax.apply_updates(p, up), s, loss

    err0 = float(jnp.linalg.norm(poses - poses_true, axis=-1).mean())
    for i in range(args.steps):
        poses, state, loss = step(poses, state)
        if i % 20 == 0 or i == args.steps - 1:
            err = float(jnp.linalg.norm(poses - poses_true, axis=-1).mean())
            print(f"step {i:4d}  loss {float(loss):.3e}  "
                  f"mean pose-err {err:.4f}", flush=True)
    err = float(jnp.linalg.norm(poses - poses_true, axis=-1).mean())
    print(f"pose error {err0:.3f} -> {err:.3f} over "
          f"{poses.shape[0]} cameras")
    assert err < 0.5 * err0, "pose fit failed to converge"
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
