"""Fused (space-folding) Menger evaluation vs the explicit cross table.

The folded field is a different function AWAY from surfaces (conservative:
never larger than the table field, min over a phantom-extended superset) but
shares the exact zero set, so marches land on the same geometry.  Contracts
tested here:
  * sign agreement everywhere (same solid set);
  * conservativeness (folded <= table value);
  * equality near the surface (|table sd| small -> fields agree);
  * end-to-end forward image allclose at march precision.
"""

import numpy as np

from raymarching_tpu import RenderConfig
from raymarching_tpu.api import render_tables
from raymarching_tpu.ops.pallas_march import pallas_surface_eval
from raymarching_tpu.scene.compile import compile_tree
from raymarching_tpu.scene.csg import ListNode, Mode, Sphere, bounds
from raymarching_tpu.scene.generators import menger_sponge
from raymarching_tpu.scene.objects import Camera, Light


def _world(iters=2):
    tree = ListNode(Mode.UNION, [
        bounds(60.0),
        menger_sponge((0.0, 0.0, -8.0), 6.0, iters, color=(0.9, 0.9, 0.8)),
        Sphere((5.0, -1.0, -5.0), 1.0, color=(0.2, 0.8, 0.3)),
    ])
    return compile_tree(tree, [Light((6.0, 10.0, 4.0))],
                        Camera(position=(0, 1, 4), fov=60.0))


def _sd(plan, tables, p, fused):
    sd, _, _ = pallas_surface_eval(plan.kernel, 1e-3, 1024, p, tables,
                                   with_color=False, with_normal=False,
                                   fused=fused, interpret=True)
    return np.asarray(sd)


def test_fused_field_contracts():
    plan, tables = _world(iters=3)
    assert any(g.fused == ("menger", 3) for g in plan.kernel.groups)
    rng = np.random.default_rng(0)
    # points concentrated around the sponge
    p = rng.uniform(-4.5, 4.5, size=(4000, 3)).astype(np.float32)
    p[:, 2] -= 8.0
    sd_table = _sd(plan, tables, p, fused=False)
    sd_fold = _sd(plan, tables, p, fused=True)

    # same solid set (signs agree; tolerate the march-precision boundary)
    off_boundary = np.abs(sd_table) > 1e-3
    assert np.all(np.sign(sd_fold[off_boundary])
                  == np.sign(sd_table[off_boundary]))
    # conservative: folded never exceeds the table value
    assert np.all(sd_fold <= sd_table + 1e-5)
    # equal near the surface (within one cell of the finest level)
    near = np.abs(sd_table) < 0.05
    np.testing.assert_allclose(sd_fold[near], sd_table[near], atol=1e-5)


def test_fused_jnp_mirror_matches_kernel():
    """core.sdf.scene_sd_fused (used by the IFT backward) must equal the
    Pallas fused field."""
    from raymarching_tpu.core.sdf import scene_sd_fused

    plan, tables = _world(iters=3)
    rng = np.random.default_rng(5)
    p = rng.uniform(-5, 5, size=(500, 3)).astype(np.float32)
    p[:, 2] -= 8.0
    sd_kernel = _sd(plan, tables, p, fused=True)
    sd_jnp = np.asarray(scene_sd_fused(plan, tables, p))
    np.testing.assert_allclose(sd_kernel, sd_jnp, rtol=1e-6, atol=1e-5)


def test_fused_gradients_flow_to_generator_params():
    import jax
    import jax.numpy as jnp
    from raymarching_tpu.api import render_tables as rt

    plan, tables = _world(iters=2)
    cfg = RenderConfig(width=24, height=16, ssaa=1, iterations=150,
                       shadows=True, normal_mode="fd",
                       fused_generators=True)

    def loss(t):
        img = rt(plan, t, cfg, backend="pallas", interpret=True)
        return jnp.mean(img * img)

    g = jax.grad(loss)(tables)
    gp = np.asarray(g.prim_pos)
    assert np.all(np.isfinite(gp))
    # the menger group's box (leaf index 1 = first leaf after bounds)
    # carries the generator's position gradient
    assert np.abs(gp[1]).max() > 1e-6
    # size gradient on the box aux
    assert abs(float(np.asarray(g.prim_aux)[1, 0])) > 1e-7


def test_fused_forward_image_allclose():
    plan, tables = _world(iters=2)
    base = RenderConfig(width=32, height=24, ssaa=1, iterations=200,
                        shadows=True, normal_mode="fd")
    img_table = np.asarray(render_tables(plan, tables, base,
                                         backend="pallas", interpret=True))
    img_fold = np.asarray(render_tables(
        plan, tables, base.replace(fused_generators=True),
        backend="pallas", interpret=True))
    # identical geometry; trajectories may differ within march precision, so
    # compare at image tolerance and require near-total pixel agreement
    diff = np.abs(img_fold - img_table).max(axis=-1)
    assert (diff < 5e-3).mean() > 0.995, f"pixels off: {(diff >= 5e-3).sum()}"
    assert np.median(diff) < 1e-4
