"""Cost-ordered block scheduling (core.order.row_cost_perm / row_permuters
+ api.plan_cost_order): bit-exact images under any 128-ray row
permutation, scatter-free permutation VJPs, and gradient parity.

The scheduling attacks the straggler bound (a kernel ray block marches
until its slowest lane converges — the analogue of the warp divergence
the reference's GLSL kernel eats, shader.comp:288-297): rows sorted by
predicted cost make blocks cost-homogeneous.  Correctness must be UNCONDITIONAL on the permutation —
a stale or adversarial perm may only change speed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raymarching_tpu import RenderConfig
from raymarching_tpu.api import plan_cost_order, render_tables
from raymarching_tpu.core.order import PERM_ROW as LANES, row_cost_perm, row_permuters
from raymarching_tpu.scene.compile import compile_tree
from raymarching_tpu.scene.csg import Box, ListNode, Mode, Sphere, bounds
from raymarching_tpu.scene.generators import menger_sponge
from raymarching_tpu.scene.objects import Camera, Light

CFG = RenderConfig(width=32, height=32, ssaa=2, iterations=80,
                   shadows=True, normal_mode="analytic")


def _world():
    tree = ListNode(Mode.UNION, [
        bounds(60.0),
        menger_sponge((0.0, 0.0, -6.0), 3.0, 1, color=(0.9, 0.5, 0.2)),
        Sphere((3.0, 1.0, -8.0), 1.5, color=(0.2, 0.4, 0.9)),
        Box((0.0, -3.0, -6.0), (10.0, 1.0, 10.0), color=(0.6, 0.6, 0.9)),
    ])
    return compile_tree(tree, [Light((6.0, 8.0, 4.0))],
                        Camera(position=(0, 0, 6), fov=55.0))


def _rand_perm(cfg):
    rows = cfg.height * cfg.width * cfg.samples_per_pixel // LANES
    return np.random.RandomState(0).permutation(rows).astype(np.int32)


def test_row_cost_perm_orders_by_row_max():
    steps = np.zeros(4 * LANES, np.float32)
    steps[0 * LANES] = 50     # row 0: max 50
    steps[1 * LANES] = 10     # row 1: max 10
    steps[2 * LANES] = 99     # row 2: max 99
    steps[3 * LANES] = 10     # row 3: max 10 (stable: after row 1)
    perm = row_cost_perm(steps)
    assert perm.tolist() == [1, 3, 0, 2]


def test_row_permuters_roundtrip_and_gather_transpose():
    perm = np.random.RandomState(1).permutation(8).astype(np.int32)
    apply_p, invert_p = row_permuters(perm)
    x = jnp.arange(8 * LANES * 3, dtype=jnp.float32).reshape(8 * LANES, 3)
    y = apply_p(x)
    np.testing.assert_array_equal(np.asarray(invert_p(y)), np.asarray(x))

    # VJP of a bijective take is the inverse take: a gather, NOT a scatter
    # (the 1M-row scatter-add is the measured 35% regression the custom
    # transpose exists to avoid).
    cot = jnp.ones_like(x) * 2.0
    _, vjp = jax.vjp(apply_p, x)
    (gx,) = vjp(cot)
    np.testing.assert_array_equal(np.asarray(gx), np.asarray(cot))
    jaxpr = str(jax.make_jaxpr(lambda v: jax.vjp(apply_p, v)[1](cot))(x))
    assert "scatter" not in jaxpr


def test_cost_order_image_bit_exact():
    plan, tables = _world()
    base = np.asarray(render_tables(plan, tables, CFG, backend="mega",
                                    interpret=True))
    permed = np.asarray(render_tables(plan, tables, CFG, backend="mega",
                                      interpret=True,
                                      ray_perm=_rand_perm(CFG)))
    np.testing.assert_array_equal(permed, base)


def test_cost_order_gradients_match():
    plan, tables = _world()

    def loss(t, perm):
        img = render_tables(plan, t, CFG, backend="mega", interpret=True,
                            ray_perm=perm)
        return jnp.mean(img * img)

    g0 = jax.grad(lambda t: loss(t, None))(tables)
    g1 = jax.grad(lambda t: loss(t, _rand_perm(CFG)))(tables)
    for field in ("prim_pos", "prim_aux", "prim_color", "light_pos",
                  "cam_position", "cam_fov"):
        a = np.asarray(getattr(g0, field), np.float64)
        b = np.asarray(getattr(g1, field), np.float64)
        scale = max(np.abs(a).max(), 1e-8)
        # table cotangents REDUCE over rays: permutation changes only the
        # FP summation order (core.order docstring)
        np.testing.assert_allclose(a / scale, b / scale, atol=5e-6)


def test_plan_cost_order_round_trip():
    plan, tables = _world()
    perm = plan_cost_order(plan, tables, CFG, interpret=True)
    rows = CFG.height * CFG.width * CFG.samples_per_pixel // LANES
    assert sorted(perm.tolist()) == list(range(rows))
    img = np.asarray(render_tables(plan, tables, CFG, backend="mega",
                                   interpret=True, ray_perm=perm))
    base = np.asarray(render_tables(plan, tables, CFG, backend="mega",
                                    interpret=True))
    np.testing.assert_array_equal(img, base)


def test_ray_perm_rejected_off_mega():
    plan, tables = _world()
    with pytest.raises(ValueError):
        render_tables(plan, tables, CFG, backend="jnp",
                      ray_perm=_rand_perm(CFG))
