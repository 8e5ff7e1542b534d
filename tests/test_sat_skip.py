"""Saturation-floor shadow skip (RenderConfig.shadow_sat_skip, r5).

Contract: image AND gradients are BIT-EXACT with the skip on or off.  A
lane where even the all-lit Lambert sum cannot reach the [saturation, 1]
clamp floor has its pixel pinned to saturation * color whatever the
shadow outcomes; the clamp zeroes every upstream cotangent, so skipping
the shadow marches changes nothing in forward or backward — unlike the
black-lane skip (forward-only), this one stays on under differentiation.
menger4's two shadow marches were 71% of its forward kernel; the carved
sponge interior is exactly the floor-dark geometry this targets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raymarching_tpu as rt
from raymarching_tpu.api import render_tables

# a scene with plenty of floor-dark geometry: a Menger sponge lit from
# one side — carve interiors and the far faces can't reach the floor
SCENE = """
Bounds 60.0

Camera Position 0.0 1.5 4.0
Camera Direction 0.0 -0.1 -1.0
Camera Up 0.0 1.0 0.0
Camera FOV 55

Light 8.0 2.0 2.0

MengerSponge 0.0 0.0 -4.0 3.0 2
Color 0.9 0.3 0.2
Sphere -2.0 -0.5 -2.5 0.6
"""

CFG = rt.RenderConfig(width=64, height=48, ssaa=1, iterations=250,
                      ray_block=1024)


@pytest.fixture(scope="module")
def world():
    return rt.compile_scene(rt.parse_scene(SCENE))


def _img(plan, tables, cfg):
    return np.asarray(render_tables(plan, tables, cfg, backend="mega",
                                    interpret=True))


def test_forward_bit_exact(world):
    plan, tables = world
    on = _img(plan, tables, CFG)
    off = _img(plan, tables, CFG.replace(shadow_sat_skip=False))
    np.testing.assert_array_equal(on, off)
    # non-vacuity: some pixels must actually sit AT the clamp floor with
    # a non-black color (the population the skip targets)
    floor_px = (np.abs(on - CFG.saturation * 1.0) < 1e-6).all(axis=-1)
    assert floor_px.any()


def test_gradients_bit_exact(world):
    plan, tables = world

    def loss(t, cfg):
        img = render_tables(plan, t, cfg, backend="mega", interpret=True,
                            differentiable=True)
        return jnp.mean(img * jnp.asarray([0.3, 0.5, 0.2]))

    g_on = jax.grad(lambda t: loss(t, CFG))(tables)
    g_off = jax.grad(
        lambda t: loss(t, CFG.replace(shadow_sat_skip=False)))(tables)
    for a, b in zip(jax.tree_util.tree_leaves(g_on),
                    jax.tree_util.tree_leaves(g_off)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert float(jnp.abs(g_on.prim_pos).max()) > 0.0


def test_colored_lights_disable_skip(world):
    """LightColor scenes scale each Lambert term per channel — the bound
    doesn't cover them, so the skip must not engage (still bit-exact
    because the code compiles it out for colored plans)."""
    scene = rt.parse_scene(SCENE.replace(
        "Light 8.0 2.0 2.0", "LightColor 8.0 2.0 2.0 1.5 0.4 0.2"))
    plan, tables = rt.compile_scene(scene)
    on = _img(plan, tables, CFG)
    off = _img(plan, tables, CFG.replace(shadow_sat_skip=False))
    np.testing.assert_array_equal(on, off)
