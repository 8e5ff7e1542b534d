"""Black-lane shadow skip (RenderConfig.shade_skip_black).

Contract: the rendered image is BIT-EXACT with the skip on or off (a black
winner's pixel is color * light == 0 whatever the light term); the runtime
gate disables the skip bitwise the moment the live color table stops being
black (fitting safety); backward: the skip is FORWARD-ONLY — under
differentiation the custom_vjp fwd rule forces it off (a skipped lane has
no true shadow state, and d pixel / d prim_color of a black primitive is
its light term, which must not be zeroed), so gradients are bit-identical
with the flag on or off, including nonzero color gradients for black
primitives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raymarching_tpu as rt
from raymarching_tpu.api import render_tables

CFG = rt.RenderConfig(width=64, height=36, ssaa=1, iterations=200,
                      ray_block=1024)


@pytest.fixture(scope="module")
def demo():
    return rt.compile_scene(rt.load_scene("scenes/demo.txt"))


def test_compile_records_black_prims(demo):
    plan, _ = demo
    # the demo's Bounds backdrop is its only (0,0,0)-colored primitive
    assert plan.kernel.black_prims == (0,)


def test_image_bit_exact_with_skip(demo):
    plan, tables = demo
    off = np.asarray(render_tables(
        plan, tables, CFG.replace(shade_skip_black=False),
        backend="mega", interpret=True))
    on = np.asarray(render_tables(plan, tables, CFG,
                                  backend="mega", interpret=True))
    np.testing.assert_array_equal(off, on)


def test_runtime_gate_self_disables_when_painted(demo):
    """Fitting safety: color the compile-time-black prim AFTER compile —
    the gate must turn the skip off bitwise (the shaded wall renders)."""
    plan, tables = demo
    pc = np.asarray(tables.prim_color).copy()
    pc[list(plan.kernel.black_prims)] = [0.9, 0.1, 0.1]
    painted = tables._replace(prim_color=jnp.asarray(pc))
    off = np.asarray(render_tables(
        plan, painted, CFG.replace(shade_skip_black=False),
        backend="mega", interpret=True))
    on = np.asarray(render_tables(plan, painted, CFG,
                                  backend="mega", interpret=True))
    np.testing.assert_array_equal(off, on)
    # and the painted wall actually shades (not black anymore)
    black = np.asarray(render_tables(plan, tables, CFG,
                                     backend="mega", interpret=True))
    assert np.abs(off - black).max() > 0.1


@pytest.mark.slow
def test_backward_exact_with_skip_enabled(demo):
    """The skip is forward-only: under jax.grad the fwd rule disables it,
    so gradients with the flag on are BIT-IDENTICAL to flag-off — in
    particular the black primitive's color gradient (its light term)
    flows instead of freezing black-initialized colors."""
    plan, tables = demo

    def loss(t, skip):
        img = render_tables(plan, t, CFG.replace(shade_skip_black=skip),
                            backend="mega", interpret=True)
        return jnp.mean(img)

    g_on = jax.grad(lambda t: loss(t, True))(tables)
    g_off = jax.grad(lambda t: loss(t, False))(tables)
    black = list(plan.kernel.black_prims)
    assert np.abs(np.asarray(g_on.prim_color)[black]).max() > 0.0
    on, off = g_on._asdict(), g_off._asdict()
    for k in on:
        np.testing.assert_array_equal(np.asarray(on[k]),
                                      np.asarray(off[k]), err_msg=k)


def test_no_kernel_plan_scene_is_unaffected():
    """Scenes without black prims (or without the two-level plan) must not
    engage the machinery at all."""
    from raymarching_tpu.ops.pallas_render import black_skip_ids
    scene = rt.load_scene("scenes/config3.txt")
    plan, tables = rt.compile_scene(scene)
    if getattr(plan.kernel, "black_prims", ()):
        pytest.skip("scene has black prims")
    assert black_skip_ids(plan, CFG) == ()
    img = np.asarray(render_tables(plan, tables, CFG,
                                   backend="mega", interpret=True))
    assert np.isfinite(img).all()
