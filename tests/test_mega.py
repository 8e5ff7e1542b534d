"""Single-kernel (mega) render path: equivalence against the multi-kernel
pallas pipeline and gradient agreement with the jnp IFT fast path."""

import jax
import jax.numpy as jnp
import numpy as np

from raymarching_tpu import RenderConfig
from raymarching_tpu.api import render_tables
from raymarching_tpu.scene.compile import compile_tree
from raymarching_tpu.scene.csg import Box, ListNode, Mode, Sphere, bounds
from raymarching_tpu.scene.generators import death_star, menger_sponge
from raymarching_tpu.scene.objects import Camera, Light
import pytest

CFG = RenderConfig(width=24, height=16, ssaa=2, iterations=80,
                   shadows=True, normal_mode="fd")


def _world():
    tree = ListNode(Mode.UNION, [
        bounds(60.0),
        Sphere((0.0, 0.0, -6.0), 2.5, color=(0.9, 0.4, 0.2)),
        death_star((4.0, 1.0, -8.0), 2.0, color=(0.2, 0.4, 0.9)),
        Box((0.0, -3.0, -6.0), (10.0, 1.0, 10.0), color=(0.6, 0.6, 0.9)),
    ])
    return compile_tree(tree, [Light((6.0, 8.0, 4.0)),
                               Light((-5.0, 6.0, 0.0))],
                        Camera(position=(0, 0, 6), fov=55.0))


def test_mega_matches_multikernel_image():
    plan, tables = _world()
    m = np.asarray(render_tables(plan, tables, CFG, backend="mega",
                                 interpret=True))
    p = np.asarray(render_tables(plan, tables, CFG, backend="pallas",
                                 interpret=True))
    np.testing.assert_allclose(m, p, atol=1e-6)


@pytest.mark.slow
def test_mega_gradients_match_jnp():
    plan, tables = _world()
    # shade_skip_black deliberately zeroes the black Bounds prim's color
    # gradient on the mega path (documented deviation, tests/test_black_skip
    # covers it); parity against the jnp oracle needs the skip off.
    cfg = CFG.replace(shade_skip_black=False)

    def loss(t, backend, interpret=False):
        img = render_tables(plan, t, cfg, backend=backend,
                            interpret=interpret, differentiable=True)
        return jnp.mean(img * img)

    gm = jax.grad(lambda t: loss(t, "mega", True))(tables)
    gj = jax.grad(lambda t: loss(t, "jnp"))(tables)
    for field in ("prim_pos", "prim_aux", "prim_color", "light_pos",
                  "cam_position", "cam_direction", "cam_up", "cam_fov"):
        a = np.asarray(getattr(gm, field), np.float64)
        b = np.asarray(getattr(gj, field), np.float64)
        scale = max(np.abs(b).max(), 1e-8)
        np.testing.assert_allclose(
            a, b, rtol=0.02, atol=0.005 * scale,
            err_msg=f"mega gradient mismatch in {field}")


def test_mega_fused_generators():
    tree = ListNode(Mode.UNION, [
        bounds(60.0),
        menger_sponge((0.0, 0.0, -8.0), 6.0, 2, color=(0.9, 0.9, 0.8)),
    ])
    plan, tables = compile_tree(tree, [Light((6.0, 10.0, 4.0))],
                                Camera(position=(0, 1, 4), fov=60.0))
    cfg = CFG.replace(fused_generators=True, ssaa=1)
    m = np.asarray(render_tables(plan, tables, cfg, backend="mega",
                                 interpret=True))
    p = np.asarray(render_tables(plan, tables, cfg, backend="pallas",
                                 interpret=True))
    np.testing.assert_allclose(m, p, atol=1e-6)


def test_mega_no_shadows():
    plan, tables = _world()
    cfg = CFG.replace(shadows=False, ssaa=1)
    m = np.asarray(render_tables(plan, tables, cfg, backend="mega",
                                 interpret=True))
    r = np.asarray(render_tables(plan, tables, cfg, backend="ref"))
    np.testing.assert_allclose(m, r, atol=5e-4)


def test_mega_depth3_fused():
    """Depth>2 trees run the WHOLE mega pipeline on the kernel path via the
    generic post-order evaluator (no jnp fallback), with gradients."""
    inner = ListNode(Mode.DIFFERENCE, [Sphere((0, 0, -5), 2.0),
                                       Sphere((1, 0, -5), 1.0)])
    mid = ListNode(Mode.INTERSECTION, [inner, Box((0, 0, -5), (3, 3, 3))])
    root = ListNode(Mode.UNION, [bounds(40.0), mid])
    plan, tables = compile_tree(root, [Light((5, 5, 5))], Camera())
    assert plan.kernel is None
    cfg = CFG.replace(ssaa=1)
    m = np.asarray(render_tables(plan, tables, cfg, backend="mega",
                                 interpret=True))
    r = np.asarray(render_tables(plan, tables, cfg, backend="ref"))
    np.testing.assert_allclose(m, r, atol=5e-4)

    def loss(t, backend, interpret=False):
        img = render_tables(plan, t, cfg, backend=backend,
                            interpret=interpret, differentiable=True)
        return jnp.mean(img * img)

    gm = jax.grad(lambda t: loss(t, "mega", True))(tables)
    gj = jax.grad(lambda t: loss(t, "jnp"))(tables)
    for field in ("prim_pos", "prim_aux", "prim_color", "light_pos"):
        a = np.asarray(getattr(gm, field), np.float64)
        b = np.asarray(getattr(gj, field), np.float64)
        scale = max(np.abs(b).max(), 1e-8)
        np.testing.assert_allclose(
            a, b, rtol=0.02, atol=0.005 * scale,
            err_msg=f"depth-3 mega gradient mismatch in {field}")


def test_two_phase_march_bit_identical():
    """Two-phase march + compaction must reproduce the single-phase mega
    render exactly (the compaction is a scheduling change, not a semantic
    one)."""
    plan, tables = _world()
    for k1 in (8, 24, 48):
        cfg = CFG.replace(ssaa=1, two_phase_k1=k1)
        a = np.asarray(render_tables(plan, tables, cfg, backend="mega",
                                     interpret=True))
        b = np.asarray(render_tables(plan, tables, cfg.replace(
            two_phase_k1=0), backend="mega", interpret=True))
        np.testing.assert_array_equal(a, b)


def test_two_phase_overflow_fallback_exact():
    """K1=1 leaves far more than 1/8 of rays unconverged -> the capacity
    overflow triggers the full re-march fallback; results stay exact."""
    plan, tables = _world()
    cfg = CFG.replace(ssaa=1, two_phase_k1=1)
    a = np.asarray(render_tables(plan, tables, cfg, backend="mega",
                                 interpret=True))
    b = np.asarray(render_tables(plan, tables,
                                 cfg.replace(two_phase_k1=0),
                                 backend="mega", interpret=True))
    np.testing.assert_array_equal(a, b)


def test_two_phase_gradients_match():
    plan, tables = _world()
    cfg = CFG.replace(ssaa=1, two_phase_k1=24)

    def loss(t, c):
        img = render_tables(plan, t, c, backend="mega", interpret=True,
                            differentiable=True)
        return jnp.mean(img * img)

    ga = jax.grad(lambda t: loss(t, cfg))(tables)
    gb = jax.grad(lambda t: loss(t, cfg.replace(two_phase_k1=0)))(tables)
    for field in ("prim_pos", "prim_aux", "prim_color", "light_pos"):
        np.testing.assert_allclose(np.asarray(getattr(ga, field)),
                                   np.asarray(getattr(gb, field)),
                                   rtol=1e-5, atol=1e-7,
                                   err_msg=f"two-phase grad {field}")


def test_mega_analytic_normals():
    """normal_mode='analytic' in the mega kernel: hand-derived winner
    gradients vs the jnp autodiff analytic normal."""
    plan, tables = _world()
    cfg = CFG.replace(normal_mode="analytic", ssaa=1)
    m = np.asarray(render_tables(plan, tables, cfg, backend="mega",
                                 interpret=True))
    # jnp backend with analytic normals = autodiff gradient of the same field
    r = np.asarray(render_tables(plan, tables, cfg, backend="jnp"))
    diff = np.abs(m - r).max(axis=-1)
    assert (diff < 5e-3).mean() > 0.99, f"bad pixels {(diff>=5e-3).sum()}"
    assert np.median(diff) < 1e-4


def test_mega_analytic_gradients_match_jnp():
    """Backward replay must differentiate the SAME normal estimator the
    forward evaluated: in analytic mode the replay uses normal_analytic
    (reverse-mode of the sd field == the kernel's winner gradient a.e.)."""
    plan, tables = _world()
    cfg = CFG.replace(normal_mode="analytic", ssaa=1)

    def loss(t, backend, interpret=False):
        img = render_tables(plan, t, cfg, backend=backend,
                            interpret=interpret, differentiable=True)
        return jnp.mean(img * img)

    gm = jax.grad(lambda t: loss(t, "mega", True))(tables)
    gj = jax.grad(lambda t: loss(t, "jnp"))(tables)
    for field in ("prim_pos", "prim_aux", "prim_color", "light_pos"):
        a = np.asarray(getattr(gm, field), np.float64)
        b = np.asarray(getattr(gj, field), np.float64)
        scale = max(np.abs(b).max(), 1e-8)
        np.testing.assert_allclose(
            a, b, rtol=0.02, atol=0.005 * scale,
            err_msg=f"analytic-mode mega gradient mismatch in {field}")


def test_pallas_analytic_normal_routed_through_kernel():
    """The pallas backend's analytic normals go through the surface kernel
    (winner gradient), not a jnp scene_sd fallback — values must agree with
    the jnp backend's autodiff normal of the same field."""
    plan, tables = _world()
    cfg = CFG.replace(normal_mode="analytic", ssaa=1)
    p = np.asarray(render_tables(plan, tables, cfg, backend="pallas",
                                 interpret=True))
    r = np.asarray(render_tables(plan, tables, cfg, backend="jnp"))
    diff = np.abs(p - r).max(axis=-1)
    assert (diff < 5e-3).mean() > 0.99, f"bad pixels {(diff>=5e-3).sum()}"
    assert np.median(diff) < 1e-4


def test_mega_analytic_normals_fused_menger():
    from raymarching_tpu.scene.generators import menger_sponge

    tree = ListNode(Mode.UNION, [
        bounds(60.0),
        menger_sponge((0.0, 0.0, -8.0), 6.0, 2, color=(0.9, 0.9, 0.8)),
    ])
    plan, tables = compile_tree(tree, [Light((6.0, 10.0, 4.0))],
                                Camera(position=(0, 1, 4), fov=60.0))
    cfg = CFG.replace(normal_mode="analytic", ssaa=1, fused_generators=True)
    a = np.asarray(render_tables(plan, tables, cfg, backend="mega",
                                 interpret=True))
    b = np.asarray(render_tables(plan, tables,
                                 cfg.replace(normal_mode="fd"),
                                 backend="mega", interpret=True))
    # analytic vs FD normals agree except at kinks/edges
    diff = np.abs(a - b).max(axis=-1)
    assert (diff < 1e-2).mean() > 0.95
    assert np.median(diff) < 1e-3


def test_lattice_grad_matches_full_fold():
    """The collapsed-lattice winner gradient (_menger_carve_lattice_grad,
    exact analytic path) must agree with the full 20^k-cross gradient fold:
    flipping the table's lattice-validity flag row switches between them,
    the sd value is BITWISE identical (the collapse proof), and the winner
    gradient matches at generic (non-tie) points."""
    from raymarching_tpu.ops.pallas_march import (_build_table, _flag_row,
                                                  _scene_sd_grad_tile)

    tree = ListNode(Mode.UNION, [
        bounds(60.0),
        menger_sponge((0.5, -0.25, -8.0), 6.0, 2, color=(0.9, 0.9, 0.8)),
    ])
    plan, tables = compile_tree(tree, [Light((6.0, 10.0, 4.0))],
                                Camera(position=(0, 1, 4), fov=60.0))
    kp = plan.kernel
    tbl = _build_table(tables, kp)
    assert float(tbl[_flag_row(kp), 0]) == 1.0
    tbl_off = tbl.at[_flag_row(kp), 0].set(0.0)

    rng = np.random.default_rng(7)
    pts = rng.uniform(-5.0, 5.0, size=(3, 4096)).astype(np.float32)
    pts[2] -= 8.0
    px, py, pz = (jnp.asarray(p) for p in pts)
    on = _scene_sd_grad_tile(kp, tbl, px, py, pz, jnp.float32)
    off = _scene_sd_grad_tile(kp, tbl_off, px, py, pz, jnp.float32)
    np.testing.assert_array_equal(np.asarray(on[0]), np.asarray(off[0]),
                                  err_msg="collapsed sd not bitwise")
    for a, b, ax in zip(on[1:], off[1:], "xyz"):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"winner grad {ax}")


def test_winner_residuals_bitwise_and_zero_launch_backward():
    """save_winner mode (engaged by the custom-vjp forward for analytic
    configs): the shade fold's saved (sd, widx, g) must be BITWISE what
    the backward's own winner launch recomputes at the same hit points,
    and the zero-launch backward (saved residuals) must produce bitwise
    the same gradients as the relaunching shape (wres=None)."""
    from raymarching_tpu.core import camera as cam
    from raymarching_tpu.ops.pallas_render import (_fused_analytic_bwd,
                                                   _fused_fwd,
                                                   _save_winner_engaged)
    from raymarching_tpu.ops.scene_vjp import fused_winner_eval
    from raymarching_tpu.scene.compile import compile_tree

    tree = ListNode(Mode.UNION, [
        bounds(60.0),
        menger_sponge((0.0, 0.0, -8.0), 6.0, 2, color=(0.9, 0.9, 0.8)),
        death_star((4.0, 1.0, -6.0), 1.8, color=(0.2, 0.4, 0.9)),
        Sphere((-3.0, -1.0, -5.0), 1.0, color=(0.2, 0.8, 0.3)),
    ])
    plan, tables = compile_tree(tree, [Light((6.0, 8.0, 4.0))],
                                Camera(position=(0, 1, 5), fov=60.0))
    cfg = CFG.replace(normal_mode="analytic", fused_generators=True, ssaa=1)
    assert _save_winner_engaged(plan, cfg)

    origin, d = cam.generate_rays(tables, cfg)
    dirs = d.reshape(-1, 3)
    out, resid = _fused_fwd(plan, cfg, True, tables, origin, dirs)
    wres = resid[-1]
    assert wres is not None
    p = resid[3]
    sd0, widx0, g0 = fused_winner_eval(plan, cfg, p, tables, True)
    np.testing.assert_array_equal(np.asarray(wres[0]), np.asarray(sd0))
    np.testing.assert_array_equal(np.asarray(wres[1]), np.asarray(widx0))
    np.testing.assert_array_equal(np.asarray(wres[2]), np.asarray(g0))

    g_out = jnp.ones_like(out) / out.size
    saved = _fused_analytic_bwd(plan, cfg, resid, g_out, True)
    relaunch = _fused_analytic_bwd(plan, cfg, resid[:-1] + (None,), g_out,
                                   True)
    for a, b in zip(jax.tree_util.tree_leaves(saved),
                    jax.tree_util.tree_leaves(relaunch)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_effective_chunk_caps_map_length():
    """XLA compile time cliffs past ~72 lax.map steps (measured r4: the
    demo at 1024^2 SSAA3 with 144 chunks cold-compiled in 82-89 s, the
    same render at <=72 chunks in 4-6 s) — ray_chunk is a MINIMUM
    granule, coarsened tile-aligned until the map length fits."""
    from raymarching_tpu import RenderConfig
    from raymarching_tpu.api import _MAX_CHUNKS, _effective_chunk

    cfg = RenderConfig(ray_chunk=65536, ray_block=128)
    # config5's shape: 9.4M rays / 65536 = 144 chunks -> coarsened
    R = 1024 * 1024 * 9
    chunk = _effective_chunk(cfg, R)
    assert chunk >= 65536
    assert -(-R // chunk) <= _MAX_CHUNKS
    assert chunk % cfg.ray_block == 0
    # small renders keep the caller's granule exactly
    assert _effective_chunk(cfg, 8 * 65536) == 65536
    # unchunked passes through
    assert _effective_chunk(RenderConfig(ray_chunk=0), R) == 0
