"""Fused DeathStar evaluation vs the explicit two-sphere table.

Unlike the Menger fold (conservative superset min), the fused DeathStar
field is the SAME two-sphere function — the carve sphere is derived from
the base row (centre + 1.5 r in x, body.cpp:159-169) instead of read from
its own table row, so values agree to f32 rounding everywhere and
gradients flow to the GENERATOR's (position, radius) rather than to two
independent spheres.  Contracts tested here:
  * provenance attaches (and only for the base-minus-carve group shape);
  * field equality vs the exact table everywhere (ulp-scale tolerance);
  * the jnp mirror (core.sdf.scene_sd_fused) matches the kernel;
  * generator-parameter gradients: radius cotangent includes the carve's
    dependence on r; the carve row receives zero cotangent;
  * end-to-end forward image allclose, exact vs fused.
"""

import jax
import jax.numpy as jnp
import numpy as np

from raymarching_tpu import RenderConfig
from raymarching_tpu.api import render_tables
from raymarching_tpu.core.sdf import scene_sd, scene_sd_fused
from raymarching_tpu.ops.pallas_march import pallas_surface_eval
from raymarching_tpu.scene.compile import compile_tree
from raymarching_tpu.scene.csg import ListNode, Mode, Sphere, bounds
from raymarching_tpu.scene.generators import DeathStarNode, death_star
from raymarching_tpu.scene.objects import Camera, Light


def _world():
    tree = ListNode(Mode.UNION, [
        bounds(60.0),
        death_star((0.5, 0.2, -6.0), 2.0, color=(0.2, 0.4, 0.9)),
        Sphere((4.0, -1.0, -5.0), 1.0, color=(0.2, 0.8, 0.3)),
    ])
    return compile_tree(tree, [Light((6.0, 10.0, 4.0))],
                        Camera(position=(0, 1, 4), fov=60.0))


def _sd(plan, tables, p, fused, analytic=False):
    sd, _, g = pallas_surface_eval(plan.kernel, 1e-3, 1024, p, tables,
                                   with_color=False, with_normal=analytic,
                                   fused=fused, analytic=analytic,
                                   interpret=True)
    return (np.asarray(sd), None if g is None else np.asarray(g))


def test_provenance_attached():
    plan, tables = _world()
    g = next(g for g in plan.kernel.groups if g.fused is not None)
    assert g.fused == ("deathstar",)
    assert g.count == 2 and g.gsign == -1 and g.scales == (-1, 1)


def test_provenance_requires_base_minus_carve_shape():
    """A DeathStarNode whose children are not sphere-minus-sphere must NOT
    get the fused descriptor (the carve derivation would be wrong)."""
    from raymarching_tpu.scene.csg import Box
    bad = DeathStarNode(Mode.DIFFERENCE)
    bad.append(Sphere((0, 0, -6), 2.0))
    bad.append(Box((3, 0, -6), (2, 2, 2)))
    tree = ListNode(Mode.UNION, [bounds(60.0), bad])
    plan, _ = compile_tree(tree, [], Camera())
    assert all(g.fused is None for g in plan.kernel.groups)


def test_fused_field_equals_exact_table():
    plan, tables = _world()
    rng = np.random.default_rng(1)
    p = rng.uniform(-5, 5, size=(4000, 3)).astype(np.float32)
    p[:, 2] -= 6.0
    sd_exact, _ = _sd(plan, tables, p, fused=False)
    sd_fused, _ = _sd(plan, tables, p, fused=True)
    # same function, carve centre re-derived in f32: ulp-scale only
    np.testing.assert_allclose(sd_fused, sd_exact, atol=2e-5)


def test_jnp_mirror_matches_kernel():
    plan, tables = _world()
    rng = np.random.default_rng(2)
    p = rng.uniform(-5, 5, size=(2048, 3)).astype(np.float32)
    p[:, 2] -= 6.0
    sd_kernel, _ = _sd(plan, tables, p, fused=True)
    sd_jnp = np.asarray(scene_sd_fused(plan, tables, jnp.asarray(p)))
    np.testing.assert_allclose(sd_kernel, sd_jnp, atol=1e-6)


def test_gradients_flow_to_generator_params():
    """d field / d radius through the fused field must include the carve's
    dependence on r (centre offset 1.5 r AND radius), and the carve row
    must receive ZERO cotangent — checked against numeric FD of the fused
    jnp field and against the exact-table gradient (which differs)."""
    plan, tables = _world()
    g = next(g for g in plan.kernel.groups if g.fused is not None)
    base = g.start
    # a point inside the base sphere near the carve boundary, where the
    # group value is the carve branch: -(carve)
    p = jnp.asarray(np.array([[1.6, 0.2, -6.0]], np.float32))

    def f_of_r(r, fn):
        aux = tables.prim_aux.copy()
        t = tables._replace(prim_aux=jnp.asarray(aux).at[base, 0].set(r))
        return fn(plan, t, p)[0]

    r0 = float(tables.prim_aux[base, 0])
    for fn in (scene_sd_fused,):
        gr = jax.grad(lambda r: f_of_r(r, fn))(jnp.float32(r0))
        h = 1e-3
        fd = (f_of_r(r0 + h, fn) - f_of_r(r0 - h, fn)) / (2 * h)
        np.testing.assert_allclose(float(gr), float(fd), atol=1e-3)

    # carve row receives zero cotangent through the fused field
    def loss(t):
        return jnp.sum(scene_sd_fused(plan, t, p))

    grads = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, tables))
    assert float(jnp.abs(grads.prim_pos[base + 1]).max()) == 0.0
    assert float(jnp.abs(grads.prim_aux[base + 1]).max()) == 0.0
    # and the base row absorbs it (nonzero)
    assert float(jnp.abs(grads.prim_pos[base]).max()) > 0.0

    # the exact-table gradient DIFFERS by construction on the carve branch
    # (there d/dr = 0 for the base radius): fused-mode semantics are
    # generator-parameter gradients, not two-sphere gradients.
    gr_exact = jax.grad(lambda r: f_of_r(r, scene_sd))(jnp.float32(r0))
    gr_fused = jax.grad(
        lambda r: f_of_r(r, scene_sd_fused))(jnp.float32(r0))
    assert abs(float(gr_exact) - float(gr_fused)) >= 0.4


def test_analytic_winner_grad_matches_fd_of_fused_field():
    plan, tables = _world()
    rng = np.random.default_rng(3)
    p = rng.uniform(-4, 4, size=(512, 3)).astype(np.float32)
    p[:, 2] -= 6.0
    sd, grad = _sd(plan, tables, p, fused=True, analytic=True)
    h = 1e-3
    fd = np.empty_like(grad)
    for a in range(3):
        dp = np.zeros(3, np.float32)
        dp[a] = h
        sp, _ = _sd(plan, tables, p + dp, fused=True)
        sm, _ = _sd(plan, tables, p - dp, fused=True)
        fd[:, a] = (sp - sm) / (2 * h)
    # away from fold creases the winner gradient equals the FD slope
    smooth = np.all(np.abs(grad - fd) < 5e-2, axis=1)
    assert smooth.mean() > 0.97


def test_forward_image_allclose():
    plan, tables = _world()
    cfg = RenderConfig(width=64, height=48, ssaa=1, iterations=200,
                       shadows=True, backend="pallas")
    a = np.asarray(render_tables(plan, tables, cfg.replace(
        fused_generators=False), backend="pallas", interpret=True))
    b = np.asarray(render_tables(plan, tables, cfg.replace(
        fused_generators=True), backend="pallas", interpret=True))
    diff = np.abs(a - b).max(axis=-1)
    assert (diff < 5e-3).mean() > 0.995
