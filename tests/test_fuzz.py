"""Seeded differential fuzzing: random CSG scenes evaluated through every
implementation layer — pure-Python tree oracle vs vectorized jnp plan vs
kernel normal form vs Pallas (interpret).  Catches structure edge cases the
hand-written scenes miss (all-negated groups, singleton lists, mixed type
runs, many groups, depth>2 nesting through the generic kernel path)."""

import numpy as np
import pytest

from raymarching_tpu.core.sdf import (scene_sd, scene_sd_kernel_form,
                                      scene_surface)
from raymarching_tpu.ops.pallas_march import kernel_key, pallas_surface_eval
from raymarching_tpu.scene.compile import compile_tree
from raymarching_tpu.scene.csg import (Box, Cross, Julia, ListNode,
                                       Mandelbox, Mandelbulb, Mode, Sphere)
from raymarching_tpu.scene.objects import Camera


def _random_prim(rng):
    pos = tuple(rng.uniform(-6, 6, 3))
    color = tuple(rng.uniform(0, 1, 3))
    kind = rng.integers(0, 6)
    if kind == 0:
        return Sphere(pos, float(rng.uniform(0.3, 3.0)), color)
    if kind == 3:
        # procedural leaves: LOW iteration counts — the scalar oracle runs
        # f64, the stack f32, and chaotic folds amplify the precision gap
        # beyond the shared tolerance at deep iteration counts
        return Mandelbox(pos, float(rng.uniform(0.5, 2.0)),
                         scale=float(rng.uniform(1.5, 3.0)),
                         iterations=int(rng.integers(2, 5)), color=color)
    if kind == 4:
        return Mandelbulb(pos, float(rng.uniform(0.5, 2.0)),
                          iterations=int(rng.integers(2, 5)), color=color)
    if kind == 5:
        return Julia(pos, float(rng.uniform(0.5, 2.0)),
                     c=tuple(rng.uniform(-0.8, 0.8, 4)),
                     iterations=int(rng.integers(2, 6)), color=color)
    size = tuple(rng.uniform(0.5, 4.0, 3))
    return (Box if kind == 1 else Cross)(pos, size, color)


def _random_list(rng, depth: int):
    mode = Mode(int(rng.integers(0, 4)))
    sub = ListNode(mode)
    for _ in range(rng.integers(1, 6)):
        if depth > 0 and rng.random() < 0.35:
            sub.append(_random_list(rng, depth - 1))
        else:
            sub.append(_random_prim(rng))
    return sub


def _random_scene(rng, depth: int = 1):
    root = ListNode(Mode.UNION)
    n_children = rng.integers(1, 7)
    for _ in range(n_children):
        if rng.random() < 0.5:
            root.append(_random_prim(rng))
        else:
            root.append(_random_list(rng, depth - 1))
    return root


@pytest.mark.parametrize("seed,depth", [(s, 1) for s in range(12)]
                         + [(s, 3) for s in range(12, 20)])
def test_fuzz_all_layers_agree(seed, depth):
    rng = np.random.default_rng(1000 + seed)
    tree = _random_scene(rng, depth)
    plan, tables = compile_tree(tree, [], Camera())
    pts = rng.uniform(-8, 8, size=(64, 3)).astype(np.float32)

    # python tree oracle
    sd_py = np.array([tree.sdf(tuple(p))[0] for p in pts], np.float32)
    col_py = np.array([tree.sdf(tuple(p))[1] for p in pts], np.float32)

    # vectorized jnp plan
    sd_j = np.asarray(scene_sd(plan, tables, pts))
    np.testing.assert_allclose(sd_j, sd_py, rtol=1e-5, atol=2e-5)
    sd_s, col_j = scene_surface(plan, tables, pts)
    np.testing.assert_allclose(np.asarray(col_j), col_py, atol=1e-6)

    # two-level kernel normal form agrees exactly when lowerable
    if plan.kernel is not None:
        sd_k = np.asarray(scene_sd_kernel_form(plan, tables, pts))
        np.testing.assert_allclose(sd_k, sd_j, rtol=0, atol=0)

    # pallas kernel path (interpret) — EVERY tree: two-level normal form
    # for depth<=2, generic post-order evaluator for deeper nests
    sd_p, cidx, g = pallas_surface_eval(
        kernel_key(plan), 1e-3, 1024, pts, tables,
        with_color=True, with_normal=False, interpret=True)
    # rtol: deep random trees legitimately accumulate tens of f32 ulps
    # between the jnp fold and the kernel fold (different association);
    # an extended 120-seed sweep found one depth-3 case at 1.9e-6
    # relative — 5e-6 keeps seed robustness without hiding real bugs
    np.testing.assert_allclose(np.asarray(sd_p), sd_j,
                               rtol=5e-6, atol=1e-5)
    color = np.where(np.asarray(cidx)[:, None] >= 0,
                     tables.prim_color[np.clip(np.asarray(cidx), 0,
                                               None)], 0.0)
    # colors may differ only at exact SD ties between distinct prims
    match = np.all(np.abs(color - col_py) < 1e-6, axis=-1)
    assert match.mean() > 0.98, f"color mismatches beyond ties: " \
        f"{(~match).sum()}/{len(match)}"


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_fused_generators_match_exact(seed):
    """Field-level fuzz for fused-generator provenance: random worlds with
    EVERY generator kind (MengerSponge, DeathStar) plus distractor prims,
    evaluated fused vs exact through the kernel path.  DeathStar fusion is
    the same function (ulp tolerance); Menger fusion is conservative with
    the same zero set, so the contract there is sign agreement + equality
    near the surface (the test_fused_menger contracts, fuzzed)."""
    from raymarching_tpu.scene.generators import death_star, menger_sponge

    rng = np.random.default_rng(7000 + seed)
    tree = ListNode(Mode.UNION)
    tree.append(menger_sponge(tuple(rng.uniform(-4, 4, 3)),
                              float(rng.uniform(3, 8)),
                              int(rng.integers(2, 4))))
    for _ in range(int(rng.integers(1, 3))):
        tree.append(death_star(tuple(rng.uniform(-6, 6, 3)),
                               float(rng.uniform(0.5, 3.0))))
    for _ in range(int(rng.integers(0, 3))):
        tree.append(_random_prim(rng))
    plan, tables = compile_tree(tree, [], Camera())
    kinds = sorted(g.fused[0] for g in plan.kernel.groups
                   if g.fused is not None)
    assert "menger" in kinds and "deathstar" in kinds
    pts = rng.uniform(-9, 9, size=(512, 3)).astype(np.float32)

    sd_e, _, _ = pallas_surface_eval(kernel_key(plan), 1e-3, 1024, pts,
                                     tables, with_color=False,
                                     with_normal=False, interpret=True)
    sd_f, _, _ = pallas_surface_eval(kernel_key(plan), 1e-3, 1024, pts,
                                     tables, with_color=False,
                                     with_normal=False, fused=True,
                                     interpret=True)
    sd_e, sd_f = np.asarray(sd_e), np.asarray(sd_f)
    off = np.abs(sd_e) > 1e-3
    assert np.all(np.sign(sd_f[off]) == np.sign(sd_e[off]))
    assert np.all(sd_f <= sd_e + 1e-4)        # conservative
    near = np.abs(sd_e) < 0.02
    np.testing.assert_allclose(sd_f[near], sd_e[near], atol=1e-4)

    # the fused jnp twin (the backward's field) matches the fused kernel
    from raymarching_tpu.core.sdf import scene_sd_fused
    sd_twin = np.asarray(scene_sd_fused(plan, tables, pts))
    np.testing.assert_allclose(sd_f, sd_twin, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_reflections_mega_matches_jnp(seed):
    """Render-level fuzz for the mirror-bounce extension: random CSG
    worlds (wrapped in Bounds so bounce rays always terminate) rendered
    with reflect_strength through the in-kernel bounce loop vs the
    recursive jnp oracle."""
    from raymarching_tpu import RenderConfig
    from raymarching_tpu.api import render_tables
    from raymarching_tpu.scene.csg import bounds
    from raymarching_tpu.scene.objects import Light

    rng = np.random.default_rng(4000 + seed)
    # smooth leaves only (Sphere/Box/Cross): fractal DEs have chaotic
    # normals, so a 1e-5 primary hit difference lawfully reflects into a
    # DIFFERENT object — pixel-level cross-backend parity is only
    # well-defined off the chaotic leaves (their own parity is fuzzed
    # field-level in test_fuzz_all_layers_agree)
    tree = ListNode(Mode.UNION)
    for _ in range(int(rng.integers(2, 6))):
        pos = tuple(rng.uniform(-6, 6, 3))
        color = tuple(rng.uniform(0, 1, 3))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            tree.append(Sphere(pos, float(rng.uniform(0.3, 3.0)), color))
        else:
            tree.append((Box if kind == 1 else Cross)(
                pos, tuple(rng.uniform(0.5, 4.0, 3)), color))
    tree.append(bounds(60.0))
    lights = [Light(tuple(rng.uniform(-10, 10, 3)))
              for _ in range(int(rng.integers(1, 3)))]
    plan, tables = compile_tree(tree, lights,
                                Camera(position=(0, 1, 9), fov=60.0))
    cfg = RenderConfig(width=24, height=16, ssaa=1, iterations=120,
                       reflect_strength=0.4,
                       reflect_bounces=int(rng.integers(1, 3)))
    a = np.asarray(render_tables(plan, tables, cfg, backend="jnp"))
    m = np.asarray(render_tables(plan, tables, cfg, backend="mega",
                                 interpret=True))
    assert np.isfinite(m).all()
    # tolerance covers f32 march-order noise at grazing bounces; the
    # match must hold for ~every pixel, not just on average
    close = np.abs(a - m).max(axis=-1) < 5e-3
    assert close.mean() > 0.99, f"{(~close).sum()}/{close.size} pixels off"
