"""Pallas march kernel vs the jnp oracle (interpret mode on CPU — the
kernel-equivalence rung of the test pyramid, SURVEY §4).  The same kernel
code runs compiled on the GPU (Triton route); interpret mode validates
semantics."""

import jax.numpy as jnp
import numpy as np
import pytest

from raymarching_tpu import RenderConfig
from raymarching_tpu.core.march import march_while
from raymarching_tpu.core.render import render_image
from raymarching_tpu.core.sdf import scene_sd
from raymarching_tpu.ops.march_op import make_march_fn
from raymarching_tpu.ops.pallas_march import make_pallas_march
from raymarching_tpu.scene.compile import compile_tree
from raymarching_tpu.scene.csg import (Box, Cross, ListNode, Mode, Sphere,
                                       bounds)
from raymarching_tpu.scene.generators import death_star, menger_sponge
from raymarching_tpu.scene.objects import Camera, Light

ITER = 60
CFG = RenderConfig(iterations=ITER, ray_block=1024)


def _rays(n, seed=0, spread=1.0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (rng.normal(size=(n, 3)) * spread).astype(np.float32)
    return o, d


def _compare(tree, n=160, seed=0):
    plan, tables = compile_tree(tree, [], Camera())
    assert plan.kernel is not None
    impl = make_pallas_march(plan, CFG, interpret=True)
    o, d = _rays(n, seed)
    res_p = impl(o, d, tables)
    res_j = march_while(lambda p: scene_sd(plan, tables, p), o, d,
                        ITER, CFG.surface_precision)
    np.testing.assert_allclose(np.asarray(res_p.position),
                               np.asarray(res_j.position),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(res_p.converged),
                                  np.asarray(res_j.converged))


def test_union_of_each_primitive_type():
    _compare(ListNode(Mode.UNION, [
        bounds(40.0),
        Sphere((0, 0, -6), 2.0),
        Box((4, 0, -6), (2, 3, 2)),
        Cross((-4, 1, -5), (2, 2, 2)),
    ]))


def test_death_star_difference():
    _compare(ListNode(Mode.UNION, [
        bounds(40.0),
        death_star((0, 0, -6), 2.5),
    ]), seed=1)


def test_menger_iter2():
    _compare(ListNode(Mode.UNION, [
        bounds(40.0),
        menger_sponge((0, 0, -8), 6.0, 2),
    ]), n=96, seed=2)


def test_intersection_and_complement_root():
    _compare(ListNode(Mode.INTERSECTION, [
        Sphere((0, 0, -6), 4.0),
        Box((0, 0, -6), (5, 5, 5)),
    ]), seed=3)
    _compare(ListNode(Mode.COMPLEMENT, [
        Sphere((0, 0, 0), 20.0),
    ]), seed=4)


def test_ragged_ray_count_padding():
    """R not a multiple of the 1024-ray tile: edge padding must not change
    real rays."""
    tree = ListNode(Mode.UNION, [bounds(40.0), Sphere((0, 0, -6), 2.0)])
    _compare(tree, n=37, seed=5)
    _compare(tree, n=1025, seed=6)


def test_full_render_pallas_vs_reference():
    """End-to-end forward image allclose: pallas-backed render vs the
    oracle renderer."""
    tree = ListNode(Mode.UNION, [
        bounds(60.0),
        Sphere((0.0, 0.0, -6.0), 2.5, color=(0.9, 0.4, 0.2)),
        Box((0.0, -3.0, -6.0), (10.0, 1.0, 10.0), color=(0.6, 0.6, 0.9)),
    ])
    plan, tables = compile_tree(tree, [Light((6.0, 8.0, 4.0))],
                                Camera(position=(0, 0, 6), fov=55.0))
    cfg = RenderConfig(width=24, height=16, ssaa=1, iterations=ITER,
                       shadows=True, normal_mode="analytic")
    impl = make_pallas_march(plan, cfg, interpret=True)
    sd_fn = lambda tb, p: scene_sd(plan, tb, p)
    march_fn = make_march_fn(sd_fn, cfg.iterations, cfg.surface_precision,
                             tables, forward_impl=impl)
    img_p = np.asarray(render_image(plan, tables, cfg, march_fn=march_fn))
    img_r = np.asarray(render_image(plan, tables, cfg))
    np.testing.assert_allclose(img_p, img_r, atol=1e-4)


def test_depth3_scene_marches_on_kernel_path():
    """Depth>2 trees compile the generic post-order evaluator — the march
    kernel must agree with the jnp oracle march (no fallback)."""
    inner = ListNode(Mode.UNION, [Sphere((0, 0, -6), 1.0)])
    mid = ListNode(Mode.DIFFERENCE, [Box((0, 0, -6), (4, 4, 4)), inner])
    root = ListNode(Mode.UNION, [bounds(40.0), mid,
                                 ListNode(Mode.UNION, [inner])])
    plan, tables = compile_tree(root, [], Camera())
    assert plan.kernel is None
    impl = make_pallas_march(plan, CFG, interpret=True)

    n = 64
    rng = np.random.default_rng(11)
    o = np.broadcast_to([0.0, 0.0, 4.0], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] -= 1.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    res_p = impl(jnp.asarray(o), jnp.asarray(d), tables)
    from raymarching_tpu.core.march import march_while
    res_j = march_while(lambda q: scene_sd(plan, tables, q),
                        jnp.asarray(o), jnp.asarray(d),
                        CFG.iterations, CFG.surface_precision)
    np.testing.assert_allclose(np.asarray(res_p.position),
                               np.asarray(res_j.position), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(res_p.converged),
                                  np.asarray(res_j.converged))


def test_march_step_counters():
    """with_steps: per-ray iteration counts from the kernel (interpret)
    match the jnp profile path."""
    from raymarching_tpu.core.march import march_profile
    from raymarching_tpu.ops.pallas_march import pallas_march

    tree = ListNode(Mode.UNION, [bounds(40.0), Sphere((0, 0, -6), 2.0)])
    plan, tables = compile_tree(tree, [], Camera())
    o, d = _rays(96, seed=9)
    res_p, steps_p = pallas_march(plan.kernel, ITER, 1e-3, 1024, o, d, tables,
                                  with_steps=True, interpret=True)
    res_j, steps_j = march_profile(
        lambda p: scene_sd(plan, tables, p), o, d, ITER, 1e-3)
    # kernel tiles may run a few extra MASKED iterations (per-tile exit,
    # K-step checks) but per-ray ACTIVE step counts are identical
    np.testing.assert_array_equal(np.asarray(steps_p), np.asarray(steps_j))


class TestMengerLattice:
    """The collapsed-lattice Menger carve fold
    (compile._menger_lattice + pallas_march._menger_carve_lattice): the
    column collapse must be BITWISE exact while rows share coordinates,
    and the flag-row gate must drop back to the full fold the moment a
    cross row is perturbed — never approximate."""

    def _menger_plan(self, iters=3):
        tree = ListNode(Mode.UNION, [
            bounds(60.0),
            menger_sponge((0, 0, -8), 9.0, iters),
        ])
        return compile_tree(tree, [], Camera())

    def test_structure_emitted(self):
        plan, tables = self._menger_plan(3)
        g = next(g for g in plan.kernel.groups if g.fused is not None)
        assert g.lattice is not None and len(g.lattice) == 3
        assert g.lattice[0] == (g.start + 1,)
        l2 = g.lattice[2]
        assert len(l2[0]) == 9 and len(l2[4]) == 64   # 9 x-coords, 64 cols
        assert sum(len(c[2]) for c in l2[4]) == 400
        from raymarching_tpu.ops.pallas_march import lattice_ok
        assert float(lattice_ok(plan.kernel, tables)) == 1.0

    def test_iters4_lattice_routing(self):
        """r5: iters=4 EMITS its full three-level lattice (the VALUE
        collapse shares each distinct x-set's minimum across columns, so
        the 512-column level 3 traces ~2.6k ops — the r3 cap's 11.7k
        no longer applies), but the WINNER folds cannot share (per-column
        row chains) and route through the value-bound subtree walk
        (_lattice_idx_ok False, _use_subtree True).  iters=3 keeps both
        collapses; an iters=5 level 4 (4096 columns) stays capped."""
        from raymarching_tpu.ops.pallas_march import (_lattice_idx_ok,
                                                      _use_subtree)
        plan3, _ = self._menger_plan(3)
        g3 = next(g for g in plan3.kernel.groups if g.fused is not None)
        assert g3.lattice is not None
        assert _lattice_idx_ok(g3) and not _use_subtree(g3)
        plan4, _ = self._menger_plan(4)
        g4 = next(g for g in plan4.kernel.groups if g.fused is not None)
        assert g4.count == 8422          # box + 1 + 20 + 400 + 8000 crosses
        assert g4.lattice is not None
        assert len(g4.lattice) == 4
        assert len(g4.lattice[3][4]) == 512     # level-3 columns
        assert not _lattice_idx_ok(g4) and _use_subtree(g4)

    def test_subtree_culled_carve_matches_full_fold_bitwise(self):
        """Deep sponges past the lattice column cap take the hierarchical
        per-subtree cull (_menger_carve_subtree_culled): the skip bound is
        a proof (every member >= med3 of the cell-margin excesses), so
        the fold must equal the plain run fold BITWISE (min is exact
        selection, order-free)."""
        import jax.numpy as jnp

        from raymarching_tpu.ops.pallas_march import (
            _build_table, _fold_runs, _menger_carve_subtree_culled,
            _menger_subtrees)

        plan, tables = self._menger_plan(4)
        g = next(g for g in plan.kernel.groups if g.fused is not None)
        assert _menger_subtrees(g) is not None
        tbl = _build_table(tables, plan.kernel)
        rng = np.random.default_rng(7)
        pts = rng.uniform(-25, 25, (2048, 3)).astype(np.float32)
        pts[:, 2] -= 8.0
        px, py, pz = (jnp.asarray(pts[:, a].reshape(16, 128))
                      for a in range(3))
        inf = jnp.full(px.shape, jnp.inf, jnp.float32)
        base = _fold_runs(tbl, tuple(r for r in g.runs if r[3] == -1),
                          px, py, pz, inf)
        pos_runs = tuple(r for r in g.runs if r[3] == 1)
        full = _fold_runs(tbl, pos_runs, px, py, pz, base)
        fast = _menger_carve_subtree_culled(plan.kernel, tbl, g, px, py,
                                            pz, base)
        np.testing.assert_array_equal(np.asarray(full), np.asarray(fast))

        # the idx / grad fold variants must be bitwise too (they back the
        # color winner, analytic normals, and the FD-stencil backward)
        import raymarching_tpu.ops.pallas_march as pm

        def both(fn):
            a = fn()
            old = pm._SUBTREE_MIN_COUNT
            pm._SUBTREE_MIN_COUNT = 10 ** 9
            try:
                b = fn()
            finally:
                pm._SUBTREE_MIN_COUNT = old
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

        f32 = jnp.float32
        both(lambda: pm._scene_sd_idx_grad_tile(plan.kernel, tbl, px, py,
                                                pz, f32))
        both(lambda: pm._scene_sd_idx_tile(plan.kernel, tbl, px, py, pz,
                                           f32))
        both(lambda: pm._scene_sd_grad_tile(plan.kernel, tbl, px, py, pz,
                                            f32))

    def test_subtree_collapsed_carve_matches_full_fold_bitwise(self):
        """iters=4's VALUE-only carve fold additionally collapses each
        live level-1 subtree's two lower levels into a per-subtree
        coordinate lattice (_menger_subtree_collapsed) — min is exact
        selection and med3 is monotone, so the collapse must equal the
        leaf-order fold BITWISE; a perturbed cross row must drop the
        structure flag and route the SCENE fold through the plain leaf
        fold (exact for any table), also bitwise."""
        import jax.numpy as jnp

        from raymarching_tpu.ops.pallas_march import (
            _build_table, _fold_runs, _menger_subtree_collapsed,
            _scene_sd_tile, _subtree_collapses, subtree_collapse_ok)

        plan, tables = self._menger_plan(4)
        kp = plan.kernel
        g = next(g for g in kp.groups if g.fused is not None)
        assert _subtree_collapses(g)
        assert float(subtree_collapse_ok(kp, tables)) == 1.0
        tbl = _build_table(tables, kp)
        rng = np.random.default_rng(11)
        far = rng.uniform(-25, 25, (1024, 3)).astype(np.float32)
        near = rng.uniform(-4.6, 4.6, (1024, 3)).astype(np.float32)
        pts = np.concatenate([far, near])
        pts[:, 2] -= 8.0
        px, py, pz = (jnp.asarray(pts[:, a].reshape(16, 128))
                      for a in range(3))
        inf = jnp.full(px.shape, jnp.inf, jnp.float32)
        base = _fold_runs(tbl, tuple(r for r in g.runs if r[3] == -1),
                          px, py, pz, inf)
        pos_runs = tuple(r for r in g.runs if r[3] == 1)
        full = _fold_runs(tbl, pos_runs, px, py, pz, base)
        fast = _menger_subtree_collapsed(kp, tbl, g, px, py, pz, base)
        np.testing.assert_array_equal(np.asarray(full), np.asarray(fast))

        # perturb one level-3 cross: flag drops, the scene fold must relay
        # through the PLAIN leaf fold — assert the scene min itself
        # against an oracle recomputed with subtree plans disabled (all
        # plain folds), so a routing bug in the lax.cond fallback wiring
        # inside _scene_sd_tile cannot hide
        import raymarching_tpu.ops.pallas_march as pm

        def scene_min_oracle(t2):
            old = pm._SUBTREE_MIN_COUNT
            pm._SUBTREE_MIN_COUNT = 10 ** 9
            try:
                return np.asarray(_scene_sd_tile(kp, t2, px, py, pz,
                                                 jnp.float32))
            finally:
                pm._SUBTREE_MIN_COUNT = old

        pp = np.array(tables.prim_pos)
        pp[g.start + 700, 0] += 0.25
        moved = tables._replace(prim_pos=pp)
        assert float(subtree_collapse_ok(kp, moved)) == 0.0
        tbl2 = _build_table(moved, kp)
        sd = np.asarray(_scene_sd_tile(kp, tbl2, px, py, pz, jnp.float32))
        np.testing.assert_array_equal(sd, scene_min_oracle(tbl2))

        # uniform translation of one ENTIRE subtree: within-subtree
        # sharing still holds, but the level-1 skip bound the collapse
        # derives from the group root is invalid — the bound-validity
        # half of the flag (r4 advisor) must catch it and the scene fold
        # must again equal the plain-fold oracle
        T = 421
        pp2 = np.array(tables.prim_pos)
        pp2[g.start + 2 + 7 * T: g.start + 2 + 8 * T, 1] += 0.6
        shifted = tables._replace(prim_pos=pp2)
        assert float(subtree_collapse_ok(kp, shifted)) == 0.0
        tbl3 = _build_table(shifted, kp)
        sd3 = np.asarray(_scene_sd_tile(kp, tbl3, px, py, pz, jnp.float32))
        np.testing.assert_array_equal(sd3, scene_min_oracle(tbl3))

        # tolerance acceptance (r5 review): translate EVERY member cross
        # (not the group root) off the generated lattice — within the
        # flag's s/72 drift budget (s = 9 -> tol = 0.125) the flag must
        # HOLD (the margin proof absorbs it and within-subtree sharing
        # is intact) and the collapsed scene min must still equal the
        # plain-fold oracle; past the budget the flag must drop.
        def translated_members(delta):
            pp3 = np.array(tables.prim_pos)
            pp3[g.start + 1: g.start + g.count, 0] += delta
            return tables._replace(prim_pos=pp3)

        near = translated_members(9.0 / 100)          # < s/72
        assert float(subtree_collapse_ok(kp, near)) == 1.0
        tbl_near = _build_table(near, kp)
        np.testing.assert_array_equal(
            np.asarray(_scene_sd_tile(kp, tbl_near, px, py, pz,
                                      jnp.float32)),
            scene_min_oracle(tbl_near))
        assert float(subtree_collapse_ok(
            kp, translated_members(9.0 / 50))) == 0.0  # > s/72
        assert float(subtree_collapse_ok(kp, tables)) == 1.0

        # the idx/grad fold family (the backward's workhorse) takes the
        # same flag-gated route (r5 value-bound walk / plain fallback):
        # winner ids, values and gradients must match the plain-fold
        # oracle bitwise on BOTH the valid and the perturbed tables
        def idx_grad_both(t2):
            got = pm._scene_sd_idx_grad_tile(kp, t2, px, py, pz,
                                             jnp.float32)
            old = pm._SUBTREE_MIN_COUNT
            pm._SUBTREE_MIN_COUNT = 10 ** 9
            try:
                want = pm._scene_sd_idx_grad_tile(kp, t2, px, py, pz,
                                                  jnp.float32)
            finally:
                pm._SUBTREE_MIN_COUNT = old
            for a, b in zip(got, want):
                np.testing.assert_array_equal(np.asarray(a),
                                              np.asarray(b))

        idx_grad_both(tbl)      # flag true: value-bound fori walk
        idx_grad_both(tbl3)     # flag false: plain-fold fallback

    def test_lattice_carve_matches_explicit_fold_bitwise(self):
        import jax.numpy as jnp

        from raymarching_tpu.ops.pallas_march import (_build_table,
                                                      _fold_runs,
                                                      _menger_carve_lattice)

        plan, tables = self._menger_plan(3)
        g = next(g for g in plan.kernel.groups if g.fused is not None)
        tbl = _build_table(tables, plan.kernel)
        rng = np.random.default_rng(3)
        pts = rng.uniform(-30, 30, (1024, 3)).astype(np.float32)
        px, py, pz = (jnp.asarray(pts[:, a]) for a in range(3))
        pos_runs = tuple(r for r in g.runs if r[3] == 1)
        full = _fold_runs(tbl, pos_runs, px, py, pz,
                          jnp.full(px.shape, jnp.inf, jnp.float32))
        fast = _menger_carve_lattice(tbl, g, px, py, pz)
        np.testing.assert_array_equal(np.asarray(full), np.asarray(fast))

    def test_march_bit_exact_and_perturbation_fallback(self):
        import dataclasses

        from raymarching_tpu.ops.pallas_march import (lattice_ok,
                                                      pallas_march)

        plan, tables = self._menger_plan(3)
        kp = plan.kernel
        kp_plain = dataclasses.replace(kp, groups=tuple(
            dataclasses.replace(g, lattice=None) for g in kp.groups))
        o, d = _rays(512, seed=11, spread=4.0)
        r1 = pallas_march(kp, ITER, 1e-3, 1024, o, d, tables, interpret=True)
        r2 = pallas_march(kp_plain, ITER, 1e-3, 1024, o, d, tables,
                          interpret=True)
        np.testing.assert_array_equal(np.asarray(r1.position),
                                      np.asarray(r2.position))
        np.testing.assert_array_equal(np.asarray(r1.sd), np.asarray(r2.sd))

        # perturb ONE cross row: flag must drop and results must still be
        # exact (the fallback full fold runs inside the lattice kernel)
        g = next(g for g in kp.groups if g.lattice is not None)
        pp = np.array(tables.prim_pos)
        pp[g.start + 5, 0] += 0.25
        moved = tables._replace(prim_pos=pp)
        assert float(lattice_ok(kp, moved)) == 0.0
        r3 = pallas_march(kp, ITER, 1e-3, 1024, o, d, moved, interpret=True)
        r4 = pallas_march(kp_plain, ITER, 1e-3, 1024, o, d, moved,
                          interpret=True)
        np.testing.assert_array_equal(np.asarray(r3.sd), np.asarray(r4.sd))
        np.testing.assert_array_equal(np.asarray(r3.position),
                                      np.asarray(r4.position))
