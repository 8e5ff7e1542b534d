"""Wide-UNION chunk cull (GroupPlan.bvh): partition rules and bit-exact
skip proofs across every scene fold.

The cull bounds the reference's O(N) UNION fold (body.cpp:66-111): long
bounded-primitive runs are split into chunks, each with a LIVE per-axis
bounding box shipped as extra table rows (ops.pallas_march._build_table);
a chunk whose per-axis excess lower bound already exceeds the tile's
running scene minimum on every lane is provably unable to win any
strict-< selection downstream, so skipping it changes neither value nor
winner index/gradient.  Like every default-path optimization here it must
be EXACT — these tests compare each fold against the same kernel with the
partition stripped, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raymarching_tpu import RenderConfig
from raymarching_tpu.api import render_tables
from raymarching_tpu.ops.pallas_march import (kernel_key, pallas_march,
                                              pallas_surface_eval)
from raymarching_tpu.scene.compile import (_BVH_CHUNK, _BVH_MIN_RUN,
                                           compile_tree, iter_bvh_chunks)
from raymarching_tpu.scene.csg import (Box, Cross, ListNode, Mode, Sphere,
                                       bounds)
from raymarching_tpu.scene.objects import Camera, Light

TILE = 1024


def _scatter_world(n_spheres=80, n_boxes=70, seed=0):
    rng = np.random.RandomState(seed)
    prims = [bounds(80.0)]
    for _ in range(n_spheres):
        p = rng.uniform(-8, 8, 3)
        p[2] -= 14.0
        prims.append(Sphere(tuple(p), float(rng.uniform(0.3, 0.7)),
                            color=tuple(rng.uniform(0.2, 1.0, 3))))
    for _ in range(n_boxes):
        p = rng.uniform(-8, 8, 3)
        p[2] -= 14.0
        prims.append(Box(tuple(p), tuple(rng.uniform(0.4, 1.2, 3)),
                         color=tuple(rng.uniform(0.2, 1.0, 3))))
    tree = ListNode(Mode.UNION, prims)
    return compile_tree(tree, [Light((6.0, 8.0, 4.0))],
                        Camera(position=(0.0, 0.0, 6.0), fov=55.0))


def _strip_bvh(kp):
    return dataclasses.replace(
        kp, groups=tuple(dataclasses.replace(g, bvh=None)
                         for g in kp.groups))


def _points(n=256, seed=1):
    rng = np.random.RandomState(seed)
    # straddle the cull regimes: far outside every chunk, inside the
    # cloud, and exactly near surfaces (march-converged-like points)
    p = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    p[:, 2] -= 10.0
    p[: n // 4] *= 4.0
    return jnp.asarray(p)


def test_partition_shape():
    plan, _tables = _scatter_world()
    kp = kernel_key(plan)
    chunks = iter_bvh_chunks(kp)
    # one 80-sphere run and one 70-box run, chunked at _BVH_CHUNK
    sizes = [c for (_t, _s, c) in chunks]
    assert sum(sizes) == 150
    assert all(c <= _BVH_CHUNK for c in sizes)
    assert sum(1 for c in sizes if c == _BVH_CHUNK) >= 4
    # chunk spans partition each run contiguously
    spans = sorted((s, s + c) for (_t, s, c) in chunks)
    for (a, b), (c2, _d) in zip(spans, spans[1:]):
        assert b == c2 or c2 > b


def test_partition_skips_short_runs_and_crosses():
    rng = np.random.RandomState(3)
    prims = [bounds(40.0)]
    for _ in range(_BVH_MIN_RUN - 1):          # below the min-run bar
        prims.append(Sphere(tuple(rng.uniform(-4, 4, 3)), 0.5))
    for _ in range(_BVH_MIN_RUN + 8):          # crosses: unbounded arms
        prims.append(Cross(tuple(rng.uniform(-4, 4, 3)), (0.2, 0.2, 0.2)))
    plan, _t = compile_tree(ListNode(Mode.UNION, prims),
                            [Light((1.0, 5.0, 1.0))], Camera())
    assert iter_bvh_chunks(kernel_key(plan)) == ()


def test_difference_groups_not_partitioned():
    rng = np.random.RandomState(4)
    carve = [Sphere(tuple(rng.uniform(-2, 2, 3)), 0.3)
             for _ in range(_BVH_MIN_RUN + 10)]
    tree = ListNode(Mode.UNION, [
        bounds(40.0),
        ListNode(Mode.DIFFERENCE, [Box((0, 0, -6), (6, 6, 6))] + carve),
    ])
    plan, _t = compile_tree(tree, [Light((1.0, 5.0, 1.0))], Camera())
    assert iter_bvh_chunks(kernel_key(plan)) == ()


def test_table_rows_bound_their_chunks():
    plan, tables = _scatter_world()
    kp = kernel_key(plan)
    from raymarching_tpu.ops.pallas_march import _build_table, _bvh_row_base
    tbl = np.asarray(_build_table(tables, kp))
    pos = np.asarray(tables.prim_pos)
    aux = np.asarray(tables.prim_aux)
    row = _bvh_row_base(kp)
    from raymarching_tpu.scene.csg import PrimType
    for (ptype, s, c) in iter_bvh_chunks(kp):
        e = (np.broadcast_to(aux[s:s + c, :1], (c, 3))
             if ptype == int(PrimType.SPHERE) else aux[s:s + c] * 0.5)
        lo, hi = (pos[s:s + c] - e).min(0), (pos[s:s + c] + e).max(0)
        np.testing.assert_allclose(tbl[row, :3], (lo + hi) / 2, atol=1e-6)
        np.testing.assert_allclose(tbl[row, 3:6], (hi - lo) / 2, atol=1e-6)
        row += 1


@pytest.mark.parametrize("with_color,with_normal,analytic", [
    (True, False, False),    # _scene_sd_idx_tile
    (False, True, True),     # _scene_sd_grad_tile
    (True, True, True),      # _scene_sd_idx_grad_tile
    (False, True, False),    # FD stencil over _scene_sd_tile
])
def test_folds_bit_exact_vs_stripped(with_color, with_normal, analytic):
    plan, tables = _scatter_world()
    kp = kernel_key(plan)
    assert iter_bvh_chunks(kp)
    p = _points()
    outs = {}
    for key, k in (("bvh", kp), ("plain", _strip_bvh(kp))):
        sd, cidx, grad = pallas_surface_eval(
            k, 1e-3, TILE, p, tables, with_color=with_color,
            with_normal=with_normal, analytic=analytic, interpret=True)
        outs[key] = (np.asarray(sd),
                     None if cidx is None else np.asarray(cidx),
                     None if grad is None else np.asarray(grad))
    for a, b in zip(outs["bvh"], outs["plain"]):
        if a is None:
            continue
        np.testing.assert_array_equal(a, b)


def test_march_bit_exact_vs_stripped():
    plan, tables = _scatter_world()
    kp = kernel_key(plan)
    n = 128
    rng = np.random.RandomState(7)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 6.0
    d = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    d[:, 2] = -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    res_a = pallas_march(kp, 200, 1e-3, TILE, jnp.asarray(o),
                         jnp.asarray(d), tables, interpret=True)
    res_b = pallas_march(_strip_bvh(kp), 200, 1e-3, TILE, jnp.asarray(o),
                         jnp.asarray(d), tables, interpret=True)
    np.testing.assert_array_equal(np.asarray(res_a.position),
                                  np.asarray(res_b.position))
    np.testing.assert_array_equal(np.asarray(res_a.sd),
                                  np.asarray(res_b.sd))
    np.testing.assert_array_equal(np.asarray(res_a.converged),
                                  np.asarray(res_b.converged))


@pytest.mark.slow
def test_render_matches_jnp_oracle():
    plan, tables = _scatter_world(n_spheres=70, n_boxes=10)
    cfg = RenderConfig(width=16, height=16, ssaa=1, iterations=80,
                       shadows=True)
    img = np.asarray(render_tables(plan, tables, cfg, backend="mega",
                                   interpret=True))
    ref = np.asarray(render_tables(plan, tables, cfg, backend="jnp"))
    np.testing.assert_allclose(img, ref, atol=2e-5)


def test_first_wins_tie_across_chunked_and_plain_runs():
    """First-wins ties are reference-observable (body.cpp:12-14): when a
    CHUNKED run's prim (earlier leaf) ties a later un-chunked run's prim
    at exactly equal f32 sd, the earlier leaf must win.  Regression for
    the r4 review finding: folding the un-chunked runs first let the
    later leaf claim the tie (and invalidated the skip proof's premise
    that ties keep an already-folded earlier leaf)."""
    rng = np.random.RandomState(11)
    prims = [bounds(80.0)]
    # 80 spheres (>= _BVH_MIN_RUN -> chunked); sphere #5 at the origin
    for i in range(80):
        if i == 5:
            prims.append(Sphere((0.0, 0.0, 0.0), 1.0))
        else:
            p = rng.uniform(4, 9, 3)
            prims.append(Sphere(tuple(p), 0.5))
    # 8 boxes (under the min-run bar -> un-chunked), the first coincident
    # with sphere #5: at (2, 0, 0) both have sd exactly 1.0f
    prims.append(Box((0.0, 0.0, 0.0), (2.0, 2.0, 2.0)))
    for _ in range(7):
        prims.append(Box(tuple(rng.uniform(4, 9, 3)), (0.6, 0.6, 0.6)))
    plan, tables = compile_tree(ListNode(Mode.UNION, prims),
                                [Light((6.0, 8.0, 4.0))], Camera())
    kp = kernel_key(plan)
    assert iter_bvh_chunks(kp)
    sphere_leaf = 6            # bounds is leaf 0; sphere #5 is leaf 6
    p = jnp.asarray(np.tile([[2.0, 0.0, 0.0]], (128, 1)), jnp.float32)
    sd, cidx, _ = pallas_surface_eval(kp, 1e-3, TILE, p, tables,
                                      with_color=True, with_normal=False,
                                      interpret=True)
    np.testing.assert_array_equal(np.asarray(sd), 1.0)
    assert (np.asarray(cidx) == sphere_leaf).all(), np.asarray(cidx)[0]


def test_bvh_composes_with_fused_generators():
    """A plan can carry BOTH a fused generator group (extended carve ids
    at _flag_row + ordinal) and chunk-culled plain groups (bound rows
    from _bvh_row_base = _flag_row + 1): the id namespace is winner ids,
    the rows are table storage — they must coexist without collision in
    every fold, in both exact and fused modes."""
    from raymarching_tpu.scene.generators import menger_sponge
    rng = np.random.RandomState(9)
    prims = [bounds(80.0),
             menger_sponge((0.0, 6.0, -20.0), 6.0, 2,
                           color=(0.9, 0.9, 0.9))]
    for _ in range(70):
        p = rng.uniform(-8, 8, 3)
        p[2] -= 14.0
        prims.append(Sphere(tuple(p), 0.5,
                            color=tuple(rng.uniform(0.2, 1.0, 3))))
    plan, tables = compile_tree(ListNode(Mode.UNION, prims),
                                [Light((6.0, 8.0, 4.0))],
                                Camera(position=(0, 2, 8), fov=60.0))
    kp = kernel_key(plan)
    assert iter_bvh_chunks(kp)
    assert any(g.fused is not None for g in kp.groups)
    p = _points(192, seed=5)
    for fused in (False, True):
        sd, cidx, grad = pallas_surface_eval(
            kp, 1e-3, TILE, p, tables, with_color=True, with_normal=True,
            analytic=True, fused=fused, interpret=True)
        sd2, cidx2, grad2 = pallas_surface_eval(
            _strip_bvh(kp), 1e-3, TILE, p, tables, with_color=True,
            with_normal=True, analytic=True, fused=fused, interpret=True)
        np.testing.assert_array_equal(np.asarray(sd), np.asarray(sd2))
        np.testing.assert_array_equal(np.asarray(cidx), np.asarray(cidx2))
        np.testing.assert_array_equal(np.asarray(grad), np.asarray(grad2))
    # end-to-end fused gradient on the mixed plan (extended ids + chunks)
    cfg = RenderConfig(width=24, height=18, ssaa=1, iterations=80,
                       fused_generators=True, normal_mode="analytic")
    g = jax.grad(lambda t: jnp.mean(render_tables(
        plan, t, cfg, backend="mega", interpret=True)))(tables)
    leaves = jax.tree_util.tree_leaves(g)
    assert all(np.isfinite(np.asarray(x)).all() for x in leaves)
    assert float(np.abs(np.asarray(g.prim_pos)).sum()) > 0


def test_order_row_layout_agrees_with_walk():
    """The order-row table layout (iter_bvh_order_spans + _build_table)
    and the fold walk's base lookup (_span_order_base) must agree — a
    drift silently hands the walk another span's ordinals (r5 review).
    Also pins that the rows hold a live permutation of the span."""
    import raymarching_tpu.ops.pallas_march as pm

    # >= 3 uniform chunks per span needed: 200 spheres -> 6x32 + 8
    plan, tables = _scatter_world(n_spheres=200, n_boxes=0)
    kp = plan.kernel
    spans = pm.iter_bvh_order_spans(kp)
    assert spans, "scatter world must produce an ordered span"
    tbl = np.asarray(pm._build_table(tables, kp))
    base = pm._order_row_base(kp)
    off = 0
    for (gi, ri, uni) in spans:
        assert uni == pm._uniform_prefix(dict(kp.groups[gi].bvh)[ri])
        rows = tbl[base + off: base + off + uni, 0].astype(int)
        assert sorted(rows.tolist()) == list(range(uni))
        assert pm._span_order_base(kp, kp.groups[gi], ri) == base + off
        off += uni
    assert tbl.shape[0] == base + off
    # nearest-camera semantics: ordinal 0 is the chunk whose live AABB
    # centre sits nearest the camera
    from raymarching_tpu.scene.compile import iter_bvh_chunks as _ibc
    chunks = _ibc(kp)
    pos = np.asarray(tables.prim_pos)
    aux = np.asarray(tables.prim_aux)
    cam = np.asarray(tables.cam_position)
    cents = []
    for (pt, s, c) in chunks:
        p = pos[s:s + c]
        e = (np.broadcast_to(aux[s:s + c, 0:1], (c, 3)) if pt == 0
             else aux[s:s + c] * 0.5)
        cents.append(((p - e).min(0) + (p + e).max(0)) / 2)
    gi, ri, uni = spans[0]
    span_off = sum(len(ch) for g2 in kp.groups[:gi]
                   for _r, ch in (g2.bvh or ()))
    d = [np.sum((c - cam) ** 2) for c in cents[span_off:span_off + uni]]
    first = int(tbl[base, 0])
    assert d[first] == min(d)
