"""Hand-derived Pallas backward for the exact-table path.

The IFT backward (ops.march_op) and the FD-normal backward both need VJPs
of the scene SDF w.r.t. the query point and every primitive parameter.
The jnp route (``jax.vjp(scene_sd)``) materializes and transposes the
[rays, prims] leaf-distance matrix in HBM — the very thing the forward
kernel exists to avoid (ops/pallas_march.py design note).

This module replaces it with winner algebra.  The scene SDF is, through
every compiled min/max fold, a.e. equal to ``sign_eff * sd_winner`` for
one winning leaf with a STATIC path sign (sign_eff = gsign * scale, the
root rsign cancels).  The fused surface kernel's combined mode
(`_scene_sd_idx_grad_tile`) returns per ray:

    sd, winner index w, g = d scene / d p   (the winner's gradient)

from ONE fold pass.  Every cotangent is then a per-lane formula:

    d scene / d center_w = -g                      (translation invariance)
    d scene / d radius_w = -sign_eff[w]            (sphere)
    d scene / d size_w,a = -sign_eff[w] * |g_a|/2  (box/cross: the active
                                                    axis is where g is
                                                    nonzero, |g_a| in {0,1})

scatter-added into the [P, 3] parameter tables with one ``segment-sum``
(O(rays) memory; chunked by the caller's ray_chunk like every other
scatter).  Gradcheck: tests/test_scene_vjp.py pins this against the jnp
``jax.vjp(scene_sd)`` route and the scan-oracle autodiff.

Fused-generator groups ride the same machinery through EXTENDED winner
ids (a carve win reports ``P + ordinal``; _fused_statics maps it back to
the group's base row, with carve theta algebra from translation
invariance + degree-1 homogeneity) — fused_winner_eval /
fused_theta_cotangents / fused_winner_hessian_chain are the folded-field
twins of the exact-path functions.  Plans with procedural leaves
(Mandelbox/Mandelbulb/Julia winners have no closed-form Hessian) keep
the jnp replay backward.

Tie semantics: axis-aligned CSG scenes tie over OPEN REGIONS, not just
measure-zero sets (coincident faces — e.g. Menger cross arms along a cell
column, or any two boxes sharing a face plane — have IDENTICAL fields
there).  On ties this backward awards the whole cotangent to the FIRST
minimal leaf (strict <), which is exactly what autodiff of the reference's
binary fold produces (``s < best ? s : best``, body.cpp:12-14) and matches
the color tie-break.  The jnp ``jax.vjp(scene_sd)`` route instead splits
evenly across tied leaves (lax.reduce_min transpose).  Both are valid
subgradients; because tied leaves have identical fields (hence identical
parameter derivatives under the shared formula), the SUM of cotangents
over each tie class — and therefore any gradient-descent step on tied
generator copies — is identical.  tests/test_scene_vjp.py checks exact
agreement off the tie set and sum conservation on it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..core.sdf import segment_sum_rows
from ..scene.compile import ScenePlan, SceneTables
from ..scene.csg import PrimType

from .march_op import ift_ray_weights


@functools.lru_cache(maxsize=None)
def _leaf_statics(plan: ScenePlan):
    """Per-leaf (sign_eff, is_sphere) numpy arrays from the static plan.

    sign_eff[leaf] is the product of negation flags along the root->leaf
    path: min/max folds SELECT but never scale, so for the winning leaf
    ``scene = sign_eff * sd_leaf`` regardless of tree depth.  For two-level
    plans this equals gsign*scale; deeper trees walk the post-order lists
    top-down."""
    P = plan.num_primitives
    sign_eff = np.zeros(max(P, 1), np.float32)
    if plan.kernel is not None:
        for g in plan.kernel.groups:
            for (ptype, start, count, scale) in g.runs:
                sign_eff[start:start + count] = float(g.gsign * scale)
    else:
        from ..scene.compile import KIND_LEAF
        # context sign per list, propagated root (last list) downward.
        ctx = [0.0] * len(plan.lists)
        ctx[len(plan.lists) - 1] = 1.0
        for li in range(len(plan.lists) - 1, -1, -1):
            for (kind, idx, neg) in plan.lists[li].entries:
                s = ctx[li] * (-1.0 if neg else 1.0)
                if kind == KIND_LEAF:
                    sign_eff[idx] = s
                else:
                    ctx[idx] = s
    pt = np.asarray(plan.prim_type, np.int32)
    is_sphere = pt == int(PrimType.SPHERE)
    # Procedural fractals (Mandelbox/Mandelbulb): homogeneous DEs whose
    # size cotangent theta_cotangents derives from (sd, g, p).
    is_proc = np.isin(pt, (int(PrimType.MANDELBOX),
                           int(PrimType.MANDELBULB),
                           int(PrimType.JULIA)))
    if P == 0:
        is_sphere = np.zeros(1, bool)
        is_proc = np.zeros(1, bool)
    return sign_eff, is_sphere, is_proc


def winner_eval(plan: ScenePlan, cfg: RenderConfig, p, tables,
                interpret: bool):
    """(sd, winner idx, d scene/dp) at points p [..., 3] — one kernel pass
    (the combined surface-kernel mode)."""
    from .pallas_march import kernel_key, pallas_surface_eval

    flat = p.reshape(-1, 3)
    sd, widx, g = pallas_surface_eval(
        kernel_key(plan), cfg.fd_h, cfg.ray_block, flat, tables,
        with_color=True, with_normal=True, fused=False, analytic=True,
        interpret=interpret)
    batch = p.shape[:-1]
    return (sd.reshape(batch), widx.reshape(batch),
            g.reshape(batch + (3,)))


def stencil_eval(plan: ScenePlan, cfg: RenderConfig, p, tables,
                 interpret: bool, *, center: bool):
    """Winner evaluation at the FD stencil of every point in ONE kernel
    launch: p [..., 3] -> (sd [K, ...], widx [K, ...], g [K, ..., 3],
    q [K, ..., 3] — the stencil points themselves, for the procedural-leaf
    cotangent in theta_cotangents).

    K = 7 with ``center`` (row 0 = p itself, rows 1+a / 4+a = p ± h e_a),
    else 6 (rows a / 3+a = p ± h e_a).  One launch over K·R points instead
    of K launches keeps per-launch fixed cost out of the backward.  Rows
    are grouped by offset so each ray block keeps the spatial coherence
    the per-block cull relies on."""
    from .pallas_march import kernel_key, pallas_surface_eval

    h = cfg.fd_h
    flat = p.reshape(-1, 3)
    eye = jnp.eye(3, dtype=flat.dtype) * h
    offs = [jnp.zeros((1, 3), flat.dtype)] if center else []
    offs = jnp.concatenate(offs + [eye, -eye])
    K = offs.shape[0]
    q = (flat[None, :, :] + offs[:, None, :]).reshape(-1, 3)
    sd, widx, g = pallas_surface_eval(
        kernel_key(plan), cfg.fd_h, cfg.ray_block, q, tables,
        with_color=True, with_normal=True, fused=False, analytic=True,
        interpret=interpret)
    batch = p.shape[:-1]
    return (sd.reshape((K,) + batch), widx.reshape((K,) + batch),
            g.reshape((K,) + batch + (3,)),
            q.reshape((K,) + batch + (3,)))


def stencil_theta_cotangents(plan: ScenePlan, tables: SceneTables,
                             widx, g, u, sd=None, p=None) -> SceneTables:
    """theta_cotangents over a leading stencil axis: widx/u [K, R],
    g [K, R, 3] -> one gradient pytree (the one-hot reduction below is
    linear in rows, so the stencil axis just flattens in)."""
    K = widx.shape[0]
    return theta_cotangents(
        plan, tables, widx.reshape(-1), g.reshape(K * g.shape[1], 3),
        u.reshape(-1), sd=None if sd is None else sd.reshape(-1),
        p=None if p is None else p.reshape(K * g.shape[1], 3))


# Rows per one-hot block: block x P one-hot tiles stay ~16 MB f32 for the
# few-hundred-prim scenes this path serves (larger P shrinks the block).
_ONEHOT_BLOCK = 8192

# The one-hot matmul formulation is O(R * K): it suits small tables (the
# demo's K=428) but loses to a scatter-add / plain row take on wide ones
# (menger4's K=8424); past this threshold _segment_add uses an XLA
# scatter-add and _gather_rows a plain row take.  The crossover is
# untuned on the GPU.  (Scatter sums in a different order
# than the matmul tree — gradients differ by ulps, covered by the grad
# suites' tolerances; values on the primal path never route here.)
_ONEHOT_MAX_K = 3000


def _gather_rows(idx, mat, rows=None):
    """rows mat[idx] for idx [R] into mat [P, C] via the same blocked
    one-hot matmul contraction as _segment_add (transposed): a per-ray
    row gather can cost more than the reduction it feeds, while
    ``one_hot(idx_block) @ mat`` is a dense matmul.  Negative idx rows
    return zeros.

    ``rows`` (static [K] np array): restrict the one-hot to a CANDIDATE
    row set the caller proves idx always falls in (or misses, -> zeros) —
    the one-hot then spans K columns instead of P.  The fused winner fold
    reports ~10 candidate rows out of hundreds (_fused_candidates), so
    this cuts the materialized one-hot traffic by P/K (~45x on the demo
    scene)."""
    R = idx.shape[0]
    if rows is not None:
        mat = jnp.asarray(mat)[jnp.asarray(rows)]        # [K, C] static
        cols = jnp.asarray(rows, idx.dtype)
    else:
        if int(mat.shape[0]) > _ONEHOT_MAX_K:
            # wide tables (e.g. menger4's 8,424 rows): the one-hot's
            # O(R*K) loses to a plain take (see _ONEHOT_MAX_K)
            mat = jnp.asarray(mat)
            return jnp.where(idx[:, None] >= 0,
                             mat[jnp.clip(idx, 0)], 0.0)
        cols = jnp.arange(mat.shape[0], dtype=idx.dtype)
    K, C = mat.shape
    block = max(256, min(_ONEHOT_BLOCK, (1 << 22) // max(K, 1)))
    pad = (-R) % block
    idx_p = (jnp.concatenate([idx, jnp.full((pad,), -1, idx.dtype)])
             if pad else idx)
    nb = (R + pad) // block
    idx_b = idx_p.reshape(nb, block)

    def body(_, i):
        onehot = (i[:, None] == cols[None, :])
        return None, jnp.dot(onehot.astype(mat.dtype), mat,
                             precision=jax.lax.Precision.HIGHEST)

    _, out = jax.lax.scan(body, None, idx_b)
    out = out.reshape(nb * block, C)
    return out[:R] if pad else out


def _segment_add(idx, vals, P: int, targets=None):
    """sum of vals rows per index in [0, P): one-hot matmul contraction.

    A blocked ``one_hot(idx_block).T @ vals_block`` does the same
    reduction as jnp.zeros([P, C]).at[idx].add(vals) with dense matmuls
    instead of a scatter-add.
    f32 one-hot entries are exact, and the matmul's tree-wise summation
    is at least as accurate as the scatter's sequential adds.
    idx: [R] int32 (negative = drop), vals: [R, C] f32 -> [P, C].

    ``targets`` (static [K] ids): reduce onto those ids only -> [K, C]
    (idx values outside drop); see _segment_add_rows."""
    R, C = vals.shape
    if targets is None:
        if P > _ONEHOT_MAX_K:
            # wide tables: a blocked scatter-add is O(R), the one-hot
            # O(R*P) (see _ONEHOT_MAX_K); negative idx rows drop
            return segment_sum_rows(idx, vals, P)
        K = P
        cols = None
    else:
        K = int(targets.shape[0])
        cols = jnp.asarray(targets, idx.dtype)
    block = max(256, min(_ONEHOT_BLOCK, (1 << 22) // max(K, 1)))
    pad = (-R) % block
    if pad:
        idx = jnp.concatenate([idx, jnp.full((pad,), -1, idx.dtype)])
        vals = jnp.concatenate([vals, jnp.zeros((pad, C), vals.dtype)])
    nb = (R + pad) // block
    idx_b = idx.reshape(nb, block)
    vals_b = vals.reshape(nb, block, C)

    def body(acc, args):
        i, v = args
        cs = jnp.arange(K, dtype=i.dtype) if cols is None else cols
        onehot = (i[:, None] == cs[None, :])
        return acc + jnp.dot(onehot.astype(v.dtype).T, v,
                             precision=jax.lax.Precision.HIGHEST), None

    out, _ = jax.lax.scan(body, jnp.zeros((K, C), vals.dtype),
                          (idx_b, vals_b))
    return out


def _segment_add_rows(idx, vals, P: int, rows):
    """_segment_add restricted to a static candidate row set ``rows``
    [K]: the blocked one-hot spans K columns instead of P (idx values
    outside ``rows`` and negatives drop out), and the [K, C] reduction
    scatters onto the static rows of the [P, C] result.  EXACT whenever
    the caller proves idx ∈ rows ∪ {misses} — the fused winner folds do
    (_fused_candidates)."""
    red = _segment_add(idx, vals, P, targets=jnp.asarray(rows))
    return jnp.zeros((P, vals.shape[1]), vals.dtype).at[
        jnp.asarray(rows)].set(red)


@functools.lru_cache(maxsize=None)
def _fused_candidates(plan: ScenePlan, ext: bool):
    """STATIC candidate winner rows of the FUSED folds, sorted [K] int32.

    In fused mode a generator group's fold reports either its BASE row
    (_scene_sd_idx_tile: always; the color winner) or — in the gradient
    fold — its extended carve id P + ordinal (_scene_sd_idx_grad_tile);
    the group's 20^k carve-table rows can never win.  Non-fused groups
    report any of their rows.  For the demo scene that is 9 candidates
    out of 431 rows, which turns every backward one-hot reduction from an
    HBM-bound [R, P] materialization into a [R, K] one (~45x less
    traffic).  ``ext``: include the extended carve ids (the gradient
    fold's id space; the color fold never reports them)."""
    P = plan.num_primitives
    rows = []
    ordinal = 0
    for g in plan.kernel.groups:
        if g.fused is not None:
            rows.append(int(g.start))
            if ext:
                rows.append(P + ordinal)
            ordinal += 1
        else:
            for (_ptype, start, count, _scale) in g.runs:
                rows.extend(range(int(start), int(start) + int(count)))
    return np.asarray(sorted(set(rows)), np.int32)


def theta_cotangents(plan: ScenePlan, tables: SceneTables, widx, g, u,
                     sd=None, p=None) -> SceneTables:
    """Scatter per-ray winner cotangents into a SceneTables gradient pytree.

    widx [...]: winner leaf per ray; g [..., 3]: d scene/dp per ray;
    u [...]: scalar cotangent on the scene SD per ray.

    Plans with procedural leaves (Mandelbox/Mandelbulb) additionally need
    the per-ray scene sd and query point p [..., 3] (every caller has
    both from the same winner
    pass): the DE is homogeneous, DE(p; c, s) = s*U((p-c)/s), so its size
    derivative is d scene/ds = (scene_sd - g.(p-c))/s — three more
    segment-sum columns, no extra kernel work.
    """
    P = int(np.shape(tables.prim_pos)[0])
    sign_eff, is_sphere, is_proc = _leaf_statics(plan)
    has_proc = bool(is_proc.any()) and bool(plan.proc)
    if has_proc and (sd is None or p is None):
        raise ValueError("plans with procedural leaves need sd and p "
                         "for theta_cotangents")

    widx = widx.reshape(-1)
    g = g.reshape(-1, 3)
    u = u.reshape(-1)

    # Per-ray rows carry only (u, g)-derived columns; the per-LEAF factors
    # (sign_eff in {±1}, sphere-vs-boxy) apply per PRIM after the
    # reduction — all rows landing on one prim share them, ±1 products
    # commute exactly with the sum, and the [R]-sized se/sphere gathers
    # disappear.
    # Negative winner rows (miss) drop out of the one-hot contraction.
    mu = -u[:, None]
    cols = [mu * g, mu, 0.5 * mu * jnp.abs(g)]
    if has_proc:
        # columns 7, 8: -u*sd and -u*(g.p); with gpos = sum(-u g) the
        # per-prim size cotangent is (col8 - col7 - c.gpos)/s.
        cols.append(mu * sd.reshape(-1, 1))
        cols.append(mu * jnp.sum(g * p.reshape(-1, 3), axis=1,
                                 keepdims=True))
    vals = jnp.concatenate(cols, axis=1)
    red = _segment_add(widx, vals, P)                    # [P, 7(+2)]

    se = jnp.asarray(sign_eff[:P])[:, None]
    sph = jnp.asarray(is_sphere[:P])[:, None]
    gpos = red[:, :3]
    aux_sphere = jnp.concatenate(
        [red[:, 3:4], jnp.zeros((P, 2), red.dtype)], axis=1)
    gaux = se * jnp.where(sph, aux_sphere, red[:, 4:7])
    if has_proc:
        mbm = jnp.asarray(is_proc[:P])[:, None]
        s_safe = jnp.where(mbm[:, 0], tables.prim_aux[:, 0], 1.0)
        size_cot = (red[:, 8] - red[:, 7]
                    - jnp.sum(jnp.asarray(tables.prim_pos) * gpos, axis=1)
                    ) / s_safe
        aux_mb = jnp.concatenate(
            [size_cot[:, None], jnp.zeros((P, 2), red.dtype)], axis=1)
        gaux = jnp.where(mbm, aux_mb, gaux)
    z = lambda x: jnp.zeros_like(jnp.asarray(x))
    return SceneTables(
        prim_pos=gpos, prim_aux=gaux, prim_color=z(tables.prim_color),
        light_pos=z(tables.light_pos), light_color=z(tables.light_color),
        cam_position=z(tables.cam_position),
        cam_direction=z(tables.cam_direction),
        cam_up=z(tables.cam_up), cam_fov=z(tables.cam_fov))


def make_march_bwd(plan: ScenePlan, cfg: RenderConfig, interpret: bool):
    """Drop-in ``bwd_impl`` for ops.march_op: the IFT backward with the
    winner kernel instead of jax.vjp(scene_sd).  Same math as
    march_op._march_bwd; grad_p f is the winner gradient (equal a.e.)."""

    def bwd(residuals, cotangents):
        p_hit, converged, t, ray, tables = residuals
        p_bar = cotangents.position

        sd, widx, g = winner_eval(plan, cfg, p_hit, tables, interpret)
        denom = jnp.sum(g * ray, axis=-1)
        t_bar = jnp.where(converged, jnp.sum(p_bar * ray, axis=-1), 0.0)
        w = ift_ray_weights(t_bar, denom, cfg.ift_damping)
        tables_bar = theta_cotangents(plan, tables, widx, g, w,
                                      sd=sd, p=p_hit)
        gp_w = w[..., None] * g
        o_bar = p_bar + gp_w
        d_bar = t[..., None] * (p_bar + gp_w)
        return o_bar, d_bar, tables_bar

    return bwd


def ift_pieces(plan: ScenePlan, cfg: RenderConfig, interpret: bool,
               p_hit, ray, conv, p_bar, tables):
    """(tables_bar, gp_w) of the IFT route — the kernelized replacement for
    the two vjp_f pullbacks in pallas_render._fused_bwd."""
    sd, widx, g = winner_eval(plan, cfg, p_hit, tables, interpret)
    denom = jnp.sum(g * ray, axis=-1)
    t_bar = jnp.where(conv, jnp.sum(p_bar * ray, axis=-1), 0.0)
    w = ift_ray_weights(t_bar, denom, cfg.ift_damping)
    tables_bar = theta_cotangents(plan, tables, widx, g, w, sd=sd, p=p_hit)
    return tables_bar, w[..., None] * g


def fd_stencil_cotangents(cfg: RenderConfig, nbar):
    """Per-stencil-row sd cotangents of the FD formula
    g_a = (f(p + h e_a) - f(p - h e_a)) / 2h, matching stencil_eval's row
    order (+x +y +z -x -y -z): u [6, ...] from nbar [..., 3]."""
    inv = 1.0 / (2.0 * cfg.fd_h)
    return jnp.concatenate(
        [jnp.moveaxis(nbar, -1, 0) * inv, -jnp.moveaxis(nbar, -1, 0) * inv])


# Extended-winner kind codes (fused carve wins, _scene_sd_idx_grad_tile's
# ext ids): dense rows < P use _leaf_statics; rows P+k use these.
_K_FLAT, _K_SPHERE, _K_MENGER_CARVE, _K_DS_CARVE = 0, 1, 2, 3


@functools.lru_cache(maxsize=None)
def _fused_statics(plan: ScenePlan):
    """Per-row static arrays over P + F rows (F = fused groups in plan
    order) for the fused winner backward:

      kind:     _K_SPHERE for dense sphere leaves, _K_DS_CARVE /
                _K_MENGER_CARVE for extended carve rows, else _K_FLAT;
      sigma:    g = sigma * unit(p - c_eff) for curved rows (sphere:
                sign_eff; DeathStar carve: -1 — gval = -carve);
      base_row: the table row a row's cotangents scatter onto (identity
                for dense rows; the group's base for carve rows)."""
    P = plan.num_primitives
    sign_eff, is_sphere, _ = _leaf_statics(plan)
    fused_groups = [g for g in plan.kernel.groups
                    if g.fused is not None] if plan.kernel else []
    F = len(fused_groups)
    kind = np.zeros(P + F, np.int32)
    kind[:P][is_sphere[:P]] = _K_SPHERE
    sigma = np.ones(P + F, np.float32)
    sigma[:P] = sign_eff[:P]
    base_row = np.arange(P + F, dtype=np.int32)
    for k, g in enumerate(fused_groups):
        base_row[P + k] = g.start
        if g.fused[0] == "deathstar":
            kind[P + k] = _K_DS_CARVE
            sigma[P + k] = -1.0       # gval = -carve, carve grad = +u'
        else:
            kind[P + k] = _K_MENGER_CARVE   # flat folded cross + size alg
    return kind, sigma, base_row, P, F


def fused_winner_eval(plan: ScenePlan, cfg: RenderConfig, p, tables,
                      interpret: bool):
    """(sd, extended winner idx, d scene_sd_fused/dp) at p — the fused
    twin of winner_eval (one combined fold pass over the FOLDED field)."""
    from .pallas_march import kernel_key, pallas_surface_eval

    flat = p.reshape(-1, 3)
    sd, widx, g = pallas_surface_eval(
        kernel_key(plan), cfg.fd_h, cfg.ray_block, flat, tables,
        with_color=True, with_normal=True, fused=True, analytic=True,
        interpret=interpret)
    batch = p.shape[:-1]
    return (sd.reshape(batch), widx.reshape(batch),
            g.reshape(batch + (3,)))


def fused_theta_cotangents(plan: ScenePlan, tables: SceneTables, widx, g,
                           u, sd, p) -> SceneTables:
    """theta_cotangents for the FUSED field: dense winners use the exact
    per-leaf formulas; extended carve winners scatter onto their group's
    base row — position by translation invariance (d gval/dc = -g, the
    same mu*g column every winner uses), size by degree-1 homogeneity
    (Menger carve: gval = -carve((p-c)/s) * s, the proc formula on aux
    column 0) or the derived-centre radius rule (DeathStar carve:
    d gval/dr = 1 - 1.5 g_x, assembled from the mu and mu*g columns).
    Callers gate on ``not plan.proc`` (procedural leaves keep the jnp
    replay)."""
    kind, sigma, base_row, P, F = _fused_statics(plan)
    widx = widx.reshape(-1)
    g = g.reshape(-1, 3)
    u = u.reshape(-1)
    mu = -u[:, None]
    cols = [mu * g, mu, 0.5 * mu * jnp.abs(g),
            mu * sd.reshape(-1, 1),
            mu * jnp.sum(g * p.reshape(-1, 3), axis=1, keepdims=True)]
    vals = jnp.concatenate(cols, axis=1)
    red = _segment_add_rows(widx, vals, P + F,
                            _fused_candidates(plan, True))  # [P+F, 9]

    kindj = jnp.asarray(kind)
    sigj = jnp.asarray(sigma)[:, None]
    gpos_ext = red[:, :3]
    # dense rows: sphere radius = se * sum(mu); box/cross = se*|g|/2 cols
    aux_sphere = jnp.concatenate(
        [red[:, 3:4], jnp.zeros((P + F, 2), red.dtype)], axis=1)
    gaux = jnp.where((kindj == _K_SPHERE)[:, None],
                     sigj * aux_sphere, sigj * red[:, 4:7])
    # Menger carve rows: homogeneous size rule on aux column 0 (the carve
    # reads the base row's size.x only) — same algebra as the proc path.
    c_ext = jnp.asarray(tables.prim_pos)[jnp.asarray(base_row)]
    s_ext = jnp.asarray(tables.prim_aux)[jnp.asarray(base_row), 0]
    s_safe = jnp.where(s_ext != 0.0, s_ext, 1.0)
    size_cot = (red[:, 8] - red[:, 7]
                - jnp.sum(c_ext * gpos_ext, axis=1)) / s_safe
    aux_menger = jnp.concatenate(
        [size_cot[:, None], jnp.zeros((P + F, 2), red.dtype)], axis=1)
    gaux = jnp.where((kindj == _K_MENGER_CARVE)[:, None], aux_menger, gaux)
    # DeathStar carve rows: d gval/dr = 1 - 1.5 g_x per ray ->
    # cot = sum u (1 - 1.5 g_x) = -red_mu + 1.5 * red_mug_x
    ds_cot = -red[:, 3] + 1.5 * red[:, 0]
    aux_ds = jnp.concatenate(
        [ds_cot[:, None], jnp.zeros((P + F, 2), red.dtype)], axis=1)
    gaux = jnp.where((kindj == _K_DS_CARVE)[:, None], aux_ds, gaux)

    # fold extended rows onto their base table rows
    br = jnp.asarray(base_row)
    gpos = jnp.zeros((P, 3), red.dtype).at[br].add(gpos_ext)
    gaux_f = jnp.zeros((P, 3), red.dtype).at[br].add(gaux)
    z = lambda x: jnp.zeros_like(jnp.asarray(x))
    return SceneTables(
        prim_pos=gpos, prim_aux=gaux_f, prim_color=z(tables.prim_color),
        light_pos=z(tables.light_pos), light_color=z(tables.light_color),
        cam_position=z(tables.cam_position),
        cam_direction=z(tables.cam_direction),
        cam_up=z(tables.cam_up), cam_fov=z(tables.cam_fov))


def fused_winner_hessian_chain(plan: ScenePlan, tables: SceneTables,
                               widx, g, gbar, sd):
    """winner_hessian_chain for the FUSED field: curved winners are dense
    spheres AND the DeathStar's derived carve sphere (c_eff = c + 1.5 r
    e_x); Menger carve winners are folded crosses — flat, zero a.e.

    For every curved winner g = sigma * unit(p - c_eff), so with
    H = (I - u u^T)/|p - c_eff|:  p_bar = sigma H gbar,
    c_bar = -sigma H gbar, and the derived centre adds
    r_bar = 1.5 * (c_eff_bar)_x for the carve row.

    NO per-ray table gathers: u = sigma * g comes from the kernel, and
    the winner identity gives |p - c_eff| = radius + sigma * scene_sd
    exactly (sphere: sd = sigma (|p-c|-r); DS carve: sd = r - |p-c'|);
    the per-ray statics (sigma, radius, kind masks) arrive through ONE
    blocked one-hot matmul (_gather_rows).

    Returns (p_bar, pos_bar [P, 3], aux_bar [P, 3]) — the parameter
    cotangents already reduced onto base table rows."""
    kind, sigma, base_row, P, F = _fused_statics(plan)
    cand = _fused_candidates(plan, True)
    widx_f = widx.reshape(-1)
    g_f = g.reshape(-1, 3)
    gbar_f = gbar.reshape(-1, 3)
    sd_f = sd.reshape(-1)
    stats = jnp.concatenate([
        jnp.asarray(sigma)[:, None],
        jnp.asarray(tables.prim_aux)[jnp.asarray(base_row), 0][:, None],
        jnp.asarray((kind == _K_SPHERE).astype(np.float32))[:, None],
        jnp.asarray((kind == _K_DS_CARVE).astype(np.float32))[:, None],
    ], axis=1)
    st = _gather_rows(widx_f, stats, rows=cand)  # zeros on miss lanes
    sg, r, sphm, dscm = (st[:, k] for k in range(4))
    curved = (sphm + dscm) > 0.5
    u = sg[:, None] * g_f
    dist = jnp.maximum(r + sg * sd_f, 1e-12)[:, None]
    hg = (gbar_f - u * jnp.sum(u * gbar_f, axis=-1, keepdims=True)) / dist
    p_bar = jnp.where(curved[:, None], sg[:, None] * hg, 0.0)
    pos_rows = -p_bar
    aux0 = jnp.where(dscm > 0.5, 1.5 * pos_rows[:, 0], 0.0)
    idx = jnp.where(curved, widx_f, -1)
    red = _segment_add_rows(idx, jnp.concatenate(
        [pos_rows, aux0[:, None]], axis=1), P + F, cand)  # [P+F, 4]
    br = jnp.asarray(base_row)
    pos_bar = jnp.zeros((P, 3), red.dtype).at[br].add(red[:, :3])
    aux_bar = jnp.zeros((P, 3), red.dtype).at[br, 0].add(red[:, 3])
    return p_bar.reshape(gbar.shape), pos_bar, aux_bar


def winner_hessian_chain(plan: ScenePlan, tables: SceneTables, widx, g,
                         gbar, sd):
    """a.e. VJP of the winner-gradient FIELD g(p) itself (the analytic
    normal primal): away from fold switches, g = sign_eff * grad sd_w, so

        dg/dp = sign_eff * H_w,    dg/d center_w = -sign_eff * H_w

    with the winner's Hessian H_w in closed form: sphere
    H = (I - u u^T)/|p - c| (u = unit(p - c)); box/cross are FLAT — their
    one-hot sign gradient is locally constant, H = 0 a.e. (this is why FD
    and analytic normals shade identically off edges).  Radius/size carry
    no gradient dependence, so prim_pos is the only parameter cotangent.
    Procedural winners (Mandelbox/Mandelbulb/Julia) have no closed-form
    Hessian here — callers gate on ``plan.proc`` and fall back to the jnp
    replay.

    NO per-ray table gathers (they can cost more than the whole
    reduction): u = sign_eff * g comes from the kernel, the winner
    identity gives |p - c| = radius + sign_eff * scene_sd exactly, and
    the per-ray statics arrive through one blocked one-hot matmul
    (_gather_rows).

    Returns (p_bar [..., 3], rows [R, 3], idx [R]) where rows/idx feed one
    ``_segment_add`` into the prim_pos cotangent (rows = -p_bar on sphere
    winners; idx = -1 elsewhere drops out of the one-hot contraction)."""
    P = int(np.shape(tables.prim_pos)[0])
    sign_eff, is_sphere, _ = _leaf_statics(plan)
    widx_f = widx.reshape(-1)
    g_f = g.reshape(-1, 3)
    gbar_f = gbar.reshape(-1, 3)
    sd_f = sd.reshape(-1)
    stats = jnp.concatenate([
        jnp.asarray(sign_eff[:P])[:, None],
        jnp.asarray(tables.prim_aux)[:, 0][:, None],
        jnp.asarray(is_sphere[:P].astype(np.float32))[:, None],
    ], axis=1)
    st = _gather_rows(widx_f, stats)            # zeros on miss lanes
    se, r, sphm = st[:, 0], st[:, 1], st[:, 2]
    sph = sphm > 0.5
    u = se[:, None] * g_f
    dist = jnp.maximum(r + se * sd_f, 1e-12)[:, None]
    hg = (gbar_f - u * jnp.sum(u * gbar_f, axis=-1, keepdims=True)) / dist
    p_bar = jnp.where(sph[:, None], se[:, None] * hg, 0.0)
    return (p_bar.reshape(gbar.shape), -p_bar,
            jnp.where(sph, widx_f, -1))


def analytic_normal_bwd(plan: ScenePlan, cfg: RenderConfig,
                        interpret: bool, p, tables, gbar):
    """VJP of the analytic winner-gradient normal mode on exact tables:
    ONE combined winner-kernel pass + the closed-form Hessian chain
    (winner_hessian_chain) + one segment-add — no jnp scene_sd replay, no
    [rays, prims] matrix.  The FD twin (fd_normal_bwd) needs a 6-point
    stencil launch; the analytic field's derivative is local, so this is
    the CHEAPER backward.  Returns (p_bar, tables_bar)."""
    sd, widx, g = winner_eval(plan, cfg, p, tables, interpret)
    p_bar, rows, idx = winner_hessian_chain(plan, tables, widx, g, gbar,
                                            sd)
    P = int(np.shape(tables.prim_pos)[0])
    pos_bar = _segment_add(idx, rows, P)
    z = lambda x: jnp.zeros_like(jnp.asarray(x))
    tables_bar = SceneTables(
        prim_pos=pos_bar, prim_aux=z(tables.prim_aux),
        prim_color=z(tables.prim_color), light_pos=z(tables.light_pos),
        light_color=z(tables.light_color),
        cam_position=z(tables.cam_position),
        cam_direction=z(tables.cam_direction),
        cam_up=z(tables.cam_up), cam_fov=z(tables.cam_fov))
    return p_bar, tables_bar


def fused_analytic_normal_bwd(plan: ScenePlan, cfg: RenderConfig,
                              interpret: bool, p, tables, gbar):
    """analytic_normal_bwd for the FUSED field (the multi-kernel backend's
    normal op under fused_generators + analytic): one fused winner pass +
    the closed-form chain.  Returns (p_bar, tables_bar)."""
    sd, widx, g = fused_winner_eval(plan, cfg, p, tables, interpret)
    p_bar, pos_bar, aux_bar = fused_winner_hessian_chain(
        plan, tables, widx, g, gbar, sd)
    z = lambda x: jnp.zeros_like(jnp.asarray(x))
    tables_bar = SceneTables(
        prim_pos=pos_bar, prim_aux=aux_bar,
        prim_color=z(tables.prim_color), light_pos=z(tables.light_pos),
        light_color=z(tables.light_color),
        cam_position=z(tables.cam_position),
        cam_direction=z(tables.cam_direction),
        cam_up=z(tables.cam_up), cam_fov=z(tables.cam_fov))
    return p_bar, tables_bar


def fd_normal_bwd(plan: ScenePlan, cfg: RenderConfig, interpret: bool,
                  p, tables, nbar):
    """VJP of the 6-eval FD normal stencil (shading.normal_fd semantics:
    g_a = (f(p + h e_a) - f(p - h e_a)) / 2h) via ONE batched winner-kernel
    pass over all six stencil points and one concatenated scatter —
    replaces jax.vjp through six jnp scene_sd evaluations (and the earlier
    six separate kernel launches, which were dispatch-latency-bound).

    Returns (p_bar, tables_bar)."""
    sd, widx, g, q = stencil_eval(plan, cfg, p, tables, interpret,
                                  center=False)
    u = fd_stencil_cotangents(cfg, nbar)
    p_bar = jnp.sum(u[..., None] * g, axis=0)
    K = widx.shape[0]
    tables_bar = stencil_theta_cotangents(
        plan, tables, widx.reshape(K, -1), g.reshape(K, -1, 3),
        u.reshape(K, -1), sd=sd.reshape(K, -1), p=q.reshape(K, -1, 3))
    return p_bar, tables_bar
