"""Scene compiler: CSG tree -> flat device tables + static reduction plan.

This replaces the reference's device encoding
(render.cpp:246-366), which packs bodies into a type-grouped table and the
tree into 64x1024 node lists that the GLSL kernel walks with a per-thread
stack interpreter (shader.comp:226-265).  A divergent stack interpreter is
exactly what does not map to a vector machine (SURVEY §3.4), so instead
we compile the
tree ONCE on the host into:

  * ``SceneTables`` — a pytree of struct-of-arrays primitive/light/camera
    parameters.  These are the *differentiable* quantities; gradients flow
    to every array in here.
  * ``ScenePlan`` — a hashable static description of the tree structure
    (types, list membership, fold ops/signs).  Structure is static per scene,
    so it is baked into the jitted program; evaluation becomes a fixed
    sequence of vectorized min/max reductions with no data-dependent control
    flow.

Key algebraic lowering: every list mode is a left fold of min/max over
optionally negated children (body.cpp:66-111).  Using max(x) = -min(-x), any
list whose children are all leaves reduces to

    list_value = gsign * min_i(scale_i * leaf_sd_i),  gsign, scale_i in {+-1}

— one sign-scaled min-reduction ("two-level kernel normal form").  The root
then folds group values with one more min/max.  Reference scenes are depth
<= 2 (SURVEY §7) so the fused kernel handles them all; deeper trees
evaluate through the generic post-order plan (still static, still
vectorized) on the jnp path.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .csg import (ListNode, Mode, Node, PRIM_TYPE, Primitive, Sphere)
from .objects import Camera, Light
from .parser import Scene

# Fold op codes
MIN = 0
MAX = 1

# Plan entry kinds
KIND_LEAF = 0
KIND_LIST = 1

# mode -> (fold op, negate_first, negate_rest); body.cpp:66-111
_MODE_FOLD = {
    Mode.UNION: (MIN, False, False),
    Mode.COMPLEMENT: (MIN, True, True),
    Mode.INTERSECTION: (MAX, False, False),
    Mode.DIFFERENCE: (MAX, False, True),
}


class SceneTables(NamedTuple):
    """Differentiable scene parameters (a JAX pytree of f32 arrays).

    The analogue of the reference's three SSBOs + camera uniforms
    (render.cpp:439-466) — but living as jit inputs, so ``jax.grad`` reaches
    every field.
    """

    prim_pos: np.ndarray     # [P, 3] primitive centre
    prim_aux: np.ndarray     # [P, 3] sphere: (radius, 0, 0); box/cross: size
    prim_color: np.ndarray   # [P, 3]
    light_pos: np.ndarray    # [L, 3]
    light_color: np.ndarray  # [L, 3] (always white in reference scenes)
    cam_position: np.ndarray   # [3]
    cam_direction: np.ndarray  # [3]
    cam_up: np.ndarray         # [3]
    cam_fov: np.ndarray        # [] degrees


@dataclasses.dataclass(frozen=True)
class ListPlan:
    """One list's fold: ``op`` over ``entries`` in child order.

    entries: tuple of (kind, index, negate) where kind is KIND_LEAF (index
    into the primitive table) or KIND_LIST (index into earlier ListPlans —
    strictly post-order).  First-entry special-casing from the reference is
    already folded into the per-entry ``negate`` flags.
    """

    op: int
    entries: Tuple[Tuple[int, int, bool], ...]


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """Two-level normal form group: gsign * min(scale_i * leaf_sd_i).

    ``runs`` splits the group's contiguous leaf range into maximal
    same-(type, scale) runs: (prim_type, start, count, scale).

    ``fused``: optional fast-path descriptor from generator provenance —
    ("menger", iterations) or ("deathstar",).  The group's base primitive
    lives at leaf ``start``; the kernel may evaluate the carve as a
    function of the base row alone (Menger: space folding instead of the
    explicit 20^k cross table — same zero set, conservative distances;
    DeathStar: the carve sphere derived as centre + 1.5 r in x,
    body.cpp:159-169).  Opt-in via RenderConfig.fused_generators and
    allclose-gated; in fused mode gradients flow to the GENERATOR's
    parameters (the base row) — carve rows are not read.  Recipe for a
    new generator: tag its ListNode subclass in _compile_tree, validate
    the lowered group shape here, add the carve (+ carve-grad) evaluator
    pair in ops.pallas_march and the jnp twin in core.sdf.scene_sd_fused.

    ``lattice``: optional shared-coordinate structure of the group's carve
    crosses, for the EXACT column-collapsed fold
    (ops.pallas_march._menger_carve_lattice).  Per recursion level, all
    crosses share per-axis centre coordinates (a 3-D lattice) and one
    size; the median-of-excesses cross SDF is monotone in each per-axis
    excess, so the min over a (y, z) column of crosses equals one median
    of the column's min x-excess — bitwise, since jnp.minimum returns an
    input exactly.  Levels are tuples: ``(leaf,)`` for the level-0 cross,
    else ``(xs_reps, ys_reps, zs_reps, size_rep, columns, members)`` where
    the *_reps are representative leaf rows per unique lattice coordinate,
    ``columns`` is ``((iy, iz, (ix, ...), (row, ...)), ...)`` indexing the
    reps (rows parallel to the ix list — the member leaf rows, so the
    idx-carrying collapse can report winners), and
    ``members`` is ``((leaf, ix, iy, iz), ...)`` for the runtime validity
    check (pallas_march._lattice_ok): the collapse is only taken while the
    live table rows still share coordinates; otherwise the kernel falls
    back to the full fold — never approximate.
    """

    gsign: int                                   # +1 | -1
    start: int                                   # first leaf index
    count: int                                   # number of leaves
    scales: Tuple[int, ...]                      # per-leaf +-1, len == count
    runs: Tuple[Tuple[int, int, int, int], ...]  # (ptype, start, count, scale)
    fused: Optional[Tuple] = None
    lattice: Optional[Tuple[Tuple, ...]] = None
    # Wide-UNION chunk cull (``((run_idx, ((start, count), ...)), ...)``):
    # long bounded-primitive runs of a plain UNION group split into
    # _BVH_CHUNK-leaf chunks, each with a LIVE axis-aligned bounding box
    # (computed from the current table every dispatch and shipped as extra
    # table rows — see ops.pallas_march._build_table), so the kernel can
    # skip a whole chunk when its per-axis excess bound already exceeds
    # the tile's running scene minimum on every lane.  Exact: the bound
    # lower-bounds both the sphere SDF and the Chebyshev box/cross metric
    # per axis (a Euclidean bounding SPHERE would NOT bound the box
    # metric, which grows like ||p||_inf along diagonals).  This bounds
    # the reference's O(N) UNION fold (body.cpp:66-111) the same way the
    # per-tile base-bound cull bounds its DIFFERENCE lists.  Only the
    # chunk PARTITION is static (leaf order, which is also why authored
    # spatial coherence — e.g. Morton-ordered emission — matters for
    # effectiveness); validity never depends on it.
    bvh: Optional[Tuple[Tuple[int, Tuple[Tuple[int, int], ...]], ...]] = None


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Root fold over groups for the fused kernel (depth <= 2 scenes).

    ``proc``: per-procedural-leaf structural parameters ``(leaf, kind,
    param, iterations)``, kind "mb" (Mandelbox, param = fold scale) or
    "bulb" (Mandelbulb, param = power) — the fractal iteration is unrolled
    at trace time, so these are plan statics, not table entries (only
    position/size are differentiable table columns).

    ``black_prims``: leaf indices whose COMPILE-TIME color is exactly
    (0, 0, 0) — e.g. the demo's Bounds backdrop.  The mega kernel may
    skip shadow marches for lanes whose color winner is one of these
    (their pixel is provably black: color * light == 0), gated at RUNTIME
    on the live table still having those rows black, so fitting a color
    re-enables full shading automatically (see
    RenderConfig.shade_skip_black).  () when the scene has none or too
    many for cheap per-lane tests."""

    root_op: int                     # MIN | MAX
    groups: Tuple[GroupPlan, ...]
    proc: Tuple[Tuple[int, str, float, int], ...] = ()
    black_prims: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class ScenePlan:
    """Static (hashable) scene structure — safe as a jit static argument."""

    prim_type: Tuple[int, ...]           # per-leaf PrimType code
    lists: Tuple[ListPlan, ...]          # post-order; last is the root
    kernel: Optional[KernelPlan]         # two-level normal form, if depth <= 2
    num_lights: int
    # Scene-format extension (``LightColor`` lines): when any light is
    # non-white, shading accumulates per-channel and gradients flow to
    # tables.light_color.  All reference scenes are all-white, where the
    # scalar path is bit-identical — so it stays the compiled default.
    colored_lights: bool = False
    # Procedural-fractal extension: (leaf, kind, param, iterations) per
    # Mandelbox/Mandelbulb leaf — structural (see KernelPlan.proc); () for
    # all reference scenes.
    proc: Tuple[Tuple[int, str, float, int], ...] = ()

    @property
    def num_primitives(self) -> int:
        return len(self.prim_type)


def _compile_tree(root: ListNode):
    prim_types: List[int] = []
    prims: List[Primitive] = []
    lists: List[ListPlan] = []
    provenance = {}  # list plan index -> fused descriptor

    def walk(node: Node) -> Tuple[int, int]:
        """Returns (kind, index) of the compiled node."""
        if isinstance(node, ListNode):
            op, neg_first, neg_rest = _MODE_FOLD[node.mode]
            entries = []
            for i, child in enumerate(node.children):
                kind, idx = walk(child)
                neg = neg_first if i == 0 else neg_rest
                entries.append((kind, idx, neg))
            lists.append(ListPlan(op=op, entries=tuple(entries)))
            from .generators import DeathStarNode, MengerNode
            if isinstance(node, MengerNode):
                provenance[len(lists) - 1] = ("menger", node.iterations)
            elif isinstance(node, DeathStarNode):
                provenance[len(lists) - 1] = ("deathstar",)
            return KIND_LIST, len(lists) - 1
        # Leaf primitive — assigned indices in depth-first (fold) order.
        prims.append(node)
        prim_types.append(int(PRIM_TYPE[type(node)]))
        return KIND_LEAF, len(prim_types) - 1

    kind, idx = walk(root)
    assert kind == KIND_LIST and idx == len(lists) - 1
    from .csg import Julia, Mandelbox, Mandelbulb

    def proc_entry(i, p):
        if isinstance(p, Mandelbox):
            return (i, "mb", p.scale, p.iterations)
        if isinstance(p, Mandelbulb):
            return (i, "bulb", float(p.power), p.iterations)
        return (i, "julia", tuple(p.c), p.iterations)

    proc = tuple(proc_entry(i, p) for i, p in enumerate(prims)
                 if isinstance(p, (Mandelbox, Mandelbulb, Julia)))
    return prims, tuple(prim_types), tuple(lists), provenance, proc


# Largest per-level column count the static lattice collapse may unroll
# (see _menger_lattice docstring: iters=3 level 2 = 64, iters=4 level 3 =
# 512).  The VALUE collapse shares each distinct x-SET's minimum across
# columns (pallas_march _menger_carve_lattice), so the 512-column level
# traces ~2.6k ops, not ~11.7k; the winner (idx/grad) collapse cannot
# share (per-column row chains) and big-lattice groups route winners
# through the value-bound subtree walk (_lattice_idx_ok).
_LATTICE_MAX_COLS = 512


def _menger_lattice(start: int, count: int, scales, iters: int):
    """Per-level lattice structure of a Menger group's carve crosses.

    Mirrors generators._generate_menger's DFS over integer lattice
    coordinates: a level-k cross's per-axis centre coordinate is
    ``box_centre + X * size / 3**k`` with ``X = sum_j 3**(k-j) * o_jx``
    over its offset path — and that float is computed through the SAME
    arithmetic for every cross sharing the lattice line, so shared
    coordinates are bitwise equal in the compiled table.  The kernel
    reads each unique coordinate once (from a representative row) and
    collapses each (y, z) column of same-size crosses into one median —
    see GroupPlan.lattice for the exactness argument.

    Structure only (no float values): valid for any tables whose rows
    still satisfy the sharing, which pallas_march._lattice_ok re-checks
    against the LIVE table at render time.

    Compile-size cap: the collapse is unrolled at trace time (one min per
    column membership), so a level with C columns / M members adds ~M
    vector ops to EVERY field evaluation's program.  iters=3's level 2 is
    64 columns / 400 members (the win that matters); iters=4's level 3 is
    512 columns / 8000 members — 11.7k traced ops whose kernel compile
    takes minutes.  Levels past
    ``_LATTICE_MAX_COLS`` make the whole group fall back to the
    ``lax.fori_loop`` run fold (291 ops regardless of size); deep sponges
    stay benchable and the fused space-folded mode remains their fast
    path."""
    if iters < 2:
        return None
    expected = 1
    for _ in range(iters - 1):
        expected = 1 + 20 * expected    # crosses in the DFS subtree
    if count != 1 + expected or any(s != 1 for s in scales[1:]):
        return None
    from .generators import _MENGER_OFFSETS
    per_level = {k: [] for k in range(iters)}
    leaf = [start + 1]                  # first cross (level 0)

    def rec(X, Y, Z, k):
        per_level[k].append((leaf[0], X, Y, Z))
        leaf[0] += 1
        if k + 1 < iters:
            for (ox, oy, oz) in _MENGER_OFFSETS:
                rec(3 * X + ox, 3 * Y + oy, 3 * Z + oz, k + 1)

    rec(0, 0, 0, 0)
    levels = [(per_level[0][0][0],)]    # level 0: a single cross
    for k in range(1, iters):
        cells = per_level[k]
        xs = sorted({c[1] for c in cells})
        ys = sorted({c[2] for c in cells})
        zs = sorted({c[3] for c in cells})
        xi = {v: i for i, v in enumerate(xs)}
        yi = {v: i for i, v in enumerate(ys)}
        zi = {v: i for i, v in enumerate(zs)}
        xs_reps = [None] * len(xs)
        ys_reps = [None] * len(ys)
        zs_reps = [None] * len(zs)
        columns = {}
        members = []
        for (row, X, Y, Z) in cells:
            ix, iy, iz = xi[X], yi[Y], zi[Z]
            if xs_reps[ix] is None:
                xs_reps[ix] = row
            if ys_reps[iy] is None:
                ys_reps[iy] = row
            if zs_reps[iz] is None:
                zs_reps[iz] = row
            # (ix, row) pairs in DFS member order: the column's x-min fold
            # keeps first-wins ties in LEAF order, and ``row`` lets the
            # idx-carrying collapse report the winning cross's table row
            columns.setdefault((iy, iz), []).append((ix, row))
            members.append((row, ix, iy, iz))
        if len(columns) > _LATTICE_MAX_COLS:
            return None
        levels.append((tuple(xs_reps), tuple(ys_reps), tuple(zs_reps),
                       cells[0][0],
                       tuple((iy, iz, tuple(ix for ix, _ in pairs),
                              tuple(r for _, r in pairs))
                             for (iy, iz), pairs in sorted(columns.items())),
                       tuple(members)))
    return tuple(levels)


def _kernel_normal_form(lists: Sequence[ListPlan],
                        prim_type: Sequence[int],
                        provenance=None, proc=()) -> Optional[KernelPlan]:
    """Lower a depth<=2 plan to root-fold-over-leaf-groups, or None."""
    provenance = provenance or {}
    root = lists[-1]
    groups: List[GroupPlan] = []
    proc_map = {i: (k, pm, it) for (i, k, pm, it) in proc}

    def run_type(leaf: int):
        # Procedural leaves carry their STRUCTURAL params in the run type
        # tag (kind, param, iterations), kind "mb"|"bulb": the fold unrolls
        # the fractal iteration at trace time, so leaves with different
        # params cannot share a run (and every fold consumer switches on
        # the tag).
        t = prim_type[leaf]
        if leaf in proc_map:
            return proc_map[leaf]
        return t

    def leaf_runs(start: int, scales: Sequence[int]):
        runs = []
        for off, s in enumerate(scales):
            t = run_type(start + off)
            if runs and runs[-1][0] == t and runs[-1][3] == s:
                ptype, rstart, rcount, rs = runs[-1]
                runs[-1] = (ptype, rstart, rcount + 1, rs)
            else:
                runs.append((t, start + off, 1, s))
        return tuple(runs)

    for kind, idx, neg in root.entries:
        if kind == KIND_LEAF:
            scales = (-1,) if neg else (1,)
            groups.append(GroupPlan(gsign=1, start=idx, count=1,
                                    scales=scales, runs=leaf_runs(idx, scales)))
            continue
        sub = lists[idx]
        if not sub.entries:
            return None  # empty sublist: fall back to the generic plan
        leaf_idxs = []
        signs = []
        for skind, sidx, sneg in sub.entries:
            if skind != KIND_LEAF:
                return None  # depth > 2
            leaf_idxs.append(sidx)
            signs.append(-1 if sneg else 1)
        start = leaf_idxs[0]
        if leaf_idxs != list(range(start, start + len(leaf_idxs))):
            return None  # non-contiguous (cannot happen with DFS numbering)
        # sub value w: MIN -> +min(sign*sd); MAX -> -min(-sign*sd)
        if sub.op == MIN:
            gsign, scales = 1, signs
        else:
            gsign, scales = -1, [-s for s in signs]
        if neg:
            gsign = -gsign
        fused = provenance.get(idx) if not neg else None
        if fused is not None and fused[0] == "deathstar":
            # Fused DeathStar derives its carve sphere from the base row
            # (centre + 1.5 r in x, body.cpp:159-169); only attach when the
            # lowered group has exactly that base-minus-carve shape.
            from .csg import PrimType
            if not (gsign == -1 and len(scales) == 2
                    and tuple(scales) == (-1, 1)
                    and prim_type[start] == int(PrimType.SPHERE)
                    and prim_type[start + 1] == int(PrimType.SPHERE)):
                fused = None
        lattice = None
        if fused is not None and fused[0] == "menger" and gsign == -1:
            lattice = _menger_lattice(start, len(scales), scales, fused[1])
        groups.append(GroupPlan(gsign=gsign, start=start, count=len(scales),
                                scales=tuple(scales),
                                runs=leaf_runs(start, scales),
                                fused=fused, lattice=lattice))
    if root.op == MIN:
        groups = _merge_trivial_groups(groups)
        groups = [dataclasses.replace(g, bvh=_bvh_partition(g))
                  for g in groups]
    return KernelPlan(root_op=root.op, groups=tuple(groups),
                      proc=tuple(proc))


def _merge_trivial_groups(groups: List[GroupPlan]) -> List[GroupPlan]:
    """Coalesce maximal stretches of adjacent PLAIN groups (gsign +1, all
    leaf scales +1, no generator fast path) under a MIN root into one
    merged group.

    The reference grammar puts every root-level object in its own body
    (scene.cpp grammar: one list per object line), so a scattered scene of
    1k spheres lowers to 1k single-leaf groups — each a separately traced
    fold step.  Under a MIN root, plain-group boundaries are semantically
    invisible: min is associative, and the strict-< winner selections keep
    the earliest leaf whether ties resolve per group or per leaf (groups,
    runs and leaves all fold in leaf order).  Merging turns the per-group
    Python fold loop into long same-type runs, which (a) fold via blocked
    ``lax.fori_loop`` instead of trace-time unrolling and (b) are what the
    wide-UNION chunk cull (_bvh_partition) partitions."""
    out: List[GroupPlan] = []
    run: List[GroupPlan] = []

    def plain(g: GroupPlan) -> bool:
        return (g.gsign == 1 and g.fused is None and g.lattice is None
                and all(s == 1 for s in g.scales))

    def flush():
        if not run:
            return
        if len(run) == 1:
            out.append(run[0])
            run.clear()
            return
        runs: List[Tuple[int, int, int, int]] = []
        for g in run:
            for r in g.runs:
                if runs and runs[-1][0] == r[0] and runs[-1][3] == r[3] \
                        and runs[-1][1] + runs[-1][2] == r[1]:
                    ptype, rstart, rcount, rs = runs[-1]
                    runs[-1] = (ptype, rstart, rcount + r[2], rs)
                else:
                    runs.append(r)
        out.append(GroupPlan(
            gsign=1, start=run[0].start,
            count=sum(g.count for g in run),
            scales=tuple(s for g in run for s in g.scales),
            runs=tuple(runs)))
        run.clear()

    for g in groups:
        if plain(g) and (not run
                         or run[-1].start + run[-1].count == g.start):
            run.append(g)
        else:
            flush()
            if plain(g):
                run.append(g)
            else:
                out.append(g)
    flush()
    return out


# Wide-UNION chunk cull sizing (GroupPlan.bvh): runs at least _BVH_MIN_RUN
# leaves long are split into _BVH_CHUNK-leaf chunks.  A chunk's skip check
# costs ~a dozen vector ops + an all-lanes reduce + a cond; a 32-sphere
# chunk fold is ~200 — so the check pays for itself whenever even a
# quarter of chunks skip, and short runs aren't worth the bound plumbing.
_BVH_MIN_RUN = 64
_BVH_CHUNK = 32


def _bvh_partition(g: GroupPlan):
    """Chunk layout for the wide-UNION cull (see GroupPlan.bvh), or None.

    Eligible: plain UNION groups (gsign +1, no generator fast path) under
    a MIN root; within them, +1-scaled runs of BOUNDED primitive types
    (sphere/box — a cross's arms are infinite, procedural DEs have no
    per-axis support bound) of at least _BVH_MIN_RUN leaves."""
    from .csg import PrimType
    if g.gsign != 1 or g.fused is not None or g.lattice is not None:
        return None
    entries = []
    for ri, (ptype, start, count, scale) in enumerate(g.runs):
        if scale != 1 or isinstance(ptype, tuple):
            continue
        if ptype not in (int(PrimType.SPHERE), int(PrimType.BOX)):
            continue
        if count < _BVH_MIN_RUN:
            continue
        chunks = tuple((s, min(_BVH_CHUNK, start + count - s))
                       for s in range(start, start + count, _BVH_CHUNK))
        entries.append((ri, chunks))
    return tuple(entries) or None


def iter_bvh_chunks(kp) -> Tuple[Tuple[int, int, int], ...]:
    """Flat (ptype, start, count) chunk list over a KernelPlan's groups,
    in the one deterministic order shared by the table builder (which
    appends one bound row per chunk after the flag row) and the kernels
    (which read them back by the same ordinal)."""
    out = []
    for g in getattr(kp, "groups", ()):
        for ri, chunks in (g.bvh or ()):
            ptype = g.runs[ri][0]
            for (s, c) in chunks:
                out.append((ptype, s, c))
    return tuple(out)


def _prim_arrays(prims: Sequence[Primitive]):
    n = len(prims)
    pos = np.zeros((max(n, 1), 3), np.float32)
    aux = np.zeros((max(n, 1), 3), np.float32)
    color = np.zeros((max(n, 1), 3), np.float32)
    if n == 0:
        # Dummy far-away sphere, never referenced by any plan entry.
        # (1e15 keeps |d|^2 finite in f32 during vectorized leaf eval.)
        aux[0, 0] = 1.0
        pos[0] = 1e15
    from .csg import Julia, Mandelbox, Mandelbulb
    for i, p in enumerate(prims):
        pos[i] = p.position
        color[i] = p.color
        if isinstance(p, Sphere):
            aux[i, 0] = p.radius
        elif isinstance(p, (Mandelbox, Mandelbulb, Julia)):
            aux[i, 0] = p.size
        else:
            aux[i] = p.size
    return pos, aux, color


def compile_tree(root: ListNode, lights: Sequence[Light], camera: Camera
                 ) -> Tuple[ScenePlan, SceneTables]:
    prims, prim_type, lists, provenance, proc = _compile_tree(root)
    kernel = _kernel_normal_form(lists, prim_type, provenance, proc)
    if kernel is not None:
        blacks = tuple(i for i, p in enumerate(prims)
                       if tuple(np.float32(c) for c in p.color)
                       == (0.0, 0.0, 0.0))
        if 0 < len(blacks) <= 8:    # per-lane test is len(blacks) compares
            kernel = dataclasses.replace(kernel, black_prims=blacks)
    colored = any(tuple(l.color) != (1.0, 1.0, 1.0) for l in lights)
    plan = ScenePlan(prim_type=prim_type, lists=lists, kernel=kernel,
                     num_lights=len(lights), colored_lights=colored,
                     proc=proc)
    pos, aux, color = _prim_arrays(prims)

    nl = len(lights)
    light_pos = np.zeros((max(nl, 1), 3), np.float32)
    light_color = np.ones((max(nl, 1), 3), np.float32)
    for i, l in enumerate(lights):
        light_pos[i] = l.position
        light_color[i] = l.color

    tables = SceneTables(
        prim_pos=pos, prim_aux=aux, prim_color=color,
        light_pos=light_pos, light_color=light_color,
        cam_position=np.asarray(camera.position, np.float32),
        cam_direction=np.asarray(camera.direction, np.float32),
        cam_up=np.asarray(camera.up, np.float32),
        cam_fov=np.asarray(camera.fov, np.float32),
    )
    return plan, tables


def compile_scene(scene: Scene) -> Tuple[ScenePlan, SceneTables]:
    return compile_tree(scene.tree, scene.lights, scene.camera)
