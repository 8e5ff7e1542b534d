"""Fused-gate offender classification (utils/gatecheck.py, r5 verdict #5).

The headline bench gates the fused fast mode against the exact path and
classifies every over-threshold pixel against the exact render's own AOVs:
offenders must sit on (within 1 px of) a silhouette / object-id / depth
discontinuity — fold-association ulps flipping a marginal SSAA sample.
An interior offender would mean the folded field is wrong ON the surface.

These tests pin (a) the mask/classifier logic on synthetic geometry where
the right answer is computable by hand, and (b) the real classification on
the demo scene's fused-vs-exact diff (interpret-mode mega, small footprint
— same scene the bench gates at 512²)."""

import numpy as np
import pytest

import raymarching_tpu as rt
from raymarching_tpu.api import render_aovs, render_tables
from raymarching_tpu.utils.gatecheck import classify_offenders, silhouette_mask


def _object_frame():
    """16x16 frame, 6x6 object at [5:11, 5:11] over empty background."""
    H = W = 16
    objid = -np.ones((H, W), np.int32)
    depth = np.full((H, W), np.inf)
    hit = np.zeros((H, W), np.float32)
    objid[5:11, 5:11] = 3
    depth[5:11, 5:11] = 5.0
    hit[5:11, 5:11] = 1.0
    return objid, depth, hit


def test_silhouette_mask_synthetic():
    """The mask must cover the object's boundary ring (and the image
    border) but not the smooth interior of either region."""
    objid, depth, hit = _object_frame()
    m = silhouette_mask(objid, depth, hit, dilate=1)
    # object-boundary pixels, adjacent background, and 1-px dilation
    assert m[5, 5] and m[4, 5] and m[11, 6] and m[5, 11]
    # the object's core (>=2 px inside its boundary) is interior
    assert not m[7, 7] and not m[8, 8]
    # deep background away from object and frame border is interior
    # (border itself is edge-class by design; 2 px in is not)
    assert not m[2, 13] and not m[13, 2]


def test_classify_offenders_synthetic():
    objid, depth, hit = _object_frame()
    diff = np.zeros(objid.shape, np.float32)
    diff[5, 5] = 0.2       # on the boundary: silhouette-class
    diff[7, 7] = 0.2       # object core: interior-class (a bug signal)
    cls = classify_offenders(diff, 5e-3, objid, depth, hit)
    assert cls["offenders"] == 2
    assert cls["offenders_on_silhouette"] == 1
    assert cls["offenders_interior"] == 1
    assert cls["interior_yx"] == [[7, 7]]
    assert cls["all_on_silhouette"] is False


def test_shadow_boundary_detected():
    """A cast-shadow edge (same object, same depth, light state flips)
    must be edge-class — the r5 demo gate's 'interior' offenders were a
    cast-shadow line across the floor."""
    H = W = 12
    objid = np.zeros((H, W), np.int32)
    hit = np.ones((H, W), np.float32)
    depth = np.full((H, W), 4.0)
    shadow = np.zeros((H, W, 2), np.float32)
    shadow[:, 6:, 1] = 1.0                 # light 1 shadowed on the right
    m = silhouette_mask(objid, depth, hit, shadow=shadow, dilate=0)
    assert m[4, 5] and m[4, 6]
    assert not m[4, 2] and not m[4, 9]
    # partial per-pixel shadow coverage is an edge by itself
    shadow2 = np.zeros((H, W, 1), np.float32)
    shadow2[5, 5, 0] = 0.5
    m2 = silhouette_mask(objid, depth, hit, shadow=shadow2, dilate=0)
    assert m2[5, 5] and not m2[8, 8]


def test_crease_detected():
    """Two faces of one object meeting at a crease (same id, smooth
    depth, normal turns 90 deg) must be edge-class — FD and analytic
    normal estimators legitimately disagree across the fold line."""
    H = W = 10
    objid = np.zeros((H, W), np.int32)
    hit = np.ones((H, W), np.float32)
    depth = np.full((H, W), 4.0)
    normal = np.zeros((H, W, 3), np.float32)
    normal[:, :5] = [0, 0, 1]
    normal[:, 5:] = [1, 0, 0]
    m = silhouette_mask(objid, depth, hit, normal=normal, dilate=0)
    assert m[4, 4] and m[4, 5]
    assert not m[4, 1] and not m[4, 8]


def test_depth_discontinuity_detected():
    """Same object id both sides, but a 2x depth jump: still edge-class
    (the demo's floor-meets-sponge seams are same-id depth creases)."""
    H = W = 8
    objid = np.zeros((H, W), np.int32)
    hit = np.ones((H, W), np.float32)
    depth = np.full((H, W), 4.0)
    depth[:, 4:] = 8.0
    m = silhouette_mask(objid, depth, hit, dilate=0)
    assert m[4, 3] and m[4, 4]
    assert not m[4, 1] and not m[4, 6]


@pytest.mark.slow
def test_demo_scene_offenders_on_silhouette():
    """The real gate, shrunk: fused-vs-exact diff of the demo scene at
    64x36 SSAA2 (interpret mega), classified against the exact AOVs.  The
    claim the bench records — every offender is silhouette-class —
    must hold here too; and the classifier must not be vacuous (the mask
    covers a small minority of the frame)."""
    plan, tables = rt.compile_scene(rt.load_scene("scenes/demo.txt"))
    cfg = rt.RenderConfig(width=64, height=36, ssaa=2, iterations=300,
                          ray_block=1024, normal_mode="fd")
    exact = np.asarray(render_tables(plan, tables, cfg, backend="mega",
                                     interpret=True))
    fused = np.asarray(render_tables(
        plan, tables,
        cfg.replace(fused_generators=True, normal_mode="analytic"),
        backend="mega", interpret=True))
    diff = np.abs(exact - fused).max(axis=-1)
    aovs = render_aovs(plan, tables, cfg, interpret=True)
    objid = np.asarray(aovs["objid"])
    depth = np.asarray(aovs["depth"])
    hit = np.asarray(aovs["hit"])
    shadow = np.asarray(aovs["shadow"])
    normal = np.asarray(aovs["normal"])
    cls = classify_offenders(diff, 5e-3, objid, depth, hit, shadow=shadow,
                             normal=normal)
    assert cls["all_on_silhouette"], (
        f"interior fused-gate offenders at {cls['interior_yx']}")
    # non-vacuity: the mask must not blanket the frame
    frac = silhouette_mask(objid, depth, hit, shadow=shadow,
                           normal=normal).mean()
    assert frac < 0.7, f"mask covers {frac:.0%} of the frame"
    # and an injected interior offender is still caught at this footprint
    inj = diff.copy()
    m = silhouette_mask(objid, depth, hit, shadow=shadow, normal=normal)
    free = np.argwhere(~m)
    assert len(free) > 0
    inj[tuple(free[len(free) // 2])] = 0.5
    assert not classify_offenders(
        inj, 5e-3, objid, depth, hit, shadow=shadow,
        normal=normal)["all_on_silhouette"]
