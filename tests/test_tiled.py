"""Host-streamed tiled rendering (api.render_tiled): row blocks through
the device must reproduce the whole-frame render.

Tolerance note: the tiled block program (traced row start) and the
whole-frame program are DIFFERENT compiled executables, and XLA fusion
differences perturb float rounding at the ulp level; the FD normal
(h=1e-3) amplifies that to ~1e-4 in shaded colors near silhouette edges.
Same-program determinism is covered by utils.selfcheck.rerun_check; here
the contract is agreement to FD-noise tolerance.
"""

import numpy as np
import pytest

import raymarching_tpu as rt
from raymarching_tpu.api import render_tables, render_tiled

CFG = rt.RenderConfig(width=64, height=36, ssaa=2, iterations=200)
TOL = dict(atol=1e-3, rtol=0)


@pytest.fixture(scope="module")
def demo():
    return rt.compile_scene(rt.load_scene("scenes/demo.txt"))


@pytest.mark.slow
@pytest.mark.parametrize("row_block", [36, 16, 7])
def test_tiled_matches_whole_frame_jnp(demo, row_block):
    plan, tables = demo
    whole = np.asarray(render_tables(plan, tables, CFG, backend="jnp"))
    tiled = render_tiled(plan, tables, CFG, row_block=row_block,
                         backend="jnp")
    np.testing.assert_allclose(whole, tiled, **TOL)


def test_tiled_blocks_are_self_consistent(demo):
    """Two different block sizes run the SAME block program shape-by-shape
    only when shapes match; across block sizes agreement stays within the
    same FD-noise bound."""
    plan, tables = demo
    a = render_tiled(plan, tables, CFG, row_block=12, backend="jnp")
    b = render_tiled(plan, tables, CFG, row_block=18, backend="jnp")
    np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.slow
def test_tiled_matches_whole_frame_mega_interpret(demo):
    plan, tables = demo
    cfg = CFG.replace(ray_block=1024)
    whole = np.asarray(render_tables(plan, tables, cfg, backend="mega",
                                     interpret=True))
    tiled = render_tiled(plan, tables, cfg, row_block=16, backend="mega",
                         interpret=True)
    np.testing.assert_allclose(whole, tiled, **TOL)


def test_tiled_row_slice_matches_band(demo):
    """row_start/num_rows stream exactly the requested band (the
    multihost splitter's contract)."""
    plan, tables = demo
    whole = render_tiled(plan, tables, CFG, row_block=16, backend="jnp")
    band = render_tiled(plan, tables, CFG, row_block=16, backend="jnp",
                        row_start=11, num_rows=13)
    assert band.shape == (13, CFG.width, 3)
    np.testing.assert_allclose(whole[11:24], band, **TOL)


def test_tiled_multihost_single_process_degrades(demo):
    """With one process, render_tiled_multihost IS render_tiled."""
    from raymarching_tpu.api import render_tiled_multihost

    plan, tables = demo
    a = render_tiled(plan, tables, CFG, row_block=16, backend="jnp")
    b = render_tiled_multihost(plan, tables, CFG, row_block=16,
                               backend="jnp")
    np.testing.assert_allclose(a, b, **TOL)


def test_tiled_rejects_out_of_range_band(demo):
    plan, tables = demo
    with pytest.raises(ValueError, match="outside frame"):
        render_tiled(plan, tables, CFG, row_block=16, backend="jnp",
                     row_start=30, num_rows=10)
    with pytest.raises(ValueError, match="outside frame"):
        render_tiled(plan, tables, CFG, row_block=16, backend="jnp",
                     row_start=-1, num_rows=4)


@pytest.mark.slow
def test_tiled_dof_matches_whole_frame(demo):
    """--row-block with aperture > 0 must render the SAME thin-lens image
    as the whole-frame DoF path (was: silent pinhole fallback)."""
    plan, tables = demo
    cfg = CFG.replace(aperture=0.05, focus_dist=6.0)
    whole = np.asarray(render_tables(plan, tables, cfg, backend="jnp"))
    tiled = render_tiled(plan, tables, cfg, row_block=16, backend="jnp")
    np.testing.assert_allclose(whole, tiled, **TOL)
    # and it actually differs from the pinhole frame (DoF engaged)
    pin = np.asarray(render_tables(plan, tables, CFG, backend="jnp"))
    assert np.abs(whole - pin).max() > 1e-3


def test_tiled_output_is_host_memory(demo):
    plan, tables = demo
    tiled = render_tiled(plan, tables, CFG, row_block=18, backend="jnp")
    assert isinstance(tiled, np.ndarray)
    assert tiled.shape == (CFG.height, CFG.width, 3)
    assert np.isfinite(tiled).all()
