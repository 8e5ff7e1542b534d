"""Block ray ordering (core.order): tiles cover compact pixel blocks.

Contract: BIT-EXACT output vs scan order — the reorder only changes which
rays share a hardware tile (performance), never any ray's math, and the
output is inverse-permuted back to scan order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raymarching_tpu as rt
from raymarching_tpu.api import render_tables
from raymarching_tpu.core.order import (block_dims, from_blocked,
                                        resolve_ray_order, to_blocked)


class TestBlockReorder:
    @pytest.mark.parametrize("H,W,S,tile", [
        (512, 512, 4, 2048),     # bench config: 16x32-pixel blocks
        (768, 1024, 9, 2048),    # reference config
        (36, 64, 1, 1024),
        (50, 60, 9, 2048),       # awkward divisors
    ])
    def test_roundtrip_is_identity(self, H, W, S, tile):
        dims = block_dims(H, W, S, tile)
        assert dims is not None
        bh, bw = dims
        assert H % bh == 0 and W % bw == 0
        R = H * W * S
        x = jnp.arange(R * 2, dtype=jnp.float32).reshape(R, 2)
        y = from_blocked(to_blocked(x, H, W, S, bh, bw), H, W, S, bh, bw)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        # and the forward map is a real permutation, not identity
        assert not np.array_equal(
            np.asarray(x), np.asarray(to_blocked(x, H, W, S, bh, bw)))

    def test_tiny_frame_declines(self):
        assert block_dims(8, 8, 1, 2048) is None

    def test_blocks_are_compact(self):
        """Consecutive tile_rays samples must span a small bounding box,
        not a full image row."""
        H = W = 512
        S, tile = 4, 2048
        bh, bw = block_dims(H, W, S, tile)
        idx = jnp.arange(H * W * S, dtype=jnp.int32).reshape(-1, 1)
        first = np.asarray(to_blocked(idx, H, W, S, bh, bw))[:tile, 0]
        ys = (first // S) // W
        xs = (first // S) % W
        # scan order would span the full 512-wide row; blocks stay local
        assert (ys.max() - ys.min() + 1) * (xs.max() - xs.min() + 1) \
            <= 2 * tile // S

    def test_scalar_rows_roundtrip(self):
        H, W, S = 36, 64, 1
        bh, bw = block_dims(H, W, S, 1024)
        x = jnp.arange(H * W * S, dtype=jnp.float32)
        y = from_blocked(to_blocked(x, H, W, S, bh, bw), H, W, S, bh, bw)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    def test_resolve_modes(self):
        cfg = rt.RenderConfig()
        assert resolve_ray_order(cfg.replace(ray_order="scan"), "mega") \
            is False
        assert resolve_ray_order(cfg.replace(ray_order="block"), "jnp") \
            is True
        assert resolve_ray_order(cfg.replace(ray_order="auto"), "mega") \
            is True
        assert resolve_ray_order(cfg.replace(ray_order="auto"), "jnp") \
            is False
        with pytest.raises(ValueError):
            resolve_ray_order(cfg.replace(ray_order="zigzag"), "mega")


@pytest.fixture(scope="module")
def demo():
    return rt.compile_scene(rt.load_scene("scenes/demo.txt"))


CFG = rt.RenderConfig(width=64, height=36, ssaa=1, iterations=200,
                      ray_block=1024)


class TestBitExactness:
    def test_mega_block_equals_scan(self, demo):
        plan, tables = demo
        a = np.asarray(render_tables(plan, tables,
                                     CFG.replace(ray_order="scan"),
                                     backend="mega", interpret=True))
        b = np.asarray(render_tables(plan, tables,
                                     CFG.replace(ray_order="block"),
                                     backend="mega", interpret=True))
        np.testing.assert_array_equal(a, b)

    @pytest.mark.slow
    def test_mega_block_chunked_equals_scan(self, demo):
        plan, tables = demo
        a = np.asarray(render_tables(
            plan, tables, CFG.replace(ray_order="scan", ray_chunk=1024),
            backend="mega", interpret=True))
        b = np.asarray(render_tables(
            plan, tables, CFG.replace(ray_order="block", ray_chunk=1024),
            backend="mega", interpret=True))
        np.testing.assert_array_equal(a, b)

    @pytest.mark.slow
    def test_gradients_match_scan(self, demo):
        plan, tables = demo

        def loss(t, order):
            img = render_tables(plan, t, CFG.replace(ray_order=order),
                                backend="mega", interpret=True)
            return jnp.mean(img)

        ga = jax.grad(loss)(tables, "scan")
        gb = jax.grad(loss)(tables, "block")
        # NOT bit-exact: table cotangents reduce over rays, and the
        # reorder changes the FP summation order — agreement to
        # reduction-order noise (measured ~4e-3 relative) is the contract.
        for a, b in zip(jax.tree_util.tree_leaves(ga),
                        jax.tree_util.tree_leaves(gb)):
            a, b = np.asarray(a), np.asarray(b)
            scale = max(float(np.abs(a).max()), 1e-12)
            np.testing.assert_allclose(a, b, atol=1e-2 * scale, rtol=0)

    @pytest.mark.slow
    def test_jnp_dof_block_matches_scan(self, demo):
        plan, tables = demo
        cfg = CFG.replace(aperture=0.05, ssaa=2)
        a = np.asarray(render_tables(plan, tables,
                                     cfg.replace(ray_order="scan"),
                                     backend="jnp"))
        b = np.asarray(render_tables(plan, tables,
                                     cfg.replace(ray_order="block"),
                                     backend="jnp"))
        np.testing.assert_array_equal(a, b)
