"""core.sdf.take_rows / segment_sum_rows: the color gather whose cotangent
is summed in two levels (per block of rays, then across blocks) instead of
by one scatter-add."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raymarching_tpu.core import sdf


def _plain_take(table, idx):
    safe = jnp.clip(idx, 0, table.shape[0] - 1)
    return jnp.where((idx >= 0)[..., None], table[safe], 0.0)


@pytest.mark.parametrize("shape", [(7,), (3, 50), (1000,)])
def test_take_rows_value_and_grad_match_plain_gather(shape):
    rng = np.random.default_rng(len(shape))
    table = jnp.asarray(rng.normal(size=(11, 3)), jnp.float32)
    idx = jnp.asarray(rng.integers(-2, 11, size=shape), jnp.int32)
    w = jnp.asarray(rng.normal(size=shape + (3,)), jnp.float32)
    np.testing.assert_array_equal(np.asarray(sdf.take_rows(table, idx)),
                                  np.asarray(_plain_take(table, idx)))
    g = jax.grad(lambda t: jnp.sum(sdf.take_rows(t, idx) * w))(table)
    g0 = jax.grad(lambda t: jnp.sum(_plain_take(t, idx) * w))(table)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g0),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("R,P,partials", [(1, 3, 1 << 24),
                                          (1000, 5, 1 << 24),
                                          (1000, 5, 40)])
def test_segment_sum_rows_matches_float64(R, P, partials, monkeypatch):
    """Ids outside [0, P) drop; a ray count that is no multiple of the
    block pads; a low partial-sum cap makes the blocks longer."""
    monkeypatch.setattr(sdf, "_SUM_PARTIALS", partials)
    rng = np.random.default_rng(R + partials)
    idx = rng.integers(-1, P + 2, size=R).astype(np.int32)
    vals = rng.normal(size=(R, 2)).astype(np.float32)
    want = np.zeros((P, 2))
    keep = (idx >= 0) & (idx < P)
    np.add.at(want, idx[keep], vals[keep].astype(np.float64))
    got = sdf.segment_sum_rows(jnp.asarray(idx), jnp.asarray(vals), P)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("device", [
    "default", pytest.param("gpu", marks=pytest.mark.gpu)])
def test_segment_sum_rows_holds_a_row_most_rays_hit(device):
    """The demo frame at 512x512 SSAA 2x2: 67 % of the 1,048,576 rays hit
    one Bounds wall, each adding light / (H*W*3*S) to its color row.  One
    plain scatter-add drifts by 2.4e-3 on these values on the CPU, and by
    1.9e-3 on the demo frame's own values on an H100 (PERF.md); the
    ``gpu`` case runs on the card in chip_smoke.py."""
    R, P = 1 << 20, 428
    rng = np.random.default_rng(0)
    idx = np.where(rng.random(R) < 0.67, 0,
                   rng.integers(1, P, size=R)).astype(np.int32)
    light = rng.choice(np.float32([0.05, 0.3, 0.7]), size=R)
    vals = np.repeat((light / np.float32(512 * 512 * 3 * 4))[:, None], 3, 1)
    want = np.zeros((P, 3))
    np.add.at(want, idx, vals.astype(np.float64))
    got = np.asarray(jax.jit(sdf.segment_sum_rows, static_argnums=2)(
        jnp.asarray(idx), jnp.asarray(vals), P), np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5
