"""Ray-ordering: map camera-grid samples to kernel ray blocks as pixel
blocks.

The kernels process rays in 1-D blocks of RenderConfig.ray_block lanes,
and a block keeps marching until its SLOWEST lane converges (the analogue
of warp divergence in the reference's GLSL kernel, shader.comp:288-297).
In flat scan order a block is a run of one image row: background lanes
that converge in a handful of steps sit behind fractal-silhouette lanes
for dozens.  Reordering samples so each block covers a compact ~square
pixel block keeps a block's lanes spatial neighbours.

The reorder is expressed as RESHAPE + TRANSPOSE (block dims divide the
frame by construction: they are chosen among the divisors of H and W), NOT
as a gather with an index array: a transpose's VJP is the inverse
transpose — a fast contiguous copy — while a 1M-row gather's VJP is a
scatter-add.

Results are inverse-permuted on the way out, so rendered images are
BIT-EXACT identical to scan order: per-ray arithmetic never depends on
block composition, and the kernel's cull/early-exit decisions are
value-exact proofs.  (Cotangents that REDUCE over rays — table gradients —
see a different FP summation order: reduction-order noise only.)
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

PERM_ROW = 128   # rays per row of a cost-ordering permutation


@lru_cache(maxsize=64)
def block_dims(H: int, W: int, S: int, block_rays: int
               ) -> Optional[Tuple[int, int]]:
    """Pixel-block shape (bh, bw) with bh | H and bw | W, sized so one
    block holds ~block_rays samples with ~square aspect; None when the
    frame is too small for ordering to matter or no useful split exists.
    """
    R = H * W * S
    if R < 2 * block_rays:
        return None
    P = max(1, block_rays // S)             # target pixels per block
    divs_h = [d for d in range(1, H + 1) if H % d == 0]
    divs_w = [d for d in range(1, W + 1) if W % d == 0]
    bh = min(divs_h, key=lambda d: abs(d - math.sqrt(P)))
    bw = min(divs_w, key=lambda d: abs(d - P / bh))
    if (bh, bw) in ((H, W), (1, W)):        # degenerate: scan already
        return None
    return bh, bw


def to_blocked(x: jnp.ndarray, H: int, W: int, S: int,
               bh: int, bw: int) -> jnp.ndarray:
    """[H*W*S, ...] scan-order samples -> block-major order (pure
    reshape/transpose; VJP is the inverse transpose, no scatter)."""
    tail = x.shape[1:]
    x = x.reshape(H // bh, bh, W // bw, bw, S, *tail)
    x = jnp.transpose(x, (0, 2, 1, 3, 4) + tuple(
        5 + i for i in range(len(tail))))
    return x.reshape((H * W * S,) + tail)


def from_blocked(x: jnp.ndarray, H: int, W: int, S: int,
                 bh: int, bw: int) -> jnp.ndarray:
    """Inverse of to_blocked."""
    tail = x.shape[1:]
    x = x.reshape(H // bh, W // bw, bh, bw, S, *tail)
    x = jnp.transpose(x, (0, 2, 1, 3, 4) + tuple(
        5 + i for i in range(len(tail))))
    return x.reshape((H * W * S,) + tail)


def row_cost_perm(steps: np.ndarray, row: int = PERM_ROW) -> np.ndarray:
    """Cost-ordered block scheduling: permutation of ROWS of ``row``
    consecutive rays, sorted by the row's max predicted step count.

    A kernel block marches until its SLOWEST lane converges, so its cost
    is the max over its rays — mixing a fractal-silhouette row with
    background rows bills every lane the fractal's steps (the reference's
    GLSL kernel eats the same divergence per warp, shader.comp:288-297).
    Sorting rows by cost makes blocks cost-homogeneous.  Opt-in: see
    api.plan_cost_order for why it does not pay on multi-phase frames.

    The permutation is over ROWS, not rays, for two reasons: the gather is
    R/row indices instead of R (its VJP — the inverse row gather, see
    row_permuters — is a contiguous row copy), and each row keeps
    spatially-adjacent samples so per-row cost stays coherent.

    ``steps`` must be per-ray step counts in the LAYOUT THE KERNEL SEES
    (i.e. after block ordering when that is enabled) — api.plan_cost_order
    produces them with the kernel's own counters.  Stale or wrong costs
    degrade only SPEED, never results: the image is bit-exact under any
    row permutation (per-ray arithmetic is block-independent, and outputs
    are inverse-permuted before the SSAA mean).
    """
    steps = np.asarray(steps).ravel()
    if steps.size % row:
        raise ValueError(f"ray count {steps.size} not a multiple of {row}")
    cost = steps.reshape(-1, row).max(axis=1)
    return np.argsort(cost, kind="stable").astype(np.int32)


def row_permuters(perm: np.ndarray, row: int = PERM_ROW
                  ) -> Tuple[Callable, Callable]:
    """(apply, invert) for a row permutation on flat [R, ...] ray arrays.

    Both directions are jnp row-takes with a CUSTOM VJP: the transpose of
    a bijective take is the take by the inverse permutation — a gather,
    never a scatter (XLA's default gather transpose IS a scatter-add; the
    bijection is what makes the cheap transpose valid).
    """
    perm = np.asarray(perm, np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    n = len(perm)

    def _taker(idx_fwd: np.ndarray, idx_bwd: np.ndarray) -> Callable:
        jf, jb = jnp.asarray(idx_fwd), jnp.asarray(idx_bwd)

        @jax.custom_vjp
        def take(x):
            t = x.reshape((n, row) + x.shape[1:])
            return jnp.take(t, jf, axis=0).reshape(x.shape)

        def fwd(x):
            return take(x), None

        def bwd(_, g):
            t = g.reshape((n, row) + g.shape[1:])
            return (jnp.take(t, jb, axis=0).reshape(g.shape),)

        take.defvjp(fwd, bwd)
        return take

    return _taker(perm, inv), _taker(inv, perm)


def resolve_ray_order(cfg, backend: str) -> bool:
    """Whether the camera-grid path should use block ordering."""
    if cfg.ray_order == "scan":
        return False
    if cfg.ray_order == "block":
        return True
    if cfg.ray_order == "auto":
        return backend == "mega"
    raise ValueError(f"unknown ray_order {cfg.ray_order!r}")
