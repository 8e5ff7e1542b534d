"""Debug / sanitizer utilities.

The reference's race/sanitizer story is "none" (SURVEY §5: the OpenMP loop
is trivially race-free; GL writes disjoint texels) and its debug util is a
dead ``debug::print(float3)`` helper (debug.cpp:8-10).  JAX is functional,
so the analogous tooling is:

  * NaN/Inf checking on pytrees and images (``check_finite``), plus the
    global ``jax_debug_nans`` switch;
  * Pallas interpret mode as the kernel "sanitizer" — every kernel entry
    point takes ``interpret=`` and runs the same kernel code in the
    interpreter on the CPU (ops.pallas_march.resolve_interpret);
  * ``print_v3`` — the spiritual successor of debug::print, but traceable
    (works under jit via jax.debug.print).
"""

from __future__ import annotations

import contextlib

import jax
import numpy as np


def check_finite(tree, name: str = "value") -> None:
    """Raise if any leaf contains NaN/Inf (host-side, concrete values)."""
    leaves = jax.tree_util.tree_leaves(tree)
    for i, leaf in enumerate(leaves):
        arr = np.asarray(leaf)
        if not np.all(np.isfinite(arr)):
            bad = int(np.size(arr) - np.isfinite(arr).sum())
            raise FloatingPointError(
                f"{name}: leaf {i} has {bad} non-finite elements "
                f"(shape {arr.shape})")


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped jax_debug_nans toggle (the jnp-path NaN sanitizer)."""
    prev = jax.config.read("jax_debug_nans")
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def print_v3(label: str, v) -> None:
    """Print a float3 from traced code (successor of debug::print)."""
    jax.debug.print(label + ": {x} {y} {z}",
                    x=v[..., 0], y=v[..., 1], z=v[..., 2])
